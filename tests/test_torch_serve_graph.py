"""The inference function's CUDA graphs (``core/serve.py``: ``CudaGraphs``) on the card.

At HandWritten's served shape (dmvae_cml over the FusedDMVAE, 400 rows of
six views) and at LUMA's (dmvae_cml over the Audio, Text and Image
encoders, 4096 rows):

* a replay gives the outputs of the eager call, bit for bit;
* an output held by the caller survives later calls at its shape;
* a shape is captured once, on its second call, and on a new thread (the
  daemon's) only after that thread's own first call;
* the head kernel's counter grows by one a call, eager, captured or
  replayed;
* deleting the function frees its graphs' memory.

Every test here needs a CUDA device and skips inside the test without one;
the CPU side of the graphs (when they do not engage, the cache's
bookkeeping) is in ``test_torch_serve.py``. No JAX here:

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_serve_graph.py
"""

import gc
import threading

import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu_torch.core import serve as tserve
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.logging import counters

HEADS = "kernels.evidential_heads"
CALLS = ("serve.eager_calls", "serve.graph_captures", "serve.graph_replays")
HANDWRITTEN_VIEWS = (240, 76, 216, 47, 64, 6)
LUMA_VIEWS = (40, 128, 3072)
LUMA_ENCODERS = (
    ("AudioEncoder", dict(output_dim=200, dropout=0.1, input_dim=40, use_2d=False)),
    ("TextEncoder", dict(output_dim=200, dropout=0.1, input_dim=128)),
    ("ImageEncoder", dict(output_dim=200, dropout=0.1)),
)
# (views, rows, classes, feature encoders)
SHAPES = {
    "handwritten": (HANDWRITTEN_VIEWS, 400, 10, None),
    "luma": (LUMA_VIEWS, 4096, 42, LUMA_ENCODERS),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _models(name, device):
    """(probe task, backbone) of dmvae_cml at the shape's published widths."""
    views, _, classes, encoders = SHAPES[name]
    backbone = ttasks.build_dmvae_task(
        output_dim=[200] * len(views) if encoders else views, hidden_dim=512, embed_dim=200,
        fused_modalities=True, feature_encoders=encoders, device=device)
    task = ttasks.build_probe_task(num_modalities=len(views), num_classes=classes,
                                   input_dim=200, hidden_dim=(128,), aggregation="cml",
                                   seed=1, device=device)
    return task, backbone


def _infer(name, device):
    task, backbone = _models(name, device)
    return tserve.build_inference_fn(task, backbone=backbone)


def _views(name, device, seed=0):
    views, rows, _, _ = SHAPES[name]
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.rand((rows, d), generator=g, device=device) for d in views)


def _host(out):
    return tserve.to_host(out)


def _assert_equal(got, want, label):
    assert list(got) == list(want), label
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (label, k)
        gap = np.max(np.abs(got[k].astype(np.float64) - want[k].astype(np.float64)))
        assert np.array_equal(got[k], want[k]), f"{label}: {k} differs by up to {gap:.3e}"


def _grew(since):
    now = counters(since)
    return {k: now[k] for k in (HEADS, *CALLS)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_replay_equals_eager_bitwise(card, name):
    infer, xs = _infer(name, card), _views(name, card)
    eager = _host(infer(xs))
    captured = _host(infer(xs))
    replayed = _host(infer(xs))
    _assert_equal(captured, eager, f"{name}: capture against eager")
    _assert_equal(replayed, eager, f"{name}: replay against eager")
    assert len(infer.graphs.graphs) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_a_held_output_survives_later_calls(card, name):
    infer = _infer(name, card)
    a, b = _views(name, card, seed=1), _views(name, card, seed=2)
    want_a, want_b = _host(infer(a)), _host(infer(b))     # eager, then the capture
    held = infer(a)                                       # a replay
    later = [infer(b) for _ in range(3)]
    assert all(held[k] is not out[k] for out in later for k in held)
    _assert_equal(_host(held), want_a, f"{name}: held output after later calls")
    _assert_equal(_host(later[-1]), want_b, f"{name}: the later call")


@pytest.mark.gpu
def test_a_new_shape_is_captured_once_on_its_second_call(card):
    infer = _infer("handwritten", card)
    steps = []
    for rows in (400, 400, 400, 64, 400, 64, 64, 64):
        since = counters()
        infer(tuple(x[:rows] for x in _views("handwritten", card)))
        grew = _grew(since)
        steps.append(next(k for k in CALLS if grew[k]))
        assert sum(grew[k] for k in CALLS) == 1, grew
    assert steps == ["serve.eager_calls", "serve.graph_captures", "serve.graph_replays",
                     "serve.eager_calls", "serve.graph_replays", "serve.graph_captures",
                     "serve.graph_replays", "serve.graph_replays"]
    assert len(infer.graphs.graphs) == 2


@pytest.mark.gpu
def test_a_new_thread_captures_after_its_own_first_call(card):
    infer, xs = _infer("handwritten", card), _views("handwritten", card)
    want = _host(infer(xs))                   # eager on this thread
    got, steps = [], []

    def serve():
        for _ in range(3):
            since = counters()
            got.append(_host(infer(xs)))
            steps.append(next(k for k in CALLS if counters(since)[k]))

    worker = threading.Thread(target=serve)
    worker.start()
    worker.join(120)
    assert not worker.is_alive() and len(got) == 3
    assert steps == ["serve.eager_calls", "serve.graph_captures", "serve.graph_replays"]
    for out in got:
        _assert_equal(out, want, "a call on the worker thread")
    since = counters()
    _assert_equal(_host(infer(xs)), want, "this thread's replay of the worker's graph")
    assert counters(since)["serve.graph_replays"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_the_head_kernel_counts_one_launch_a_call(card, name):
    infer, xs = _infer(name, card), _views(name, card)
    for what in CALLS + ("serve.graph_replays",):
        since = counters()
        infer(xs)
        assert _grew(since) == {HEADS: 1, **{k: int(k == what) for k in CALLS}}, what


@pytest.mark.gpu
def test_deleting_the_function_frees_its_graphs(card):
    task, backbone = _models("luma", card)
    xs = _views("luma", card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    infer = tserve.build_inference_fn(task, backbone=backbone)
    for _ in range(3):
        out = infer(xs)
    del out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    live = torch.cuda.memory_reserved()
    del infer
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    print(f"memory_reserved: {before} before, {live} with the graph, {after} after "
          f"({torch.cuda.get_device_name(0)})")
    assert live - before > 2**28, "the LUMA graph's pool holds its activations"
    assert after <= before + 2**26

"""The DeepSeek-V2 text tower (``models/text_tower.py``, ``layers.TowerTextEncoder``) and its
expert product (``ops/moe_experts.py``) against plain references.

On the CPU, at a small size in float32 (hidden 64, 4 heads of 16 + 8 / 16,
kv rank 32, 8 experts top-3 of width 32, 1 shared, 1 dense layer of width
96 + 2 MoE layers, vocabulary 257, 16 positions, YaRN at factor 40 over 32
original positions): the tower against ``reference/deepseek_v2_lite.py``,
and LUMA's ``dmvae_cml`` with the tower, served by ``build_inference_fn``,
against the benchmark's plain reference of that cell. The YaRN numbers at
the published values, the routing and dispatch without a host sync, the
parameter count at the published widths (on the meta device), the views'
dtypes through ``_as_tensor``, spans and counters, and export's refusal.

The ``gpu``-marked tests run on the card (no JAX here):

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_text_tower.py
"""

import gc
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from disentagled_multimodal_fusion_tpu_torch.core import serve as tserve
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.logging import counters, recording
from disentagled_multimodal_fusion_tpu_torch.models import text_tower
from disentagled_multimodal_fusion_tpu_torch.models.layers import ENCODER_REGISTRY, TowerTextEncoder
from disentagled_multimodal_fusion_tpu_torch.ops import moe_experts as tmoe
from port_bench.reference import luma_dsv2lite as bench_reference
from reference import deepseek_v2_lite as reference

PUBLISHED = text_tower.DEEPSEEK_V2_LITE
SMALL = dict(PUBLISHED, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
             n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=1,
             moe_intermediate_size=32, intermediate_size=96, num_hidden_layers=3,
             vocab_size=257, max_position_embeddings=64,
             rope_scaling=dict(PUBLISHED["rope_scaling"], original_max_position_embeddings=32))
POSITIONS = 16
# the port's float32 tower against the float32 reference: the same
# arithmetic summed in other orders (the experts by tile or by expert, the
# routed sum before or after the shared experts), a few float32 roundings
# of outputs of order 1 deep, so 1e-5 absolute and relative
TOL = dict(rtol=1e-5, atol=1e-5)


def _draw(module, seed):
    """Every tower weight N(0, 0.1) (large enough at hidden 64 that each
    part moves the output), norm scales U(0.8, 1.2), from the seed."""
    g = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith("norm.weight"):
            p.data.uniform_(0.8, 1.2, generator=g)
        else:
            p.data.normal_(0.0, 0.1, generator=g)


def _ids(rows, seed=0, vocab=257):
    return torch.randint(0, vocab, (rows, POSITIONS), generator=torch.Generator().manual_seed(seed))


def _encoder(seed=0):
    enc = TowerTextEncoder(torch.Generator().manual_seed(seed), config=SMALL, dtype="float32")
    _draw(enc.tower, seed)
    return enc


def test_tower_matches_the_plain_reference():
    enc = _encoder(1)
    ids = _ids(6, 2)
    got = enc.tower(ids)
    want = reference.tower(SMALL, enc.tower.state_dict(), "", ids)
    assert got.shape == (6, 64) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL)


def _luma_cfg():
    """The benchmark configuration's layout at the small size."""
    return dict(SMALL, views=[40, POSITIONS, 3072], num_classes=5,
                encoders=[{"name": "AudioEncoder", "widths": [40, 128, 256, 200], "dropout": 0.1},
                          {"name": "TowerTextEncoder", "widths": [64, 256, 256, 200],
                           "dropout": 0.1},
                          {"name": "ImageEncoder", "image_side": 32, "channels": [3, 32, 64, 128],
                           "widths": [2048, 512, 200], "dropout": 0.1}],
                dmvae={"hidden_dim": 64, "embed_dim": 200, "poe_temperature": 1.5})


def _luma(cfg):
    specs = (("AudioEncoder", dict(output_dim=200, dropout=0.1, input_dim=40, use_2d=False)),
             ("TowerTextEncoder", dict(config=SMALL, output_dim=200, dropout=0.1,
                                       dtype="float32")),
             ("ImageEncoder", dict(output_dim=200, dropout=0.1)))
    backbone = ttasks.build_dmvae_task(output_dim=[200] * 3, hidden_dim=64, embed_dim=200,
                                       fused_modalities=True, feature_encoders=specs,
                                       device="cpu")
    _draw(backbone.feat_encs[1].tower, 3)
    task = ttasks.build_probe_task(num_modalities=3, num_classes=cfg["num_classes"],
                                   input_dim=200, hidden_dim=(128,), aggregation="cml", seed=1,
                                   device="cpu")
    return task, backbone


def _views(rows, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, 40, generator=g), _ids(rows, seed + 1),
            torch.randn(rows, 3072, generator=g))


def test_luma_with_the_tower_matches_the_plain_reference():
    cfg = _luma_cfg()
    task, backbone = _luma(cfg)
    infer = tserve.build_inference_fn(task, backbone=backbone)
    xs = _views(5)
    got = infer(xs)
    w = {f"backbone.{k}": v for k, v in backbone.state_dict().items()}
    w.update({f"heads.{k}": v for k, v in task.model.state_dict().items()})
    want = bench_reference.forward(cfg, "dmvae_cml", w, xs)
    for key in ("probs", "epistemic", "aleatoric"):
        torch.testing.assert_close(got[key], want[key], **TOL)
    # the evidence reaches e^10: compared as logits
    for key in ("evidence", "fused_evidence"):
        torch.testing.assert_close(torch.log(got[key]), torch.log(want[key]), **TOL)
    assert torch.equal(got["pred"], want["pred"])


def test_yarn_numbers_at_the_published_values():
    # a float64 transcription: f_extra = 10000^(-2i/64), f_inter = f_extra / 40,
    # m = 1 - clamp((i - 10) / (23 - 10), 0, 1), inv_freq = f_inter (1 - m) + f_extra m
    f_extra = np.array([10000.0 ** (-2 * i / 64) for i in range(32)])
    m = 1.0 - np.clip((np.arange(32) - 10) / (23 - 10), 0.0, 1.0)
    inv_freq = f_extra / 40 * (1 - m) + f_extra * m
    s = 0.1 * 0.707 * math.log(40) + 1
    # float32 against float64: a few roundings of float32 (2^-24 each)
    for got in (text_tower.yarn_inv_freq(PUBLISHED), reference.rope_inv_freq(PUBLISHED)):
        np.testing.assert_allclose(got.numpy(), inv_freq, rtol=1e-6, atol=0)
    for got in (text_tower.softmax_scale(PUBLISHED), reference.attention_scale(PUBLISHED)):
        assert got == pytest.approx(192 ** -0.5 * s * s, rel=1e-12)
    assert round(text_tower.softmax_scale(PUBLISHED), 6) == 0.114721
    assert text_tower.rope_mscale(PUBLISHED) == 1.0


class _NoHostSync(TorchDispatchMode):
    """Refuses the operators that read a device value back to the host."""

    REFUSED = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero, torch.ops.aten.item}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.REFUSED:
            raise AssertionError(f"host sync: {func}")
        return func(*args, **(kwargs or {}))


def test_the_mode_refuses_a_host_sync():
    with pytest.raises(AssertionError, match="host sync"), _NoHostSync():
        torch.ones(3).sum().item()


def test_routing_dispatch_and_the_tower_make_no_host_sync():
    enc = _encoder(4)
    ids = _ids(3, 5)
    with _NoHostSync():
        x = torch.randn(48, 64)
        weights, experts = tmoe.route(x, torch.randn(8, 64), 3)
        d = tmoe.dispatch(experts, 8)
        tmoe.moe_experts(x, weights, experts, torch.randn(8, 32, 64), torch.randn(8, 32, 64),
                         torch.randn(8, 64, 32))
        enc(ids)
    assert d.tile_expert.shape == (-(-48 * 3 // tmoe.BLOCK_M) + 8,)


def test_dispatch_covers_every_routed_row_once(monkeypatch):
    monkeypatch.setattr(tmoe, "BLOCK_M", 16)
    experts = torch.randint(0, 8, (100, 3), generator=torch.Generator().manual_seed(6))
    d = tmoe.dispatch(experts, 8)
    assert sorted(d.order.tolist()) == list(range(300))
    assert torch.equal(experts.reshape(-1)[d.order], experts.reshape(-1).sort(stable=True).values)
    rows = []
    for e, start, end in zip(d.tile_expert.tolist(), d.tile_start.tolist(), d.tile_end.tolist()):
        if e >= 0:
            rows += [(e, r) for r in range(start, min(start + 16, end))]
    assert [r for _, r in rows] == list(range(300))
    assert all(experts.reshape(-1)[d.order[r]] == e for e, r in rows)


def test_moe_experts_is_the_weighted_sum_of_the_routed_experts(monkeypatch):
    monkeypatch.setattr(tmoe, "BLOCK_M", 4)
    g = torch.Generator().manual_seed(7)
    x, w_gate = torch.randn(40, 16, generator=g), torch.randn(5, 8, 16, generator=g)
    w_up, w_down = torch.randn(5, 8, 16, generator=g), torch.randn(5, 16, 8, generator=g)
    weights, experts = tmoe.route(x, torch.randn(5, 16, generator=g), 2)
    got = tmoe.moe_experts(x, weights, experts, w_gate, w_up, w_down)
    want = torch.zeros(40, 16)
    for t in range(40):
        for k in range(2):
            e = int(experts[t, k])
            want[t] += weights[t, k] * (w_down[e] @ (torch.nn.functional.silu(w_gate[e] @ x[t])
                                                     * (w_up[e] @ x[t])))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_published_widths_hold_15_5_billion_parameters_on_the_meta_device():
    enc = TowerTextEncoder(torch.Generator(), device="meta")
    assert sum(p.numel() for p in enc.tower.parameters()) == 15_496_769_024
    assert all(p.device.type == "meta" and p.dtype == torch.bfloat16
               for p in enc.tower.parameters())
    assert len(enc.tower.layers) == 27
    assert sum(isinstance(layer.mlp, text_tower.MoE) for layer in enc.tower.layers) == 26


def test_the_tower_is_frozen_and_built_where_asked():
    enc = _encoder(8)
    assert not any(p.requires_grad for p in enc.tower.parameters())
    assert all(p.requires_grad for p in enc.layers.parameters())
    assert ENCODER_REGISTRY["TowerTextEncoder"] is TowerTextEncoder
    # build_dmvae_task hands the tower the model's device
    _, backbone = _luma(_luma_cfg())
    assert backbone.feat_encs[1].tower.embed_tokens.weight.device.type == "cpu"
    with pytest.raises(TypeError, match="token ids"):
        enc(torch.rand(2, POSITIONS))
    with pytest.raises(ValueError, match="q_lora_rank"):
        text_tower.Tower(dict(SMALL, q_lora_rank=16), torch.float32, torch.device("meta"))


def test_integer_views_stay_integer_and_float_views_are_unchanged():
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = tserve._as_tensor(ids, torch.device("cpu"))
    assert t.dtype == torch.int64 and torch.equal(t, torch.arange(12).reshape(3, 4))
    assert tserve._as_tensor(torch.arange(4, dtype=torch.int32), "cpu").dtype == torch.int64
    x = np.random.default_rng(0).standard_normal((3, 40))
    for view in (x, x.astype(np.float32), torch.from_numpy(x)):
        got = tserve._as_tensor(view, torch.device("cpu"))
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.from_numpy(x.astype(np.float32)))
    key_f = tserve.graph_key((torch.zeros(2, 4), torch.zeros(2, 4)))
    key_i = tserve.graph_key((torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int64)))
    assert key_f != key_i


def test_spans_and_counters_of_a_served_request():
    cfg = _luma_cfg()
    task, backbone = _luma(cfg)
    infer = tserve.build_inference_fn(task, backbone=backbone)
    with recording() as rec:
        infer(_views(4, 9))
    names = [s.name for s in rec.spans]
    assert names.count("serve.text_tower") == 1
    assert names.count("tower.attention") == 3 and names.count("tower.moe") == 2
    by_id = {s.id: s for s in rec.spans}
    tower = next(s for s in rec.spans if s.name == "serve.text_tower")
    assert by_id[tower.parent].name == "serve.backbone"
    assert rec.counters["tower.tokens"] == 4 * POSITIONS
    # the CPU runs the plain grouped product: no kernel launch
    assert rec.counters["kernels.moe_experts"] == 0


def test_export_refuses_the_tower():
    task, backbone = _luma(_luma_cfg())
    infer = tserve.build_inference_fn(task, backbone=backbone)
    with pytest.raises(NotImplementedError, match="TowerTextEncoder"):
        tserve.export_inference(infer, _views(2))


def test_the_tower_calls_no_fused_library_operator():
    # the expert product is the repository's kernel and attention stays
    # unfused: neither of PyTorch's fused operators is called
    import inspect

    for module in (text_tower, tmoe):
        source = inspect.getsource(module)
        for name in ("scaled_dot_product_attention", "_grouped_mm", "flash_attn"):
            assert name not in source, (module.__name__, name)


def test_the_kernel_source_defines_the_kernel_the_benchmark_reads_by_name():
    # csrc/moe_experts.cu is the expert product the card runs; the device
    # trace's readers find its launches by the kernel's name
    import re
    from pathlib import Path

    from port_bench import registry

    source = (Path(tmoe.__file__).resolve().parents[1] / "csrc"
              / f"{tmoe.KERNEL_SOURCE}.cu").read_text()
    assert re.search(rf"__global__ void __launch_bounds__\([^)]*\)\s+{tmoe.EXPERT_KERNEL}\(",
                     source)
    for metric in ("moe_experts_device_ms", "moe_experts_roofline_pct"):
        assert registry.module("metrics", metric).EXPERT_KERNEL == tmoe.EXPERT_KERNEL


def test_the_benchmark_reference_is_a_copy_of_the_reference():
    import inspect

    for name in ("yarn_get_mscale", "rope_inv_freq", "attention_scale", "rope_cos_sin",
                 "rms_norm", "apply_rope", "gated_mlp", "attention", "moe", "layer_weights",
                 "tower"):
        assert (inspect.getsource(getattr(bench_reference, name))
                == inspect.getsource(getattr(reference, name))), name


# ------------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1000, 128 * 128])
def test_expert_kernel_matches_its_plain_version_at_published_widths(card, t):
    # 1000 tokens: about 94 rows an expert, every tile ragged; 128 rows of
    # 128 tokens: the benchmark's request, about 1536 rows an expert
    g = torch.Generator(device=card).manual_seed(11)
    e, h, width, k = 64, 2048, 1408, 6

    def bf16(*shape, std=0.02):
        return torch.empty(shape, device=card, dtype=torch.bfloat16).normal_(0, std, generator=g)

    x, w_gate, w_up, w_down = bf16(t, h, std=1.0), bf16(e, width, h), bf16(e, width, h), bf16(
        e, h, width)
    weights, experts = tmoe.route(x, bf16(e, h), k)
    d = tmoe.dispatch(experts, e)
    before = counters()["kernels.moe_experts"]
    h_kernel = tmoe.grouped_product(x, w_gate, w_up, d, x.new_empty((t * k, width)),
                                    rows=d.token)
    h_plain = tmoe.grouped_product_plain(x, w_gate, w_up, d, x.new_empty((t * k, width)),
                                         rows=d.token)
    # both sum the same bf16 products in float32, in other orders, and round
    # silu(g) u to bf16 once: at most one bf16 step apart, which is 2^-8 to
    # 2^-7 of the value
    torch.testing.assert_close(h_kernel.float(), h_plain.float(), rtol=2 ** -7, atol=1e-5)
    scale = weights.reshape(-1)[d.order].contiguous()
    y_kernel = tmoe.grouped_product(h_kernel, w_down, None, d, torch.empty(
        t * k, h, device=card), dest=d.order, scale=scale)
    y_plain = tmoe.grouped_product_plain(h_kernel, w_down, None, d, torch.empty(
        t * k, h, device=card), dest=d.order, scale=scale)
    # float32 sums of 1408 bf16 products in other orders
    torch.testing.assert_close(y_kernel, y_plain, rtol=1e-4, atol=1e-6)
    torch.cuda.synchronize()
    assert counters()["kernels.moe_experts"] - before == 2


@pytest.mark.gpu
def test_graph_replay_equals_eager_bit_for_bit_at_published_widths(card):
    specs = (("AudioEncoder", dict(output_dim=200, dropout=0.1, input_dim=40, use_2d=False)),
             ("TowerTextEncoder", dict(output_dim=200, dropout=0.1)),
             ("ImageEncoder", dict(output_dim=200, dropout=0.1)))
    backbone = ttasks.build_dmvae_task(output_dim=[200] * 3, hidden_dim=512, embed_dim=200,
                                       fused_modalities=True, feature_encoders=specs,
                                       device=card)
    tower = backbone.feat_encs[1].tower
    assert tower.embed_tokens.weight.dtype == torch.bfloat16 and len(tower.layers) == 27
    task = ttasks.build_probe_task(num_modalities=3, num_classes=42, input_dim=200,
                                   hidden_dim=(128,), aggregation="cml", seed=1, device=card)
    infer = tserve.build_inference_fn(task, backbone=backbone)
    g = torch.Generator(device=card).manual_seed(12)
    xs = (torch.randn(8, 40, generator=g, device=card),
          torch.randint(0, 102400, (8, 128), generator=g, device=card),
          torch.randn(8, 3072, generator=g, device=card))
    eager = {k: v.clone() for k, v in infer(xs).items()}
    infer(xs)  # the capture
    before = counters()
    replayed = infer(xs)
    torch.cuda.synchronize()
    grown = counters(before)
    for key in eager:
        assert torch.equal(replayed[key], eager[key]), key
    assert grown["serve.graph_replays"] == 1
    assert grown["kernels.moe_experts"] == 2 * 26
    assert grown["tower.tokens"] == 8 * 128
    del infer, task, backbone, tower, eager, replayed
    gc.collect()
    torch.cuda.empty_cache()

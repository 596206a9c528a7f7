"""The port's serving slice against the JAX package's, end to end on the CPU.

``build_inference_fn`` of both packages runs on the same views with the JAX
init carried over by ``convert.py``. Tolerances: evidence and probs rtol
1e-4 / atol 1e-5, epistemic and aleatoric rtol 1e-4 / atol 1e-6, ``pred``
equal. XLA:CPU and torch sum dot products of up to 512 terms in another
order, and the saturated evidence reaches 2.2e4, so the relative error of
the float32 sums sets these bounds.

Also here: bucketing, the daemon and the HTTP front of the port, its runner,
its config and data copies, and that it never imports JAX; and the CPU side
of the inference function's CUDA graphs (``core/serve.py``: ``CudaGraphs``):
they do not engage on the CPU, under grad or in training mode, their key
and bounded cache, the export of a function that has them, and outputs that
are each call's own (the graphs on the card: ``test_torch_serve_graph.py``).
"""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.core import serve as jserve
from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu_torch.convert import load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core import serve as tserve
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.daemon import ServingDaemon
from disentagled_multimodal_fusion_tpu_torch.core.http_front import start_http_server
from disentagled_multimodal_fusion_tpu_torch.core.logging import counters
from disentagled_multimodal_fusion_tpu_torch.data.multiview import DATASET_REGISTRY

REPO_ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(dims=(12, 10, 7), hidden=32, embed=8, probe_hidden=(16,), num_classes=4)
HANDWRITTEN = dict(dims=(240, 76, 216, 47, 64, 6), hidden=512, embed=200,
                   probe_hidden=(128,), num_classes=10)


def _pair(name, dims, hidden, embed, probe_hidden, num_classes, fused_dmvae=True):
    """(JAX infer fn, port infer fn) for one served model, same weights."""
    if not name.startswith("dmvae_"):
        jtask = jtasks.build_late_fusion_task(
            rng=jax.random.PRNGKey(2), output_dims=dims, num_classes=num_classes,
            hidden_dim=probe_hidden, aggregation=name.split("_")[0],
        )
        ttask = ttasks.build_late_fusion_task(
            output_dims=dims, num_classes=num_classes, hidden_dim=probe_hidden,
            aggregation=name.split("_")[0], device="cpu",
        )
        load_flax_params(ttask.model, jax.device_get(jtask.params))
        return (jserve.build_inference_fn(jtask, jtask.params),
                tserve.build_inference_fn(ttask))

    jbb, jbb_params, *_ = jtasks.build_dmvae_task(
        rng=jax.random.PRNGKey(0), xs_sample=[jnp.zeros((2, d)) for d in dims],
        output_dim=dims, hidden_dim=hidden, embed_dim=embed, fused_modalities=fused_dmvae,
    )
    tbb = ttasks.build_dmvae_task(output_dim=dims, hidden_dim=hidden, embed_dim=embed,
                                  fused_modalities=fused_dmvae, device="cpu")
    load_flax_params(tbb, jax.device_get(jbb_params))
    kw = dict(num_modalities=len(dims), num_classes=num_classes, input_dim=embed,
              hidden_dim=probe_hidden)
    if name == "dmvae_dis":
        jtask = jtasks.build_disentangled_probe_task(rng=jax.random.PRNGKey(1), **kw)
        ttask = ttasks.build_disentangled_probe_task(**kw, device="cpu")
    else:
        agg = name.split("_")[1]
        jtask = jtasks.build_probe_task(rng=jax.random.PRNGKey(1), aggregation=agg, **kw)
        ttask = ttasks.build_probe_task(aggregation=agg, **kw, device="cpu")
    load_flax_params(ttask.model, jax.device_get(jtask.params))
    return (jserve.build_inference_fn(jtask, jtask.params, backbone=jbb, backbone_params=jbb_params),
            tserve.build_inference_fn(ttask, backbone=tbb))


def _assert_outputs_match(port, ref):
    port = tserve.to_host(port)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert set(port) == set(ref)
    for k in port:
        assert port[k].shape == ref[k].shape, k
    np.testing.assert_array_equal(port["pred"], ref["pred"])
    for k in ("evidence", "fused_evidence", "probs"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("epistemic", "aleatoric"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


def _views(rows, dims, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.random((rows, d), dtype=np.float32) for d in dims)


@pytest.mark.parametrize("name,fused_dmvae", [
    ("dmvae_cml", True), ("dmvae_joint", True), ("dmvae_dis", True), ("dmvae_cml", False),
    ("cml_fusion", True), ("dbf_fusion", True),
])
def test_inference_matches_jax(name, fused_dmvae):
    jinfer, tinfer = _pair(name, fused_dmvae=fused_dmvae, **SMALL)
    xs = _views(16, SMALL["dims"])
    _assert_outputs_match(tinfer(xs), jinfer(tuple(jnp.asarray(x) for x in xs)))


def test_inference_matches_jax_at_full_handwritten_width():
    views, _ = DATASET_REGISTRY["HandWritten"]().arrays()
    xs = tuple(v[:64] for v in views)
    jinfer, tinfer = _pair("dmvae_cml", **HANDWRITTEN)
    _assert_outputs_match(tinfer(xs), jinfer(tuple(jnp.asarray(x) for x in xs)))


GRAPH_CALLS = ("serve.eager_calls", "serve.graph_captures", "serve.graph_replays")


def _port_infer():
    """The port's dmvae_cml inference function at SMALL's widths, on the CPU."""
    backbone = ttasks.build_dmvae_task(output_dim=SMALL["dims"], hidden_dim=SMALL["hidden"],
                                       embed_dim=SMALL["embed"], fused_modalities=True,
                                       device="cpu")
    task = ttasks.build_probe_task(num_modalities=len(SMALL["dims"]),
                                   num_classes=SMALL["num_classes"], input_dim=SMALL["embed"],
                                   hidden_dim=SMALL["probe_hidden"], aggregation="cml",
                                   device="cpu")
    return tserve.build_inference_fn(task, backbone=backbone)


@pytest.mark.parametrize("how", ["cpu", "grad", "training"])
def test_graphs_do_not_engage_on_the_cpu_under_grad_or_in_training(how):
    infer, xs = _port_infer(), _views(8, SMALL["dims"])
    if how == "training":
        infer.module.backbone.train()
    since = counters()
    with torch.enable_grad() if how == "grad" else torch.no_grad():
        outs = [infer(xs) for _ in range(4)]
    grew = counters(since)
    assert {k: grew[k] for k in GRAPH_CALLS} == {
        "serve.eager_calls": 4, "serve.graph_captures": 0, "serve.graph_replays": 0}
    assert not infer.graphs.graphs and not infer.graphs.seen
    assert not any(t.requires_grad for out in outs for t in out.values())


class _OnCard:
    """A stand-in for a view on the card: what ``CudaGraphs.engages`` reads."""

    is_cuda = True


def test_graphs_engage_on_the_card_only_in_eval_mode_outside_a_capture(monkeypatch):
    infer = _port_infer()
    graphs, card = infer.graphs, (_OnCard(), _OnCard(), _OnCard())
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    assert not infer.module.training
    assert graphs.engages(card)
    assert not graphs.engages((_OnCard(), torch.zeros(2, 3), _OnCard()))
    for sub in (infer.module, infer.module.backbone, infer.module.model):
        sub.train()
        assert not graphs.engages(card), type(sub).__name__
        infer.module.eval()
    assert graphs.engages(card)
    capturing[0] = True
    assert not graphs.engages(card)


def test_graph_key_tells_shapes_dtypes_and_devices_apart():
    a = (torch.zeros(4, 3), torch.zeros(4, 5))
    assert tserve.graph_key(a) == tserve.graph_key((torch.ones(4, 3), torch.ones(4, 5)))
    assert tserve.graph_key(a) == (((4, 3), torch.float32), ((4, 5), torch.float32),
                                   torch.device("cpu"))
    for other in [(torch.zeros(8, 3), torch.zeros(8, 5)), (torch.zeros(4, 3),),
                  (torch.zeros(4, 3), torch.zeros(4, 5, dtype=torch.float64)),
                  (torch.zeros(4, 5), torch.zeros(4, 3))]:
        assert tserve.graph_key(other) != tserve.graph_key(a)


def test_the_graph_cache_captures_on_a_second_call_and_evicts_the_least_recent(monkeypatch):
    assert tserve.GRAPH_SHAPES >= len(tserve.DEFAULT_BUCKETS)
    monkeypatch.setattr(tserve, "GRAPH_SHAPES", 3)
    cache = tserve.CudaGraphs(torch.nn.Linear(2, 2))

    def call(key):
        what = cache.step(key)
        if what == "capture":
            cache.keep(key, f"graph {key}")
        return what

    assert [call(k) for k in "aab"] == ["eager", "capture", "eager"]
    assert [call(k) for k in "aba"] == ["replay", "capture", "replay"]
    assert list(cache.graphs) == ["b", "a"]            # most recent last
    assert [call(k) for k in "cc"] == ["eager", "capture"]
    assert [call(k) for k in "dd"] == ["eager", "capture"]
    assert list(cache.graphs) == ["a", "c", "d"]       # b, least recent, went
    assert [call(k) for k in "bb"] == ["eager", "capture"]
    assert list(cache.graphs) == ["c", "d", "b"]
    # keys seen once are bounded too, and do not push graphs out
    assert [call(k) for k in "wxyz"] == ["eager"] * 4
    assert [k for k, _ in cache.seen] == ["x", "y", "z"]
    assert list(cache.graphs) == ["c", "d", "b"]
    assert call("w") == "eager"
    # a capture waits for a second call on one thread (a thread's first call
    # makes its library handles); a graph replays on any thread
    other = []
    worker = threading.Thread(target=lambda: other.extend(call(k) for k in "xxb"))
    worker.start()
    worker.join(10)
    assert not worker.is_alive()
    assert other == ["eager", "capture", "replay"]
    assert call("w") == "capture"


def test_export_of_a_function_with_graphs_holds_one_head_operator_call(tmp_path):
    infer, xs = _port_infer(), _views(8, SMALL["dims"])
    for _ in range(3):
        infer(xs)
    exported = tserve.export_inference(infer, xs, tmp_path / "b8.pt2")
    assert tserve.head_op_calls(exported) == 1
    assert not infer.graphs.graphs
    np.testing.assert_array_equal(
        tserve.to_host(tserve.load_exported(tmp_path / "b8.pt2")(xs))["pred"],
        tserve.to_host(infer(xs))["pred"])


def test_the_outputs_of_two_calls_are_each_their_own():
    infer = _port_infer()
    a, b = _views(8, SMALL["dims"], seed=1), _views(8, SMALL["dims"], seed=2)
    want = tserve.to_host(infer(a))
    first, second = infer(a), infer(b)
    for k in first:
        assert first[k] is not second[k]
        assert first[k].data_ptr() != second[k].data_ptr()
        np.testing.assert_array_equal(first[k].numpy(), want[k], err_msg=k)
    assert not np.array_equal(first["probs"].numpy(), second["probs"].numpy())


@pytest.fixture(scope="module")
def small_engine():
    _, tinfer = _pair("dmvae_cml", **SMALL)
    return tinfer, tserve.ServingEngine(tinfer, buckets=(4, 8))


def test_bucketing_matches_exact_batch(small_engine):
    infer, engine = small_engine
    for rows in (1, 5, 8, 19):  # under, at and past the top bucket
        xs = _views(rows, SMALL["dims"], seed=rows)
        out, direct = engine(xs), tserve.to_host(infer(xs))
        for k in direct:
            assert out[k].shape[0] == rows, k
            np.testing.assert_allclose(out[k], direct[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_daemon_answers_concurrent_requests(small_engine):
    _, engine = small_engine
    errors = []

    def client(cid):
        try:
            rng = np.random.default_rng(cid)
            for _ in range(5):
                xs = _views(int(rng.integers(1, 7)), SMALL["dims"], seed=int(rng.integers(1 << 30)))
                got, want = daemon.infer(xs), engine(xs)
                np.testing.assert_array_equal(got["pred"], want["pred"])
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    with ServingDaemon(engine, max_delay_ms=2.0) as daemon:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert daemon.stats()["requests"] == 20
    assert not errors, errors


def _toy_engine(delay=0.0):
    import time

    def fn(xs):
        time.sleep(delay)
        x = np.asarray(xs[0])
        return {"y": x * 2.0, "rows": x.sum(1)}  # an output that is named "rows"

    return tserve.ServingEngine(fn, buckets=(8, 16))


def test_daemon_done_callback_may_call_back_into_the_daemon():
    """Futures resolve outside the daemon's lock: a done-callback that runs
    on the dispatcher thread and calls stats()/submit() must not deadlock."""
    with ServingDaemon(_toy_engine(delay=0.05), max_delay_ms=0.0) as d:
        inner = []
        first = d.submit((np.ones((2, 3), np.float32),))
        first.add_done_callback(lambda f: inner.append((d.stats(), d.submit((np.ones((1, 3)),)))))
        first.result(timeout=10)
        for _ in range(100):
            if inner:
                break
            threading.Event().wait(0.05)
        assert inner and inner[0][1].result(timeout=10)["y"].shape == (1, 3)


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_front_namespaces_outputs_and_reports_errors():
    with ServingDaemon(_toy_engine(), max_delay_ms=1.0) as daemon:
        server, port = start_http_server(daemon)
        try:
            x = np.random.default_rng(0).standard_normal((5, 6)).astype(np.float32)
            status, resp = _http(port, "/v1/infer", {"views": [x.tolist()]})
            assert status == 200 and resp["rows"] == 5
            np.testing.assert_allclose(resp["outputs"]["y"], x * 2.0, rtol=1e-6)
            np.testing.assert_allclose(resp["outputs"]["rows"], x.sum(1), rtol=1e-5)
            status, resp = _http(port, "/v1/infer", {"views": [x.tolist()], "fields": ["y"]})
            assert status == 200 and set(resp["outputs"]) == {"y"}
            assert _http(port, "/v1/infer", {"views": [x.tolist()], "fields": ["nope"]})[0] == 400
            assert _http(port, "/v1/infer", {"views": [[1.0, 2.0]]})[0] == 400
            assert _http(port, "/v1/infer", {"views": [[[1.0]], [[1.0], [2.0]]]})[0] == 400
            assert _http(port, "/v1/nope", {"views": [x.tolist()]})[0] == 404
            assert _http(port, "/healthz") == (200, {"ok": True})
            status, st = _http(port, "/v1/stats")
            assert status == 200 and st["requests"] >= 2 and st["buckets"] == [8, 16]
        finally:
            server.shutdown()
            server.server_close()


@pytest.mark.parametrize("extra", [
    ["--model", "dmvae_cml", "--daemon", "--daemon-seconds", "0.3", "--daemon-clients", "2"],
    ["--model", "dmvae_dis", "--no-fused-dmvae"],
    ["--model", "cml_fusion"],
])
def test_runner_serves_handwritten_on_cpu(extra):
    from disentagled_multimodal_fusion_tpu_torch.runners import serve as runner

    report = runner.main([*extra, "--dataset", "HandWritten", "--device", "cpu",
                          "--random-init", "--buckets", "1", "8", "--reps", "2"])
    assert [r["bucket"] for r in report["buckets"]] == [1, 8]
    assert all(r["num_outputs"] == 6 for r in report["buckets"])
    assert report["backend"] == "cpu"
    if "--daemon" in extra:
        assert report["daemon"]["requests"] > 0


def test_runner_refuses_to_run_without_random_init(tmp_path, monkeypatch):
    """Without --random-init the runner serves a checkpoint, and stops,
    naming the missing file, when there is none."""
    from disentagled_multimodal_fusion_tpu_torch.runners import serve as runner

    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    missing = tmp_path / "checkpoints" / "cml_fusion_fusion_dsHandWritten_seed0.pt"
    with pytest.raises(SystemExit, match=f"no checkpoint at {missing}.*--random-init"):
        runner.main(["--model", "cml_fusion", "--dataset", "HandWritten", "--device", "cpu"])


def test_entry_points_without_a_device_need_cuda(monkeypatch):
    from disentagled_multimodal_fusion_tpu_torch.runners import serve as runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttasks.build_late_fusion_task(output_dims=(3, 4), num_classes=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(["--model", "cml_fusion", "--dataset", "HandWritten", "--random-init"])


def test_port_config_copy_matches_the_yaml():
    import yaml

    from disentagled_multimodal_fusion_tpu_torch.configs.config import CONFIG

    path = REPO_ROOT / "disentagled_multimodal_fusion_tpu" / "configs" / "config.yaml"
    full = yaml.safe_load(path.read_text())
    assert CONFIG == {k: full[k] for k in CONFIG}


def test_port_data_loader_matches_jax_package():
    from disentagled_multimodal_fusion_tpu.data.multiview import DATASET_REGISTRY as JAX_REGISTRY

    port, ref = DATASET_REGISTRY["HandWritten"](), JAX_REGISTRY["HandWritten"]()
    assert port.num_classes == ref.num_classes == 10
    np.testing.assert_array_equal(port.dims, ref.dims)
    np.testing.assert_array_equal(port.Y, ref.Y)
    for a, b in zip(port.X, ref.X):
        np.testing.assert_array_equal(a, b)


def test_port_never_imports_jax():
    """Import every module of the port, and chip_smoke.py, in a fresh
    interpreter: neither jax nor the JAX package may be loaded."""
    script = """
import importlib, pkgutil, sys
import disentagled_multimodal_fusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
jaxy = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "disentagled_multimodal_fusion_tpu"
        or m.startswith("disentagled_multimodal_fusion_tpu.")]
assert not jaxy, jaxy
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20

"""The port's serving artifacts (``torch.export``) against direct calls and
against the JAX package's ``jax.export`` artifacts, on the CPU.

* ``export_inference`` -> ``load_exported`` gives the direct call's six
  outputs (rtol 1e-5 / atol 1e-6, the JAX package's tests/test_serve.py
  tolerance for its own round trip) for a probe over the FusedDMVAE, the
  disentangled probe over the per-modality DMVAE and a late fusion; each
  exported graph holds exactly one call of the head kernel's operator
  ``dmf::evidential_heads``.
* The artifact replays in a fresh interpreter that loads only
  ``ops/head_op.py`` by path (the operator's CPU implementation is its
  plain version, so a CPU artifact needs no kernel library) and never
  imports a module of either package.
* ``runners/serve.py --export-dir`` writes one ``.pt2`` per bucket under the
  JAX package's names, the operator's file beside them, and lists them in
  its report.
* The port's artifact and the JAX package's ``export_inference`` /
  ``load_exported`` artifact, on the same weights carried over by
  ``convert.py``, give the same outputs (float32 on both sides, rtol 1e-5
  / atol 1e-6; ``pred`` equal).
* ``ServingEngine.warmup(buckets=)`` runs only the buckets it names.
"""

import json
import subprocess
import sys
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
from disentagled_multimodal_fusion_tpu_torch.ops import head_op

TOL = dict(rtol=1e-5, atol=1e-6)
DIMS = (12, 10, 7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs this file beside other test
    processes, as tests/test_torch_luma.py does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _views(rows, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.random((rows, d), dtype=np.float32) for d in DIMS)


def _port_infer(name, fused_dmvae=True):
    if name.endswith("_fusion"):
        task = ttasks.build_late_fusion_task(output_dims=DIMS, num_classes=4, hidden_dim=(16,),
                                             aggregation=name.split("_")[0], seed=2,
                                             device="cpu")
        return tserve.build_inference_fn(task)
    backbone = ttasks.build_dmvae_task(output_dim=DIMS, hidden_dim=32, embed_dim=8,
                                       fused_modalities=fused_dmvae, device="cpu")
    kw = dict(num_modalities=len(DIMS), num_classes=4, input_dim=8, hidden_dim=(16,), seed=1,
              device="cpu")
    task = (ttasks.build_disentangled_probe_task(**kw) if name == "dmvae_dis"
            else ttasks.build_probe_task(aggregation=name.split("_")[1], **kw))
    return tserve.build_inference_fn(task, backbone=backbone)


def _assert_same(got, ref):
    got, ref = tserve.to_host(got), tserve.to_host(ref)
    assert set(got) == set(ref) == {"pred", "probs", "evidence", "fused_evidence", "epistemic",
                                    "aleatoric"}
    np.testing.assert_array_equal(got["pred"], ref["pred"])
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name,fused_dmvae", [("dmvae_cml", True), ("dmvae_dis", False),
                                              ("cml_fusion", True)])
def test_export_roundtrip(tmp_path, name, fused_dmvae):
    infer = _port_infer(name, fused_dmvae)
    xs = _views(8)
    path = tmp_path / f"{name}_b8.pt2"
    exported = tserve.export_inference(infer, xs, path)
    assert tserve.head_op_calls(exported) == 1
    # the live model keeps its gradients; the artifact's weights are frozen
    assert all(p.requires_grad for p in infer.module.parameters())
    _assert_same(tserve.load_exported(path)(xs), infer(xs))


def test_export_replays_without_package(tmp_path):
    """The ``.pt2`` replays in an interpreter that never imports either
    package: torch and the operator's file alone."""
    infer = _port_infer("dmvae_cml")
    xs = _views(4, seed=1)
    art = tmp_path / "dmvae_cml_b4.pt2"
    tserve.export_inference(infer, xs, art)
    direct = tserve.to_host(infer(xs))
    np.savez(tmp_path / "io.npz", *xs, fused=direct["fused_evidence"], probs=direct["probs"])
    script = f"""
import importlib.util, sys
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("dmf_head_op", {head_op.__file__!r})
op = importlib.util.module_from_spec(spec)
spec.loader.exec_module(op)
io = np.load({str(tmp_path / "io.npz")!r})
xs = tuple(torch.from_numpy(io[f"arr_{{i}}"]) for i in range({len(xs)}))
out = torch.export.load({str(art)!r}).module()(xs)
np.testing.assert_allclose(out["fused_evidence"].detach().numpy(), io["fused"], rtol=1e-5, atol=1e-6)
np.testing.assert_allclose(out["probs"].detach().numpy(), io["probs"], rtol=1e-5, atol=1e-6)
bad = [m for m in sys.modules if "disentagled" in m]
assert not bad, f"a package module was loaded by the replay: {{bad}}"
print("REPLAY_OK")
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "REPLAY_OK" in proc.stdout


def test_serve_export_dir_writes_one_artifact_per_bucket(tmp_path):
    from disentagled_multimodal_fusion_tpu_torch.runners import serve as runner

    out = tmp_path / "exported"
    report = runner.main(["--model", "cml_fusion", "--dataset", "HandWritten", "--device", "cpu",
                          "--random-init", "--buckets", "1", "8", "--reps", "1",
                          "--export-dir", str(out)])
    names = ["cml_fusion_HandWritten_seed0_b1.pt2", "cml_fusion_HandWritten_seed0_b8.pt2",
             "dmf_head_op.py"]
    assert [Path(p).name for p in report["exported"]] == names
    assert sorted(p.name for p in out.iterdir()) == sorted(names)
    json.dumps(report)  # the report stays printable
    program = tserve.load_exported(out / names[1])
    views = tuple(np.random.default_rng(0).random((8, d), dtype=np.float32)
                  for d in (240, 76, 216, 47, 64, 6))
    assert program(views)["evidence"].shape == (8, 6, 10)


def _jax_pair():
    """(JAX infer fn, port infer fn) of dmvae_cml on the same weights."""
    jbb, jbb_params, *_ = jtasks.build_dmvae_task(
        rng=jax.random.PRNGKey(0), xs_sample=[jnp.zeros((2, d)) for d in DIMS],
        output_dim=DIMS, hidden_dim=32, embed_dim=8, fused_modalities=True)
    jtask = jtasks.build_probe_task(rng=jax.random.PRNGKey(1), num_modalities=len(DIMS),
                                    num_classes=4, input_dim=8, hidden_dim=(16,),
                                    aggregation="cml")
    tbb = ttasks.build_dmvae_task(output_dim=DIMS, hidden_dim=32, embed_dim=8,
                                  fused_modalities=True, device="cpu")
    load_flax_params(tbb, jax.device_get(jbb_params))
    ttask = ttasks.build_probe_task(num_modalities=len(DIMS), num_classes=4, input_dim=8,
                                    hidden_dim=(16,), aggregation="cml", device="cpu")
    load_flax_params(ttask.model, jax.device_get(jtask.params))
    return (jserve.build_inference_fn(jtask, jtask.params, backbone=jbb, backbone_params=jbb_params),
            tserve.build_inference_fn(ttask, backbone=tbb))


def test_port_artifact_matches_jax_artifact(tmp_path):
    jinfer, tinfer = _jax_pair()
    xs = _views(8, seed=2)
    jserve.export_inference(jinfer, tuple(jnp.asarray(x) for x in xs),
                            str(tmp_path / "jax_b8.stablehlo"))
    tserve.export_inference(tinfer, xs, tmp_path / "port_b8.pt2")
    ref = jserve.load_exported(str(tmp_path / "jax_b8.stablehlo"))(xs)
    got = tserve.load_exported(tmp_path / "port_b8.pt2")(xs)
    _assert_same(got, {k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()})


def test_warmup_runs_only_the_named_buckets():
    calls = []

    def fn(xs):
        calls.append(int(xs[0].shape[0]))
        return {"x": torch.from_numpy(np.asarray(xs[0]))}

    engine = tserve.ServingEngine(fn, buckets=(1, 8, 64))
    xs = _views(3)
    engine.warmup(xs, buckets=(8,))
    assert calls == [8]
    engine.warmup(xs)
    assert calls == [8, 1, 8, 64]

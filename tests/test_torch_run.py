"""The port's training runner, evaluation and data perturbations against the
JAX package's.

* ``_eval_all``/``format_eval_result`` on the same evidences: the same nested
  dict, values within 1e-6;
* ``postprocessing``: the same split indices and perturbed views as JAX for
  the same ``np.random.seed``, bit for bit;
* a whole ``run_condition`` on the CPU at tiny widths: it finishes, and its
  report columns equal those the JAX flatteners give for the same rows;
* the CLI on the CPU (quick CUB cell, report files), its refusal of the
  options it does not have, and the port's imports.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.eval import analysis as janalysis
from disentagled_multimodal_fusion_tpu_torch.eval import analysis as tanalysis

REPO_ROOT = Path(__file__).resolve().parent.parent


def _assert_same_tree(port, ref, path=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _assert_same_tree(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same_tree(a, b, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("has_shared", [True, False])
def test_evaluation_matches_jax(has_shared):
    rng = np.random.default_rng(0)
    n, v, c = 160, 3, 5  # 160 rows: 0.15 * 160 sits on an integer (risk-coverage)
    ev = np.exp(rng.standard_normal((n, v, c)) * 2.0).astype(np.float32)
    ev[:3] = 0.0
    y = rng.integers(0, c, n)
    y[y == 4] = 3  # class 4 never occurs: its true-class mean divides by 0 counts
    fused = ev.sum(axis=1)
    ref = janalysis.evaluate_evidences(jnp.asarray(ev), jnp.asarray(fused), jnp.asarray(y), c,
                                       has_shared)
    port = tanalysis.evaluate_evidences(torch.from_numpy(ev), torch.from_numpy(fused),
                                        torch.from_numpy(y), c, has_shared)
    _assert_same_tree(port, ref)
    row = dict(seed=0, typ="Normal", ds="X", model="m")
    ref_row = janalysis.flatten_sample_info_datasets(ref, **row)
    assert tanalysis.flatten_sample_info_datasets(port, **row) == pytest.approx(
        ref_row, rel=1e-6, abs=1e-6)


def test_postprocessing_matches_jax_bit_for_bit():
    from disentagled_multimodal_fusion_tpu.data.multiview import DATASET_REGISTRY as JAX_REGISTRY
    from disentagled_multimodal_fusion_tpu_torch.data.multiview import DATASET_REGISTRY

    out = []
    for registry in (JAX_REGISTRY, DATASET_REGISTRY):
        np.random.seed(3)
        ds = registry["HandWritten"]()
        idx = np.arange(len(ds))
        np.random.shuffle(idx)
        test_idx = idx[1600:]
        ds.postprocessing(test_idx, addNoise=True, sigma=0.5, ratio_noise=0.5,
                          addConflict=True, ratio_conflict=0.5)
        out.append((idx, ds.X))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


def _tiny_config():
    """The config at tiny widths: DMVAE hidden 16, embed 8, probe heads 8 -> 8."""
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

    cfg = load_config()
    cfg["dmvae"].update(hidden_dim=16, embed_dim=8, num_epochs=2)
    cfg["probes"].update(input_dim=8, model_hidden_dim=[8], model_epochs=2)
    return make_getter(cfg)


@pytest.mark.parametrize("engine,conflict", [("megakernel", False), ("step", True)])
def test_run_condition_tiny_matches_the_jax_report_columns(engine, conflict):
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    rows = {}
    runner.run_condition(C=_tiny_config(), seed=0, dataset_name="CUB", conflict=conflict,
                         quick=False, device=torch.device("cpu"), rows_out=rows,
                         probe_engine=engine)
    assert list(rows) == ["dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion",
                          "avg_fusion"]
    for info in rows.values():
        assert 0.0 <= info["fused"]["accuracy"] <= 1.0
        assert Path(info["path"]).exists()
    nested = {0: {"Conflict" if conflict else "Normal": {"CUB": rows}}}
    columns, _ = tanalysis.build_metrics_rows_datasets(nested)
    assert columns == list(janalysis.build_metrics_dataframe_datasets(nested).columns)


def test_cli_trains_a_quick_cell_on_the_cpu_and_writes_the_report(monkeypatch):
    from disentagled_multimodal_fusion_tpu_torch.core.artifacts import artifact_path
    from disentagled_multimodal_fusion_tpu_torch.runners import common
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner
    from disentagled_multimodal_fusion_tpu_torch.utils.xlsx import read_xlsx

    tiny = _tiny_config()
    monkeypatch.setattr(common, "make_getter", lambda cfg: tiny)
    rows = runner.main(["--quick", "--seeds", "0", "--datasets", "CUB", "--conditions", "Normal",
                        "--device", "cpu", "--probe-engine", "megakernel"])
    assert len(rows[0]["Normal"]["CUB"]) == 6
    report = artifact_path("logs/dataset_analysis.xlsx")
    sheets = read_xlsx(report)
    assert list(sheets) == ["main_grouped", "all_results", "grouped_results"]
    assert len(sheets["all_results"]) == 7  # header + six models
    for sheet in sheets:
        assert report.with_name(f"dataset_analysis_{sheet}.csv").exists()
    log = artifact_path("logs/cml_fusion_fusion_dsCUB_seed0/metrics.csv")
    assert log.read_text().splitlines()[0] == "epoch,train_loss,val_loss,val_acc"


@pytest.mark.parametrize("flags", [
    ["--vmap-seeds"], ["--one-program-cells"], ["--backbone", "dssl"], ["--dtype", "bfloat16"],
    ["--rows-file", "rows.json"], ["--profile"], ["--intermediate-fusion", "lrtf"],
    ["--data-parallel", "2"],
])
def test_cli_refuses_what_is_not_ported(flags):
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    with pytest.raises(SystemExit):
        runner.parse_args(["--device", "cpu", *flags])


def test_cell_seed_matches_jax():
    from disentagled_multimodal_fusion_tpu.runners.common import cell_seed as jseed
    from disentagled_multimodal_fusion_tpu_torch.runners.common import cell_seed

    for args in [(0, "HandWritten", False), (3, "CUB", True), (4, "Scene", False)]:
        assert cell_seed(*args) == jseed(*args)


def test_port_imports_no_jax_flax_optax_or_pandas():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter:
    none of jax, flax, optax, pandas or the JAX package gets loaded."""
    script = """
import importlib, pkgutil, sys
import disentagled_multimodal_fusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
banned = ("jax", "flax", "optax", "pandas", "disentagled_multimodal_fusion_tpu")
loaded = [m for m in sys.modules if m in banned or m.split(".")[0] in banned]
assert not loaded, loaded
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30

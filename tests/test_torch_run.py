"""The port's training runner, evaluation and data perturbations against the
JAX package's.

* ``_eval_all``/``format_eval_result`` on the same evidences: the same nested
  dict, values within 1e-6;
* ``postprocessing``: the same split indices and perturbed views as JAX for
  the same ``np.random.seed``, bit for bit;
* a whole ``run_condition`` on the CPU at tiny widths: it finishes, and its
  report columns equal those the JAX flatteners give for the same rows;
* the CLI on the CPU (quick CUB cell, report files), its refusal of the
  options it does not have, and the port's imports;
* the intermediate fusions in the seed-batched engines (skip rows per seed,
  ``--one-program-cells`` equal to ``--vmap-seeds``, each seed equal to its
  sequential replay from the same generators), ``--rows-file`` (a sweep
  that fails in its second cell leaves the first, and the rerun fits only
  the second and writes the report an uninterrupted sweep writes, in all
  three engines), ``--profile`` (a trace, also from a sweep that raises)
  and the UQ figures (with and without matplotlib);
* the seed-batched engines: ``--one-program-cells`` rows equal
  ``--vmap-seeds`` rows bit for bit, a ``--vmap-seeds`` cell equals its
  per-seed replay by the sequential trainer from the same generators, and
  the fold seeds never meet the sequential slots.
"""

import contextlib
import json
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


def _assert_same_tree(port, ref, path="", rtol=1e-6):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _assert_same_tree(port[k], ref[k], f"{path}/{k}", rtol)
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same_tree(a, b, f"{path}[{i}]", rtol)
    else:
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=1e-6, err_msg=path)


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
    ["--backbone", "dssl", "--vmap-seeds"], ["--dtype", "float16"],
    ["--intermediate-fusion", "lrtf", "nope"], ["--data-parallel", "2"],
])
def test_cli_refuses_what_is_not_ported(flags):
    """Among them a compute type other than float32 and bfloat16 (bfloat16
    runs: tests/test_torch_bf16_runs.py)."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    with pytest.raises(SystemExit):
        runner.parse_args(["--device", "cpu", *flags])


@pytest.mark.parametrize("engine", ["--vmap-seeds", "--one-program-cells"])
def test_cli_refuses_the_epoch_kernel_with_a_seed_batched_engine(engine):
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    assert getattr(runner.parse_args([engine]), engine[2:].replace("-", "_"))
    with pytest.raises(SystemExit):
        runner.parse_args([engine, "--probe-engine", "megakernel"])


def test_force_vmap_seeds_is_accepted_and_never_falls_back(monkeypatch):
    from disentagled_multimodal_fusion_tpu_torch.runners import common
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    def sequential(**kw):
        raise AssertionError("--vmap-seeds fell back to the sequential engine")

    tiny = _tiny_config()
    monkeypatch.setattr(common, "make_getter", lambda cfg: tiny)
    monkeypatch.setattr(runner, "run_condition", sequential)
    rows = runner.main(["--vmap-seeds", "--force-vmap-seeds", "--quick", "--seeds", "0", "1",
                        "--datasets", "CUB", "--conditions", "Normal", "--device", "cpu",
                        "--skip-report"])
    assert [len(rows[s]["Normal"]["CUB"]) for s in (0, 1)] == [6, 6]


def test_a_failing_cell_still_waits_for_the_previous_cells_artifacts(monkeypatch):
    """--one-program-cells writes a cell's artifacts on a thread while the
    next cell runs; if that cell raises, the writes still finish first."""
    import time

    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    issued, written = [], []

    def onejit(*, dataset_name, defer_artifacts, **kw):
        assert defer_artifacts
        issued.append(dataset_name)
        if len(issued) == 2:
            raise RuntimeError("the second cell failed")

        def finish():
            time.sleep(0.2)
            written.append(dataset_name)

        return finish

    monkeypatch.setattr(runner, "run_condition_onejit", onejit)
    with pytest.raises(RuntimeError, match="second cell"):
        runner.main(["--one-program-cells", "--seeds", "0", "--datasets", "CUB", "PIE",
                     "--conditions", "Normal", "--device", "cpu", "--skip-report"])
    assert written == ["CUB"]


def test_fold_seeds_never_meet_the_sequential_slots():
    """A CPU generator keeps a seed's low 32 bits: the seed-batched engines'
    fold seeds and the sequential engine's slots must differ there."""
    from disentagled_multimodal_fusion_tpu_torch.runners.common import (
        MAX_FOLD_CELL,
        cell_seed,
        fold_seed,
    )

    cells = [cell_seed(s, ds, c) for s in range(8) for ds in ("CUB", "HandWritten", "PIE", "Scene")
             for c in (False, True)]
    slots = {(c * 16 + k) % 2**32 for c in cells + [MAX_FOLD_CELL - 1] for k in range(16)}
    folds = {fold_seed(c, i) % 2**32 for c in cells + [MAX_FOLD_CELL - 1]
             for i in [0, 1, *range(10, 16), *range(100, 106)]}
    assert not slots & folds
    assert len(folds) == (len(cells) + 1) * 14  # no two fold indices share a seed
    for bad in ((MAX_FOLD_CELL, 0), (-1, 0), (0, 256)):
        with pytest.raises(ValueError):
            fold_seed(*bad)


def _strip(info):
    return {k: v for k, v in info.items() if k not in ("path", "fit_seconds",
                                                        "backbone_fit_seconds")}


@pytest.fixture(scope="module")
def seed_batched_rows():
    """A tiny Conflict cell on CUB, seeds 0 and 1, through both seed-batched
    engines."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    out = {}
    for engine in (runner.run_condition_vmapped, runner.run_condition_onejit):
        rows = {0: {}, 1: {}}
        engine(C=_tiny_config(), seeds=[0, 1], dataset_name="CUB", conflict=True, quick=False,
               device=torch.device("cpu"), rows_by_seed=rows)
        out[engine.__name__] = rows
    return out


def test_one_program_rows_equal_vmapped_rows_bit_for_bit(seed_batched_rows):
    vmapped, onejit = (seed_batched_rows[k] for k in ("run_condition_vmapped",
                                                       "run_condition_onejit"))
    for seed in (0, 1):
        assert list(onejit[seed]) == list(vmapped[seed]) == [
            "dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion"]
        for name, info in vmapped[seed].items():
            assert _strip(onejit[seed][name]) == _strip(info), name
            assert Path(info["path"]).exists()


def test_seed_batched_cell_equals_its_per_seed_sequential_replay(seed_batched_rows):
    """Each seed of the --vmap-seeds cell, replayed by the sequential
    trainer from the same fold-index generators, gives the same rows
    (rtol 1e-6)."""
    from disentagled_multimodal_fusion_tpu_torch.core.tasks import dmvae_objective, embed_dataset
    from disentagled_multimodal_fusion_tpu_torch.core.train import Randomness, train
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner
    from disentagled_multimodal_fusion_tpu_torch.runners.common import cell_seed, fold_seed

    C, cpu = _tiny_config(), torch.device("cpu")
    st = runner.cell_settings(C, "CUB", False)
    for seed in (0, 1):
        views, labels, tr, te, dims, num_classes = runner.split_cell(C, seed, "CUB", True, False)
        xs_tr, xs_te = (tuple(torch.from_numpy(v[rows]) for v in views) for rows in (tr, te))
        y_tr, y_te = torch.from_numpy(labels[tr]), torch.from_numpy(labels[te])
        c = cell_seed(seed, "CUB", True)
        backbone = runner.build_backbone(st, dims, fold_seed(c, 0), cpu)
        loss_fn, opt = dmvae_objective(backbone, lr=st.dmvae_lr, num_epochs=st.dmvae_epochs)
        train(model=backbone, loss_fn=loss_fn, data={"xs": xs_tr}, n_train=len(tr),
              optimizer=opt, epochs=st.dmvae_epochs, batch_size=st.batch_size,
              randomness=Randomness(fold_seed(c, 1), cpu))
        (zc_tr, zp_tr), (zc_te, zp_te) = embed_dataset(backbone, xs_tr), embed_dataset(backbone,
                                                                                       xs_te)
        data = {"probe": ({"zc": zc_tr, "zp": zp_tr, "y": y_tr},
                          {"zc": zc_te, "zp": zp_te, "y": y_te}),
                "raw": ({"xs": xs_tr, "y": y_tr}, {"xs": xs_te, "y": y_te})}
        specs, _ = runner.build_cell_head_specs(st=st, dims=dims, num_classes=num_classes,
                                                device=cpu)
        for j, (name, builder, kind, shared_layout, _) in enumerate(specs):
            task = builder(fold_seed(c, 10 + j))
            train(model=task.model, loss_fn=task.loss_fn, data=data[kind][0], n_train=len(tr),
                  optimizer=task.optimizer, epochs=st.probe_epochs, batch_size=st.batch_size,
                  randomness=Randomness(fold_seed(c, 100 + j), cpu), val_fn=task.val_fn,
                  val_data=data[kind][1])
            evaluate = (tanalysis.evaluate_subjective_model_with_shared if shared_layout
                        else tanalysis.evaluate_subjective_model)
            replay = evaluate(task, data[kind][1])
            _assert_same_tree(_strip(seed_batched_rows["run_condition_vmapped"][seed][name]),
                              replay, f"seed {seed} {name}")


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
# the seed-batched engines, restore, evaluate and the synthetic sweep among them
for name in ("core.sweep_cell", "core.checkpoint", "runners.evaluate", "runners.run",
             "runners.run_synthetic", "models.disentangledssl", "ops.vmf", "data.synthetic",
             "models.fusions", "eval.uq_plots"):
    assert f"{pkg.__name__}.{name}" in names, name
# matplotlib only when a figure is drawn
assert "matplotlib" not in sys.modules
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 35


def test_only_bfloat16_and_the_mesh_are_not_ported():
    """Only the mesh is left: --dtype bfloat16 runs since the bf16 slice."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    assert runner.NOT_PORTED == ("--data-parallel/--model-parallel",)
    assert runner.parse_args(["--dtype", "bfloat16"]).dtype == "bfloat16"
    args = runner.parse_args(["--include-intermediate", "--intermediate-fusion", "lrtf", "mi3",
                              "--rows-file", "rows.json", "--profile", "--no-fused-dmvae"])
    assert args.intermediate_fusion == ["concat", "lrtf", "mi3"]
    assert (args.rows_file, args.profile, args.no_fused_dmvae) == ("rows.json", True, True)
    assert runner.parse_args(["--intermediate-fusion", "lrtf", "concat",
                              "--include-intermediate"]).intermediate_fusion == ["lrtf", "concat"]


FUSIONS = ("concat", "lrtf", "mi3")  # mi3 needs three views: skipped on CUB


@contextlib.contextmanager
def one_torch_thread():
    """One torch thread: the suite runs this file beside other test
    processes, and torch's thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def intermediate_rows():
    """A tiny Normal cell on CUB, seeds 0 and 1, with three intermediate
    fusions, through both seed-batched engines."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    out = {}
    with one_torch_thread():
        for engine in (runner.run_condition_vmapped, runner.run_condition_onejit):
            rows = {0: {}, 1: {}}
            engine(C=_tiny_config(), seeds=[0, 1], dataset_name="CUB", conflict=False,
                   quick=False, device=torch.device("cpu"), rows_by_seed=rows,
                   intermediate_fusions=FUSIONS)
            out[engine.__name__] = rows
    return out


def test_seed_batched_intermediate_rows(intermediate_rows):
    vmapped, onejit = (intermediate_rows[k] for k in ("run_condition_vmapped",
                                                       "run_condition_onejit"))
    for seed in (0, 1):
        assert sorted(vmapped[seed]) == sorted(onejit[seed]) == sorted([
            "dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion",
            "intermediate_fusion", "intermediate_lrtf", "intermediate_mi3"])
        assert vmapped[seed]["intermediate_mi3"] == {
            "skipped": "mi3 fuses exactly 3 views, got 2"}
        for name, info in vmapped[seed].items():
            assert _strip(onejit[seed][name]) == _strip(info), name
        # one head, evaluated in the per-view layout
        assert len(vmapped[seed]["intermediate_lrtf"]["per_view"]) == 1
        assert "shared" not in vmapped[seed]["intermediate_lrtf"]


def test_seed_batched_intermediate_jobs_equal_their_sequential_replay(intermediate_rows):
    """Each seed's intermediate jobs of the --vmap-seeds cell, replayed by
    the sequential trainer from their fold indices (10 + j, 100 + j, after
    the six heads), give the same rows: rtol 1e-4. A batched and a single
    product of lrtf's einsums round apart by an ulp, Adam's m / sqrt(v)
    turns that into a step of the learning rate's size on entries whose
    gradient is near zero, and the evidence's exp carries the logits'
    absolute difference into its relative one."""
    from disentagled_multimodal_fusion_tpu_torch.core.train import Randomness, train
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner
    from disentagled_multimodal_fusion_tpu_torch.runners.common import cell_seed, fold_seed

    C, cpu = _tiny_config(), torch.device("cpu")
    st = runner.cell_settings(C, "CUB", False)
    for seed in (0, 1):
        views, labels, tr, te, dims, num_classes = runner.split_cell(C, seed, "CUB", False, False)
        xs_tr, xs_te = (tuple(torch.from_numpy(v[rows]) for v in views) for rows in (tr, te))
        y_tr, y_te = torch.from_numpy(labels[tr]), torch.from_numpy(labels[te])
        c = cell_seed(seed, "CUB", False)
        specs, skipped = runner.build_cell_head_specs(st=st, dims=dims, num_classes=num_classes,
                                                      device=cpu, intermediate_fusions=FUSIONS)
        assert [(s.name, s.fusion) for s in specs[6:]] == [("intermediate_fusion", "concat"),
                                                           ("intermediate_lrtf", "lrtf")]
        assert list(skipped) == ["intermediate_mi3"]
        with one_torch_thread():
            for j, (name, builder, kind, shared_layout, _) in enumerate(specs[6:], start=6):
                task = builder(fold_seed(c, 10 + j))
                train(model=task.model, loss_fn=task.loss_fn, data={"xs": xs_tr, "y": y_tr},
                      n_train=len(tr), optimizer=task.optimizer, epochs=st.probe_epochs,
                      batch_size=st.batch_size,
                      randomness=Randomness(fold_seed(c, 100 + j), cpu), val_fn=task.val_fn,
                      val_data={"xs": xs_te, "y": y_te})
                replay = tanalysis.evaluate_subjective_model(task, {"xs": xs_te, "y": y_te})
                _assert_same_tree(
                    _strip(intermediate_rows["run_condition_vmapped"][seed][name]), replay,
                    f"seed {seed} {name}", rtol=1e-4)


def _read_report(root):
    logs = Path(root) / "logs"
    return {p.name: p.read_text() for p in sorted(logs.glob("dataset_analysis_*.csv"))}


@pytest.mark.parametrize("engine", [[], ["--vmap-seeds"], ["--one-program-cells"]],
                         ids=["sequential", "vmap", "one_program"])
def test_rows_file_resumes_a_failed_sweep(engine, tmp_path, monkeypatch):
    """The second cell of a two-cell sweep raises: the rows file holds the
    first. The rerun fits only the second cell and writes the report an
    uninterrupted sweep writes."""
    with one_torch_thread():
        _rows_file_resume(engine, tmp_path, monkeypatch)


def _rows_file_resume(engine, tmp_path, monkeypatch):
    from disentagled_multimodal_fusion_tpu_torch.runners import common
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    tiny = _tiny_config()
    monkeypatch.setattr(common, "make_getter", lambda cfg: tiny)
    # mi3's skip row counts towards a complete cell
    argv = ["--quick", "--seeds", "0", "1", "--datasets", "CUB", "--conditions", "Normal",
            "Conflict", "--device", "cpu", "--intermediate-fusion", "mi3", *engine]
    fn = {(): "run_condition", ("--vmap-seeds",): "run_condition_vmapped",
          ("--one-program-cells",): "run_condition_onejit"}[tuple(engine)]
    real = getattr(runner, fn)
    cells = []

    def counted(fail_on=None):
        def run(**kw):
            cells.append((kw.get("seed"), kw["conflict"]))
            if kw["conflict"] == fail_on:
                raise RuntimeError("the cell failed")
            return real(**kw)
        return run

    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path / "whole"))
    runner.main(argv)
    whole = _read_report(tmp_path / "whole")

    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path / "resumed"))
    rows_file = tmp_path / "rows.json"
    monkeypatch.setattr(runner, fn, counted(fail_on=True))
    with pytest.raises(RuntimeError, match="cell failed"):
        runner.main([*argv, "--rows-file", str(rows_file)])
    saved = json.loads(rows_file.read_text())
    # the sequential engine runs seed by seed: seed 0's Normal cell, then its
    # Conflict cell failed; a seed-batched engine runs both seeds per cell
    done = ["0"] if not engine else ["0", "1"]
    for seed in ("0", "1"):
        cell = saved[seed].get("Normal", {}).get("CUB", {})
        assert len(cell) == (7 if seed in done else 0)  # six heads and the mi3 skip row
        assert "CUB" not in saved[seed].get("Conflict", {})
    cells.clear()
    monkeypatch.setattr(runner, fn, counted())
    runner.main([*argv, "--rows-file", str(rows_file)])
    assert cells == ([(0, True), (1, False), (1, True)] if not engine else [(None, True)])
    assert _read_report(tmp_path / "resumed") == whole
    cells.clear()
    rows = runner.main([*argv, "--rows-file", str(rows_file), "--skip-report"])
    assert not cells
    assert len(rows[1]["Conflict"]["CUB"]) == 7


def test_rows_file_announces_the_cells_it_resumes(tmp_path, monkeypatch, capsys):
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    rows_file = tmp_path / "rows.json"
    rows_file.write_text(json.dumps({"0": {"Normal": {"CUB": {f"m{i}": {} for i in range(6)}}}}))
    monkeypatch.setattr(runner, "run_condition", lambda **kw: pytest.fail("refit a cell"))
    rows = runner.main(["--seeds", "0", "--datasets", "CUB", "--conditions", "Normal",
                        "--device", "cpu", "--skip-report", "--rows-file", str(rows_file)])
    assert "--rows-file: resuming; 1 completed cell(s) found" in capsys.readouterr().out
    assert list(rows) == [0] and len(rows[0]["Normal"]["CUB"]) == 6


@pytest.mark.parametrize("fails", [False, True])
def test_profile_writes_a_trace(fails, tmp_path, monkeypatch, capsys):
    """--profile writes the sweep's Chrome trace, also when the sweep raises."""
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    def cell(**kw):
        torch.ones(4).cumsum(0)
        if fails:
            raise RuntimeError("the cell failed")
        kw["rows_out"]["m"] = {}

    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    monkeypatch.setattr(runner, "run_condition", cell)
    argv = ["--seeds", "0", "--datasets", "CUB", "--conditions", "Normal", "--device", "cpu",
            "--skip-report", "--profile"]
    if fails:
        with pytest.raises(RuntimeError, match="cell failed"):
            runner.main(argv)
    else:
        runner.main(argv)
    trace = tmp_path / "logs" / "traces" / "uq_sweep" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::cumsum" for e in events)
    assert "profiler trace written to logs/traces/uq_sweep" in capsys.readouterr().out


def _uq_rows():
    rng = np.random.default_rng(0)
    rows = {}
    for seed in (0, 1):
        ev = torch.from_numpy(np.exp(rng.standard_normal((40, 2, 3))).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 3, 40))
        info = tanalysis.evaluate_evidences(ev, ev.sum(dim=1), y, 3, True)
        rows[seed] = {"Normal": {"CUB": {"cml_fusion": info,
                                         "intermediate_mi3": {"skipped": "mi3 ..."}}}}
    return rows


def test_uq_figures_are_written_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    from disentagled_multimodal_fusion_tpu_torch.eval.uq_plots import write_uq_plots

    rows = _uq_rows()
    for seed in rows:  # write_sweep_report drops skip rows first
        del rows[seed]["Normal"]["CUB"]["intermediate_mi3"]
    paths = write_uq_plots(rows, tmp_path)
    assert [Path(p).name for p in paths] == ["Normal_CUB_uq.svg"]
    assert Path(paths[0]).read_text().lstrip().startswith("<?xml")


def test_uq_figures_are_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    import sys

    from disentagled_multimodal_fusion_tpu_torch.eval.uq_plots import write_uq_plots
    from disentagled_multimodal_fusion_tpu_torch.runners import run as runner

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    assert write_uq_plots(_uq_rows(), tmp_path / "plots") == []
    runner.write_sweep_report(_uq_rows(), str(tmp_path / "logs" / "report.xlsx"))
    assert "no UQ figures written" in capsys.readouterr().out
    assert not list((tmp_path / "logs").glob("uq_plots/*.svg"))

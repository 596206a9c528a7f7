"""``runners/run_luma.py --vmap-seeds`` on the CPU, on the LUMA fixture
corpus of tests/test_torch_luma.py (network refused, one torch thread).

* ``--vmap-seeds --seeds 0 1 --ood-eval --include-intermediate
  --rows-file``: every row of both seeds, finite; seed 0's six base rows
  against the sequential engine's (tests/test_torch_luma.py's ``luma_run``,
  the same slots): accuracies equal, every other metric within rtol 1e-4 /
  atol 1e-5 (batched convolutions sum in another order than one seed's);
  checkpoints under the sequential names, each with its seed's BatchNorm
  statistics, so ``runners/evaluate.py --dataset LUMA`` gives each seed's
  row back.
* ``--segment-epochs 1`` over two epochs gives the rows of the whole fits
  (rtol 1e-6 / atol 1e-7).
* ``--rows-file``: the block is skipped only when every seed is complete.
* the mesh flags are still refused, with ``--dtype bfloat16`` too.
The text features hash with Python's salted ``hash``, so everything here
runs in one process.
"""

import io
import math
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from test_torch_luma import corpus, luma_run, offline_and_one_thread  # noqa: F401 (fixtures)

from disentagled_multimodal_fusion_tpu_torch.runners import evaluate, run_luma

BASE = ("dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion")
MODELS = BASE + ("intermediate_fusion",)
ROW_TOL = dict(rtol=1e-4, atol=1e-5)
SAME = dict(rtol=1e-6, atol=1e-7)


def _run(root, monkeypatch, argv):
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(root))
    out = io.StringIO()
    with redirect_stdout(out):
        rows = run_luma.main(argv)
    return rows, out.getvalue()


def _argv(corpus, *extra, epochs=1):
    return ["--data-path", corpus, "--ood-eval", "--include-intermediate", "--dmvae-epochs",
            str(epochs), "--probe-epochs", str(epochs), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def vmap_run(corpus, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("luma_vmap")
    mp = pytest.MonkeyPatch()
    argv = _argv(corpus, "--seeds", "0", "1", "--vmap-seeds", "--rows-file",
                 str(root / "rows.json"))
    rows, out = _run(root, mp, argv)
    yield root, rows, out, argv
    mp.undo()


def _flat(tree, prefix=""):
    """A row's numbers by dotted path (lists of dicts by index), without its
    checkpoint path and fit time."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, dict) or (isinstance(v, list) and v and isinstance(v[0], dict)):
            out.update(_flat(v, f"{prefix}{k}."))
        elif k not in ("path", "fit_seconds"):
            out[f"{prefix}{k}"] = v
    return out


def assert_rows_close(got, want, tol, label):
    """Two rows: the same keys, accuracies equal, every other number within
    ``tol``. Returns the largest absolute gap."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), label
    worst = 0.0
    for k, ref in w.items():
        a, b = np.asarray(g[k], np.float64), np.asarray(ref, np.float64)
        if "accuracy" in k:
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {k}")
            continue
        np.testing.assert_allclose(a, b, err_msg=f"{label} {k}", **tol)
        if a.size and np.isfinite(b).all():
            worst = max(worst, float(np.abs(a - b).max()))
    return worst


def test_vmap_seeds_rows_checkpoints_and_the_sequential_engine(vmap_run, luma_run):
    root, rows, out, _ = vmap_run
    assert sorted(rows) == [0, 1]
    for s in (0, 1):
        models = rows[s]["Normal"]["LUMA"]
        assert sorted(models) == sorted(MODELS)
        for name, info in models.items():
            assert math.isfinite(info["fused"]["accuracy"]), (s, name)
            assert all(0.0 <= v <= 1.0 for v in info["ood"].values()), (s, name)
            assert (root / "checkpoints" / f"{name}_fusion_dsLUMA_seed{s}.pt").exists()
        assert (root / "checkpoints" / f"dmvae_datasetLUMA_seed{s}_a1e-05_normal.pt").exists()
    assert "DMVAE x2 seeds trained" in out and "seeds [0, 1] done" in out
    # the seeds differ: their own weights, draws and statistics
    assert (torch.load(root / "checkpoints" / "cml_fusion_fusion_dsLUMA_seed0.pt")
            ["feat_encs.2.blocks.bn.0.mean"] != torch.load(
                root / "checkpoints" / "cml_fusion_fusion_dsLUMA_seed1.pt")
            ["feat_encs.2.blocks.bn.0.mean"]).any()
    seq = luma_run[1][0]["Normal"]["LUMA"]
    gaps = {name: assert_rows_close(rows[0]["Normal"]["LUMA"][name], seq[name], ROW_TOL, name)
            for name in BASE}
    print("seed 0 against the sequential engine, largest gaps:", gaps)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("model", ["dmvae_cml", "dmvae_dis", "cml_fusion"])
def test_evaluate_luma_reproduces_each_seeds_row(vmap_run, monkeypatch, model, seed):
    root, rows, _, argv = vmap_run
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(root))
    args = evaluate.parse_args(["--model", model, "--dataset", "LUMA", "--seed", str(seed),
                                "--data-path", argv[1], "--device", "cpu"])
    info = evaluate.eval_luma(args, torch.device("cpu"))
    ref = {k: v for k, v in rows[seed]["Normal"]["LUMA"][model].items()
           if k not in ("ood", "path", "fit_seconds")}
    assert info == ref


def test_segment_epochs_gives_the_rows_of_the_whole_fits(corpus, tmp_path,  # noqa: F811
                                                         monkeypatch):
    argv = _argv(corpus, "--seeds", "0", "1", "--vmap-seeds", epochs=2)
    whole, _ = _run(tmp_path / "whole", monkeypatch, argv)
    seg, _ = _run(tmp_path / "seg", monkeypatch, argv + ["--segment-epochs", "1"])
    for s in (0, 1):
        for name in MODELS:
            assert_rows_close(seg[s]["Normal"]["LUMA"][name], whole[s]["Normal"]["LUMA"][name],
                              SAME, f"seed {s} {name}")


def test_rows_file_skips_the_block_only_when_every_seed_is_complete(vmap_run, luma_run,
                                                                      monkeypatch, tmp_path):
    root, rows, _, argv = vmap_run
    monkeypatch.setattr(run_luma, "run_seeds_batched",
                        lambda **kw: pytest.fail("the resume trained"))
    again, out = _run(root, monkeypatch, argv)
    assert "--rows-file: resuming; 2 completed seed(s) found [0, 1]" in out
    assert "--rows-file: every seed complete, skipping training" in out
    assert again == rows

    # seed 0 complete, seed 1 not: every seed is trained
    (tmp_path / "rows.json").write_text((luma_run[0] / "rows.json").read_text())
    calls = []

    class Stop(Exception):
        pass

    def record(**kw):
        calls.append(list(kw["seeds"]))
        raise Stop  # before any fit

    monkeypatch.setattr(run_luma, "run_seeds_batched", record)
    argv = _argv(argv[1], "--seeds", "0", "1", "--vmap-seeds", "--rows-file",
                 str(tmp_path / "rows.json"))
    with pytest.raises(Stop):
        _run(tmp_path, monkeypatch, argv)
    assert calls == [[0, 1]]


@pytest.mark.parametrize("flags", [["--dtype", "bfloat16", "--data-parallel", "2"],
                                   ["--data-parallel", "2"], ["--model-parallel", "2"]])
def test_bf16_and_the_mesh_stay_refused(flags, capsys):
    """The mesh stays refused, beside --dtype bfloat16 too (which runs with
    --vmap-seeds: tests/test_torch_bf16_runs.py)."""
    with pytest.raises(SystemExit):
        run_luma.parse_args(["--vmap-seeds", "--segment-epochs", "1", *flags])
    assert "not ported yet" in capsys.readouterr().err


def test_vmap_flags_parse():
    args = run_luma.parse_args(["--vmap-seeds", "--segment-epochs", "2", "--force-vmap-seeds"])
    assert args.vmap_seeds and args.segment_epochs == 2 and args.force_vmap_seeds

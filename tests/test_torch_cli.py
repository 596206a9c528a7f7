"""The port's sweep and evaluation runners as a user runs them, with
``python -m``, on the CPU.

* ``runners/run.py`` trains a quick CUB Normal cell through the sequential
  engine (seed 0) and through ``--one-program-cells`` (seeds 0 and 1, its
  artifacts written on a thread), prints its ``sweep done`` line, and
  leaves every seed's backbone and head checkpoints behind;
* ``runners/evaluate.py``, run on those checkpoints, reports the fused
  accuracy the sweep printed (to the 4 decimals it prints);
* ``runners/run_synthetic.py`` trains a quick (seed 0, dep 50) cell, prints
  its ``sweep done`` line and leaves its JAX-named checkpoints, and
  ``runners/evaluate.py --dataset synthetic`` reports the fused accuracy it
  printed for each of its three models;
* ``runners/run.py --no-fused-dmvae --include-intermediate
  --intermediate-fusion lrtf mi3`` on CUB writes the six heads' rows,
  ``intermediate_fusion`` and ``intermediate_lrtf`` with their
  checkpoints, and mi3's skip row, to its ``--rows-file``; it trains the
  per-modality DMVAE, and ``runners/evaluate.py --no-fused-dmvae`` restores
  it and reports the fused accuracy the sweep printed
  (``run_synthetic.py --no-fused-dmvae``: tests/test_torch_synthetic.py);
* ``runners/run_luma.py`` trains one epoch of each fit on a fixture corpus
  with ``--ood-eval``, prints its ``LUMA protocol done`` line and writes its
  reports and checkpoints, and ``runners/evaluate.py --dataset LUMA``
  reports the fused accuracy it printed; ``run_luma.py`` refuses the flags
  it does not have yet (the mesh's model axis, also beside ``--dtype
  bfloat16`` and ``--data-parallel``, which run) with a parser error that points at ROADMAP.md (``--vmap-seeds`` and ``--segment-epochs`` run:
  tests/test_torch_luma_seed_batched.py).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from disentagled_multimodal_fusion_tpu_torch.runners.common import backbone_checkpoint, head_name

REPO_ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "disentagled_multimodal_fusion_tpu_torch.runners"
MODELS = ("dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion")
ENGINES = {"sequential": ([], (0,)), "one_program": (["--one-program-cells"], (0, 1))}


def _run(module, args, root, **env):
    proc = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.{module}", *args], cwd=REPO_ROOT,
        env=dict(os.environ, DMF_ARTIFACT_ROOT=str(root), **env), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module", params=sorted(ENGINES))
def sweep(request, tmp_path_factory):
    flags, seeds = ENGINES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    out = _run("run", ["--quick", "--datasets", "CUB", "--conditions", "Normal", "--device",
                       "cpu", "--skip-report", "--seeds", *map(str, seeds), *flags], root)
    return request.param, seeds, root, out


def test_the_sweep_trains_when_run_as_a_module(sweep):
    _, seeds, root, out = sweep
    assert re.search(r"^sweep done in [0-9.]+s$", out, re.M), out
    for seed in seeds:
        assert (root / f"{backbone_checkpoint('CUB', seed, 'normal')}.pt").is_file()
        for model in MODELS:
            assert (root / "checkpoints" / f"{head_name(model, 'CUB', seed, 'normal')}.pt"
                    ).is_file(), (model, seed)


def test_evaluate_reports_the_sweeps_fused_accuracy_when_run_as_a_module(sweep):
    engine, seeds, root, out = sweep
    accs = [json.loads(_run("evaluate", ["--model", "dmvae_cml", "--dataset", "CUB", "--seed",
                                         str(seed), "--device", "cpu"], root))
            ["fused"]["accuracy"] for seed in seeds]
    pattern = (r"\[CUB/normal/seed0\] dmvae_cml: fused_acc=([0-9.]+)" if engine == "sequential"
               else r"\[CUB/normal\] dmvae_cml x2: fused_acc ([0-9.]+) \+/-")
    printed = float(re.search(pattern, out).group(1))
    assert abs(np.mean(accs) - printed) <= 5e-5 + 1e-12, (accs, printed)


@pytest.fixture(scope="module")
def synthetic_sweep(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    out = _run("run_synthetic", ["--quick", "--seeds", "0", "--deps", "50", "--device", "cpu"],
               root)
    return root, out


def test_the_synthetic_sweep_trains_when_run_as_a_module(synthetic_sweep):
    root, out = synthetic_sweep
    assert re.search(r"^sweep done in [0-9.]+s$", out, re.M), out
    for name in ("dmvae_seed0_dep50", "dmvae_fusion_seed0_dep50", "late_fusion_seed0_dep50_aggcml",
                 "late_fusion_seed0_dep50_aggavg"):
        assert (root / "checkpoints" / f"{name}.pt").is_file(), name
    assert (root / "logs" / "synthetic_dataset.xlsx").is_file()


@pytest.mark.parametrize("model,label", [("dmvae_cml", "dmvae_cml"), ("cml_fusion", "cml"),
                                         ("avg_fusion", "avg")])
def test_evaluate_synthetic_reports_the_sweeps_fused_accuracy_when_run_as_a_module(
        synthetic_sweep, model, label):
    root, out = synthetic_sweep
    info = json.loads(_run("evaluate", ["--model", model, "--dataset", "synthetic", "--seed", "0",
                                        "--dep", "50", "--quick", "--device", "cpu"], root))
    printed = float(re.search(rf"\[seed 0 dep 50\] {label}: fused_acc=([0-9.]+)", out).group(1))
    assert abs(info["fused"]["accuracy"] - printed) <= 5e-5 + 1e-12, (info["fused"], printed)


# one torch thread: the suite runs these beside other test processes
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def intermediate_sweep(tmp_path_factory):
    """A quick CUB cell over the per-modality DMVAE with two intermediate
    fusions and a rows file."""
    root = tmp_path_factory.mktemp("intermediate")
    out = _run("run", ["--quick", "--seeds", "0", "--datasets", "CUB", "--conditions", "Normal",
                       "--device", "cpu", "--skip-report", "--no-fused-dmvae",
                       "--include-intermediate", "--intermediate-fusion", "lrtf", "mi3",
                       "--rows-file", str(root / "rows.json")], root, **ONE_THREAD)
    return root, out


def test_intermediate_fusions_leave_rows_skip_rows_and_checkpoints(intermediate_sweep):
    root, out = intermediate_sweep
    assert "[CUB] skipping intermediate_mi3: mi3 fuses exactly 3 views, got 2" in out
    rows = json.loads((root / "rows.json").read_text())["0"]["Normal"]["CUB"]
    assert sorted(rows) == sorted([*MODELS, "intermediate_fusion", "intermediate_lrtf",
                                   "intermediate_mi3"])
    assert rows["intermediate_mi3"] == {"skipped": "mi3 fuses exactly 3 views, got 2"}
    for model in ("intermediate_fusion", "intermediate_lrtf"):
        printed = float(re.search(rf"\] {model}: fused_acc=([0-9.]+)", out).group(1))
        assert abs(rows[model]["fused"]["accuracy"] - printed) <= 5e-5, model
        assert len(rows[model]["per_view"]) == 1
        assert (root / "checkpoints" / f"{head_name(model, 'CUB', 0, 'normal')}.pt").is_file()
    assert not (root / "checkpoints" / f"{head_name('intermediate_mi3', 'CUB', 0, 'normal')}.pt"
                ).exists()


def test_unfused_dmvae_sweep_and_evaluate_when_run_as_modules(intermediate_sweep):
    root, out = intermediate_sweep
    assert "dmvae (unfused) fit" in out
    info = json.loads(_run("evaluate", ["--model", "dmvae_cml", "--dataset", "CUB", "--seed", "0",
                                        "--device", "cpu", "--no-fused-dmvae"], root,
                           **ONE_THREAD))
    printed = float(re.search(r"\[CUB/normal/seed0\] dmvae_cml: fused_acc=([0-9.]+)",
                              out).group(1))
    assert abs(info["fused"]["accuracy"] - printed) <= 5e-5 + 1e-12, (info["fused"], printed)


# the LUMA runs read one fixture corpus; its hash text features are salted per
# process, so both processes get one salt (evaluate also reads the run's
# feature cache), and the tokenizer looks for local files only
LUMA_ENV = {**ONE_THREAD, "PYTHONHASHSEED": "0", "HF_HUB_OFFLINE": "1",
            "TRANSFORMERS_OFFLINE": "1"}


@pytest.fixture(scope="module")
def luma_sweep(tmp_path_factory):
    from disentagled_multimodal_fusion_tpu_torch.data.luma import make_fake_luma

    root = tmp_path_factory.mktemp("luma")
    corpus = make_fake_luma(str(root / "corpus"), n_classes=3, train_per_class=4,
                            test_per_class=2, ood_classes=1)
    out = _run("run_luma", ["--data-path", corpus, "--seeds", "0", "--ood-eval",
                            "--dmvae-epochs", "1", "--probe-epochs", "1", "--device", "cpu"],
               root, **LUMA_ENV)
    return root, corpus, out


def test_the_luma_protocol_trains_when_run_as_a_module(luma_sweep):
    root, _, out = luma_sweep
    assert re.search(r"^LUMA protocol done in [0-9.]+s$", out, re.M), out
    assert (root / "checkpoints" / "dmvae_datasetLUMA_seed0_a1e-05_normal.pt").is_file()
    for model in MODELS:
        assert (root / "checkpoints" / f"{model}_fusion_dsLUMA_seed0.pt").is_file(), model
    for name in ("luma_analysis.xlsx", "luma_ood.json"):
        assert (root / "logs" / name).is_file(), name


@pytest.mark.parametrize("model", ["dmvae_joint", "avg_fusion"])
def test_evaluate_luma_reports_the_runs_fused_accuracy_when_run_as_a_module(luma_sweep, model):
    root, corpus, out = luma_sweep
    info = json.loads(_run("evaluate", ["--model", model, "--dataset", "LUMA", "--seed", "0",
                                        "--data-path", corpus, "--device", "cpu"], root,
                           **LUMA_ENV))
    printed = float(re.search(rf"\[seed 0\] {model}: fused_acc=([0-9.]+)", out).group(1))
    assert abs(info["fused"]["accuracy"] - printed) <= 5e-5 + 1e-12, (info["fused"], printed)


@pytest.mark.parametrize("flags", [["--dtype", "bfloat16", "--model-parallel", "2"],
                                   ["--data-parallel", "2", "--model-parallel", "2"],
                                   ["--model-parallel", "2"]],
                         ids=["bfloat16", "data_parallel", "model_parallel"])
def test_run_luma_refuses_what_is_not_ported(flags, capsys, monkeypatch):
    """The mesh's model axis runs now, with --dtype bfloat16 and
    --data-parallel too: the flags parse, and without a process group of
    data x model ranks the runner exits naming that launch (the ranks run
    in tests/test_torch_multiprocess_model.py)."""
    from disentagled_multimodal_fusion_tpu_torch.parallel.distributed import CLUSTER_ENV
    from disentagled_multimodal_fusion_tpu_torch.runners import run_luma

    for var in CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    argv = ["--seeds", "0", *flags, "--device", "cpu"]
    args = run_luma.parse_args(argv)
    assert args.model_parallel == 2
    world = 2 * args.data_parallel
    with pytest.raises(SystemExit) as exit_info:
        run_luma.main(argv)
    assert (f"--nproc-per-node {world} -m <runner> --data-parallel {args.data_parallel} "
            f"--model-parallel 2") in str(exit_info.value)
    assert "not ported" not in capsys.readouterr().err

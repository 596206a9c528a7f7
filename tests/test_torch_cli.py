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
  printed for each of its three models.
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


def _run(module, args, root):
    proc = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.{module}", *args], cwd=REPO_ROOT,
        env=dict(os.environ, DMF_ARTIFACT_ROOT=str(root)), capture_output=True, text=True,
        timeout=300)
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

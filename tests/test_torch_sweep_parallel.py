"""``runners/sweep_parallel.py`` of the port, end to end on the CPU.

Two worker processes split two datasets (``--procs 2``), each running the
port's ``runners.run`` with its own rows file; the orchestrator merges the
rows and writes the one report. A one-process ``runners.run`` of the same
cells, run at the same time in another artifact root, must give the same
rows bit for bit (the same code on the same CPU, one thread each), but for
the wall times and checkpoint paths each row records, and the same
``all_results`` report.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

from disentagled_multimodal_fusion_tpu_torch.runners.sweep_parallel import merge_rows

REPO_ROOT = Path(__file__).resolve().parent.parent
CELLS = ["--datasets", "CUB", "PIE", "--seeds", "0", "--conditions", "Normal"]
VOLATILE = ("fit_seconds", "backbone_fit_seconds", "vmf_syncs_per_epoch", "path")


def _start(module, args, root):
    env = dict(os.environ, DMF_ARTIFACT_ROOT=str(root), OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO_ROOT))
    return subprocess.Popen([sys.executable, "-m", f"disentagled_multimodal_fusion_tpu_torch."
                             f"runners.{module}", *args], cwd=str(REPO_ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc):
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    return out


def _stable(rows):
    """The rows without what differs from run to run."""
    if isinstance(rows, dict):
        return {k: _stable(v) for k, v in rows.items() if k not in VOLATILE}
    return rows


def test_sweep_parallel_rows_equal_one_process(tmp_path):
    sweep_root, one_root = tmp_path / "sweep", tmp_path / "one"
    sweep = _start("sweep_parallel", ["--procs", "2", *CELLS, "--quick", "--device", "cpu"],
                   sweep_root)
    one = _start("run", [*CELLS, "--quick", "--device", "cpu", "--rows-file",
                         str(one_root / "rows.json")], one_root)
    out = _finish(sweep)
    _finish(one)
    assert "parallel sweep (2 workers, 2 datasets) done" in out
    for rank, dataset in enumerate(("CUB", "PIE")):
        log = (sweep_root / "logs" / f"sweep_worker_{rank}.log").read_text()
        assert f"--datasets {dataset} --rows-file" in log and "--device cpu" in log
    merged = merge_rows([sweep_root / "logs" / f"sweep_rows_w{r}.json" for r in range(2)])
    want = {int(s): v for s, v in json.loads((one_root / "rows.json").read_text()).items()}
    assert set(merged[0]["Normal"]) == {"CUB", "PIE"}
    assert _stable(merged) == _stable(want)
    report = "logs/dataset_analysis_all_results.csv"
    assert (sweep_root / report).read_text() == (one_root / report).read_text()

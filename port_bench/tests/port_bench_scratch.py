"""A scratch checkout of the benchmark for the CPU tests: ``BENCHMARK.json`` and a
copy of ``port_bench/`` in a temporary folder, with the repository's
``data/`` linked beside them and each cell's traffic cut to a size the CPU
serves in a moment (the configurations keep their published widths).

A mix kept for later (a workload file with no entry in ``BENCHMARK.json``)
is registered in the scratch copy beside a cell of its configuration,
reporting that cell's metrics, so that its model path stays tested."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SMALL_TRAFFIC = {"corpus_rows": 256, "rows_per_request": 64, "compare_requests": 2}
# each kept mix, and the cell whose entry and metrics it borrows
KEPT = {"handwritten.score_late": "handwritten.score"}


def _register_kept(tmp: Path) -> None:
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for mix, like in KEPT.items():
        traffic = json.loads((tmp / "port_bench" / "workloads" / f"{mix}.json").read_text())
        entry = next(w for w in bench["workloads"] if w["name"] == like)
        bench["workloads"].append(dict(entry, name=mix, traffic=traffic["traffic"]))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(mix)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


def scratch_checkout(tmp: Path, small: bool = True, kept: bool = False) -> Path:
    """The scratch checkout's root; with ``kept`` the kept mixes are cells."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "port_bench", tmp / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "data").symlink_to(REPO / "data")
    if small:
        for path in (tmp / "port_bench" / "workloads").glob("*.json"):
            cell = json.loads(path.read_text())
            cell.update(SMALL_TRAFFIC)
            path.write_text(json.dumps(cell, indent=2))
    if kept:
        _register_kept(tmp)
    return tmp

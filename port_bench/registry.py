"""Finds what belongs to a cell, a configuration, a loop or a metric by its name.

``BENCHMARK.json`` lies at the checkout's root, beside this folder. A cell
``<cell>`` is ``workloads/<cell>.json``, whose ``loop`` names the module
``loops/<loop>.py`` that sets it up and serves its windows; its
configuration ``<config>`` is ``configs/<config>.json`` (with, for the
scoring loop, ``models/<config>.py`` and ``reference/<config>.py``). A
metric, end-to-end or per-layer, is read by ``metrics/<quantity>.py``, the
quantity being its name up to its first dot: ``score_p95_ms.handwritten`` and
``score_p95_ms`` share one reader and differ in the cells that report
them. Modules are loaded from their files, so names may hold dots.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import List, Tuple

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def module(kind: str, name: str, here: Path = HERE) -> ModuleType:
    """``<kind>/<name>.py`` under this folder, loaded from its file."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, here: Path = HERE) -> ModuleType:
    """The reader of metric ``name``: its quantity's file."""
    return module("metrics", name.partition(".")[0], here)


def cell(bench: dict, name: str, here: Path = HERE) -> Tuple[dict, dict, dict]:
    """(the cell's entry in BENCHMARK.json, its workload file, its
    configuration file); the two files must name the entry's configuration
    and traffic."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = load_json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {workload[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return entry, workload, load_json(here / "configs" / f"{entry['config']}.json")


def reported(bench: dict, name: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell ``name`` reports: those listing it under ``workloads``; of those
    without the key, end-to-end metrics in every cell, and per-layer
    metrics wherever the end-to-end metric they move is reported."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


@dataclass
class Cell:
    """What a loop's ``set_up`` is handed: the cell's entry, its workload
    and configuration files, the run's seed and device, the system under
    test (``"port"``, or ``"control"`` where the loop has one), the
    folders, and the set-up's phases so far as (name, end time)."""

    name: str
    entry: dict
    workload: dict
    config: dict
    seed: int
    device: torch.device
    system: str
    here: Path
    root: Path
    phases: List[Tuple[str, float]] = field(default_factory=list)

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (the device's queue drained first)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases.append((name, time.perf_counter()))

    def log(self, *parts) -> None:
        print(*parts, file=sys.stderr, flush=True)

"""Readings that set a cell's limits: the port over many seeds, and the control over some.

    python3 -m port_bench.calibrate --workload <cell> --seeds <n>... \
        --control-seeds <n>... --seconds <s> [--out <file>]

Each seed is a run of the cell as the benchmark makes it (weights and
corpus from the seed, a window of ``--seconds`` at the cell's load, the
same number of requests compared), all in this one process. The control is
the plain reference computed in TF32, the precision below the float32 the
configurations state, put in the port's place. For each number compared it
prints one JSON line a run, then the summary: the lower reading (the
largest the port gives) and the upper (the smallest the control gives). The
limits in ``workloads/<cell>.json`` are set between the two; the
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from port_bench import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the readings are the card's", file=sys.stderr)
        return 2
    lines, readings = [], {"port": [], "control": []}
    for system, seeds in (("port", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            result = run.run_cell(args.workload, seed, args.seconds, False, system=system)
            values = {k: c["value"] for k, c in result["checks"].items()}
            readings[system].append(values)
            line = {"workload": args.workload, "system": system, "seed": seed,
                    "attempted": result["attempted"], "failed": result["failed"],
                    "correct": result["correct"], "values": values}
            lines.append(line)
            print(json.dumps(line), flush=True)
    names = list(readings["port"][0]) if readings["port"] else []
    # float(): a non-finite reading comes back as a string
    summary = {"workload": args.workload, "card": run.card_line(), "summary": {
        n: {"lower": max(float(r[n]) for r in readings["port"]),
            "upper": (min(float(r[n]) for r in readings["control"])
                      if readings["control"] else None)}
        for n in names}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

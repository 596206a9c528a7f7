"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's workload file names its loop (``loops/<loop>.py``), which sets
the cell up from ``--seed`` (weights, inputs, the port's function built
and its one shape warmed up; the head kernel's library is built into the
port's ``_build/`` on the first run in a checkout and loaded from there
after). ``setup_s`` runs from this module's first line to the end of that
set-up. The loop then serves the measured window: all of ``--seconds``
with ``--trace 0``; with ``--trace 1`` half untraced (the host's readings)
and half under ``torch.profiler`` with CUDA activity only (the device's
readings, ``trace.py``).

After the window the peak of device memory is read and the loop checks
what the window produced (``check``: it frees the port and recomputes
with the plain reference); each number compared must lie within its limit
in the workload file. The metrics are read by name (``metrics/``): the
cell's end-to-end ones with ``--trace 0``, its per-layer ones with
``--trace 1``, from the readings of the first window, the loop's
constants, ``setup_s`` and the traced window's summary (``trace``).

A loop module has ``set_up(cell) -> run`` (``cell`` a ``registry.Cell``);
``run`` has ``warm()``, ``window(seconds) -> dict`` of readings with at
least ``attempted`` and ``failed``, ``requests`` and ``window_s``,
``constants`` (a dict), and ``check() -> {number: value}``.

The last lines on standard error are the numbers compared, each beside its
limit; the last line on standard output is the result, one JSON object.
Without a CUDA card, or with fewer than the cell asks for, the run prints
no result and exits 2; if JAX, jaxlib, flax or the JAX package is loaded
once the window has closed, it names them and exits 3.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

from port_bench import compare, registry, trace  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "disentagled_multimodal_fusion_tpu"})


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted(FORBIDDEN & {name.partition(".")[0] for name in list(sys.modules)})


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi unreadable ({err})"


def _finite(x):
    return x if math.isfinite(x) else str(x)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             system: str = "port", here: Path = registry.HERE, root: Path = registry.ROOT,
             started: float = STARTED) -> dict:
    """One run of cell ``name``: the result dict (without printing).
    ``system`` is ``"port"`` (the benchmark) or ``"control"``, which
    ``calibrate.py`` reads to set the limits."""
    bench = registry.benchmark(root)
    entry, workload, cfg = registry.cell(bench, name, here)
    cell = registry.Cell(name, entry, workload, cfg, seed, torch.device(device), system, here,
                         root)
    cell.phase("imports")
    run = registry.module("loops", workload["loop"], here).set_up(cell)
    if traced:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's own start-up
            run.warm()
    cell.phase("warm-up")
    setup_s = cell.phases[-1][1] - started
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{phase} {t1 - t0:.3f}" for (_, t0), (phase, t1) in
        zip([("start", started)] + cell.phases[:-1], cell.phases)))

    windows = [run.window(seconds / 2 if traced else seconds)]
    summary = None
    if traced:
        profiler = profile(activities=[ProfilerActivity.CUDA])
        profiler.start()
        windows.append(run.window(seconds / 2))
        profiler.stop()
        summary = trace.summarize(trace.device_ops(profiler), windows[1]["requests"],
                                  windows[1]["window_s"])
        if summary is None:
            raise RuntimeError("the profiler saw no device operation in the window")
    attempted = sum(w["attempted"] for w in windows)
    failed = sum(w["failed"] for w in windows)
    memory_peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0

    ok, checks = compare.judge(run.check(), workload["limits"])
    readings = SimpleNamespace(**windows[0], **run.constants, setup_s=setup_s, trace=summary)
    metrics = {}
    for m in registry.reported(bench, name, "per_layer" if traced else "end_to_end"):
        value = registry.reader(m["name"], here).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": _finite(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
           "kind": torch.cuda.get_device_name(cell.device) if cell.device.type == "cuda" else "cpu",
           "count": entry["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": ok and failed == 0 and attempted > 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    entry, _, _ = registry.cell(registry.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"{args.workload} needs {entry['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available. "
            f"No result: this benchmark never times the CPU.")
        return 2
    log(f"card: {card_line()} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"loaded in this process after the window: {', '.join(found)}. No result.")
        return 3
    for key, c in result["checks"].items():
        log(f"check {key} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

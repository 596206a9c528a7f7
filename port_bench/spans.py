"""The port's spans against the device trace: where a scoring cell's host time and the card's idle time go.

    python3 -m port_bench.spans --workload <cell> --seed <n> --seconds <s> [--pairs <k>]

Sets a cell up as ``run.py`` does, its loop, weights and warm-up unchanged
(the warm-up under the profiler, as a ``--trace 1`` run has it), with the
port's spans recorded (``core/logging.py``'s ``recording()``) through
set-up. It then serves windows of ``--seconds`` / 2 each: ``--pairs``
pairs of one untraced window with recording off and one with recording on,
their order turned in every other pair (the recorder's cost to
``host_issue_ms``), then one window with recording
on under ``torch.profiler``, CUDA activity only (the traced half of a
``--trace 1`` run). It prints a table a span name on standard error and
one JSON line on standard output. It never runs a check of ``correct``,
and ``run.py`` does not call it: it measures, it does not benchmark.

The reductions below take spans as the recorder keeps them (``id``,
``name``, ``parent``, ``request``, ``start_ns``, ``end_ns`` on the host's
``perf_counter_ns``; one thread's spans, whose innermost span at any time
is one) and device operations as (start_ns, end_ns, name) on the
Unix-epoch clock of the profiler (``device_ops_ns``); ``offset_ns`` moves
a span onto that clock (the recording's anchor). Idle time is the traced
window less the union of the device operations; each idle nanosecond goes
to the innermost span open then, or to the harness when none is.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Sequence, Tuple  # noqa: E402

import torch  # noqa: E402

from disentagled_multimodal_fusion_tpu_torch.core.logging import (  # noqa: E402
    recording, span_table)
from port_bench import registry, trace  # noqa: E402

HARNESS = "(harness: no span open)"
# the scoring path's spans (core/serve.py): the port holds the card while
# one of them is open
PORT_PREFIX = "serve."

Interval = Tuple[int, int]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def device_ops_ns(prof) -> List[Tuple[int, int, str]]:
    """(start_ns, end_ns, name) of every device operation the profiler saw,
    on the Unix-epoch clock: its trace's start plus the event's offset."""
    start = prof.profiler.kineto_results.trace_start_ns()
    return [(start + round(1000 * s), start + round(1000 * e), name)
            for s, e, name in trace.device_ops(prof)]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_intervals(ops: Sequence[Tuple[int, int, str]], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi] in which no device operation ran."""
    out, t = [], lo
    for s, e in union((s, e) for s, e, _ in ops):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def overlap_ns(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Time in both of two sorted, disjoint lists of intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_intervals(spans, offset_ns: int = 0) -> List[Tuple[int, int, str]]:
    """(start, end, name): each span's interval less those of the spans
    opened directly inside it, moved by ``offset_ns``; sorted."""
    ids = {s.id for s in spans}
    kids = defaultdict(list)
    for s in spans:
        if s.parent in ids:
            kids[s.parent].append(s)
    out = []
    for s in spans:
        t = s.start_ns
        for c in sorted(kids[s.id], key=lambda c: c.start_ns):
            if c.start_ns > t:
                out.append((t + offset_ns, c.start_ns + offset_ns, s.name))
            t = max(t, c.end_ns)
        if s.end_ns > t:
            out.append((t + offset_ns, s.end_ns + offset_ns, s.name))
    return sorted(out)


def idle_by_span(spans, ops, lo: int, hi: int, offset_ns: int = 0) -> Dict[str, int]:
    """Idle nanoseconds of [lo, hi] by the innermost span open then, and
    under ``HARNESS`` those in which no span was open; they sum to the
    window's idle time."""
    idle = idle_intervals(ops, lo, hi)
    by_name: Dict[str, List[Interval]] = defaultdict(list)
    for s, e, name in self_intervals(spans, offset_ns):
        by_name[name].append((s, e))
    out = {name: overlap_ns(idle, union(iv)) for name, iv in by_name.items()}
    out[HARNESS] = sum(e - s for s, e in idle) - sum(out.values())
    return out


def idle_in_port_ns(spans, ops, lo: int, hi: int, offset_ns: int = 0) -> int:
    """Idle nanoseconds of [lo, hi] while a span of the scoring path
    (``serve.*``) was open."""
    port = union((s.start_ns + offset_ns, s.end_ns + offset_ns) for s in spans
                 if s.name.startswith(PORT_PREFIX))
    return overlap_ns(idle_intervals(ops, lo, hi), port)


def first_request(spans) -> Tuple[float, Dict[str, float]]:
    """Seconds of the first request among ``spans`` (its ``serve.infer``
    and its ``serve.to_host``, with the ``kernels.*`` spans inside), and
    the self seconds of each span name in it; (0.0, {}) without a
    ``serve.infer``."""
    roots = [s for s in spans if s.name == "serve.infer"]
    if not roots:
        return 0.0, {}
    request = min(roots, key=lambda s: s.start_ns).request
    mine = [s for s in spans if s.request == request]
    total = sum(s.end_ns - s.start_ns for s in mine if s.name in ("serve.infer", "serve.to_host"))
    return total / 1e9, {name: row["self_ns"] / 1e9 for name, row in span_table(mine).items()}


def readings(spans, requests: int, ops, lo: int, hi: int, offset_ns: int,
             setup_spans=()) -> dict:
    """The per-layer quantities of a traced window of ``requests``
    requests: ``backbone_host_ms``, ``heads_host_ms`` and
    ``uncertainty_host_ms`` (mean self time a request of ``serve.backbone``,
    ``serve.heads``, ``serve.uncertainty``), ``to_host_ms`` (mean time a
    request of ``serve.to_host``), ``idle_in_port_pct`` (the share of the
    window in which the card idles while a ``serve.*`` span is open) and,
    from set-up's spans, ``first_request_s``."""
    table = span_table(spans)
    ms = lambda name, key: table.get(name, {}).get(key, 0) / 1e6 / requests  # noqa: E731
    return {
        "backbone_host_ms": ms("serve.backbone", "self_ns"),
        "heads_host_ms": ms("serve.heads", "self_ns"),
        "uncertainty_host_ms": ms("serve.uncertainty", "self_ns"),
        "to_host_ms": ms("serve.to_host", "total_ns"),
        "idle_in_port_pct": 100.0 * idle_in_port_ns(spans, ops, lo, hi, offset_ns) / (hi - lo),
        "first_request_s": first_request(setup_spans)[0],
    }


def table_lines(spans, requests: int, idle: Dict[str, int]) -> List[str]:
    """The table of a window: a row a span name (count, mean and self ms a
    request, idle seconds while it was the innermost span open), then the
    harness's own."""
    table = span_table(spans)
    lines = [f"{'span':<24} {'count':>7} {'ms/request':>11} {'self ms':>9} {'idle s':>9}"]
    for name, row in sorted(table.items(), key=lambda kv: -kv[1]["self_ns"]):
        lines.append(f"{name:<24} {row['count']:>7} {row['total_ns'] / 1e6 / requests:>11.5f} "
                     f"{row['self_ns'] / 1e6 / requests:>9.5f} {idle.get(name, 0) / 1e9:>9.5f}")
    lines.append(f"{HARNESS:<24} {'':>7} {'':>11} {'':>9} {idle.get(HARNESS, 0) / 1e9:>9.5f}")
    return lines


def _mean_ms(values) -> float:
    return 1e3 * sum(values) / len(values) if values else float("nan")


def measure(name: str, seed: int, seconds: float, pairs: int = 1, device="cuda",
            here: Path = registry.HERE, root: Path = registry.ROOT,
            started: float = STARTED) -> dict:
    """One measurement of cell ``name`` (see the module's text): the dict
    of the JSON line."""
    from torch.profiler import ProfilerActivity, profile

    bench = registry.benchmark(root)
    entry, workload, cfg = registry.cell(bench, name, here)
    cell = registry.Cell(name, entry, workload, cfg, seed, torch.device(device), "port", here,
                         root)
    cell.phase("imports")
    with recording() as setup:
        run = registry.module("loops", workload["loop"], here).set_up(cell)
        with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's own start-up
            run.warm()
    cell.phase("warm-up")
    setup_s = cell.phases[-1][1] - started
    half = seconds / 2
    off, on = [], []
    for k in range(pairs):
        if k % 2:
            off.append(run.window(half))
        with recording() as untraced:
            on.append(run.window(half))
        if not k % 2:
            off.append(run.window(half))
    profiler = profile(activities=[ProfilerActivity.CUDA])
    with recording() as traced:
        profiler.start()
        lo = time.perf_counter_ns()
        window = run.window(half)
        hi = time.perf_counter_ns()
        profiler.stop()
    ops = device_ops_ns(profiler)
    summary = trace.summarize(trace.device_ops(profiler), window["requests"], window["window_s"])
    offset = traced.anchor[1] - traced.anchor[0]
    lo, hi = lo + offset, hi + offset
    idle = idle_by_span(traced.spans, ops, lo, hi, offset)
    requests = window["requests"]
    first_s, first_spans = first_request(setup.spans)
    spans_s = sum(s.end_ns - s.start_ns for s in traced.spans
                  if s.name in ("serve.infer", "serve.to_host")) / 1e9
    untraced_table, traced_table = span_table(untraced.spans), span_table(traced.spans)
    device_idle_s = summary.window_s - summary.busy_s if summary else float("nan")
    log(f"set-up {setup_s:.3f} s; first request {first_s:.4f} s, self s by span {first_spans}")
    log(f"untraced, recording on ({on[-1]['requests']} requests):")
    for line in table_lines(untraced.spans, on[-1]["requests"], {}):
        log("  " + line)
    log(f"traced ({requests} requests, {len(ops)} device operations, idle "
        f"{device_idle_s:.5f} s of {window['window_s']:.5f}):")
    for line in table_lines(traced.spans, requests, idle):
        log("  " + line)
    return {
        "cell": name, "seed": seed, "torch": torch.__version__,
        "setup_s": setup_s,
        "host_issue_ms": {"off": [_mean_ms(w["issue_s"]) for w in off],
                          "on": [_mean_ms(w["issue_s"]) for w in on]},
        "latency_ms": {"off": [_mean_ms(w["latency_s"]) for w in off],
                       "on": [_mean_ms(w["latency_s"]) for w in on],
                       "traced": _mean_ms(window["latency_s"])},
        "readings": readings(traced.spans, requests, ops, lo, hi, offset, setup.spans),
        "spans": {"untraced": untraced_table, "traced": traced_table,
                  "untraced_requests": on[-1]["requests"], "traced_requests": requests},
        "idle_s": {"by_span": {k: v / 1e9 for k, v in idle.items()},
                   "attributed": sum(idle.values()) / 1e9, "device": device_idle_s,
                   "busy": summary.busy_s if summary else 0.0,
                   "window": window["window_s"], "bounds": (hi - lo) / 1e9},
        "coverage": spans_s / sum(window["latency_s"]) if window["latency_s"] else 0.0,
        "first_request": {"s": first_s, "self_s": first_spans},
        "dropped": {"setup": setup.dropped, "untraced": untraced.dropped,
                    "traced": traced.dropped},
        "counters": dict(traced.counters),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--pairs", type=int, default=1)
    args = parser.parse_args(argv)
    entry, _, _ = registry.cell(registry.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"{args.workload} needs {entry['chips']} CUDA device(s); no measurement on the CPU.")
        return 2
    result = measure(args.workload, args.seed, args.seconds, args.pairs)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The device trace of a traced window, reduced to what the per-layer readers take.

A ``--trace 1`` run wraps its measured window in ``torch.profiler`` with CUDA
activity only (kernels, copies, memsets on the card; no host operator
events, which would cost the host more than the requests do). ``summarize``
reduces the device operations to what the readers take: the seconds in
which any operation ran (the union of their intervals), the device time by
operation name, and the idle gaps between operations, each named by the
operations on either side of it (a gap after a device-to-host copy is the
host converting outputs and issuing the next request).
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# the f32 build of csrc/evidential_head.cu (its bf16 build is
# evidential_heads_bf16_kernel, which this does not match)
HEAD_KERNEL = "evidential_heads_kernel"


@dataclass
class TraceSummary:
    """Device operations of a traced window."""

    requests: int                       # requests completed in the traced window
    window_s: float                     # the traced window (host clock)
    busy_s: float                       # union of the operations' intervals
    op_s: Dict[str, float]              # device time by operation name
    gaps_s: Dict[str, float]            # idle seconds between operations, by what surrounds them
    span_s: float                       # first operation's start to last one's end

    def kernel_s(self, name: str) -> float:
        """Device seconds of the operations whose name holds ``name``."""
        return sum(s for k, s in self.op_s.items() if name in k)


def short_name(name: str) -> str:
    """An operation's name without its template arguments and signature, with
    the functor of a PyTorch elementwise kernel in brackets."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    bare = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    short = re.split(r"[<(]", bare, maxsplit=1)[0].strip() or name
    rest = bare[len(short):]
    found = (re.findall(r"\w+Functor\w*|\w+_functor", rest)
             or re.findall(r"\w+_kernel_cuda|launch_\w+", rest))
    return f"{short} [{found[-1]}]" if found else short


def device_ops(prof) -> List[Tuple[float, float, str]]:
    """(start_us, end_us, name) of every device operation the profiler saw."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def summarize(ops: Sequence[Tuple[float, float, str]], requests: int,
              window_s: float) -> Optional[TraceSummary]:
    """The union, sums by name and labelled gaps of the device operations of
    a traced window of ``requests`` requests; None when there are none."""
    if not ops:
        return None
    ops = sorted(ops)
    op_s: Dict[str, float] = defaultdict(float)
    gaps: Dict[str, float] = defaultdict(float)
    busy_us, cur_start, cur_end, cur_name = 0.0, ops[0][0], ops[0][1], ops[0][2]
    for start, end, name in ops:
        op_s[name] += (end - start) / 1e6
        if start > cur_end:
            busy_us += cur_end - cur_start
            gaps[f"{short_name(cur_name)} -> {short_name(name)}"] += (start - cur_end) / 1e6
            cur_start, cur_end, cur_name = start, end, name
        elif end >= cur_end:
            cur_end, cur_name = end, name
    busy_us += cur_end - cur_start
    return TraceSummary(requests=requests, window_s=window_s, busy_s=busy_us / 1e6,
                        op_s=dict(op_s), gaps_s=dict(gaps),
                        span_s=(max(e for _, e, _ in ops) - ops[0][0]) / 1e6)


def breakdown(summary: TraceSummary) -> dict:
    """The ten device operations that took most time, and the ten largest
    sums of idle time by what surrounds them (the window outside the first
    and last operation under its own name), each in seconds."""
    gaps = dict(summary.gaps_s)
    outside = summary.window_s - summary.span_s
    if outside > 0:
        gaps["before the first and after the last device operation"] = outside
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(summary.op_s), "idle_gaps": top(gaps)}

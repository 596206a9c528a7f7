"""The head kernel's share of its roofline: its bound a request (the larger of
the heads' FLOPs over 67 TFLOP/s and their bytes over 3.35 TB/s, counted
from the published widths, ``bounds.head_bound_s``) over its device time a
request in the profiler's trace (the f32 build, by kernel name)."""

from port_bench.trace import HEAD_KERNEL


def read(r):
    if r.trace is None or r.trace.requests == 0:
        return None
    per_request = r.trace.kernel_s(HEAD_KERNEL) / r.trace.requests
    return 100.0 * r.head_bound_s / per_request if per_request > 0 else None

"""Device time a request of every operation but the head kernel: the cuBLAS
and cuDNN products, BatchNorm, pooling, the PoE, the uncertainties, the
copies to the host (profiler trace, summed by operation)."""

from port_bench.trace import HEAD_KERNEL


def read(r):
    if r.trace is None or r.trace.requests == 0:
        return None
    total = sum(r.trace.op_s.values()) - r.trace.kernel_s(HEAD_KERNEL)
    return 1e3 * total / r.trace.requests

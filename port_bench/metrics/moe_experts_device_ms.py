"""The expert kernel's device time a request (both of its launches in every
MoE layer), from the profiler's trace by kernel name; nothing where the
trace holds no such kernel."""

EXPERT_KERNEL = "moe_experts_kernel"


def read(r):
    if r.trace is None or r.trace.requests == 0:
        return None
    seconds = r.trace.kernel_s(EXPERT_KERNEL)
    return 1e3 * seconds / r.trace.requests if seconds > 0 else None

"""The expert kernel's share of its roofline: its bound a request (the larger
of its FLOPs over 989 TFLOP/s in bf16 and its bytes over 3.35 TB/s, counted
from the published widths by ``models/<config>.py``'s ``expert_work``: the
gate, up and down products of the routed rows in every MoE layer, each
expert weight and token activation moved once) over its device time a
request in the profiler's trace, by kernel name. Nothing where the trace
holds no such kernel or the loop gave no bound."""

EXPERT_KERNEL = "moe_experts_kernel"


def read(r):
    bound = getattr(r, "expert_bound_s", None)
    if r.trace is None or r.trace.requests == 0 or not bound:
        return None
    per_request = r.trace.kernel_s(EXPERT_KERNEL) / r.trace.requests
    return 100.0 * bound / per_request if per_request > 0 else None

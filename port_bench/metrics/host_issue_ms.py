"""Host time a request from the call into the inference function until it
returns, before its outputs are copied to the host: the mean of the
harness's own span around the call, over the untraced half of a traced
run's window (the profiler's cost to the host stays out)."""


def read(r):
    if not r.issue_s:
        return None
    return 1e3 * sum(r.issue_s) / len(r.issue_s)

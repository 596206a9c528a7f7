"""Rows whose outputs reached the host in the measured window, over the
window's seconds (host clock): every completed request of the window."""


def read(r):
    return r.rows / r.window_s if r.window_s > 0 else 0.0

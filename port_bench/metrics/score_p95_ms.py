"""The 95th percentile, over every request of the measured window, of one
request's time from the call into the inference function until its
outputs are numpy arrays on the host (host clock); infinite where no
request completed."""

import math

import numpy as np


def read(r):
    return float(np.percentile(r.latency_s, 95)) * 1e3 if r.latency_s else math.inf

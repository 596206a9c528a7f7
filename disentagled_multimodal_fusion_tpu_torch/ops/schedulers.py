"""Annealing schedulers as pure functions of the iteration counter.

Counterpart of ``disentagled_multimodal_fusion_tpu/ops/schedulers.py``
(reference: utils.py:10-42, LinearScheduler / ExponentialScheduler). The
iteration is a Python int (the global step); the arithmetic is float32, as
in the JAX package, and the value comes back as a Python float.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def linear_schedule(iteration: int, start_value: float, end_value: float, n_iterations: int,
                    start_iteration: int = 0) -> float:
    """Linear ramp from start_value to end_value over n_iterations."""
    m = _F32((end_value - start_value) / n_iterations)
    it = _F32(iteration)
    if it <= start_iteration:
        return float(_F32(start_value))
    if it > start_iteration + n_iterations:
        return float(_F32(end_value))
    return float((it - _F32(start_iteration)) * m + _F32(start_value))


def exponential_schedule(iteration: int, start_value: float, end_value: float,
                         n_iterations: int, start_iteration: int = 0,
                         base: float = 10.0) -> float:
    """Log-space linear ramp: base ** linear(log_base(start) -> log_base(end))."""
    if start_value <= 0 or end_value <= 0:
        # the reference crashes at math.log(0) (utils.py:35), e.g. with
        # DisentangledSSL's default lmd_start_value=0 and lmd_end_value>0
        raise ValueError(
            f"exponential_schedule needs start_value and end_value > 0 "
            f"(got {start_value}, {end_value}); the log-space ramp is "
            f"undefined at 0 — use a small positive start (e.g. 1e-4) or "
            f"linear_schedule"
        )
    lin = linear_schedule(iteration, math.log(start_value, base), math.log(end_value, base),
                          n_iterations, start_iteration)
    return float(_F32(base) ** _F32(lin))

"""Stirling-series gammaln / digamma / trigamma from elementwise ops.

Counterpart of ``disentagled_multimodal_fusion_tpu/ops/special.py``. The
probe-epoch kernel (``csrc/probe_epoch.cu``) evaluates these series on the
card, and its hand-derived backward differentiates the series themselves
(not the library ``lgamma``/``digamma``), as ``jax.value_and_grad`` does
inside the TPU kernel. ``run_epoch_plain`` uses these functions under
autograd, so the plain version and the kernel share one arithmetic.

Domain: x >= 1 (alpha = evidence + 1 and its row sums, up to ~7e14). The
argument is shifted by 8 by recurrence, so the asymptotic series runs at
z = x + 8 >= 9. The functions keep the input's dtype (float32 on the path;
float64 for a reference evaluation).
"""

from __future__ import annotations

import math

import torch

_SHIFT = 8
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def gammaln_stirling(x: torch.Tensor) -> torch.Tensor:
    """log Gamma(x) = gammaln(x + 8) - sum_{k<8} log(x + k), with the
    Stirling series at z = x + 8:
    (z-1/2) log z - z + log(2 pi)/2 + 1/(12 z) - 1/(360 z^3) + 1/(1260 z^5).
    Its derivative is algebraically :func:`digamma_stirling`."""
    z = x + _SHIFT
    # a sum of logs, not the log of a product: the product overflows float32
    # for the saturated evidence (x ~ 1e13 -> prod ~ 1e104)
    shift_logs = torch.zeros_like(x)
    for k in range(_SHIFT):
        shift_logs = shift_logs + torch.log(x + k)
    rz = 1.0 / z
    rz2 = rz * rz
    series = rz * (1.0 / 12.0 + rz2 * (-1.0 / 360.0 + rz2 * (1.0 / 1260.0)))
    return (z - 0.5) * torch.log(z) - z + _HALF_LOG_2PI + series - shift_logs


def digamma_stirling(x: torch.Tensor) -> torch.Tensor:
    """psi(x) = psi(x + 8) - sum_{k<8} 1/(x + k), with the series at z = x + 8:
    log z - 1/(2z) - 1/(12 z^2) + 1/(120 z^4) - 1/(252 z^6)."""
    z = x + _SHIFT
    shift_recip = torch.zeros_like(x)
    for k in range(_SHIFT):
        shift_recip = shift_recip + 1.0 / (x + k)
    rz = 1.0 / z
    rz2 = rz * rz
    series = rz2 * (-1.0 / 12.0 + rz2 * (1.0 / 120.0 - rz2 * (1.0 / 252.0)))
    return torch.log(z) - 0.5 * rz + series - shift_recip


def trigamma_stirling(x: torch.Tensor) -> torch.Tensor:
    """The exact derivative of :func:`digamma_stirling` as written:
    1/z + 1/(2z^2) + 1/(6z^3) - 1/(30z^5) + 1/(42z^7) + sum_{k<8} 1/(x+k)^2,
    z = x + 8."""
    z = x + _SHIFT
    shift_sq = torch.zeros_like(x)
    for k in range(_SHIFT):
        r = 1.0 / (x + k)
        shift_sq = shift_sq + r * r
    rz = 1.0 / z
    rz2 = rz * rz
    series = rz + rz2 * (0.5 + rz * (1.0 / 6.0 + rz2 * (-1.0 / 30.0 + rz2 * (1.0 / 42.0))))
    return series + shift_sq

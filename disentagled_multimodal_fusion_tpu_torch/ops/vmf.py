"""Von Mises-Fisher sampling on the hypersphere, with the draw split from
the rotation.

Counterpart of ``disentagled_multimodal_fusion_tpu/ops/vmf.py``
(reference: models/classifiers.py:281-441): Wood's (1994) rejection
sampler for the marginal w = <x, mu>, with the Taylor-blended envelope
parameter for kappa in (10, 11), then a Householder rotation from the north
pole onto ``loc``.

The sampled w depends only on kappa and m, never on ``loc``, and the
tangent direction v is plain normal noise; only the rotation uses ``loc``,
and the gradient flows only through it. So the draw is separate here:
:func:`sample_w` makes w for many rows at once (a fit draws a whole epoch's
w in one call, outside autograd), and :func:`vmf_rotate` turns (w, v) into
the sample on ``loc``. A test can hand in the JAX package's w and v.

The rejection loop runs on the device in blocks: each block draws
``rounds`` proposals for every row still pending and keeps, per row, the
first accepted one. That is exact rejection sampling (proposals are iid, and
a row takes its first acceptance); no row ever gets a w that was not
accepted, and the rounds are not capped. The only host syncs are one count
of the pending rows per block, and one index of them when some are left;
:func:`sample_w` returns how many it made.

The proposal's e ~ Beta((m-1)/2, (m-1)/2) is built as e = X / (X + Y)
with X, Y independent chi-square variables of m - 1 degrees of freedom,
each the sum of m - 1 squared standard normals: Gamma((m-1)/2, 1) is half
such a chi-square, and Beta(a, a) = G1 / (G1 + G2). It is exact for every
integer m >= 2 and needs only ``torch.randn`` on the fit's generator, on
any device. The uniform u lies in [1e-20, 1), as the JAX package draws it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

EPS = 1e-20


def sample_w3(u: torch.Tensor, scale) -> torch.Tensor:
    """Closed-form w for m == 3 from uniforms u (classifiers.py:337-347)."""
    stacked = torch.stack([torch.log(u), torch.log1p(-u) - 2.0 * scale], dim=0)
    return 1.0 + torch.logsumexp(stacked, dim=0) / scale


def wood_constants(scale: torch.Tensor, m: int):
    """(b, a, d) of Wood's envelope for concentration ``scale``, with the
    Taylor blend of b for kappa in (10, 11) (classifiers.py:349-380)."""
    c = torch.sqrt(4.0 * scale ** 2 + (m - 1) ** 2)
    b_true = (-2.0 * scale + c) / (m - 1)
    b_app = (m - 1) / (4.0 * scale)
    s = torch.clamp(scale - 10.0, 0.0, 1.0)
    b = b_app * s + b_true * (1.0 - s)
    a = (m - 1 + 2.0 * scale + c) / 4.0
    d = (4.0 * a * b) / (1.0 + b) - (m - 1) * math.log(m - 1)
    return b, a, d


def _proposals(randomness, shape, m: int):
    """Beta((m-1)/2, (m-1)/2) proposals e and uniforms u of ``shape``."""
    z = randomness.normal((*shape, 2, m - 1))
    chi2 = torch.sum(z * z, dim=-1)
    e = chi2[..., 0] / (chi2[..., 0] + chi2[..., 1])
    u = randomness.uniform(shape) * (1.0 - EPS) + EPS
    return e, u


def sample_w(randomness, kappa: float, m: int, n: int, rounds: int = 4
             ) -> Tuple[torch.Tensor, int]:
    """(w (n,), host syncs): n draws of the vMF marginal at concentration
    ``kappa`` on the unit sphere in R^m (m >= 3), from ``randomness``
    (``normal`` and ``uniform``), on its device.

    m == 3 takes the closed form (one uniform per row, no sync); otherwise
    Wood's rejection sampler in blocks of ``rounds`` proposals per pending
    row (module docstring)."""
    device = randomness.device
    scale = torch.full((), float(kappa), dtype=torch.float32, device=device)
    if m == 3:
        return sample_w3(randomness.uniform((n,)) * (1.0 - EPS) + EPS, scale), 0
    b, a, d = wood_constants(scale, m)
    w = torch.empty(n, dtype=torch.float32, device=device)
    pending = torch.arange(n, device=device)
    syncs = 0
    while pending.numel():
        e, u = _proposals(randomness, (rounds, pending.numel()), m)
        w_prop = (1.0 - (1.0 + b) * e) / (1.0 - (1.0 - b) * e)
        t = (2.0 * a * b) / (1.0 - (1.0 - b) * e)
        accept = ((m - 1.0) * torch.log(t) - t + d) > torch.log(u)
        first = torch.argmax(accept.float(), dim=0)  # the first accepted round
        got = torch.any(accept, dim=0)
        taken = torch.gather(w_prop, 0, first[None])[0]
        left = int(torch.count_nonzero(~got))
        syncs += 1
        if left == 0:
            w[pending] = taken
            break
        w[pending] = torch.where(got, taken, w[pending])
        pending = pending[~got]
        syncs += 1
    return w, syncs


def householder_rotation(x: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Rotate north-pole-aligned samples onto loc (classifiers.py:433-437)."""
    e1 = torch.zeros_like(loc)
    e1[..., 0] = 1.0
    u = e1 - loc
    u = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-5)
    return x - 2.0 * torch.sum(x * u, dim=-1, keepdim=True) * u


def vmf_rotate(w: torch.Tensor, v: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """The reparameterised vMF sample on ``loc`` (B, m) (unit rows) from its
    marginal w (B,) or (B, 1) and normal noise v (B, m - 1); the gradient
    flows through ``loc`` only, as in the reference's rsample."""
    w = w.reshape(*loc.shape[:-1], 1)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    w_tangent = torch.sqrt(torch.clamp(1.0 - w ** 2, min=1e-10))
    return householder_rotation(torch.cat([w, w_tangent * v], dim=-1), loc)

"""The closed-form backward of the probe-epoch kernel's loss, in float64.

``csrc/probe_epoch.cu``'s loss kernel does not differentiate: it evaluates
dL/dz written out by hand (the formula in the source's header note), one
warp per (row, view) with the classes across lanes. This file writes that
formula out again in float64, in the kernel's layout (per-row scalars,
per-class terms, the DC term through pd_ij, Gp_c and Gu), and holds it
against ``torch.autograd`` through ``_avg_trusted_loss_2d`` and the clip and
saturated evidence that end ``_stacked_forward``
(``ops/probe_megakernel.py``), in float64 at rtol 1e-9 (atol 1e-12 of the
largest entry): both sides then differ only in float64 rounding.

Every case has a ragged row mask, logits at exactly +10 and -10 (the clip's
gradient of 0.5) and beyond, a labelled row with y all zeros and, from two
views on, two views equal on one row (the +1 gradient of |p_i - p_j| at 0).
"""

import math

import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu_torch.ops.evidence import LOG1E13, clip_jax
from disentagled_multimodal_fusion_tpu_torch.ops.probe_megakernel import (
    DC_EPS,
    _avg_trusted_loss_2d,
)
from disentagled_multimodal_fusion_tpu_torch.ops.special import (
    digamma_stirling,
    gammaln_stirling,
    trigamma_stirling,
)

COEF, GAMMA_T, FUSED = 0.4, 0.68, 1.0
B = 10


def _inputs(v, c, seed):
    """z (V, B, C), one-hot yoh (B, C) and rmask (B, 1), float64."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((v, B, c)) * 4.0
    z[0, 0, 0] = 10.0        # the clip's ties
    z[-1, 1, c - 1] = -10.0
    z[0, 2, 1] = 12.5        # beyond the clip: no gradient
    if v >= 2:
        z[1, 3] = z[0, 3]    # two equal views: |p_0 - p_1| = 0 on every class
    yoh = np.eye(c)[rng.integers(0, c, B)]
    yoh[0] = np.eye(c)[0]    # the saturated logit on the label (well conditioned)
    yoh[4] = 0.0             # a row with y all zeros, still in the mask
    rmask = np.ones((B, 1))
    rmask[-3:] = 0.0         # the ragged tail
    return (torch.from_numpy(z), torch.from_numpy(yoh), torch.from_numpy(rmask))


def _evidence(zc):
    """The kernel's ``evidence``: exp(zc + L - logaddexp(zc, L))."""
    lse = torch.clamp(zc, min=LOG1E13) + torch.log1p(torch.exp(-(zc - LOG1E13).abs()))
    return torch.exp(zc + LOG1E13 - lse)


def closed_form(z, yoh, rmask):
    """(loss, dL/dz) as the loss kernel evaluates them."""
    v, _, c = z.shape
    zc = torch.clamp(z, -10.0, 10.0)
    e = _evidence(zc)
    a = e + 1.0
    y = yoh[None]                                                   # (1, B, C)
    # per-row scalars: one warp reduction each
    s = a.sum(-1, keepdim=True)                                     # (V, B, 1)
    se = s + DC_EPS
    kl = (a - 1.0) * (1.0 - y) + 1.0
    skl = kl.sum(-1, keepdim=True)
    t = (kl - 1.0).sum(-1, keepdim=True)
    yy = y.sum(-1, keepdim=True)
    # per-class terms: one lane each
    a_term = (y * (digamma_stirling(s) - digamma_stirling(a))).sum(-1, keepdim=True)
    first = (gammaln_stirling(skl) - gammaln_stirling(kl).sum(-1, keepdim=True)
             - math.lgamma(float(c)))
    second = ((kl - 1.0) * (digamma_stirling(kl) - digamma_stirling(skl))).sum(-1, keepdim=True)
    dedl = (yy * trigamma_stirling(s) - y * trigamma_stirling(a)
            + COEF * (1.0 - y) * ((kl - 1.0) * trigamma_stirling(kl) - t * trigamma_stirling(skl)))
    # the DC term couples the views of a row
    p = a / se
    u = c / se
    gp = torch.zeros_like(a)
    gu = torch.zeros_like(s)
    dc_rows = torch.zeros_like(s)
    for i in range(v):
        for j in range(v):
            if j == i:
                continue
            pd = 0.5 * (p[i] - p[j]).abs().sum(-1, keepdim=True)
            if j > i:
                dc_rows[i] += 2.0 * pd * ((1.0 - u[i]) * (1.0 - u[j]))
            # d|p_lo - p_hi| / dp_i in pair order, +1 at a tie
            lo, hi = min(i, j), max(i, j)
            sign = torch.where(p[lo] - p[hi] >= 0, 1.0, -1.0).to(p.dtype)
            gp[i] += ((1.0 - u[i]) * (1.0 - u[j])) * (sign if i == lo else -sign)
            gu[i] += -2.0 * pd * (1.0 - u[j])
    gpa = (gp * a).sum(-1, keepdim=True)
    ddc = gp / se - (gpa + c * gu) / (se * se)
    # the masked means, as the loss kernel's scales
    rb = rmask[None]
    msum = float(rmask.sum())
    edl_sum = ((a_term + COEF * (first + second)) * rb).sum()
    dc_sum = (dc_rows / max(1, v - 1) * rb).sum()
    loss = edl_sum / max(msum * v, 1.0) / v + GAMMA_T * (dc_sum / max(msum, 1.0)) * FUSED
    ke = rb / max(msum * v, 1.0) / v
    kd = GAMMA_T * FUSED / max(1, v - 1) / max(msum, 1.0) * rb
    dalpha = ke * dedl + kd * ddc
    # back through the saturated evidence and the clip (0.5 at exactly +-10)
    sig = 1.0 / (1.0 + torch.exp(zc - LOG1E13))
    clip_grad = torch.where(z.abs() < 10.0, 1.0, torch.where(z.abs() == 10.0, 0.5, 0.0))
    return loss, dalpha * e * sig * clip_grad.to(z.dtype)


def autograd_reference(z, yoh, rmask):
    """(loss, dL/dz) by autograd: the tail of ``_stacked_forward`` (clip with
    JAX's gradient, saturated evidence), then ``_avg_trusted_loss_2d``."""
    z = z.clone().requires_grad_()
    zc = clip_jax(z)
    evs = torch.exp(zc + LOG1E13 - torch.logaddexp(zc, torch.full_like(zc, LOG1E13)))
    loss = _avg_trusted_loss_2d(evs, yoh, rmask, COEF, GAMMA_T, FUSED, z.shape[-1])
    (grad,) = torch.autograd.grad(loss, z)
    return loss.detach(), grad


@pytest.mark.parametrize("c", [5, 10, 68])
@pytest.mark.parametrize("v", [1, 2, 3, 8])
def test_closed_form_backward_matches_autograd(v, c):
    z, yoh, rmask = _inputs(v, c, seed=10 * v + c)
    loss, grad = closed_form(z, yoh, rmask)
    ref_loss, ref_grad = autograd_reference(z, yoh, rmask)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-9)
    # an entry whose terms cancel to ~1e-5 of the largest carries their
    # float64 rounding (~1e-16 of the largest), hence the atol at 1e-12 of it
    scale = float(ref_grad.abs().max())
    np.testing.assert_allclose(grad.numpy(), ref_grad.numpy(), rtol=1e-9, atol=1e-12 * scale)
    # the cases reach what they are meant to
    assert float(grad[0, 0, 0]) != 0.0                      # +10: half the gradient
    assert float(grad[0, 2, 1]) == 0.0                      # beyond the clip
    assert not bool(grad[:, -3:].any())                     # masked rows
    if v >= 2:
        assert torch.equal(z[0, 3], z[1, 3])

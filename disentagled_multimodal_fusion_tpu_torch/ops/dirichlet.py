"""Dirichlet / evidential-deep-learning math.

Counterpart of ``disentagled_multimodal_fusion_tpu/ops/dirichlet.py``: the
EDL digamma loss with its annealed KL regulariser, the Dirichlet
KL-to-uniform, the disagreement-consistency (DC) loss, the multi-view
AvgTrusted criterion, the one-head EDL loss of intermediate fusion and the
epistemic/aleatoric decomposition.

Every loss takes an optional {0, 1} row ``mask`` (B,), so that a padded
batch gives the same means as a ragged one. The math runs in float32 with
the library ``torch.special.digamma`` / ``torch.lgamma``, as the JAX
package's step path uses ``jax.scipy.special``. ``abs`` has JAX's gradient
at 0 (``ops/evidence.abs_jax``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .evidence import abs_jax


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of ``x`` over axis 0, restricted to rows where ``mask`` is 1."""
    if mask is None:
        return torch.mean(x)
    mask = mask.to(x.dtype)
    m = mask.reshape((mask.shape[0],) + (1,) * (x.dim() - 1))
    denom = torch.sum(mask) * (x.numel() / x.shape[0])
    return torch.sum(x * m) / torch.clamp(denom, min=1.0)


def dirichlet_kl_to_uniform(alpha: torch.Tensor, num_classes: int) -> torch.Tensor:
    """KL( Dir(alpha) || Dir(1, ..., 1) ) per row: alpha (B, C) -> (B, 1)."""
    alpha = alpha.float()
    sum_alpha = torch.sum(alpha, dim=1, keepdim=True)
    first = (
        torch.lgamma(sum_alpha)
        - torch.sum(torch.lgamma(alpha), dim=1, keepdim=True)
        - math.lgamma(float(num_classes))
    )
    second = torch.sum(
        (alpha - 1.0) * (torch.special.digamma(alpha) - torch.special.digamma(sum_alpha)),
        dim=1, keepdim=True,
    )
    return first + second


def edl_digamma_loss(alpha, target_onehot, annealing_step, num_classes: int,
                     annealing_start: float, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Digamma-form EDL loss, mean over rows: ``A = sum_c y_c (psi(S) -
    psi(alpha_c))`` plus ``min(1, step / start)`` times KL( Dir(alpha~) ||
    Dir(1) ), ``alpha~ = (alpha - 1)(1 - y) + 1``."""
    alpha = alpha.float()
    y = target_onehot.float()
    s = torch.sum(alpha, dim=1, keepdim=True)
    a_term = torch.sum(
        y * (torch.special.digamma(s) - torch.special.digamma(alpha)), dim=1, keepdim=True
    )
    coef = min(1.0, float(annealing_step) / float(annealing_start))
    kl_alpha = (alpha - 1.0) * (1.0 - y) + 1.0
    kl = coef * dirichlet_kl_to_uniform(kl_alpha, num_classes)
    return _masked_mean(a_term + kl, mask)


def dc_loss(evidences: torch.Tensor, eps: float = 1e-8,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Disagreement-consistency loss of (B, V, C) evidences -> scalar."""
    evidences = evidences.float()
    _, v, c = evidences.shape
    alpha = evidences + 1.0
    s = torch.sum(alpha, dim=-1, keepdim=True)
    p = alpha / (s + eps)
    u = (c / (s + eps))[..., 0]                                        # (B, V)
    pd = 0.5 * torch.sum(abs_jax(p[:, :, None, :] - p[:, None, :, :]), dim=-1)
    one_minus_u = 1.0 - u
    cc = one_minus_u[:, :, None] * one_minus_u[:, None, :]
    dc_per_i = torch.sum(pd * cc, dim=2) / max(1, v - 1)               # (B, V)
    return _masked_mean(torch.sum(dc_per_i, dim=1), mask)


def avg_trusted_loss(evidences, target, evidence_a, annealing_step, num_views: int,
                     annealing_start: float = 50.0, fused: float = 1.0,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-view trusted EDL criterion:
    ``mean_{B,V}(EDL per view) / V + gamma_t * DC * fused`` with
    ``gamma_t = 0.2 (1 - t) + t``, ``t = min(1, step / max(1, start))`` (the
    reference's gamma = 1).

    Two quirks of the reference are kept: the extra ``/ V`` after the mean
    over B*V rows, and the fused-branch EDL term, which the reference
    computes but never adds, is not computed (``evidence_a`` is unused).
    """
    del evidence_a
    b, v, c = evidences.shape
    if v != num_views:
        raise ValueError(f"evidences have {v} views, expected {num_views}")
    # a comparison, not F.one_hot, whose range check waits for the device
    target_onehot = (target.long()[:, None] == torch.arange(c, device=target.device)).float()
    alpha_flat = (evidences.float() + 1.0).reshape(b * v, c)
    target_flat = torch.repeat_interleave(target_onehot, v, dim=0)
    mask_flat = None if mask is None else torch.repeat_interleave(mask, v, dim=0)
    loss_acc = edl_digamma_loss(
        alpha_flat, target_flat, annealing_step, c, annealing_start, mask=mask_flat
    ) / v
    t = min(1.0, float(annealing_step) / max(1.0, float(annealing_start)))
    gamma_t = 0.2 * (1.0 - t) + t
    return loss_acc + gamma_t * dc_loss(evidences, mask=mask) * fused


def single_evidential_loss(evidence, target, annealing_step, annealing_start: float = 50.0,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-head EDL loss of (B, C) evidence (reference: losses.py:250-272)."""
    c = evidence.shape[-1]
    target_onehot = (target.long()[:, None] == torch.arange(c, device=target.device)).float()
    return edl_digamma_loss(evidence.float() + 1.0, target_onehot, annealing_step, c,
                            annealing_start, mask=mask)


def dirichlet_uncertainties(evidence: torch.Tensor, num_classes: int):
    """Epistemic / aleatoric decomposition of (B, C) evidence.

    With ``alpha = evidence + 1`` and ``S = sum(alpha)``: epistemic ``K / S``
    and aleatoric ``-sum_c p_c (digamma(alpha_c + 1) - digamma(S + 1))``,
    each (B,).
    """
    alphas = evidence.float() + 1.0
    s = torch.sum(alphas, dim=-1, keepdim=True)
    probs = alphas / s
    epistemic = (num_classes / s)[..., 0]
    aleatoric = -torch.sum(
        probs * (torch.special.digamma(alphas + 1.0) - torch.special.digamma(s + 1.0)),
        dim=-1,
    )
    return epistemic, aleatoric

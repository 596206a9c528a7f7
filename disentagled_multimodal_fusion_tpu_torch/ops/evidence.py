"""Evidence activation and Dirichlet-evidence fusion rules.

Counterpart of ``disentagled_multimodal_fusion_tpu/ops/evidence.py``: the
same functions over a stacked ``(B, V, C)`` evidence tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the constants and the saturated exponential are defined once, in the
# operator's file (which stands alone for replaying exported programs)
from .head_op import CLIP, LOG1E13, saturated_exp


class _ClipJax(torch.autograd.Function):
    """``clamp(x, -10, 10)`` with JAX's gradient for ``jnp.clip``: 1 strictly
    inside, 0.5 at exactly +-10, 0 outside (torch's clamp gives 1 at the
    bounds). Written with ``setup_context`` so that ``torch.func``'s grad and
    vmap (the seed-batched trainer) can run it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.clamp(x, -CLIP, CLIP)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        a = x.abs()
        return grad * torch.where(a < CLIP, 1.0, torch.where(a == CLIP, 0.5, 0.0)).to(grad.dtype)


class _AbsJax(torch.autograd.Function):
    """``abs(x)`` with JAX's gradient: +1 at 0 (torch's gives 0)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x.abs()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, -grad)


def clip_jax(x: torch.Tensor) -> torch.Tensor:
    return _ClipJax.apply(x)


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    return _AbsJax.apply(x)


def evidence_activation(h: torch.Tensor, activation: str = "exp") -> torch.Tensor:
    """Map raw head outputs to non-negative Dirichlet evidence.

    ``exp`` is the saturated exponential ``exp(h) * 1e13 / (exp(h) + 1e13)``
    with ``h`` clamped to [-10, 10] (with JAX's gradient at the bounds),
    evaluated in log space.
    """
    if activation == "softplus":
        return F.softplus(h)
    return saturated_exp(clip_jax(h))


def cml_fusion(all_evidences: torch.Tensor) -> torch.Tensor:
    """Cumulative fusion: sum of per-view evidences."""
    return torch.sum(all_evidences, dim=1)


def avg_fusion(all_evidences: torch.Tensor) -> torch.Tensor:
    """Average fusion: mean of per-view evidences."""
    return torch.mean(all_evidences, dim=1)


def disentangled_fusion(all_evidences: torch.Tensor, shared_index: int = 0) -> torch.Tensor:
    """Sum of evidences excluding the shared view."""
    return torch.sum(all_evidences, dim=1) - all_evidences[:, shared_index, :]


def joint_fusion(
    all_evidences: torch.Tensor, shared_index: int = 0, shared_weight: float = 0.5
) -> torch.Tensor:
    """``w * shared + (1-w) * sum(private)``."""
    shared = all_evidences[:, shared_index, :]
    disentangled = torch.sum(all_evidences, dim=1) - shared
    return shared_weight * shared + (1.0 - shared_weight) * disentangled


def discounted_belief_fusion(all_evidences: torch.Tensor, flambda: float = 3.0) -> torch.Tensor:
    """Conflict-aware discounted belief fusion, vectorised over views.

    Each view's belief is discounted by its pairwise disagreement with the
    other views, uncertainty is renormalised so that ``sum(belief) + u == 1``,
    and the discounted evidences are averaged. The divisions by ``S`` are
    exact (no epsilon), as in the JAX package.
    """
    num_classes = all_evidences.shape[-1]
    denominator = torch.sum(all_evidences + 1.0, dim=-1, keepdim=True)  # (B, V, 1)
    prob = (all_evidences + 1.0) / denominator
    belief = all_evidences / denominator
    uncertainty = num_classes / denominator
    cp = 0.5 * torch.sum(torch.abs(prob[:, :, None, :] - prob[:, None, :, :]), dim=-1)
    one_minus_u = 1.0 - uncertainty[..., 0]
    cc = one_minus_u[:, :, None] * one_minus_u[:, None, :]
    dc = cp * cc
    agreement = torch.prod((1.0 - dc**flambda) ** (1.0 / flambda), dim=2)  # (B, V)
    discount = agreement[..., None]
    belief = belief * discount
    uncertainty = uncertainty * discount + 1.0 - discount
    discounted_evidence = num_classes * belief / (uncertainty + 1e-6)
    return torch.mean(discounted_evidence, dim=1)


AGGREGATIONS = {
    "cml": cml_fusion,
    "avg": avg_fusion,
    "joint": joint_fusion,
    "disentangled": disentangled_fusion,
    "dbf": discounted_belief_fusion,
}

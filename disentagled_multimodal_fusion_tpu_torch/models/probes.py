"""Evidential probes over frozen backbone embeddings.

Counterpart of ``disentagled_multimodal_fusion_tpu/models/probes.py``:

* ``EvidentialProbe`` / ``FusedEvidentialProbe``: 1 shared + N private
  evidential heads on (Zc, [Zp_i]); evidence (B, 1+N, C).
* ``DisentangledEvidentialProbe`` / ``FusedDisentangledEvidentialProbe``:
  N private heads; evidence (B, N, C).

The fused variants stack their heads into one :class:`StackedMLP`. In an
eval forward with one hidden layer, the configured one, they run all heads
through the evidential head kernel (``ops/cuda_kernels.py``) in one launch,
its bf16 build when the heads compute in bf16 (``dtype``; the evidence is
float32 in both, JAX lines 127 and 152).
That kernel has no backward, so a training forward (dropout masks given, or
a gradient wanted) takes the differentiable plain path. The unfused
variants are eval-only here (training runs the fused ones).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.cuda_kernels import evidential_heads_stacked, evidential_heads_stacked_bf16
from ..ops.evidence import evidence_activation
from .dmvae_fused import StackedMLP, pad_stack
from .layers import EvidentialNN


def _wants_grad(stack: StackedMLP, x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in stack.parameters())
    )


def stacked_evidence(stack: StackedMLP, x: torch.Tensor, drop_masks=None,
                     keep: float = 1.0) -> torch.Tensor:
    """Evidence (B, V, C) of the stacked heads on x (B, V, D): through the
    kernel (its bf16 build for bf16 heads) for an eval forward of
    one-hidden-layer heads, else layer by layer (differentiable, with the
    dropout masks when given)."""
    if stack.num_layers == 2 and drop_masks is None and not _wants_grad(stack, x):
        (w1, b1), (w2, b2) = stack.layer(0), stack.layer(1)
        heads = evidential_heads_stacked if stack.dtype is None else evidential_heads_stacked_bf16
        return heads(x.transpose(0, 1), w1, b1, w2, b2)
    return evidence_activation(stack(x, drop_masks, keep))


class EvidentialProbe(nn.Module):
    """Shared + per-modality evidential heads, one module each."""

    def __init__(self, num_modalities: int, num_classes: int, input_dim: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,),
                 shared_input_dim: Optional[int] = None, dtype=None):
        super().__init__()
        hidden = tuple(hidden_dim)
        self.x_shared = EvidentialNN(
            (shared_input_dim or input_dim, *hidden), num_classes, generator, dtype=dtype
        )
        self.x_specs = nn.ModuleList(
            EvidentialNN((input_dim, *hidden), num_classes, generator, dtype=dtype)
            for _ in range(num_modalities)
        )

    def forward(self, zc, zp_list):
        """zc (B, Ds); zp_list N x (B, D). Returns (B, 1+N, C)."""
        evid = [self.x_shared(zc)] + [head(z) for head, z in zip(self.x_specs, zp_list)]
        return torch.stack(evid, dim=1)


class DisentangledEvidentialProbe(nn.Module):
    """Private-only evidential heads, one module each."""

    def __init__(self, num_modalities: int, num_classes: int, input_dim: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,), dtype=None):
        super().__init__()
        self.spec_heads = nn.ModuleList(
            EvidentialNN((input_dim, *tuple(hidden_dim)), num_classes, generator, dtype=dtype)
            for _ in range(num_modalities)
        )

    def forward(self, zp_list):
        """zp_list N x (B, D). Returns (B, N, C)."""
        return torch.stack([head(z) for head, z in zip(self.spec_heads, zp_list)], dim=1)


class FusedEvidentialProbe(nn.Module):
    """EvidentialProbe with its 1+N heads stacked. ``drop_masks`` (one
    boolean (B, 1+N, hidden) keep-mask per hidden layer) turns dropout on
    at rate ``dropout``."""

    def __init__(self, num_modalities: int, num_classes: int, input_dim: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,),
                 shared_input_dim: Optional[int] = None, dropout: float = 0.3, dtype=None):
        super().__init__()
        in_dims = (shared_input_dim or input_dim,) + (input_dim,) * num_modalities
        self.keep = 1.0 - dropout
        self.stack = StackedMLP(
            in_dims, tuple(hidden_dim), (num_classes,) * len(in_dims), generator, dtype
        )

    def forward(self, zc, zp_list, drop_masks=None):
        """zc (B, Ds); zp_list N x (B, D). Returns (B, 1+N, C)."""
        return stacked_evidence(self.stack, pad_stack([zc, *zp_list]), drop_masks, self.keep)


class FusedDisentangledEvidentialProbe(nn.Module):
    """Private-only variant of :class:`FusedEvidentialProbe`."""

    def __init__(self, num_modalities: int, num_classes: int, input_dim: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,),
                 dropout: float = 0.3, dtype=None):
        super().__init__()
        self.keep = 1.0 - dropout
        self.stack = StackedMLP(
            (input_dim,) * num_modalities, tuple(hidden_dim),
            (num_classes,) * num_modalities, generator, dtype,
        )

    def forward(self, zp_list, drop_masks=None):
        """zp_list N x (B, D). Returns (B, N, C)."""
        return stacked_evidence(self.stack, pad_stack(zp_list), drop_masks, self.keep)

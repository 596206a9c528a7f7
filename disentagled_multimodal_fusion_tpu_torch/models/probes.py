"""Evidential probes over frozen backbone embeddings (eval mode).

Counterpart of ``disentagled_multimodal_fusion_tpu/models/probes.py``:

* ``EvidentialProbe`` / ``FusedEvidentialProbe``: 1 shared + N private
  evidential heads on (Zc, [Zp_i]); evidence (B, 1+N, C).
* ``DisentangledEvidentialProbe`` / ``FusedDisentangledEvidentialProbe``:
  N private heads; evidence (B, N, C).

The fused variants stack their heads into one :class:`StackedMLP`. With one
hidden layer, the configured one, they run all heads through the evidential
head kernel (``ops/cuda_kernels.py``) in one launch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.cuda_kernels import evidential_heads_stacked
from ..ops.evidence import evidence_activation
from .dmvae_fused import StackedMLP, pad_stack
from .layers import EvidentialNN


def stacked_evidence(stack: StackedMLP, x: torch.Tensor) -> torch.Tensor:
    """Evidence (B, V, C) of the stacked heads on x (B, V, D): through the
    kernel when the heads have one hidden layer, else layer by layer."""
    if stack.num_layers == 2:
        (w1, b1), (w2, b2) = stack.layer(0), stack.layer(1)
        return evidential_heads_stacked(x.transpose(0, 1), w1, b1, w2, b2)
    return evidence_activation(stack(x))


class EvidentialProbe(nn.Module):
    """Shared + per-modality evidential heads, one module each."""

    def __init__(self, num_modalities: int, num_classes: int, input_dim: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,),
                 shared_input_dim: Optional[int] = None):
        super().__init__()
        hidden = tuple(hidden_dim)
        self.x_shared = EvidentialNN(
            (shared_input_dim or input_dim, *hidden), num_classes, generator
        )
        self.x_specs = nn.ModuleList(
            EvidentialNN((input_dim, *hidden), num_classes, generator)
            for _ in range(num_modalities)
        )

    def forward(self, zc, zp_list):
        """zc (B, Ds); zp_list N x (B, D). Returns (B, 1+N, C)."""
        evid = [self.x_shared(zc)] + [head(z) for head, z in zip(self.x_specs, zp_list)]
        return torch.stack(evid, dim=1)


class DisentangledEvidentialProbe(nn.Module):
    """Private-only evidential heads, one module each."""

    def __init__(self, num_modalities: int, num_classes: int, input_dim: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,)):
        super().__init__()
        self.spec_heads = nn.ModuleList(
            EvidentialNN((input_dim, *tuple(hidden_dim)), num_classes, generator)
            for _ in range(num_modalities)
        )

    def forward(self, zp_list):
        """zp_list N x (B, D). Returns (B, N, C)."""
        return torch.stack([head(z) for head, z in zip(self.spec_heads, zp_list)], dim=1)


class FusedEvidentialProbe(nn.Module):
    """EvidentialProbe with its 1+N heads stacked."""

    def __init__(self, num_modalities: int, num_classes: int, input_dim: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,),
                 shared_input_dim: Optional[int] = None):
        super().__init__()
        in_dims = (shared_input_dim or input_dim,) + (input_dim,) * num_modalities
        self.stack = StackedMLP(
            in_dims, tuple(hidden_dim), (num_classes,) * len(in_dims), generator
        )

    def forward(self, zc, zp_list):
        """zc (B, Ds); zp_list N x (B, D). Returns (B, 1+N, C)."""
        return stacked_evidence(self.stack, pad_stack([zc, *zp_list]))


class FusedDisentangledEvidentialProbe(nn.Module):
    """Private-only variant of :class:`FusedEvidentialProbe`."""

    def __init__(self, num_modalities: int, num_classes: int, input_dim: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,)):
        super().__init__()
        self.stack = StackedMLP(
            (input_dim,) * num_modalities, tuple(hidden_dim),
            (num_classes,) * num_modalities, generator,
        )

    def forward(self, zp_list):
        """zp_list N x (B, D). Returns (B, N, C)."""
        return stacked_evidence(self.stack, pad_stack(zp_list))

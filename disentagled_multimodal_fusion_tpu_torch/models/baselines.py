"""Late-fusion evidential baselines.

Counterpart of ``LateFusion`` and ``FusedLateFusion`` in
``disentagled_multimodal_fusion_tpu/models/baselines.py``: one evidential
head per raw view, evidence (B, N, C). The fused variant zero-pads the views
to the widest; its eval forward runs the stacked heads through the
evidential head kernel, its training forward (dropout masks given, or a
gradient wanted) the differentiable plain path. ``LateFusion`` is eval-only
here. ``IntermediateFusion`` and the LUMA feature encoders come with later
slices.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .dmvae_fused import StackedMLP, pad_stack
from .layers import EvidentialNN
from .probes import stacked_evidence


class LateFusion(nn.Module):
    """Per-view evidential heads, one module each."""

    def __init__(self, output_dims: Sequence[int], num_classes: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,)):
        super().__init__()
        self.output_dims = tuple(output_dims)
        self.heads = nn.ModuleList(
            EvidentialNN((d, *tuple(hidden_dim)), num_classes, generator)
            for d in self.output_dims
        )

    def forward(self, xs):
        """xs: N views (B, S_i). Returns (B, N, C)."""
        return torch.stack([head(x.float()) for head, x in zip(self.heads, xs)], dim=1)


class FusedLateFusion(nn.Module):
    """LateFusion with its per-view heads stacked."""

    def __init__(self, output_dims: Sequence[int], num_classes: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,),
                 dropout: float = 0.3):
        super().__init__()
        self.output_dims = tuple(output_dims)
        self.keep = 1.0 - dropout
        self.stack = StackedMLP(
            self.output_dims, tuple(hidden_dim), (num_classes,) * len(self.output_dims),
            generator,
        )

    def forward(self, xs, drop_masks=None):
        """xs: N views (B, S_i); drop_masks: one boolean (B, N, hidden)
        keep-mask per hidden layer in training. Returns (B, N, C)."""
        return stacked_evidence(self.stack, pad_stack(xs), drop_masks, self.keep)

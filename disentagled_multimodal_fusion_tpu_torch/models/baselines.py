"""Late-fusion evidential baselines.

Counterpart of ``LateFusion`` and ``FusedLateFusion`` in
``disentagled_multimodal_fusion_tpu/models/baselines.py``: one evidential
head per raw view, evidence (B, N, C). The fused variant zero-pads the views
to the widest; its eval forward runs the stacked heads through the
evidential head kernel, its training forward (dropout masks given, or a
gradient wanted) the differentiable plain path. ``LateFusion`` is eval-only
here. ``IntermediateFusion`` joins the flat views with a library fusion
(``models/fusions.py``) and puts one evidential head, with dropout, on the
result: evidence (B, C), computed by plain PyTorch as the JAX package
computes it by plain XLA. The LUMA feature encoders come with a later slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .dmvae_fused import StackedMLP, pad_stack
from .fusions import build_fusion
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


class IntermediateFusion(nn.Module):
    """Fusion -> one evidential head (baselines.py:153-194; JAX
    ``models/baselines.py:57-100``). ``fusion`` names a library fusion
    (``fusions.INTERMEDIATE_FUSIONS``; the reference's is ``concat``); the
    head is ``EvidentialNN`` with layers (fused_dim, hidden_dim)."""

    def __init__(self, output_dims: Sequence[int], num_classes: int,
                 generator: torch.Generator, hidden_dim: int = 32, dropout: float = 0.3,
                 fusion: str = "concat", fusion_output_dim: int = 64, fusion_rank: int = 8):
        super().__init__()
        self.output_dims = tuple(output_dims)
        self.fusion, fused_dim = build_fusion(fusion, self.output_dims,
                                              output_dim=fusion_output_dim, rank=fusion_rank,
                                              generator=generator)
        self.head = EvidentialNN((fused_dim, hidden_dim), num_classes, generator, dropout)

    def forward(self, xs, drop_masks=None):
        """xs: N views (B, S_i); drop_masks: the head's boolean (B,
        hidden_dim) keep-mask in training. Returns evidence (B, C)."""
        dtype = self.head.mlp.layers[0].weight.dtype  # float32 data, whatever it came as
        fused = self.fusion([x.to(dtype).reshape(x.shape[0], -1) for x in xs])
        return self.head(fused.reshape(fused.shape[0], -1), drop_masks)

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
computes it by plain XLA. ``dtype`` is the heads' (and not the encoders')
compute type, as the JAX builders set it (``--dtype bfloat16``).

Each model takes ``feature_encoders`` (specs for ``layers.build_encoders``;
JAX lines 21-136): the views go through them first, and ``output_dims`` are
then their output widths. In ``FusedLateFusion`` the encoders' outputs feed
the stacked heads, so its eval forward sends them through the head kernel.
A training forward is given the encoders' keep-masks (``enc_masks``, one
list per encoder); without them the encoders evaluate, with BatchNorm's
running statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .dmvae_fused import StackedMLP, pad_stack
from .fusions import build_fusion
from .layers import Encoded, EvidentialNN, build_encoders, encode_views
from .probes import stacked_evidence


class LateFusion(Encoded):
    """Per-view evidential heads, one module each."""

    def __init__(self, output_dims: Sequence[int], num_classes: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,),
                 feature_encoders=None, dtype=None):
        super().__init__()
        self.output_dims = tuple(output_dims)
        self.feat_encs = build_encoders(feature_encoders, generator)
        self.heads = nn.ModuleList(
            EvidentialNN((d, *tuple(hidden_dim)), num_classes, generator, dtype=dtype)
            for d in self.output_dims
        )

    def forward(self, xs):
        """xs: N views (B, S_i). Returns (B, N, C)."""
        feats = encode_views(self.feat_encs, [x.float() for x in xs])
        return torch.stack([head(x) for head, x in zip(self.heads, feats)], dim=1)


class FusedLateFusion(Encoded):
    """LateFusion with its per-view heads stacked."""

    def __init__(self, output_dims: Sequence[int], num_classes: int,
                 generator: torch.Generator, hidden_dim: Sequence[int] = (32,),
                 dropout: float = 0.3, feature_encoders=None, dtype=None):
        super().__init__()
        self.output_dims = tuple(output_dims)
        self.feat_encs = build_encoders(feature_encoders, generator)
        self.keep = 1.0 - dropout
        self.stack = StackedMLP(
            self.output_dims, tuple(hidden_dim), (num_classes,) * len(self.output_dims),
            generator, dtype,
        )

    def forward(self, xs, drop_masks=None, enc_masks=None):
        """xs: N views (B, S_i); drop_masks: one boolean (B, N, hidden)
        keep-mask per hidden layer in training. Returns (B, N, C)."""
        feats = encode_views(self.feat_encs, [x.float() for x in xs], enc_masks)
        return stacked_evidence(self.stack, pad_stack(feats), drop_masks, self.keep)


class IntermediateFusion(Encoded):
    """Fusion -> one evidential head (baselines.py:153-194; JAX
    ``models/baselines.py:57-100``). ``fusion`` names a library fusion
    (``fusions.INTERMEDIATE_FUSIONS``; the reference's is ``concat``); the
    head is ``EvidentialNN`` with layers (fused_dim, hidden_dim)."""

    def __init__(self, output_dims: Sequence[int], num_classes: int,
                 generator: torch.Generator, hidden_dim: int = 32, dropout: float = 0.3,
                 fusion: str = "concat", fusion_output_dim: int = 64, fusion_rank: int = 8,
                 feature_encoders=None, dtype=None):
        super().__init__()
        self.output_dims = tuple(output_dims)
        self.feat_encs = build_encoders(feature_encoders, generator)
        self.fusion, fused_dim = build_fusion(fusion, self.output_dims,
                                              output_dim=fusion_output_dim, rank=fusion_rank,
                                              generator=generator)
        self.head = EvidentialNN((fused_dim, hidden_dim), num_classes, generator, dropout,
                                 dtype)

    def forward(self, xs, drop_masks=None, enc_masks=None):
        """xs: N views (B, S_i); drop_masks: the head's boolean (B,
        hidden_dim) keep-mask in training. Returns evidence (B, C)."""
        # the views in the parameters' type, float32 (JAX lines 90-93): the
        # fusion runs in it, the head then in its compute type
        dtype = self.head.mlp.layers[0].weight.dtype
        feats = encode_views(self.feat_encs, [x.to(dtype) for x in xs], enc_masks)
        fused = self.fusion([x.reshape(x.shape[0], -1) for x in feats])
        return self.head(fused.reshape(fused.shape[0], -1), drop_masks)

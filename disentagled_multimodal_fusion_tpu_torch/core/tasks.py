"""Task builders, inference half: each model family with its evidence and
aggregation functions.

Counterpart of ``build_dmvae_task``, ``build_probe_task``,
``build_disentangled_probe_task`` and ``build_late_fusion_task`` of
``disentagled_multimodal_fusion_tpu/core/tasks.py``. Parameters live in the
modules, drawn from ``torch.Generator(seed)`` on the CPU and then moved to
the device, so one seed gives the same weights everywhere. Optimizer
configs and loss closures come with the training slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..models.baselines import FusedLateFusion, LateFusion
from ..models.dmvae import DMVAE
from ..models.dmvae_fused import FusedDMVAE
from ..models.probes import (
    DisentangledEvidentialProbe,
    EvidentialProbe,
    FusedDisentangledEvidentialProbe,
    FusedEvidentialProbe,
)
from ..ops.evidence import AGGREGATIONS
from .setup import resolve_device


class EvidentialTask(NamedTuple):
    """An evidential classifier as serving sees it."""

    model: nn.Module
    evidences_fn: Callable  # data dict -> (B, V, C) evidence
    aggregation: Callable   # (B, V, C) -> (B, C)
    num_classes: int


def _build(cls, seed: int, device, **kwargs) -> nn.Module:
    generator = torch.Generator().manual_seed(seed)
    return cls(generator=generator, **kwargs).to(resolve_device(device)).eval()


def build_dmvae_task(
    *,
    output_dim: Sequence[int],
    seed: int = 0,
    hidden_dim: int = 512,
    embed_dim: int = 100,
    poe_temperature: float = 1.5,
    fused_modalities: bool = False,
    device=None,
) -> nn.Module:
    """The DMVAE backbone (FusedDMVAE when ``fused_modalities``)."""
    cls = FusedDMVAE if fused_modalities else DMVAE
    return _build(cls, seed, device, x_dims=tuple(output_dim), hidden_dim=hidden_dim,
                  embed_dim=embed_dim, poe_temperature=poe_temperature)


def build_probe_task(
    *,
    num_modalities: int,
    num_classes: int,
    input_dim: int,
    seed: int = 0,
    hidden_dim: Sequence[int] = (128,),
    aggregation: str = "cml",
    shared_input_dim: Optional[int] = None,
    fused_heads: bool = True,
    device=None,
) -> EvidentialTask:
    """Shared + private evidential probe. Data: {'zc': (B, Ds), 'zp': (B, N, D)}."""
    cls = FusedEvidentialProbe if fused_heads else EvidentialProbe
    model = _build(cls, seed, device, num_modalities=num_modalities, num_classes=num_classes,
                   input_dim=input_dim, hidden_dim=tuple(hidden_dim),
                   shared_input_dim=shared_input_dim)

    def evidences(data):
        return model(data["zc"], list(data["zp"].unbind(dim=1)))

    return EvidentialTask(model, evidences, AGGREGATIONS[aggregation], num_classes)


def build_disentangled_probe_task(
    *,
    num_modalities: int,
    num_classes: int,
    input_dim: int,
    seed: int = 0,
    hidden_dim: Sequence[int] = (128,),
    aggregation: str = "cml",
    fused_heads: bool = True,
    device=None,
) -> EvidentialTask:
    """Private-only evidential probe. Data: {'zp': (B, N, D)}."""
    if aggregation not in ("cml", "avg"):
        raise ValueError("aggregation must be one of ['cml', 'avg']")
    cls = FusedDisentangledEvidentialProbe if fused_heads else DisentangledEvidentialProbe
    model = _build(cls, seed, device, num_modalities=num_modalities, num_classes=num_classes,
                   input_dim=input_dim, hidden_dim=tuple(hidden_dim))

    def evidences(data):
        return model(list(data["zp"].unbind(dim=1)))

    return EvidentialTask(model, evidences, AGGREGATIONS[aggregation], num_classes)


def build_late_fusion_task(
    *,
    output_dims: Sequence[int],
    num_classes: int,
    seed: int = 0,
    hidden_dim: Sequence[int] = (128,),
    aggregation: str = "cml",
    fused_heads: bool = True,
    device=None,
) -> EvidentialTask:
    """Per-view evidential heads on raw views. Data: {'xs': N views (B, S_i)}."""
    cls = FusedLateFusion if fused_heads else LateFusion
    model = _build(cls, seed, device, output_dims=tuple(output_dims), num_classes=num_classes,
                   hidden_dim=tuple(hidden_dim))

    def evidences(data):
        return model(data["xs"])

    return EvidentialTask(model, evidences, AGGREGATIONS[aggregation], num_classes)

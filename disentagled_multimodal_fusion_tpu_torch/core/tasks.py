"""Task builders: each model family with its evidence, aggregation, loss and
validation functions and its optimizer.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/tasks.py``.
Parameters live in the modules, drawn from ``torch.Generator(seed)`` on the
CPU and then moved to the device, so one seed gives the same weights
everywhere. Optimizer settings are the reference's (JAX docstring, lines
8-18):

* DMVAE: Adam + cosine (T_max = num_epochs, eta_min 0);
* EvidentialProbe: AdamW (wd 1e-4) + cosine (eta_min 1e-6);
* DisentangledProbe: AdamW (wd 0.01) + plateau (factor 0.1, patience 5);
* LateFusion: Adam + plateau (factor 0.1, patience 10).

Loss closures take ``(batch, mask, epoch, randomness)`` and draw their own
noise from ``randomness`` (dropout keep-masks, reparameterisation draws);
validation closures take ``(data, epoch)`` and run the eval forward, which
goes through the evidential head kernel on the card.
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
from ..ops.dirichlet import avg_trusted_loss
from ..ops.evidence import AGGREGATIONS
from .megakernel import ProbeMegakernelDesc
from .setup import resolve_device
from .train import OptimizerConfig


class EvidentialTask(NamedTuple):
    """An evidential classifier as serving and training see it."""

    model: nn.Module
    evidences_fn: Callable  # data dict -> (B, V, C) evidence, eval mode
    aggregation: Callable   # (B, V, C) -> (B, C)
    num_classes: int
    loss_fn: Optional[Callable] = None   # (batch, mask, epoch, randomness) -> (loss, aux)
    val_fn: Optional[Callable] = None    # (data, epoch) -> (val_loss, val_acc)
    optimizer: Optional[OptimizerConfig] = None
    megakernel: Optional[ProbeMegakernelDesc] = None  # whole-epoch kernel descriptor


def _build(cls, seed: int, device, **kwargs) -> nn.Module:
    generator = torch.Generator().manual_seed(seed)
    return cls(generator=generator, **kwargs).to(resolve_device(device)).eval()


def _acc(evidence_a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(evidence_a, dim=-1) == y).float())


def _drop_masks(randomness, keep: float, rows: int, views: int, hidden: Sequence[int]):
    """One boolean (rows, views, h) keep-mask per hidden layer, or None
    without dropout."""
    if keep >= 1.0:
        return None
    return [randomness.bernoulli(keep, (rows, views, h)) for h in hidden]


def _evidential_closures(model, forward, views: int, hidden, aggregation: str,
                         annealing_start: float, fused: float):
    """(loss_fn, val_fn) of a stacked evidential model; ``forward(data,
    drop_masks)`` returns (B, V, C) evidence."""
    agg = AGGREGATIONS[aggregation]

    def loss(ev, y, epoch, mask):
        return avg_trusted_loss(ev, y, agg(ev), annealing_step=epoch, num_views=views,
                                annealing_start=annealing_start, fused=fused, mask=mask)

    def loss_fn(batch, mask, epoch, randomness):
        masks = _drop_masks(randomness, model.keep, batch["y"].shape[0], views, hidden)
        return loss(forward(batch, masks), batch["y"], epoch, mask), {}

    def val_fn(data, epoch):
        ev = forward(data, None)
        return loss(ev, data["y"], epoch, None), _acc(agg(ev), data["y"])

    return loss_fn, val_fn


# ------------------------------------------------------------------ DMVAE
def build_dmvae_task(
    *,
    output_dim: Sequence[int],
    seed: int = 0,
    hidden_dim: int = 512,
    embed_dim: int = 100,
    poe_temperature: float = 1.5,
    a: float = 1.0,
    dropout: float = 0.0,
    fused_modalities: bool = False,
    device=None,
) -> nn.Module:
    """The DMVAE backbone (FusedDMVAE when ``fused_modalities``). Train it
    with :func:`dmvae_objective`."""
    if dropout:
        raise NotImplementedError("DMVAE dropout is not ported yet (the configs use 0)")
    if fused_modalities:
        return _build(FusedDMVAE, seed, device, x_dims=tuple(output_dim),
                      hidden_dim=hidden_dim, embed_dim=embed_dim,
                      poe_temperature=poe_temperature, a=a)
    return _build(DMVAE, seed, device, x_dims=tuple(output_dim), hidden_dim=hidden_dim,
                  embed_dim=embed_dim, poe_temperature=poe_temperature)


def dmvae_objective(model: FusedDMVAE, *, lr: float = 1e-4, num_epochs: int = 50):
    """(loss_fn, optimizer) of a FusedDMVAE fit: the ELBO with its three
    standard-normal draws from the fit's randomness, Adam + cosine."""
    if not isinstance(model, FusedDMVAE):
        raise NotImplementedError("only the fused DMVAE trains in the port so far")

    def loss_fn(batch, mask, epoch, randomness):
        rows = batch["xs"][0].shape[0]
        noise = tuple(randomness.normal(s) for s in model.noise_shapes(rows))
        return model(batch["xs"], noise, mask)

    opt = OptimizerConfig(name="adam", lr=lr, schedule="cosine", cosine_t_max=num_epochs,
                          eta_min=0.0)
    return loss_fn, opt


@torch.no_grad()
def embed_dataset(model: nn.Module, xs):
    """Frozen-backbone embeddings: (zc (B, D), zp (B, N, D))."""
    zc, zp_list = model.get_embedding(xs)
    return zc, torch.stack(zp_list, dim=1)


# ------------------------------------------------------------------ probes
def build_probe_task(
    *,
    num_modalities: int,
    num_classes: int,
    input_dim: int,
    seed: int = 0,
    hidden_dim: Sequence[int] = (128,),
    lr: float = 1e-4,
    dropout: float = 0.3,
    annealing_start: float = 20,
    aggregation: str = "cml",
    fused: float = 1.0,
    num_epochs: int = 200,
    shared_input_dim: Optional[int] = None,
    fused_heads: bool = True,
    device=None,
) -> EvidentialTask:
    """Shared + private evidential probe. Data: {'zc': (B, Ds), 'zp': (B, N, D), 'y'}."""
    hidden = tuple(hidden_dim)
    kw = dict(num_modalities=num_modalities, num_classes=num_classes, input_dim=input_dim,
              hidden_dim=hidden, shared_input_dim=shared_input_dim)
    if not fused_heads:
        model = _build(EvidentialProbe, seed, device, **kw)
        return EvidentialTask(model, lambda d: model(d["zc"], list(d["zp"].unbind(dim=1))),
                              AGGREGATIONS[aggregation], num_classes)
    model = _build(FusedEvidentialProbe, seed, device, dropout=dropout, **kw)

    def forward(data, masks=None):
        return model(data["zc"], list(data["zp"].unbind(dim=1)), masks)

    loss_fn, val_fn = _evidential_closures(model, forward, 1 + num_modalities, hidden,
                                           aggregation, annealing_start, fused)
    opt = OptimizerConfig(name="adamw", lr=lr, weight_decay=1e-4, schedule="cosine",
                          cosine_t_max=num_epochs, eta_min=1e-6)
    mk = None
    if len(hidden) == 1:
        mk = ProbeMegakernelDesc(num_modalities, num_classes, input_dim, shared_input_dim,
                                 hidden[0], float(dropout), float(fused),
                                 float(annealing_start), True)
    return EvidentialTask(model, forward, AGGREGATIONS[aggregation], num_classes, loss_fn,
                          val_fn, opt, megakernel=mk)


def build_disentangled_probe_task(
    *,
    num_modalities: int,
    num_classes: int,
    input_dim: int,
    seed: int = 0,
    hidden_dim: Sequence[int] = (128,),
    lr: float = 1e-4,
    dropout: float = 0.3,
    annealing_start: float = 20,
    aggregation: str = "cml",
    num_epochs: int = 200,
    fused_heads: bool = True,
    device=None,
) -> EvidentialTask:
    """Private-only evidential probe. Data: {'zp': (B, N, D), 'y'}."""
    if aggregation not in ("cml", "avg"):
        raise ValueError("aggregation must be one of ['cml', 'avg']")
    hidden = tuple(hidden_dim)
    kw = dict(num_modalities=num_modalities, num_classes=num_classes, input_dim=input_dim,
              hidden_dim=hidden)
    if not fused_heads:
        model = _build(DisentangledEvidentialProbe, seed, device, **kw)
        return EvidentialTask(model, lambda d: model(list(d["zp"].unbind(dim=1))),
                              AGGREGATIONS[aggregation], num_classes)
    model = _build(FusedDisentangledEvidentialProbe, seed, device, dropout=dropout, **kw)

    def forward(data, masks=None):
        return model(list(data["zp"].unbind(dim=1)), masks)

    loss_fn, val_fn = _evidential_closures(model, forward, num_modalities, hidden,
                                           aggregation, annealing_start, 1.0)
    opt = OptimizerConfig(name="adamw", lr=lr, weight_decay=0.01, schedule="plateau",
                          plateau_factor=0.1, plateau_patience=5)
    mk = None
    if len(hidden) == 1:
        mk = ProbeMegakernelDesc(num_modalities, num_classes, input_dim, None, hidden[0],
                                 float(dropout), 1.0, float(annealing_start), False)
    return EvidentialTask(model, forward, AGGREGATIONS[aggregation], num_classes, loss_fn,
                          val_fn, opt, megakernel=mk)


# ------------------------------------------------------------------ baselines
def build_late_fusion_task(
    *,
    output_dims: Sequence[int],
    num_classes: int,
    seed: int = 0,
    hidden_dim: Sequence[int] = (128,),
    dropout: float = 0.3,
    lr: float = 1e-4,
    annealing_start: float = 20,
    aggregation: str = "cml",
    fused: float = 1.0,
    fused_heads: bool = True,
    device=None,
) -> EvidentialTask:
    """Per-view evidential heads on raw views. Data: {'xs': N views (B, S_i), 'y'}."""
    hidden = tuple(hidden_dim)
    kw = dict(output_dims=tuple(output_dims), num_classes=num_classes, hidden_dim=hidden)
    if not fused_heads:
        model = _build(LateFusion, seed, device, **kw)
        return EvidentialTask(model, lambda d: model(d["xs"]), AGGREGATIONS[aggregation],
                              num_classes)
    model = _build(FusedLateFusion, seed, device, dropout=dropout, **kw)

    def forward(data, masks=None):
        return model(data["xs"], masks)

    loss_fn, val_fn = _evidential_closures(model, forward, len(output_dims), hidden,
                                           aggregation, annealing_start, fused)
    opt = OptimizerConfig(name="adam", lr=lr, schedule="plateau", plateau_factor=0.1,
                          plateau_patience=10)
    return EvidentialTask(model, forward, AGGREGATIONS[aggregation], num_classes, loss_fn,
                          val_fn, opt)

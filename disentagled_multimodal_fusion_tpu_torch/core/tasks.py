"""Task builders: each model family with its evidence, aggregation, loss and
validation functions and its optimizer.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/tasks.py``.
Parameters live in the modules, drawn from ``torch.Generator(seed)`` on the
CPU and then moved to the device, so one seed gives the same weights
everywhere; a feature encoder made on its device (``TowerTextEncoder``,
15.5 B parameters) is handed the device and draws there instead.
Optimizer settings are the reference's (JAX docstring, lines 8-18):

* DMVAE: Adam + cosine (T_max = num_epochs, eta_min 0);
* DisentangledSSL: Adam + cosine (T_max = epochs, eta_min 0);
* EvidentialProbe: AdamW (wd 1e-4) + cosine (eta_min 1e-6);
* DisentangledProbe: AdamW (wd 0.01) + plateau (factor 0.1, patience 5);
* LateFusion: Adam + plateau (factor 0.1, patience 10);
* IntermediateFusion: Adam + plateau (factor 0.1, patience 5).

Each loss closure is an :class:`~.train.Objective`: ``draw(randomness, rows)``
makes a step's noise (dropout keep-masks, reparameterisation draws) and
``loss(batch, mask, epoch, draws)`` computes from it, so the seed-batched
trainer can draw per seed and run the arithmetic under ``torch.func.vmap``;
called as ``(batch, mask, epoch, randomness)`` they draw, then compute.
Validation closures take ``(data, epoch)`` and run the eval forward, which
goes through the evidential head kernel on the card for the stacked heads
(IntermediateFusion's one head is plain PyTorch, as it is plain XLA in the
JAX package). :func:`embed_many` and :func:`evidences_many` are the
frozen-backbone and eval forwards over stacked seeds. The DisentangledSSL objective draws a whole epoch at once
(its vMF rejection sampler syncs with the host once per block, not per
step) and takes the global step for its lambda schedule.

``dtype`` (every builder but DisentangledSSL's; JAX lines 97-102) is the
models' compute type: None or ``"float32"``, or ``"bfloat16"`` for the
``--dtype bfloat16`` mode, in which the backbone's and the heads' products
run in bf16 while the parameters, the optimizer's state, the losses and
the BatchNorm statistics stay float32. A bf16 probe gets no epoch-kernel
descriptor (JAX lines 276, 363): it trains through the step loop, and its
eval forward goes through the head kernel's bf16 build. The feature
encoders keep their own type (their specs' ``dtype``; the runners build
them in float32, as the JAX runners do).

``fused_heads`` (the probe and late-fusion builders; JAX lines 255, 344,
436) picks the stacked heads (the default) or one module per head
(``EvidentialProbe``, ``DisentangledEvidentialProbe``, ``LateFusion``).
Both train: the same loss and validation closures, the same optimizer, and
the same draw of the stacked keep-masks, each unfused head taking its
slice, so that the two fed the same randomness drop the same units. Only
the stacked probes have an epoch-kernel descriptor, as in the JAX package;
the unfused heads compute by plain PyTorch, in training and evaluation.

``feature_encoders`` (the DMVAE, late-fusion and intermediate-fusion
builders; JAX lines 127-177, 411-566) are specs for
``models.layers.build_encoders``, LUMA's Audio, Text and Image encoders:
their widths come from the specs, so no sample of the views is needed to
build them. Their keep-masks are drawn before the model's own, in the
order the forward calls the encoders (audio, text, image; each layer in
turn), as flax draws them. Their BatchNorm statistics are the model's
state, kept in its buffers: each training step's forward uses the batch's
statistics and moves the running ones, and validation, evaluation and
:func:`embed_dataset_chunked` run in eval mode on the running ones. A
checkpoint of the module carries them.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..models.baselines import FusedLateFusion, IntermediateFusion, LateFusion
from ..models.dmvae import DMVAE
from ..models.disentangledssl import DisentangledSSL
from ..models.dmvae_fused import FusedDMVAE
from ..models.layers import norm_dtype, placed
from ..models.probes import (
    DisentangledEvidentialProbe,
    EvidentialProbe,
    FusedDisentangledEvidentialProbe,
    FusedEvidentialProbe,
)
from ..ops.dirichlet import avg_trusted_loss, single_evidential_loss
from ..ops.evidence import AGGREGATIONS
from .megakernel import ProbeMegakernelDesc
from .setup import resolve_device
from .train import Objective, OptimizerConfig, functional, slice_draws


class EvidentialTask(NamedTuple):
    """An evidential classifier as serving and training see it."""

    model: nn.Module
    evidences_fn: Callable  # data dict -> (B, V, C) evidence, eval mode
    aggregation: Callable   # (B, V, C) -> (B, C)
    num_classes: int
    loss_fn: Optional[Objective] = None  # (batch, mask, epoch, randomness) -> (loss, aux)
    val_fn: Optional[Callable] = None    # (data, epoch) -> (val_loss, val_acc)
    optimizer: Optional[OptimizerConfig] = None
    megakernel: Optional[ProbeMegakernelDesc] = None  # whole-epoch kernel descriptor


def _build(cls, seed: int, device, **kwargs) -> nn.Module:
    device = resolve_device(device)
    if kwargs.get("feature_encoders"):
        # an encoder made on its device (the text tower) is handed it
        kwargs["feature_encoders"] = placed(kwargs["feature_encoders"], device)
    generator = torch.Generator().manual_seed(seed)
    return cls(generator=generator, **kwargs).to(device).eval()


def _acc(evidence_a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(evidence_a, dim=-1) == y).float())


def _drop_masks(randomness, keep: float, rows: int, views: int, hidden: Sequence[int]):
    """One boolean (rows, views, h) keep-mask per hidden layer, or None
    without dropout."""
    if keep >= 1.0:
        return None
    return [randomness.bernoulli(keep, (rows, views, h)) for h in hidden]


def _encoder_masks(randomness, model, rows: int) -> list:
    """The model's feature encoders' keep-masks, flat, in the order its
    forward calls them ([] without encoders)."""
    encoders = getattr(model, "feat_encs", None)
    if encoders is None:
        return []
    return [randomness.bernoulli(enc.keep, shape)
            for enc, shapes in zip(encoders, model.enc_drop_shapes(rows)) for shape in shapes]


def _split_encoder_masks(model, flat):
    """(one list per encoder, the rest) of a flat draw that starts with
    :func:`_encoder_masks`."""
    out, i = [], 0
    for shapes in model.enc_drop_shapes(1):
        out.append(list(flat[i:i + len(shapes)]))
        i += len(shapes)
    return out, list(flat[i:])


def _with_encoders(model, draw, loss_from_draws):
    """An :class:`Objective` whose draws start with the model's encoder
    masks when it has encoders. ``draw(randomness, rows)`` makes the
    model's own masks (a list or None); ``loss_from_draws(batch, mask,
    epoch, masks, enc_masks)`` gets them back, with the encoders' masks
    (None without encoders). Without encoders the draws are ``draw``'s
    alone, as before."""
    if getattr(model, "feat_encs", None) is None:
        return Objective(draw, lambda b, m, e, masks: loss_from_draws(b, m, e, masks, None))

    def draw_all(randomness, rows):
        enc = _encoder_masks(randomness, model, rows)
        return enc + (draw(randomness, rows) or [])

    def loss_all(batch, mask, epoch, flat):
        enc, own = _split_encoder_masks(model, flat)
        return loss_from_draws(batch, mask, epoch, own or None, enc)

    return Objective(draw_all, loss_all)


def _evidential_closures(model, forward, views: int, hidden, aggregation: str,
                         annealing_start: float, fused: float):
    """(loss_fn, val_fn) of a stacked evidential model; ``forward(data,
    drop_masks[, enc_masks])`` returns (B, V, C) evidence."""
    agg = AGGREGATIONS[aggregation]

    def loss(ev, y, epoch, mask):
        return avg_trusted_loss(ev, y, agg(ev), annealing_step=epoch, num_views=views,
                                annealing_start=annealing_start, fused=fused, mask=mask)

    def draw(randomness, rows):
        return _drop_masks(randomness, model.keep, rows, views, hidden)

    def loss_from_draws(batch, mask, epoch, masks, enc_masks):
        ev = forward(batch, masks) if enc_masks is None else forward(batch, masks, enc_masks)
        return loss(ev, batch["y"], epoch, mask), {}

    def val_fn(data, epoch):
        ev = forward(data, None)
        return loss(ev, data["y"], epoch, None), _acc(agg(ev), data["y"])

    return _with_encoders(model, draw, loss_from_draws), val_fn


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
    lambda_per_modality: Optional[Sequence[float]] = None,
    fused_modalities: bool = False,
    feature_encoders=None,
    dtype=None,
    device=None,
) -> nn.Module:
    """The DMVAE backbone, FusedDMVAE when ``fused_modalities`` and the
    per-modality DMVAE otherwise, over ``feature_encoders`` when given
    (``output_dim`` are then their output widths). Train it with
    :func:`dmvae_objective`."""
    cls = FusedDMVAE if fused_modalities else DMVAE
    return _build(cls, seed, device, x_dims=tuple(output_dim), hidden_dim=hidden_dim,
                  embed_dim=embed_dim, poe_temperature=poe_temperature, a=a, dropout=dropout,
                  lambda_per_modality=lambda_per_modality, feature_encoders=feature_encoders,
                  dtype=dtype)


def dmvae_objective(model, *, lr: float = 1e-4, num_epochs: int = 50):
    """(loss_fn, optimizer) of a DMVAE or FusedDMVAE fit: the ELBO with its
    three standard-normal draws, then its feature encoders' keep-masks and,
    with dropout, its own, from the fit's randomness (one flat tuple);
    Adam + cosine."""
    if not isinstance(model, (DMVAE, FusedDMVAE)):
        raise TypeError(f"not a DMVAE: {type(model).__name__}")

    def draw(randomness, rows):
        noise = tuple(randomness.normal(s) for s in model.noise_shapes(rows))
        enc = tuple(_encoder_masks(randomness, model, rows))
        masks = tuple(randomness.bernoulli(model.keep, s) for s in model.drop_shapes(rows))
        return noise + enc + masks

    def loss_from_draws(batch, mask, epoch, draws):
        enc, own = _split_encoder_masks(model, draws[3:])
        return model(batch["xs"], draws[:3], mask, own or None, enc or None)

    def rows(draws, lo, hi):
        # the decoder's keep-masks do not hold the rows on their first axis
        n_enc = sum(len(shapes) for shapes in model.enc_drop_shapes(1))
        head = 3 + n_enc
        own = list(draws[head:])
        return (slice_draws(draws[:head], lo, hi)
                + tuple(model.drop_rows(own, lo, hi) if own else ()))

    opt = OptimizerConfig(name="adam", lr=lr, schedule="cosine", cosine_t_max=num_epochs,
                          eta_min=0.0)
    return Objective(draw, loss_from_draws, rows=rows), opt


# ------------------------------------------------------------------ SSL
def build_disentangledssl_task(
    *,
    output_dim: Sequence[int],
    seed: int = 0,
    hidden_dim: int = 512,
    embed_dim: int = 100,
    a: float = 1.0,
    distribution: str = "vmf",
    vmfkappa: float = 1.0,
    lr: float = 1e-4,
    lmd_start_value: float = 0.0,
    lmd_end_value: float = 0.0,
    lmd_n_iterations: int = 8000,
    lmd_start_iteration: int = 0,
    condzs: bool = True,
    usezsx: bool = False,
    epochs: int = 50,
    feature_encoders=None,
    device=None,
):
    """(model, loss_fn, optimizer) of the DisentangledSSL backbone
    (disentangledssl.py:17-194; JAX ``core/tasks.py:616-675``): Adam + cosine
    over ``epochs``. The loss ignores the row mask, since SupCon couples all
    rows of a batch, so train it with ``drop_last``. With
    ``feature_encoders`` (two encoder specs) each view goes through its
    encoder first; ``output_dim`` stays the views' raw widths, and the
    encoders' keep-masks lead each step's draws."""
    model = _build(DisentangledSSL, seed, device, output_dim=tuple(output_dim),
                   hidden_dim=hidden_dim, embed_dim=embed_dim, a=a, distribution=distribution,
                   vmfkappa=vmfkappa, lmd_start_value=lmd_start_value,
                   lmd_end_value=lmd_end_value, lmd_n_iterations=lmd_n_iterations,
                   lmd_start_iteration=lmd_start_iteration, condzs=condzs, usezsx=usezsx,
                   feature_encoders=feature_encoders)

    def loss(batch, mask, epoch, draws, step):
        del mask, epoch
        return model.loss(batch["xs"], draws, step)

    opt = OptimizerConfig(name="adam", lr=lr, schedule="cosine", cosine_t_max=epochs,
                          eta_min=0.0)
    return model, Objective(None, loss, draw_epoch=model.draw, with_step=True), opt


@torch.no_grad()
def embed_dataset(model: nn.Module, xs):
    """Frozen-backbone embeddings: (zc (B, D), zp (B, N, D))."""
    zc, zp_list = model.get_embedding(xs)
    return zc, torch.stack(zp_list, dim=1)


# the JAX package's name for the DisentangledSSL backbone's embeddings: Zc
# (B, 2E) is the two shared codes side by side, Zp (B, 2, E)
embed_dataset_ssl = embed_dataset


def embed_dataset_chunked(model: nn.Module, xs, chunk: int = 4096):
    """:func:`embed_dataset` over row chunks of ``chunk``, concatenated."""
    parts = [embed_dataset(model, tuple(x[s0:s0 + chunk] for x in xs))
             for s0 in range(0, xs[0].shape[0], chunk)]
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


@torch.no_grad()
def embed_many(model: nn.Module, params: Dict[str, torch.Tensor], xs):
    """:func:`embed_dataset` for S stacked backbones ``params`` (S, ...) on
    stacked views (S, B, S_i): (zc (S, B, D), zp (S, B, N, D))."""
    return torch.func.vmap(lambda p, x: functional(model, p, embed_dataset, model, x))(params, xs)


@torch.no_grad()
def evidences_many(task: EvidentialTask, params: Dict[str, torch.Tensor], data):
    """The task's eval evidence (S, B, V, C) for S stacked parameter sets on
    stacked data, the heads of all S through one head-kernel launch."""
    return torch.func.vmap(lambda p, d: functional(task.model, p, task.evidences_fn, d))(
        params, data)


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
    dtype=None,
    device=None,
) -> EvidentialTask:
    """Shared + private evidential probe. Data: {'zc': (B, Ds), 'zp': (B, N, D), 'y'}."""
    hidden = tuple(hidden_dim)
    dtype = norm_dtype(dtype)
    model = _build(FusedEvidentialProbe if fused_heads else EvidentialProbe, seed, device,
                   num_modalities=num_modalities, num_classes=num_classes, input_dim=input_dim,
                   hidden_dim=hidden, shared_input_dim=shared_input_dim, dropout=dropout,
                   dtype=dtype)

    def forward(data, masks=None):
        return model(data["zc"], list(data["zp"].unbind(dim=1)), masks)

    loss_fn, val_fn = _evidential_closures(model, forward, 1 + num_modalities, hidden,
                                           aggregation, annealing_start, fused)
    opt = OptimizerConfig(name="adamw", lr=lr, weight_decay=1e-4, schedule="cosine",
                          cosine_t_max=num_epochs, eta_min=1e-6)
    mk = None
    if fused_heads and len(hidden) == 1 and dtype is None:
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
    dtype=None,
    device=None,
) -> EvidentialTask:
    """Private-only evidential probe. Data: {'zp': (B, N, D), 'y'}."""
    if aggregation not in ("cml", "avg"):
        raise ValueError("aggregation must be one of ['cml', 'avg']")
    hidden = tuple(hidden_dim)
    dtype = norm_dtype(dtype)
    cls = FusedDisentangledEvidentialProbe if fused_heads else DisentangledEvidentialProbe
    model = _build(cls, seed, device, num_modalities=num_modalities, num_classes=num_classes,
                   input_dim=input_dim, hidden_dim=hidden, dropout=dropout, dtype=dtype)

    def forward(data, masks=None):
        return model(list(data["zp"].unbind(dim=1)), masks)

    loss_fn, val_fn = _evidential_closures(model, forward, num_modalities, hidden,
                                           aggregation, annealing_start, 1.0)
    opt = OptimizerConfig(name="adamw", lr=lr, weight_decay=0.01, schedule="plateau",
                          plateau_factor=0.1, plateau_patience=5)
    mk = None
    if fused_heads and len(hidden) == 1 and dtype is None:
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
    feature_encoders=None,
    dtype=None,
    device=None,
) -> EvidentialTask:
    """Per-view evidential heads on raw views, through ``feature_encoders``
    when given (``output_dims`` are then their output widths). Data: {'xs':
    N views (B, S_i), 'y'}."""
    hidden = tuple(hidden_dim)
    model = _build(FusedLateFusion if fused_heads else LateFusion, seed, device,
                   output_dims=tuple(output_dims), num_classes=num_classes, hidden_dim=hidden,
                   dropout=dropout, feature_encoders=feature_encoders, dtype=dtype)

    def forward(data, masks=None, enc_masks=None):
        return model(data["xs"], masks, enc_masks)

    loss_fn, val_fn = _evidential_closures(model, forward, len(output_dims), hidden,
                                           aggregation, annealing_start, fused)
    opt = OptimizerConfig(name="adam", lr=lr, schedule="plateau", plateau_factor=0.1,
                          plateau_patience=10)
    return EvidentialTask(model, forward, AGGREGATIONS[aggregation], num_classes, loss_fn,
                          val_fn, opt)


def build_intermediate_fusion_task(
    *,
    output_dims: Sequence[int],
    num_classes: int,
    seed: int = 0,
    hidden_dim: int = 32,
    dropout: float = 0.3,
    lr: float = 1e-4,
    annealing_start: float = 20,
    fusion: str = "concat",
    fusion_output_dim: int = 64,
    fusion_rank: int = 8,
    feature_encoders=None,
    dtype=None,
    device=None,
) -> EvidentialTask:
    """Fusion -> one evidential head (baselines.py:153-252; JAX
    ``core/tasks.py:508-613``). ``fusion`` names the library fusion
    (``models.fusions.INTERMEDIATE_FUSIONS``). The loss is the one-head EDL
    loss; the head's dropout masks are drawn from the fit's randomness
    before the step. Evidence is (B, 1, C) to the evaluator, which reads it
    in the per-view layout. With ``feature_encoders`` the views go through
    them first (``output_dims`` are then their output widths) and their
    masks are drawn before the head's. Data: {'xs': N views (B, S_i), 'y'}."""
    model = _build(IntermediateFusion, seed, device, output_dims=tuple(output_dims),
                   num_classes=num_classes, hidden_dim=hidden_dim, dropout=dropout,
                   fusion=fusion, fusion_output_dim=fusion_output_dim,
                   fusion_rank=fusion_rank, feature_encoders=feature_encoders, dtype=dtype)

    def loss(ev, y, epoch, mask):
        return single_evidential_loss(ev, y, annealing_step=epoch,
                                      annealing_start=annealing_start, mask=mask)

    head = model.head.mlp

    def draw(randomness, rows):
        if head.keep >= 1.0:
            return None
        return [randomness.bernoulli(head.keep, (rows, h)) for h in head.hidden]

    def loss_from_draws(batch, mask, epoch, masks, enc_masks):
        return loss(model(batch["xs"], masks, enc_masks), batch["y"], epoch, mask), {}

    def val_fn(data, epoch):
        ev = model(data["xs"])
        return loss(ev, data["y"], epoch, None), _acc(ev, data["y"])

    opt = OptimizerConfig(name="adam", lr=lr, schedule="plateau", plateau_factor=0.1,
                          plateau_patience=5)
    return EvidentialTask(model, lambda d: model(d["xs"])[:, None, :], lambda ev: ev[:, 0, :],
                          num_classes, _with_encoders(model, draw, loss_from_draws), val_fn, opt)

"""Training harness: an eager loop over epochs and steps with autograd.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/train.py``
(``train`` / ``make_train_program``, lines 43-172 and 453-563). The JAX
package compiles a whole fit into one scan; here each step runs eagerly on
the device, and nothing is fetched to the host until the fit ends: the
per-step losses, the validation metrics and the plateau state stay on the
device, and the histories come back in one copy.

* Adam/AdamW is written by hand with optax's arithmetic
  (``ops/adam.py``), which the probe-epoch kernel shares.
* The epoch index is the annealing step; validation runs after the train
  pass; cosine LR is closed-form per epoch; ReduceLROnPlateau is a carried
  (lr, best, bad) state.
* Each epoch is a shuffle and ``n // B`` full batches plus one batch of the
  exact ragged size ``n % B``.
* Randomness is explicit: a :class:`Randomness` (one ``torch.Generator``)
  draws the epoch permutation and whatever noise the loss asks for, in a
  fixed order. A test hands in an object with the same three methods that
  replays the JAX draws.

Left out (``ROADMAP.md``): ``train_many`` (seed-vmapped fits), the mesh,
model state (BatchNorm), ``drop_last``, unshuffled epochs and mid-training
resume.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.adam import adam_update, bias_corrections


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer + per-epoch LR schedule.

    name: 'adam' or 'adamw' (decoupled decay). schedule: 'constant' |
    'cosine' | 'plateau'.
    """

    name: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 0.0
    schedule: str = "constant"
    cosine_t_max: int = 100
    eta_min: float = 0.0
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    plateau_threshold: float = 1e-4
    min_lr: float = 0.0


class TrainResult(NamedTuple):
    """Per-epoch histories of one fit, fetched once at its end."""

    train_loss: np.ndarray  # (E,) mean train loss, weighted by batch sizes
    val_loss: np.ndarray    # (E,) nan without validation
    val_acc: np.ndarray     # (E,) nan without validation
    final_lr: float


class Randomness:
    """The random draws of one fit, from one ``torch.Generator`` on the
    fit's device: the epoch permutation, Bernoulli keep-masks and standard
    normals, in the order the fit asks for them."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.device)

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        """A boolean mask, True with probability ``p``."""
        return torch.rand(shape, generator=self.generator, device=self.device) < p

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)


def _cosine_lr(cfg: OptimizerConfig, epoch: int) -> float:
    """torch CosineAnnealingLR after ``epoch`` per-epoch steps, closed form,
    in float32 like the JAX package."""
    f32 = np.float32
    t = f32(epoch)
    cos = np.cos(f32(math.pi) * t / f32(cfg.cosine_t_max))
    return float(f32(cfg.eta_min) + f32(cfg.lr - cfg.eta_min) * (f32(1.0) + cos) / f32(2.0))


def _plateau_init(cfg: OptimizerConfig, device):
    return (torch.full((), cfg.lr, dtype=torch.float32, device=device),
            torch.full((), math.inf, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _plateau_update(cfg: OptimizerConfig, state, metric):
    """torch ReduceLROnPlateau (mode='min', threshold_mode='rel'), on device."""
    lr, best, bad = state
    is_better = metric < best * (1.0 - cfg.plateau_threshold)
    best = torch.where(is_better, metric, best)
    bad = torch.where(is_better, torch.zeros_like(bad), bad + 1)
    reduce = bad > cfg.plateau_patience
    lr = torch.where(reduce, torch.clamp(lr * cfg.plateau_factor, min=cfg.min_lr), lr)
    bad = torch.where(reduce, torch.zeros_like(bad), bad)
    return lr, best, bad


def lr_for_epoch(cfg: OptimizerConfig, epoch: int, plateau_lr):
    """The epoch's LR: a float (cosine, constant) or the plateau's 0-d tensor."""
    if cfg.schedule == "cosine":
        return _cosine_lr(cfg, epoch)
    if cfg.schedule == "plateau":
        return plateau_lr
    return cfg.lr


def epoch_batches(perm: torch.Tensor, batch_size: int):
    """An epoch's row indices: the full batches, then the EXACT-size ragged
    tail of n % B rows when there is one."""
    return list(torch.split(perm, batch_size))


def batch_sizes(n: int, batch_size: int):
    """Row counts of an epoch's steps."""
    return [batch_size] * (n // batch_size) + ([n % batch_size] if n % batch_size else [])


def gather_rows(data, idx: torch.Tensor):
    """``data`` (a dict of tensors or tuples of tensors, rows first) at idx."""
    def take(a):
        if isinstance(a, (tuple, list)):
            return type(a)(t.index_select(0, idx) for t in a)
        return a.index_select(0, idx)

    return {k: take(v) for k, v in data.items()}


def _finish(history, plateau_lr) -> TrainResult:
    """One device-to-host copy of the whole fit's histories."""
    rows = torch.stack([torch.stack(col) for col in zip(*history)])
    out = torch.cat([rows.reshape(-1), plateau_lr.reshape(1).to(rows.dtype)]).cpu().numpy()
    tl, vl, va = out[:-1].reshape(3, -1)
    return TrainResult(train_loss=tl, val_loss=vl, val_acc=va, final_lr=float(out[-1]))


def validate(cfg: OptimizerConfig, val_fn, val_data, epoch: int, plateau, device):
    """(val_loss, val_acc, plateau') after an epoch; nan without val_fn."""
    if val_fn is None:
        nan = torch.full((), math.nan, dtype=torch.float32, device=device)
        return nan, nan, plateau
    with torch.no_grad():
        val_loss, val_acc = val_fn(val_data, epoch)
    return val_loss.float(), val_acc.float(), _plateau_update(cfg, plateau, val_loss)


def train(
    *,
    model: torch.nn.Module,
    loss_fn: Callable,
    data: Any,
    n_train: int,
    optimizer: OptimizerConfig,
    epochs: int,
    batch_size: int,
    randomness,
    val_fn: Optional[Callable] = None,
    val_data: Any = None,
    megakernel: Any = None,
) -> TrainResult:
    """Fit ``model``'s parameters in place.

    ``loss_fn(batch, mask, epoch, randomness) -> (loss, aux)``: ``batch`` is
    ``data`` at the step's rows, ``mask`` (rows,) is all ones (the tail is
    exact-size). ``val_fn(val_data, epoch) -> (val_loss, val_acc)`` runs
    under ``no_grad`` after each epoch's train pass.

    ``megakernel``: a :class:`~.megakernel.ProbeMegakernelDesc` (probe tasks
    carry one). When the fit qualifies (``supports_probe_megakernel``), the
    whole-epoch kernel program replaces the step loop: same randomness
    stream, one kernel call per epoch.
    """
    if optimizer.name == "adam" and optimizer.weight_decay > 0:
        raise NotImplementedError("coupled L2 for Adam is not needed by the reference")
    if megakernel is not None:
        from .megakernel import make_probe_megakernel_program, supports_probe_megakernel

        if supports_probe_megakernel(megakernel, optimizer):
            program = make_probe_megakernel_program(
                desc=megakernel, n_train=n_train, optimizer=optimizer, epochs=epochs,
                batch_size=batch_size, val_fn=val_fn,
            )
            return program(model.stack, randomness, data, val_data)

    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    weight_decay = optimizer.weight_decay if optimizer.name == "adamw" else 0.0
    plateau = _plateau_init(optimizer, device)
    weights = torch.tensor(batch_sizes(n_train, batch_size), dtype=torch.float32).to(device)
    count = 0
    history = []
    for epoch in range(epochs):
        perm = randomness.permutation(n_train)
        lr = lr_for_epoch(optimizer, epoch, plateau[0])
        losses = []
        for idx in epoch_batches(perm, batch_size):
            batch = gather_rows(data, idx)
            mask = torch.ones(idx.shape[0], dtype=torch.float32, device=device)
            loss, _ = loss_fn(batch, mask, epoch, randomness)
            grads = torch.autograd.grad(loss, params)
            count += 1
            adam_update(params, moments, grads, *bias_corrections(count), lr, weight_decay)
            losses.append(loss.detach().float())
        train_loss = torch.sum(torch.stack(losses) * weights) / weights.sum()
        val_loss, val_acc, plateau = validate(optimizer, val_fn, val_data, epoch, plateau, device)
        history.append((train_loss, val_loss, val_acc))
    return _finish(history, plateau[0])

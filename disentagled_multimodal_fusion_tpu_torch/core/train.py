"""Training harness: an eager loop over epochs and steps with autograd, and
its seed-batched twin.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/train.py``
(``train``, ``train_many`` and ``make_train_program``, lines 43-172 and
337-563). The JAX package compiles a whole fit into one scan; here each step
runs eagerly on the device, and nothing is fetched to the host until the fit
ends: the per-step losses, the validation metrics and the plateau state stay
on the device.

* Adam/AdamW is written by hand with optax's arithmetic
  (``ops/adam.py``), which the probe-epoch kernel shares.
* The epoch index is the annealing step; validation runs after the train
  pass; cosine LR is closed-form per epoch; ReduceLROnPlateau is a carried
  (lr, best, bad) state.
* Each epoch is a shuffle (or the rows in order, ``shuffle=False``) and
  ``n // B`` full batches, plus one batch of the exact ragged size ``n % B``
  unless ``drop_last`` drops it (JAX ``_epoch_batches``, lines 150-170).
* Randomness is explicit: a :class:`Randomness` (one ``torch.Generator``)
  draws the epoch permutation and then every step's draws of the loss (an
  :class:`Objective`), in a fixed order. A test hands in an object with the
  same methods that replays the JAX draws.
* :func:`train_many` fits S instances (stacked seeds) at once: their
  parameters are stacked on a leading axis and each step runs under
  ``torch.func.vmap``, so the S fits share every operation the host issues.
  Each instance keeps its own :class:`Randomness`, drawn outside the vmapped
  step in the order its own :func:`train` would draw (an
  :class:`Objective` splits a loss's draws from its arithmetic).

* Model state (the LUMA encoders' BatchNorm statistics, the JAX package's
  ``batch_stats``; JAX lines 190, 215-219 and 554) lives in the model's
  buffers and is carried step by step: each training forward normalises by
  its batch's statistics and writes the new running ones
  (``models.layers.batch_norm`` computes them as a function of (input,
  statistics)); validation, after the epoch's steps, normalises by the
  running ones. The epoch-kernel predicate declines such fits (no probe has
  state). :func:`train_many` stacks the state beside the parameters
  (:func:`stack_model_state`): each vmapped step hands every instance's
  statistics to the forward as buffers and takes the new ones back, so each
  instance keeps its own.
* Mid-training resume (JAX lines 175-201): ``train(start_epoch=k,
  resume=result.state)`` continues a fit of k epochs from its optimizer
  moments, step count, plateau state and generator state (the model holds
  its parameters and statistics), equal to the uninterrupted fit; so does
  the epoch-kernel program, from the same :class:`TrainState`.
* The mesh's ``data`` axis (JAX lines 279-327 and 369-400; ``parallel/``):
  ``train(mesh=)`` splits every step's rows over the ranks, each holding
  the dataset whole and drawing the global batch's randomness from a
  generator of the same seed; each rank runs the loss on its rows (an
  :class:`Objective` cuts its draws to them) inside
  ``parallel.distributed.row_split``, so BatchNorm's moments, SupCon's
  negatives and the orthogonality penalty are the global batch's, and the
  gradients of the losses, each scaled by its rank's share of the rows,
  are summed over the ranks: the gradient of the global batch's loss. Every
  rank applies the same Adam step, so the parameters stay equal on all of
  them; validation runs on each rank's rows and its means are summed the
  same way. ``train_many(mesh=)`` splits the S instances instead, with no
  collective inside the fit, and gathers the results so that every rank
  returns all S.
* The mesh's ``model`` axis (JAX lines 279-327: ``train(mesh=,
  tp_hidden_dim=)``): each rank keeps its block of every parameter the
  rule cuts (``parallel.mesh.ShardPlan``) and of its two Adam moments
  (AdamW's decay is elementwise, so it runs on the blocks), and runs the
  loss and the validation through :func:`functional` on its blocks inside
  ``parallel.mesh.model_split`` (the Megatron cut of the MLPs; every other
  cut parameter gathered whole first). The ranks of a model group compute
  the same loss, so the gradients, the losses and the validation sums are
  summed over the data group alone. At the end every rank writes the
  whole parameters back into the model, and the state's moments are
  whole too: the caller holds what one process would have trained, as
  JAX's global arrays are. Through the fit the model holds no storage for
  the parameters the plan cuts (each rank holds 1/M of them and of their
  moments, as a JAX device holds its shards): a rank keeps its blocks,
  their moments, the tensors the rule leaves whole (trained in the
  model's own storage) and, while a step runs, the transient gathers of
  the parameters gathered on use. Anything that reads a cut parameter of
  the model during the fit, rather than the blocks through
  :func:`functional`, fails. The model gets its whole parameters back at
  the end of the fit, and also when the fit raises. Without
  ``tp_hidden_dim`` (and in ``train_many``) the model axis cuts nothing:
  its ranks repeat the work.
* :func:`live_fit` names what the step loop running now holds (the
  model's parameters, the fit's and their moments), and
  :func:`resident_bytes` counts the bytes of their distinct storages: a
  reading of the memory a fit keeps resident, taken from inside it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

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


class TrainState(NamedTuple):
    """What an exact resume of :func:`train` needs besides the model, which
    holds its parameters and statistics."""

    moments: tuple  # an (m, v) pair per trainable parameter, in parameter order
    count: int      # optimizer steps taken
    plateau: tuple  # (lr, best, bad), 0-d tensors
    rng: Any        # the generator's state (None for a randomness without state())


class TrainResult(NamedTuple):
    """Per-epoch histories of one fit, fetched once at its end."""

    train_loss: np.ndarray  # (E,) mean train loss, weighted by batch sizes
    val_loss: np.ndarray    # (E,) nan without validation
    val_acc: np.ndarray     # (E,) nan without validation
    final_lr: float
    state: Optional[TrainState] = None  # for train(start_epoch=, resume=)


class Randomness:
    """The random draws of one fit, from one ``torch.Generator`` on the
    fit's device: the epoch permutation, Bernoulli keep-masks, standard
    normals, uniforms, integers and vMF marginals, in the order the fit asks
    for them. ``vmf_syncs`` counts the host syncs of the vMF rejection
    sampler."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.vmf_syncs = 0

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.device)

    def bernoulli(self, p: float, shape) -> torch.Tensor:
        """A boolean mask, True with probability ``p``."""
        return torch.rand(shape, generator=self.generator, device=self.device) < p

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        """Uniform on [0, 1)."""
        return torch.rand(shape, generator=self.generator, device=self.device)

    def integers(self, high: int, shape) -> torch.Tensor:
        """Uniform integers in [0, high)."""
        return torch.randint(0, high, shape, generator=self.generator, device=self.device)

    def vmf_w(self, kappa: float, m: int, n: int) -> torch.Tensor:
        """n draws of the vMF marginal w in R^m (``ops.vmf.sample_w``)."""
        from ..ops.vmf import sample_w

        w, syncs = sample_w(self, kappa, m, n)
        self.vmf_syncs += syncs
        return w

    def state(self) -> torch.Tensor:
        """The generator's state, for an exact resume."""
        return self.generator.get_state()

    def restore(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)


def slice_draws(draws, lo: int, hi: int):
    """The draws of rows [lo, hi) of a step: every tensor's leading axis
    sliced (None stays None)."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return draws[lo:hi]
    return type(draws)(slice_draws(d, lo, hi) for d in draws)


class Objective:
    """A loss whose random draws are split from its arithmetic.

    ``draw(randomness, rows)`` makes one step's draws (None, a tensor, or a
    tuple or list of tensors) from ``randomness``; ``loss(batch, mask, epoch,
    draws) -> (loss, aux)`` draws nothing, so ``torch.func.vmap`` can run it
    over stacked seeds (vmap's default ``randomness="error"`` fails on a draw
    left inside). The trainers draw a whole epoch at once, after its
    permutation: :meth:`draw_epoch` (by default ``draw`` per step, in step
    order; ``draw_epoch=`` replaces it, and then ``draw`` may be None). With
    ``with_step`` the loss also takes the global step, the optimizer steps
    taken before this one (the JAX package's ``StepInfo.step``):
    ``loss(batch, mask, epoch, draws, step)``. Called as ``(batch, mask,
    epoch, randomness)`` it draws one step, then computes (at step 0).
    ``rows(draws, lo, hi)`` cuts a step's draws to its rows [lo, hi) for a
    data-parallel step (by default :func:`slice_draws`, every draw's leading
    axis; ``rows=`` replaces it for draws laid out otherwise).
    """

    def __init__(self, draw: Optional[Callable], loss: Callable, *,
                 draw_epoch: Optional[Callable] = None, with_step: bool = False,
                 rows: Optional[Callable] = None):
        self.draw, self.loss, self.with_step = draw, loss, with_step
        self._draw_epoch = draw_epoch
        self.rows = rows or slice_draws

    def draw_epoch(self, randomness, sizes: Sequence[int]) -> list:
        """Every step's draws of an epoch whose steps take ``sizes`` rows."""
        if self._draw_epoch is not None:
            return self._draw_epoch(randomness, sizes)
        return [self.draw(randomness, rows) for rows in sizes]

    def compute(self, batch, mask, epoch, draws, step: int = 0):
        if self.with_step:
            return self.loss(batch, mask, epoch, draws, step)
        return self.loss(batch, mask, epoch, draws)

    def __call__(self, batch, mask, epoch, randomness):
        return self.compute(batch, mask, epoch, self.draw_epoch(randomness, [mask.shape[0]])[0])


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


def epoch_batches(perm: torch.Tensor, batch_size: int, drop_last: bool = False):
    """An epoch's row indices (along perm's last axis): the full batches,
    then the EXACT-size ragged tail of n % B rows when there is one and
    ``drop_last`` is off."""
    parts = list(torch.split(perm, batch_size, dim=-1))
    if drop_last and parts[-1].shape[-1] < batch_size:
        parts.pop()
    return parts


def batch_sizes(n: int, batch_size: int, drop_last: bool = False):
    """Row counts of an epoch's steps. Raises ``ValueError`` when
    ``drop_last`` leaves no step (n < batch_size)."""
    if drop_last and n // batch_size == 0:
        raise ValueError(
            f"drop_last=True with n_train={n} < batch_size={batch_size}: zero optimizer steps "
            f"per epoch (the loss would be 0/0=NaN and params would never update); shrink "
            f"batch_size or use drop_last=False")
    tail = 0 if drop_last else n % batch_size
    return [batch_size] * (n // batch_size) + ([tail] if tail else [])


def epoch_order(randomness, n: int, shuffle: bool, device) -> torch.Tensor:
    """The epoch's row order: a permutation drawn from ``randomness``, or
    the rows in order (nothing drawn) when ``shuffle`` is off."""
    if shuffle:
        return randomness.permutation(n)
    return torch.arange(n, device=device)


def gather_rows(data, idx: torch.Tensor):
    """``data`` (a dict of tensors or tuples of tensors, rows first) at idx."""
    def take(a):
        if isinstance(a, (tuple, list)):
            return type(a)(t.index_select(0, idx) for t in a)
        return a.index_select(0, idx)

    return {k: take(v) for k, v in data.items()}


def _finish(history, state: TrainState) -> TrainResult:
    """One device-to-host copy of the whole fit's histories."""
    rows = torch.stack([torch.stack(col) for col in zip(*history)])
    lr = state.plateau[0]
    out = torch.cat([rows.reshape(-1), lr.reshape(1).to(rows.dtype)]).cpu().numpy()
    tl, vl, va = out[:-1].reshape(3, -1)
    return TrainResult(train_loss=tl, val_loss=vl, val_acc=va, final_lr=float(out[-1]),
                       state=state)


def resume_state(optimizer: OptimizerConfig, params: Sequence[torch.Tensor], randomness,
                 resume: Optional[TrainState]):
    """(moments, count, plateau) to start a fit from: ``resume``'s, with
    ``randomness`` set back to its generator state, or fresh ones."""
    if resume is None:
        device = params[0].device
        return ([(torch.zeros_like(p), torch.zeros_like(p)) for p in params], 0,
                _plateau_init(optimizer, device))
    if resume.rng is not None:
        randomness.restore(resume.rng)
    return ([(m.clone(), v.clone()) for m, v in resume.moments], resume.count,
            tuple(t.clone() for t in resume.plateau))


def capture_state(moments, count: int, plateau, randomness) -> TrainState:
    """The :class:`TrainState` at the end of a fit."""
    rng = randomness.state() if hasattr(randomness, "state") else None
    return TrainState(tuple(moments), count, tuple(plateau), rng)


def num_rows(data) -> int:
    """The row count of ``data`` (a dict of tensors or tuples of tensors,
    rows first)."""
    leaf = next(iter(data.values()))
    return (leaf[0] if isinstance(leaf, (tuple, list)) else leaf).shape[0]


def _validate_rows(mesh, val_fn, val_data, epoch: int, device):
    """(val_loss, val_acc) of the whole of ``val_data``, each rank running
    ``val_fn`` on its rows: both are means over the rows, so the ranks' means
    weighted by their shares of the rows sum to the global ones."""
    from ..parallel.distributed import all_reduce
    from ..parallel.mesh import rows_of, shard_batch

    n = num_rows(val_data)
    sl = rows_of(n, mesh)
    part = torch.zeros(2, dtype=torch.float32, device=device)
    if sl.stop > sl.start:
        val_loss, val_acc = val_fn(shard_batch(val_data, mesh), epoch)
        part = torch.stack([val_loss.float(), val_acc.float()]) * ((sl.stop - sl.start) / n)
    val_loss, val_acc = all_reduce(part, group=mesh.data_group)
    return val_loss, val_acc


def validate(cfg: OptimizerConfig, val_fn, val_data, epoch: int, plateau, device, mesh=None):
    """(val_loss, val_acc, plateau') after an epoch; nan without val_fn.
    Under a ``mesh`` each rank validates its rows (:func:`_validate_rows`)."""
    if val_fn is None:
        nan = torch.full((), math.nan, dtype=torch.float32, device=device)
        return nan, nan, plateau
    with torch.no_grad():
        if mesh is None:
            val_loss, val_acc = val_fn(val_data, epoch)
        else:
            val_loss, val_acc = _validate_rows(mesh, val_fn, val_data, epoch, device)
    return val_loss.float(), val_acc.float(), _plateau_update(cfg, plateau, val_loss)


def _step(mesh, loss_fn, params, data, idx, draws, epoch: int, count: int, call):
    """One step's (loss, gradients) of the global batch ``idx`` (and its
    ``draws``): in this process, or over the mesh (:func:`_rows_step`)."""
    if mesh is not None:
        return _rows_step(mesh, loss_fn, params, data, idx, draws, epoch, count, call)
    mask = torch.ones(idx.shape[0], dtype=torch.float32, device=idx.device)
    loss, _ = loss_fn.compute(gather_rows(data, idx), mask, epoch, draws, count)
    return loss, torch.autograd.grad(loss, params)


def _rows_step(mesh, loss_fn, params, data, idx, draws, epoch: int, count: int, call):
    """One data-parallel step: this rank's part of the global batch ``idx``
    (and of its ``draws``) through the loss, inside the step's row split;
    ``call(fn, *args)`` runs the loss (on the parameter blocks, under the
    model axis). Returns (the global batch's loss, its gradients), equal on
    every rank of a model group: each rank's loss, a mean over its rows, is
    scaled by its share of the rows, and one sum over the data group adds
    the gradients and the losses."""
    from ..parallel.distributed import RowSplit, all_reduce, row_split
    from ..parallel.mesh import split_rows

    rows = idx.shape[0]
    split = RowSplit(split_rows(rows, mesh.shape["data"]), mesh.data_index, mesh.data_group)
    lo, hi = split.lo, split.hi
    batch = gather_rows(data, idx[lo:hi])
    mask = torch.ones(hi - lo, dtype=torch.float32, device=idx.device)
    with row_split(split):
        loss, _ = call(loss_fn.compute, batch, mask, epoch, loss_fn.rows(draws, lo, hi), count)
        share = loss * ((hi - lo) / rows)
        grads = torch.autograd.grad(share, params)
    if hi == lo:
        # no rows: the backward above still joined every collective of the
        # forward; this rank adds nothing to the loss or to any gradient
        share = torch.zeros_like(share)
        grads = [torch.zeros_like(p) for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]
                                + [share.detach().float().reshape(1)]), group=mesh.data_group)
    out, at = [], 0
    for p in params:
        out.append(flat[at:at + p.numel()].view_as(p))
        at += p.numel()
    # the loss a copy: a view would keep the step's whole gradient buffer
    # alive in the epoch's list of losses
    return flat[-1].clone(), out


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
    drop_last: bool = False,
    shuffle: bool = True,
    start_epoch: int = 0,
    resume: Optional[TrainState] = None,
    mesh: Any = None,
    tp_hidden_dim: Optional[int] = None,
) -> TrainResult:
    """Fit ``model``'s parameters in place over epochs [start_epoch,
    start_epoch + epochs).

    ``loss_fn`` is an :class:`Objective`: each epoch draws its permutation
    (unless ``shuffle`` is off), then every step's draws, then computes
    ``loss(batch, mask, epoch, draws) -> (loss, aux)`` per step: ``batch``
    is ``data`` at the step's rows, ``mask`` (rows,) is all ones (the tail
    is exact-size, or dropped with ``drop_last``). ``val_fn(val_data,
    epoch) -> (val_loss, val_acc)`` runs under ``no_grad`` after each
    epoch's train pass. A model with BatchNorm carries its running
    statistics in its buffers from step to step, and validation uses them.

    ``megakernel``: a :class:`~.megakernel.ProbeMegakernelDesc` (probe tasks
    carry one). When the fit qualifies (``supports_probe_megakernel``), the
    whole-epoch kernel program replaces the step loop: same randomness
    stream, one kernel call per epoch.

    Mid-training resume: ``start_epoch=k, resume=first.state`` on the
    model the first call of k epochs fitted continues it exactly (the
    epoch-indexed schedules and annealing, Adam's step count, the plateau
    state and the generator); the two calls' histories together equal one
    uninterrupted fit's. The global step a ``with_step`` objective sees is
    Adam's step count, which ``resume`` carries.

    ``mesh``: a ``parallel.mesh.Mesh``; every rank of it calls ``train``
    with the same arguments (``data`` whole, ``randomness`` from the same
    seed) and splits each step's rows over its ``data`` axis
    (:func:`_rows_step`; the module docstring). The histories, the plateau
    state and the parameters are the global batch's, equal on every rank.
    The epoch kernel is declined under a mesh, as in the JAX package.

    ``tp_hidden_dim``: with a mesh whose ``model`` axis is larger than 1,
    the hidden width the model axis cuts (the Megatron cut, the module
    docstring); ``ValueError`` when the axis does not divide a width the
    rule cuts. Until the fit ends (or raises) the model holds no storage
    for the parameters the cut takes: each rank trains its blocks.
    """
    if optimizer.name == "adam" and optimizer.weight_decay > 0:
        raise NotImplementedError("coupled L2 for Adam is not needed by the reference")
    if megakernel is not None:
        from .megakernel import make_probe_megakernel_program, supports_probe_megakernel

        if supports_probe_megakernel(megakernel, optimizer, mesh=mesh):
            program = make_probe_megakernel_program(
                desc=megakernel, n_train=n_train, optimizer=optimizer, epochs=epochs,
                batch_size=batch_size, val_fn=val_fn, drop_last=drop_last, shuffle=shuffle,
                start_epoch=start_epoch,
            )
            return program(model.stack, randomness, data, val_data, resume)

    names, params, plan, call = _fit_params(model, mesh, tp_hidden_dim)
    device = params[0].device
    moments, count, plateau = resume_state(optimizer, params, randomness, resume)
    if plan is not None and resume is not None:  # the state's moments are whole
        moments = [(plan.block(k, m).clone(), plan.block(k, v).clone())
                   for k, (m, v) in zip(names, moments)]
    if val_fn is not None and plan is not None:
        val_fn = functools.partial(call, val_fn)
    weight_decay = optimizer.weight_decay if optimizer.name == "adamw" else 0.0
    sizes = batch_sizes(n_train, batch_size, drop_last)
    weights = torch.tensor(sizes, dtype=torch.float32).to(device)
    history = []
    with _holding(model, plan, names, params, moments):
        for epoch in range(start_epoch, start_epoch + epochs):
            perm = epoch_order(randomness, n_train, shuffle, device)
            draws = loss_fn.draw_epoch(randomness, sizes)
            lr = lr_for_epoch(optimizer, epoch, plateau[0])
            losses = []
            for idx, step_draws in zip(epoch_batches(perm, batch_size, drop_last), draws):
                loss, grads = _step(mesh, loss_fn, params, data, idx, step_draws, epoch, count,
                                    call)
                count += 1
                adam_update(params, moments, grads, *bias_corrections(count), lr, weight_decay)
                losses.append(loss.detach().float())
            train_loss = torch.sum(torch.stack(losses) * weights) / weights.sum()
            val_loss, val_acc, plateau = validate(optimizer, val_fn, val_data, epoch, plateau,
                                                  device, mesh)
            history.append((train_loss, val_loss, val_acc))
    if plan is not None:  # the state's moments whole, as the model's parameters are
        ms = plan.whole({k: m for k, (m, _) in zip(names, moments)})
        vs = plan.whole({k: v for k, (_, v) in zip(names, moments)})
        moments = [(ms[k], vs[k]) for k in names]
    return _finish(history, capture_state(moments, count, plateau, randomness))


def _plain_call(fn, *args):
    return fn(*args)


def _fit_params(model: nn.Module, mesh, tp_hidden_dim: Optional[int]):
    """(names, parameters, plan, call) of a fit: ``model``'s trainable
    parameters, or under a model axis that cuts ``tp_hidden_dim`` this
    rank's blocks of the ones its ``parallel.mesh.ShardPlan`` cuts (new
    leaves) and the others in the model's own storage; ``call(fn, *args)``
    runs the loss or the validation on them."""
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    params = [p for p in model.parameters() if p.requires_grad]
    if mesh is None or tp_hidden_dim is None or mesh.shape["model"] == 1:
        return names, params, None, _plain_call
    from ..parallel.mesh import ShardPlan

    plan = ShardPlan(model, names, mesh, tp_hidden_dim)
    params = [(plan.block(k, p.detach()).clone() if k in plan.cuts else p.detach())
              .requires_grad_() for k, p in zip(names, params)]
    return names, params, plan, _model_axis_call(model, plan, names, params)


class LiveFit(NamedTuple):
    """What the :func:`train` step loop running now holds."""

    model_params: list  # the model's parameters (the cut ones hold no storage)
    params: list        # the tensors the fit trains: under a model axis, this rank's blocks
    moments: list       # their (m, v) pairs


_LIVE_FIT: contextvars.ContextVar = contextvars.ContextVar("live_fit", default=None)


def live_fit() -> Optional[LiveFit]:
    """The :class:`LiveFit` of the step loop running now (None outside
    one), for reading from inside a fit (its loss or validation) what the
    fit holds."""
    return _LIVE_FIT.get()


def resident_bytes(fit: Optional[LiveFit] = None) -> int:
    """The bytes of the distinct storages that ``fit`` (by default
    :func:`live_fit`'s) holds: the model's parameters, the fit's and their
    moments, each storage once; a parameter released under the model axis
    holds none."""
    fit = fit or live_fit()
    storages = {}
    for t in [*fit.model_params, *fit.params, *(x for mv in fit.moments for x in mv)]:
        st = t.untyped_storage()
        if st.nbytes():
            storages[(t.device, st.data_ptr())] = st.nbytes()
    return sum(storages.values())


@contextlib.contextmanager
def _holding(model: nn.Module, plan, names, params, moments):
    """The block as the body of a fit of ``params`` (by ``names``) with
    ``moments``: :func:`live_fit` names them. Under a model axis (``plan``)
    each parameter of the model that the plan cuts holds an empty tensor
    of its type while the block runs, and on leaving it, by an exception
    too, gets its whole value back, gathered from every rank's blocks (a
    collective over the model group, so every rank leaves the block
    alike)."""
    own = dict(model.named_parameters())
    cut = [] if plan is None else [k for k in names if k in plan.cuts]
    token = _LIVE_FIT.set(LiveFit(list(own.values()), params, moments))
    for k in cut:  # an empty tensor of the parameter's type: any read of its values fails
        own[k].data = own[k].new_empty(0)
    try:
        yield
    finally:
        _LIVE_FIT.reset(token)
        if cut:
            whole = plan.whole({k: p for k, p in zip(names, params) if k in plan.cuts})
            for k in cut:
                own[k].data = whole[k].clone(memory_format=torch.contiguous_format)


def step_gradients(*, model: nn.Module, loss_fn, data, n_train: int, batch_size: int,
                   randomness, mesh: Any = None, tp_hidden_dim: Optional[int] = None,
                   drop_last: bool = False, shuffle: bool = True):
    """(loss, {name: gradient}) of the first step that :func:`train` with
    these arguments takes, from the same draws, the gradients whole (under
    a model axis, every rank's blocks gathered); ``model``'s parameters are
    left as they are (a BatchNorm's running statistics take the step's).
    For holding a mesh's step elementwise against one process's."""
    names, params, plan, call = _fit_params(model, mesh, tp_hidden_dim)
    with _holding(model, plan, names, params, []):
        perm = epoch_order(randomness, n_train, shuffle, params[0].device)
        draws = loss_fn.draw_epoch(randomness, batch_sizes(n_train, batch_size, drop_last))
        idx = epoch_batches(perm, batch_size, drop_last)[0]
        loss, grads = _step(mesh, loss_fn, params, data, idx, draws[0], 0, 0, call)
    grads = {k: g.detach() for k, g in zip(names, grads)}
    return loss.detach().float(), grads if plan is None else plan.whole(grads)


def _model_axis_call(model: nn.Module, plan, names, params):
    """``call(fn, *args)``: ``fn`` run on the parameter blocks ``params``
    (by ``names``) inside the plan's model split."""
    from ..parallel.mesh import model_split

    def call(fn, *args):
        with model_split(plan.split):
            return functional(model, plan.call_params(dict(zip(names, params))), fn, *args)

    return call


# ------------------------------------------------------------ seed-batched fits
class _Bound(nn.Module):
    """Holds a module so that ``torch.func.functional_call`` can swap its
    parameters for one call of any function that uses it."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(*args)


def functional(model: nn.Module, params: Dict[str, torch.Tensor], fn: Callable, *args):
    """``fn(*args)`` with ``model``'s parameters replaced by ``params`` (named
    as in ``model.named_parameters()``) for the call. Under ``vmap`` over
    stacked ``params`` it runs every instance's parameters through ``fn``."""
    return torch.func.functional_call(
        _Bound(model), {f"model.{k}": v for k, v in params.items()}, (fn, *args)
    )


def stack_params(models: Sequence[nn.Module]) -> Dict[str, torch.Tensor]:
    """The models' trainable parameters stacked on a leading instance axis."""
    named = [dict(m.named_parameters()) for m in models]
    return {k: torch.stack([n[k].detach() for n in named])
            for k, p in named[0].items() if p.requires_grad}


def model_state_names(model: nn.Module):
    """The names of ``model``'s state: the buffers its training forward
    writes, the BatchNorm running statistics (the JAX package's
    ``batch_stats``); [] for a stateless model."""
    from ..models.layers import BatchNorm

    return [f"{prefix}.{name}" for prefix, module in model.named_modules()
            if isinstance(module, BatchNorm) for name, _ in module.named_buffers(recurse=False)]


def stack_model_state(models: Sequence[nn.Module]) -> Dict[str, torch.Tensor]:
    """The models' state (:func:`model_state_names`) stacked on a leading
    instance axis; {} for stateless models."""
    named = [dict(m.named_buffers()) for m in models]
    return {k: torch.stack([n[k].detach() for n in named]) for k in model_state_names(models[0])}


@torch.no_grad()
def load_params(models: Sequence[nn.Module], params: Dict[str, Any],
                model_state: Optional[Dict[str, Any]] = None) -> None:
    """Copy instance ``s`` of the stacked ``params`` (tensors or numpy
    arrays), and of the stacked ``model_state`` when given, into
    ``models[s]``."""
    for s, model in enumerate(models):
        for k, p in model.named_parameters():
            if k in params:
                p.copy_(torch.as_tensor(params[k][s]))
        for k, b in model.named_buffers():
            if model_state and k in model_state:
                b.copy_(torch.as_tensor(model_state[k][s]))


def _stack_draws(draws):
    """Per-instance draws (each None, a tensor, or a tuple/list of tensors)
    stacked on a leading axis."""
    first = draws[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(draws)
    return type(first)(torch.stack(parts) for parts in zip(*draws))


def _take_rows(data, idx: torch.Tensor, broadcast: bool):
    """Every instance's rows at its own indices ``idx`` (S, rows): leaves are
    (S, n, ...) tensors, or (n, ...) shared by all when ``broadcast``."""
    inst = torch.arange(idx.shape[0], device=idx.device)[:, None]

    def take(a):
        if isinstance(a, (tuple, list)):
            return type(a)(take(t) for t in a)
        return a[idx] if broadcast else a[inst, idx]

    return {k: take(v) for k, v in data.items()}


class ManyState(NamedTuple):
    """What an exact resume of :func:`train_many` needs besides the
    parameters."""

    moments: tuple  # an (m, v) pair per parameter, stacked
    count: int      # optimizer steps taken
    plateau: tuple  # (lr, best, bad), each (S,)
    rng: tuple      # each instance's generator state
    model_state: Dict[str, torch.Tensor]  # name -> (S, ...) running statistics


class ManyResult(NamedTuple):
    """Stacked results of :func:`train_many`, on the device (nothing is
    fetched to the host)."""

    params: Dict[str, torch.Tensor]  # name -> (S, ...) trained parameters
    train_loss: torch.Tensor         # (S, E)
    val_loss: torch.Tensor           # (S, E), nan without validation
    val_acc: torch.Tensor            # (S, E), nan without validation
    final_lr: torch.Tensor           # (S,)
    state: ManyState


def train_many(
    *,
    model: nn.Module,
    params: Dict[str, torch.Tensor],
    loss_fn: Objective,
    data: Any,
    n_train: int,
    optimizer: OptimizerConfig,
    epochs: int,
    batch_size: int,
    randomness: Sequence,
    val_fn: Optional[Callable] = None,
    val_data: Any = None,
    data_broadcast: bool = False,
    segment_epochs: Optional[int] = None,
    drop_last: bool = False,
    shuffle: bool = True,
    model_state: Optional[Dict[str, torch.Tensor]] = None,
    mesh: Any = None,
) -> ManyResult:
    """Fit S instances of ``model`` at once; instance s equals :func:`train`
    of ``model`` with ``params[.][s]`` and ``randomness[s]``.

    ``model`` is the module the closures run; its own parameters are left as
    they are. ``params`` maps its parameter names to stacked (S, ...)
    initial values (:func:`stack_params`). ``data`` and ``val_data`` leaves
    carry the S axis first, or are shared by all instances when
    ``data_broadcast``. ``loss_fn`` is an :class:`Objective`; ``val_fn(data,
    epoch)`` runs per instance under ``vmap`` and ``no_grad``, which sends the
    eval forward of the stacked heads through one head-kernel launch for all
    S instances.

    Each epoch draws, for every instance from its own ``randomness[s]``, the
    permutation (unless ``shuffle`` is off) and then each step's draws, as
    :func:`train` draws them; ``drop_last`` drops the ragged tail. The
    plateau state is per instance (its LR an (S,) tensor broadcast to every
    parameter); the cosine LR is shared.

    ``model_state`` maps ``model``'s state buffers (:func:`model_state_names`)
    to stacked (S, ...) initial values (:func:`stack_model_state`): each
    step's forward gets instance s's statistics as the model's buffers, and
    their new values are carried to the next step, so instance s moves its
    own statistics as :func:`train` moves the model's; validation
    normalises by them. The result's ``model_state`` holds the final ones.

    ``segment_epochs`` runs the epochs in segments of that length, each
    resumed exactly from the last one's optimizer, plateau, generator and
    model states (:class:`ManyState`).

    ``mesh``: a ``parallel.mesh.Mesh`` whose ranks all call ``train_many``
    with the same arguments. Its ``data`` axis splits the S instances (S
    must divide by it): each rank fits its S / n_dp instances with no
    collective inside the fit, then one gather gives every rank all S
    results, and every ``randomness[s]`` the state its own fit left.
    Broadcast data stays whole on every rank.
    """
    if optimizer.name == "adam" and optimizer.weight_decay > 0:
        raise NotImplementedError("coupled L2 for Adam is not needed by the reference")
    if mesh is not None:
        return _train_many_on_mesh(
            mesh, model=model, params=params, loss_fn=loss_fn, data=data, n_train=n_train,
            optimizer=optimizer, epochs=epochs, batch_size=batch_size, randomness=randomness,
            val_fn=val_fn, val_data=val_data, data_broadcast=data_broadcast,
            segment_epochs=segment_epochs, drop_last=drop_last, shuffle=shuffle,
            model_state=model_state)
    fit = (model, loss_fn, data, n_train, optimizer, batch_size, randomness, val_fn, val_data,
           data_broadcast, drop_last, shuffle)
    model_state = dict(model_state or {})
    if not segment_epochs or segment_epochs >= epochs:
        return _train_many_segment(*fit, params, model_state, 0, epochs, None)
    parts, start, resume = [], 0, None
    while start < epochs:
        seg = min(segment_epochs, epochs - start)
        r = _train_many_segment(*fit, params, model_state, start, seg, resume)
        parts.append(r)
        params, resume, start = r.params, r.state, start + seg
    cat = lambda k: torch.cat([getattr(r, k) for r in parts], dim=1)  # noqa: E731
    return parts[-1]._replace(train_loss=cat("train_loss"), val_loss=cat("val_loss"),
                              val_acc=cat("val_acc"))


def _train_many_on_mesh(mesh, *, params, randomness, data, val_data, data_broadcast,
                        model_state, **fit) -> ManyResult:
    """:func:`train_many` of this rank's instances, gathered to all S."""
    from ..parallel.distributed import gather_instances
    from ..parallel.mesh import instances_of, shard_instances

    s_count = len(randomness)
    sl = instances_of(s_count, mesh)

    def mine(tree):
        return tree if data_broadcast or tree is None else shard_instances(tree, mesh, s_count)

    local = train_many(params=shard_instances(params, mesh, s_count), randomness=randomness[sl],
                       data=mine(data), val_data=mine(val_data), data_broadcast=data_broadcast,
                       model_state=shard_instances(model_state or {}, mesh, s_count), **fit)
    st = local.state
    full = gather_instances({
        "params": local.params, "train_loss": local.train_loss, "val_loss": local.val_loss,
        "val_acc": local.val_acc, "final_lr": local.final_lr, "moments": st.moments,
        "plateau": st.plateau, "model_state": st.model_state,
        # a test's replayed randomness has no state
        "rng": None if any(r is None for r in st.rng) else torch.stack(st.rng),
    }, s_count, sl, mesh.data_group)
    rng = (None,) * s_count
    if full["rng"] is not None:
        rng = tuple(state.clone() for state in full["rng"].cpu().unbind(0))
        for r, state in zip(randomness, rng):
            r.restore(state)
    state = ManyState(full["moments"], st.count, full["plateau"], rng, full["model_state"])
    return ManyResult(full["params"], full["train_loss"], full["val_loss"], full["val_acc"],
                      full["final_lr"], state)


def _train_many_segment(model, loss_fn, data, n_train, optimizer, batch_size, randomness, val_fn,
                        val_data, broadcast, drop_last, shuffle, params, model_state, start_epoch,
                        epochs, resume):
    """Epochs [start_epoch, start_epoch + epochs) of :func:`train_many`,
    from ``resume`` (and its model state) when given."""
    from torch.func import grad_and_value, vmap

    params = {k: v.detach().clone() for k, v in params.items()}
    device = next(iter(params.values())).device
    s_count = len(randomness)
    weight_decay = optimizer.weight_decay if optimizer.name == "adamw" else 0.0
    if resume is None:
        moments = tuple((torch.zeros_like(p), torch.zeros_like(p)) for p in params.values())
        count = 0
        plateau = tuple(t.expand(s_count).clone() for t in _plateau_init(optimizer, device))
    else:
        moments = tuple((m.clone(), v.clone()) for m, v in resume.moments)
        count, plateau, model_state = resume.count, resume.plateau, resume.model_state
        for r, st in zip(randomness, resume.rng):
            r.restore(st)
    stats = {k: v.detach().clone() for k, v in model_state.items()}
    sizes = batch_sizes(n_train, batch_size, drop_last)
    # the step weights made on the device: a copy from the host would wait
    # for the device to drain
    weights = torch.full((len(sizes),), float(batch_size), device=device)
    weights[-1] = float(sizes[-1])
    data_dim = None if broadcast else 0

    def loss_of(p, st, batch, mask, epoch, draws, step):
        # the forward writes the new statistics into these copies in place
        # (``models.layers.BatchNorm``); they come back as the aux
        new = {k: v.clone() for k, v in st.items()}
        loss, _ = functional(model, {**p, **new}, loss_fn.compute, batch, mask, epoch, draws,
                             step)
        return loss, new

    def val_of(p, st, vdata, epoch):
        return functional(model, {**p, **st}, val_fn, vdata, epoch)

    history = []
    for epoch in range(start_epoch, start_epoch + epochs):
        # each instance's draws in its own fit's order: the permutation, then
        # each step's draws
        perms, draws = [], []
        for r in randomness:
            perms.append(epoch_order(r, n_train, shuffle, device))
            draws.append(loss_fn.draw_epoch(r, sizes))
        perm = torch.stack(perms)
        lr = lr_for_epoch(optimizer, epoch, plateau[0])
        losses = []
        for step, idx in enumerate(epoch_batches(perm, batch_size, drop_last)):
            batch = _take_rows(data, idx, broadcast)
            mask = torch.ones(idx.shape[1], dtype=torch.float32, device=device)
            d = _stack_draws([per_inst[step] for per_inst in draws])
            step_fn = vmap(grad_and_value(loss_of, has_aux=True),
                           in_dims=(0, 0, 0, None, None, None if d is None else 0, None))
            grads, (loss, new) = step_fn(params, stats, batch, mask, epoch, d, count)
            stats = {k: new[k].detach() for k in stats}
            count += 1
            bc1, bc2 = bias_corrections(count)
            for (k, p), mv in zip(params.items(), moments):
                step_lr = lr if isinstance(lr, float) else lr.view(-1, *[1] * (p.dim() - 1))
                adam_update([p], [mv], [grads[k]], bc1, bc2, step_lr, weight_decay)
            losses.append(loss.detach().float())
        train_loss = torch.sum(torch.stack(losses, dim=1) * weights, dim=1) / weights.sum()
        if val_fn is None:
            val_loss = val_acc = torch.full((s_count,), math.nan, device=device)
        else:
            with torch.no_grad():
                val_loss, val_acc = vmap(val_of, in_dims=(0, 0, data_dim, None))(
                    params, stats, val_data, epoch)
            val_loss, val_acc = val_loss.float(), val_acc.float()
            plateau = _plateau_update(optimizer, plateau, val_loss)
        history.append((train_loss, val_loss, val_acc))
    tl, vl, va = (torch.stack(col, dim=1) for col in zip(*history))
    state = ManyState(moments, count, plateau, tuple(r.state() for r in randomness), stats)
    return ManyResult(params, tl, vl, va, plateau[0], state)

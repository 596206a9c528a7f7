"""Probe fits through the whole-epoch kernel (drop-in for the step loop).

Counterpart of ``disentagled_multimodal_fusion_tpu/core/megakernel.py``.
``make_probe_megakernel_program`` returns a program with the same contract
as ``core.train.train``'s step loop, but each epoch's S optimizer steps
(forward, backward, AdamW) run in one ``ops.probe_megakernel.run_epoch_kernel``
call: four kernel launches per step from one C call, instead of some
hundred PyTorch operations per step.

The randomness is the step loop's, draw for draw: per epoch the permutation,
then one (rows, V, H) keep-mask per step at the step's exact row count, from
the same :class:`~.train.Randomness`. So a kernel fit and a step fit from
one generator state can be compared at float tolerance. The ragged tail
becomes a zero-padded, row-masked extra step (the probes are stateless, so
masking the loss is exact); with ``drop_last`` there is no tail and no extra
step (JAX ``core/megakernel.py:113-124``), so an epoch of n = 8000 rows at
B = 128 is 62 steps, and Adam counts 62 steps per epoch. Unshuffled epochs
(``shuffle=False``) take the rows in order and draw no permutation.
Validation and the plateau state run after each epoch as in the step loop.
A fit resumes mid-training as the step loop does (JAX lines 116 and
146-152): ``start_epoch`` and a :class:`~.train.TrainState`, whose moments
are the four stacked parameters' (w1, b1, w2, b2), the probe's parameter
order, so a state of either program resumes the other.

Scope (``supports_probe_megakernel``): the fused probes with one hidden
layer of at most 128 units and at most 8 heads, AdamW, cosine/plateau/
constant schedule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.adam import B1, B2
from ..ops.probe_megakernel import MAX_HIDDEN, MAX_VIEWS, run_epoch_kernel
from .train import (
    OptimizerConfig,
    _finish,
    batch_sizes,
    capture_state,
    epoch_batches,
    epoch_order,
    lr_for_epoch,
    resume_state,
    validate,
)


class ProbeMegakernelDesc(NamedTuple):
    """Static facts the kernel program needs about a probe task."""

    num_modalities: int
    num_classes: int
    input_dim: int
    shared_input_dim: Optional[int]  # None for the private-only probe
    hidden_dim: int
    dropout: float
    fused: float
    annealing_start: float
    has_shared: bool


def supports_probe_megakernel(desc: Optional[ProbeMegakernelDesc],
                              optimizer: OptimizerConfig) -> bool:
    """True when the kernel program is a drop-in for this fit: an AdamW
    probe whose heads the kernel takes (at most ``MAX_VIEWS`` heads of at
    most ``MAX_HIDDEN`` hidden units). Any other fit runs the step loop on
    the same randomness stream."""
    return (
        desc is not None
        and optimizer.name == "adamw"
        and optimizer.schedule in ("cosine", "plateau", "constant")
        and desc.num_modalities + (1 if desc.has_shared else 0) <= MAX_VIEWS
        and desc.hidden_dim <= MAX_HIDDEN
    )


def _stack_views(desc: ProbeMegakernelDesc, data) -> torch.Tensor:
    """(N, V, pad) probe input in FusedEvidentialProbe's layout: zc and the
    zp rows zero-padded to pad = max(in_dims)."""
    zp = data["zp"].float()                                          # (N, M, D)
    if not desc.has_shared:
        return zp
    ds = desc.shared_input_dim or desc.input_dim
    pad = max(ds, desc.input_dim)
    rows = [F.pad(data["zc"].float(), (0, pad - ds))]
    rows += [F.pad(zp[:, i], (0, pad - desc.input_dim)) for i in range(desc.num_modalities)]
    return torch.stack(rows, dim=1)


def _epoch_coefficients(epoch: int, annealing_start: float):
    """(coef, gamma_t) of the AvgTrustedLoss at ``epoch``, in float32:
    coef = min(1, epoch / start), gamma_t = 0.2 (1 - t) + t with
    t = min(1, epoch / max(1, start))."""
    f32 = np.float32
    e = f32(epoch)
    coef = min(f32(1.0), e / f32(annealing_start))
    t = min(f32(1.0), e / f32(max(1.0, annealing_start)))
    return float(coef), float(f32(0.2) * (f32(1.0) - t) + t)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the leading axis of t to ``rows``."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


def make_probe_megakernel_program(
    *,
    desc: ProbeMegakernelDesc,
    n_train: int,
    optimizer: OptimizerConfig,
    epochs: int,
    batch_size: int,
    val_fn,
    drop_last: bool = False,
    shuffle: bool = True,
    start_epoch: int = 0,
):
    """``program(stack, randomness, data, val_data, resume=None) ->
    TrainResult``, which fits the probe's
    :class:`~..models.dmvae_fused.StackedMLP` ``stack`` in place over epochs
    [start_epoch, start_epoch + epochs), from ``resume`` (a
    :class:`~.train.TrainState`) when given."""
    sizes = batch_sizes(n_train, batch_size, drop_last)
    s_total = len(sizes)
    v_heads = desc.num_modalities + (1 if desc.has_shared else 0)
    keep = 1.0 - desc.dropout
    weight_decay = optimizer.weight_decay

    def program(stack, randomness, data, val_data, resume=None):
        p4 = [stack.w1.data, stack.b1.data, stack.w2.data, stack.b2.data]
        device = p4[0].device
        moments, count, plateau = resume_state(optimizer, p4, randomness, resume)
        mus, nus = (tuple(t) for t in zip(*moments))
        xin_all = _stack_views(desc, data)                           # (N, V, pad)
        yoh_all = F.one_hot(data["y"].long(), desc.num_classes).float()
        host_masks = np.zeros((s_total, batch_size, 1), np.float32)
        for i, rows in enumerate(sizes):
            host_masks[i, :rows] = 1.0
        rmasks = torch.from_numpy(host_masks).to(device)
        weights = torch.tensor(sizes, dtype=torch.float32).to(device)
        history = []
        for epoch in range(start_epoch, start_epoch + epochs):
            perm = epoch_order(randomness, n_train, shuffle, device)
            lr = lr_for_epoch(optimizer, epoch, plateau[0])

            # the epoch's batches, the tail zero-padded to B rows
            steps = epoch_batches(perm, batch_size, drop_last)
            xs = torch.stack([_pad_rows(xin_all.index_select(0, i), batch_size) for i in steps])
            ys = torch.stack([_pad_rows(yoh_all.index_select(0, i), batch_size) for i in steps])
            xs = xs.transpose(1, 2).contiguous()                     # (S, V, B, pad)
            drops = None
            if keep < 1.0:
                # one mask per step at its exact row count, as the step loop draws it
                masks = [_pad_rows(randomness.bernoulli(keep, (rows, v_heads, desc.hidden_dim))
                                   .float(), batch_size) for rows in sizes]
                drops = torch.stack(masks).transpose(1, 2).contiguous()  # (S, V, B, H)

            # per-step Adam bias corrections 1 - b^count, in float32 on the device
            counts = torch.arange(count + 1, count + 1 + s_total, dtype=torch.float32,
                                  device=device)
            bc1s = (1.0 - torch.pow(torch.full((), B1, device=device), counts))[:, None]
            bc2s = (1.0 - torch.pow(torch.full((), B2, device=device), counts))[:, None]
            coef, gamma_t = _epoch_coefficients(epoch, desc.annealing_start)

            new_p, mus, nus, losses = run_epoch_kernel(
                xs, drops, ys, rmasks, bc1s, bc2s, lr, coef, gamma_t, tuple(p4), mus, nus,
                keep=keep, fused=desc.fused, num_classes=desc.num_classes,
                weight_decay=weight_decay,
            )
            for dst, src in zip(p4, new_p):
                if dst.data_ptr() != src.data_ptr():  # the plain version returns new tensors
                    dst.copy_(src)
            count += s_total
            train_loss = torch.sum(losses * weights) / weights.sum()
            val_loss, val_acc, plateau = validate(optimizer, val_fn, val_data, epoch, plateau,
                                                  device)
            history.append((train_loss, val_loss, val_acc))
        return _finish(history, capture_state(zip(mus, nus), count, plateau, randomness))

    return program

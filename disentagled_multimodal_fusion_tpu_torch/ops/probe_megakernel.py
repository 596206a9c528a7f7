"""One whole probe epoch (S AdamW steps) as a hand-written CUDA kernel.

``run_epoch_kernel`` launches ``csrc/probe_epoch.cu``. It replaces the
Pallas TPU kernel ``run_epoch_kernel`` of
``disentagled_multimodal_fusion_tpu/ops/probe_megakernel.py:246`` (body
``_make_epoch_kernel``, lines 166-237): per step, the stacked V-head forward
with dropout masks, the saturated evidence, the AvgTrustedLoss (EDL digamma
A-term + annealed Dirichlet KL + pairwise DC), its gradient and the AdamW
update. Randomness, the batch plan, validation and the LR schedule stay
outside, in ``core/megakernel.py``.

The TPU kernel takes its backward from ``jax.value_and_grad`` inside the
kernel; the CUDA kernel carries a backward derived by hand, which
differentiates the Stirling series of ``ops/special.py`` (with
``trigamma_stirling``) and follows JAX's gradients at the ties: 0.5 for the
clip at exactly +-10, +1 for ``|p_i - p_j|`` at 0, 0 for the ReLU at 0.

Bound on an H100 at the HandWritten shape (V=7, B=100, D=200, H=128, C=10,
S=16): ~79 MFLOP of f32 per step, 1.26 GFLOP per epoch, 19 us at
67 TFLOP/s, against 19 MB per epoch when each input is read once and the
state (p, m, v: 2.3 MB) read once and written once (6 us at 3.35 TB/s):
bound by operations. This design re-reads and re-writes the state every
step (87 MB per epoch), because it does not fit one SM's shared memory; it
launches three kernels per step from one C call per epoch (forward with W1
brought into shared memory by bulk asynchronous copies; loss and dh with a
warp per (row, view); gradient + AdamW as register-tiled products over
operands staged by bulk copies, B split across warps and added in a fixed
order). A block covers all of H with four hidden units per lane, so the
kernel takes H <= 128 (the config's 128).

``run_epoch_plain`` is the plain PyTorch version, with autograd through the
same Stirling series and custom gradients at the ties. The wrapper takes it
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. The counter ``kernels.probe_epoch`` (``core/logging.py``) counts the
kernel's epoch calls (a plain int, exact while one thread at a time
launches).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..core.logging import count
from .adam import adam_update
from .evidence import LOG1E13, abs_jax, clip_jax
from .special import digamma_stirling, gammaln_stirling

KERNEL_SOURCE = "probe_epoch"
MAX_VIEWS = 8
MAX_HIDDEN = 128  # four hidden units per lane of a warp in the forward kernel
DC_EPS = 1e-8  # ops/dirichlet.dc_loss


def _stacked_forward(params, x, drop, keep: float):
    """relu(x W1 + b1) -> dropout -> W2 + b2 -> saturated evidence.
    x (V, B, D); drop (V, B, H) {0, 1}; returns (V, B, C)."""
    w1, b1, w2, b2 = params
    h = torch.relu(torch.bmm(x, w1) + b1[:, None, :])
    if keep < 1.0:
        h = h * drop * (1.0 / keep)
    z = clip_jax(torch.bmm(h, w2) + b2[:, None, :])
    return torch.exp(z + LOG1E13 - torch.logaddexp(z, torch.full_like(z, LOG1E13)))


def _avg_trusted_loss_2d(evs, yoh, rmask, coef, gamma_t, fused: float, num_classes: int):
    """``ops/dirichlet.avg_trusted_loss`` over (V, B, C) evidences with the
    Stirling series; yoh (B, C) one-hot, rmask (B, 1) {0, 1}."""
    v = evs.shape[0]
    msum = torch.sum(rmask)
    alpha = evs + 1.0
    s = torch.sum(alpha, dim=-1, keepdim=True)                       # (V, B, 1)
    a_term = torch.sum(yoh * (digamma_stirling(s) - digamma_stirling(alpha)), dim=-1,
                       keepdim=True)
    kl_alpha = (alpha - 1.0) * (1.0 - yoh) + 1.0
    skl = torch.sum(kl_alpha, dim=-1, keepdim=True)
    first = (gammaln_stirling(skl) - torch.sum(gammaln_stirling(kl_alpha), dim=-1, keepdim=True)
             - math.lgamma(float(num_classes)))
    second = torch.sum((kl_alpha - 1.0) * (digamma_stirling(kl_alpha) - digamma_stirling(skl)),
                       dim=-1, keepdim=True)
    edl_sum = torch.sum((a_term + coef * (first + second)) * rmask)
    # the masked mean over B*V rows, then the reference's extra / V
    edl = edl_sum / torch.clamp(msum * v, min=1.0) / v
    ps = alpha / (s + DC_EPS)
    us = num_classes / (s + DC_EPS)
    dc_rows = torch.zeros_like(rmask)
    for i in range(v):
        for j in range(i + 1, v):
            pd = 0.5 * torch.sum(abs_jax(ps[i] - ps[j]), dim=-1, keepdim=True)
            dc_rows = dc_rows + 2.0 * pd * ((1.0 - us[i]) * (1.0 - us[j]))
    dc = torch.sum(dc_rows / max(1, v - 1) * rmask) / torch.clamp(msum, min=1.0)
    return edl + gamma_t * dc * fused


def run_epoch_plain(xs, drops, yohs, rmasks, bc1s, bc2s, lr, coef, gamma_t,
                    params, mus, nus, *, keep: float, fused: float, num_classes: int,
                    weight_decay: float):
    """One epoch of S steps, plain PyTorch, the signature of the kernel.

    xs (S, V, B, D) batches; drops (S, V, B, H) {0, 1} dropout masks (ones
    when keep == 1); yohs (S, B, C) one-hot targets; rmasks (S, B, 1) row
    masks; bc1s/bc2s (S, 1) Adam bias corrections 1 - b^count; lr, coef,
    gamma_t scalars (floats or 0-d tensors). params/mus/nus: 4-tuples
    (w1 (V, D, H), b1 (V, H), w2 (V, H, C), b2 (V, C)). Returns new
    (params, mus, nus, losses (S,)); the inputs are left as they are.
    """
    p = [t.detach().clone() for t in params]
    m = [t.detach().clone() for t in mus]
    n = [t.detach().clone() for t in nus]
    losses = []
    for step in range(xs.shape[0]):
        with torch.enable_grad():
            leaves = [t.requires_grad_() for t in (q.detach() for q in p)]
            drop = drops[step] if keep < 1.0 else None
            evs = _stacked_forward(leaves, xs[step], drop, keep)
            loss = _avg_trusted_loss_2d(evs, yohs[step], rmasks[step], coef, gamma_t, fused,
                                        num_classes)
            grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.detach())
        adam_update(p, list(zip(m, n)), grads, bc1s[step, 0], bc2s[step, 0], lr, weight_decay)
    return tuple(p), tuple(m), tuple(n), torch.stack(losses)


@functools.lru_cache(maxsize=None)
def _kernel():
    from .cuda_build import load_library

    fn = load_library(KERNEL_SOURCE).dmf_probe_epoch
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 7 + [p] * 12 + [p] * 5 + [i32] * 6 + [f32] * 4 + [p]
    fn.restype = i32
    return fn


def _error_string(code: int) -> str:
    from .cuda_build import load_library

    lib = load_library(KERNEL_SOURCE)
    lib.dmf_error_string.argtypes = [ctypes.c_int]
    lib.dmf_error_string.restype = ctypes.c_char_p
    return lib.dmf_error_string(code).decode()


def _scalar(value, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``, without a host-to-device copy for
    a Python float (a fill kernel takes the value as an argument)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(value), dtype=torch.float32, device=device)


def run_epoch_kernel(xs, drops, yohs, rmasks, bc1s, bc2s, lr, coef, gamma_t,
                     params, mus, nus, *, keep: float, fused: float, num_classes: int,
                     weight_decay: float):
    """One epoch through ``csrc/probe_epoch.cu``; arguments as
    :func:`run_epoch_plain`. On the card the kernel updates ``params``,
    ``mus`` and ``nus`` in place and returns them with the losses (S,);
    on the CPU the plain version returns new tensors. ``drops`` is not read
    when ``keep == 1``."""
    if xs.device.type == "cpu":
        return run_epoch_plain(xs, drops, yohs, rmasks, bc1s, bc2s, lr, coef, gamma_t,
                               params, mus, nus, keep=keep, fused=fused,
                               num_classes=num_classes, weight_decay=weight_decay)
    s, v, b, d = xs.shape
    h, c = params[0].shape[-1], params[2].shape[-1]
    if not 1 <= v <= MAX_VIEWS:
        raise ValueError(f"the kernel takes 1 to {MAX_VIEWS} views, got {v}")
    if h > MAX_HIDDEN:
        raise ValueError(f"the kernel takes at most {MAX_HIDDEN} hidden units, got {h}")
    if c != num_classes:
        raise ValueError(f"w2 has {c} classes, num_classes is {num_classes}")
    state_shapes = [(v, d, h), (v, h), (v, h, c), (v, c)]
    expect = {"xs": (s, v, b, d), "yohs": (s, b, c), "rmasks": (s, b, 1),
              "bc1s": (s, 1), "bc2s": (s, 1)}
    if keep < 1.0:
        expect["drops"] = (s, v, b, h)
    named = {"xs": xs, "drops": drops, "yohs": yohs, "rmasks": rmasks, "bc1s": bc1s,
             "bc2s": bc2s}
    for group, tensors in (("params", params), ("mus", mus), ("nus", nus)):
        for i, t in enumerate(tensors):
            named[f"{group}[{i}]"] = t
            expect[f"{group}[{i}]"] = state_shapes[i]
    for name, shape in expect.items():
        t = named[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != xs.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {xs.device}")
    losses = torch.empty(s, dtype=torch.float32, device=xs.device)
    if s == 0:
        return tuple(params), tuple(mus), tuple(nus), losses
    scal = torch.stack([_scalar(lr, xs.device), _scalar(coef, xs.device),
                        _scalar(gamma_t, xs.device)])
    # scratch: dropped hidden activations, logits -> dL/dz, dL/dh and the
    # loss kernel's partial sums (two per block of rows, then sum(rmask):
    # 2 b + 1 floats hold them however many rows a block takes)
    hd = torch.empty((v, b, h), dtype=torch.float32, device=xs.device)
    zbuf = torch.empty((v, b, c), dtype=torch.float32, device=xs.device)
    dh = torch.empty_like(hd)
    partials = torch.empty(2 * b + 1, dtype=torch.float32, device=xs.device)
    drop_ptr = drops.data_ptr() if keep < 1.0 else None
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(
            xs.data_ptr(), drop_ptr, yohs.data_ptr(), rmasks.data_ptr(), bc1s.data_ptr(),
            bc2s.data_ptr(), scal.data_ptr(),
            *(t.data_ptr() for t in (*params, *mus, *nus)),
            losses.data_ptr(), hd.data_ptr(), zbuf.data_ptr(), dh.data_ptr(), partials.data_ptr(),
            s, v, b, d, h, c,
            float(np.float32(1.0 / keep)), float(fused), float(weight_decay),
            math.lgamma(float(num_classes)),
            stream,
        )
    if code != 0:
        raise RuntimeError(f"probe_epoch kernel launch failed: {_error_string(code)}")
    count("kernels.probe_epoch")
    return tuple(params), tuple(mus), tuple(nus), losses


"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``evidential_heads_stacked`` launches ``csrc/evidential_head.cu``: the
evidential-head forward Dense -> ReLU -> Dense -> saturated-exp evidence for
V stacked heads in one launch. It replaces the Pallas TPU kernel
``evidential_head_fused`` / ``evidential_heads_stacked`` of
``disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53-105``.

On an H100 at the serving shape (B=256, V=7, D=200, H=128, C=10) the kernel
is bound by f32 operations (96.3 MFLOP, 1.44 us at 67 TFLOP/s) more than by
bytes (~2.26 MB, 0.68 us at 3.35 TB/s); at B=1 the weights make it bound by
bytes. Its design keeps relu(h) on chip so the hidden activations never
reach device memory (see the source for the rest).

The kernel has no backward: the wrapper raises when a gradient is wanted
(grad mode on and an input requiring grad), on any device, so a training
forward cannot silently lose its gradient. The wrapper runs the plain
version only for tensors on the CPU. For CUDA tensors it launches the
kernel or raises; it never falls back.
``evidential_heads_stacked.launches`` counts the launches (a plain int,
exact while one thread at a time launches).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .evidence import evidence_activation

KERNEL_SOURCE = "evidential_head"


def evidential_heads_stacked_plain(x_stack, w1s, b1s, w2s, b2s):
    """Plain PyTorch version: x_stack (V, B, D); w1s (V, D, H); b1s (V, H);
    w2s (V, H, C); b2s (V, C) -> (B, V, C) evidence."""
    h = torch.relu(torch.einsum("vbd,vdh->vbh", x_stack, w1s) + b1s[:, None, :])
    logits = torch.einsum("vbh,vhc->vbc", h, w2s) + b2s[:, None, :]
    return evidence_activation(logits).transpose(0, 1)


@functools.lru_cache(maxsize=None)
def _kernel():
    from .cuda_build import load_library

    fn = load_library(KERNEL_SOURCE).dmf_evidential_heads
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, i64, i64, p, p, p, p, p, i32, i32, i32, i32, i32, p]
    fn.restype = i32
    return fn


def _error_string(code: int) -> str:
    from .cuda_build import load_library

    lib = load_library(KERNEL_SOURCE)
    lib.dmf_error_string.argtypes = [ctypes.c_int]
    lib.dmf_error_string.restype = ctypes.c_char_p
    return lib.dmf_error_string(code).decode()


def evidential_heads_stacked(x_stack, w1s, b1s, w2s, b2s):
    """V evidential heads over V inputs in one kernel launch.

    x_stack: (V, B, D), any strides with a unit last stride; w1s (V, D, H),
    b1s (V, H), w2s (V, H, C), b2s (V, C) contiguous; all float32 on one
    device. Returns (B, V, C) evidence. Forward only: raises when grad mode
    is on and an input requires grad.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x_stack, w1s, b1s, w2s, b2s)
    ):
        raise RuntimeError(
            "evidential_heads_stacked has no backward; call it under torch.no_grad() "
            "or use the plain path for training"
        )
    if x_stack.device.type == "cpu":
        return evidential_heads_stacked_plain(x_stack, w1s, b1s, w2s, b2s)
    v, b, d = x_stack.shape
    h, c = w1s.shape[-1], w2s.shape[-1]
    expect = {"w1s": (v, d, h), "b1s": (v, h), "w2s": (v, h, c), "b2s": (v, c)}
    tensors = {"w1s": w1s, "b1s": b1s, "w2s": w2s, "b2s": b2s}
    for name, t in tensors.items():
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expect[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in {"x_stack": x_stack, **tensors}.items():
        if t.device != x_stack.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all inputs must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
    if x_stack.stride(2) != 1 and d > 1:
        raise ValueError("x_stack must have a unit stride along D")
    out = torch.empty((b, v, c), dtype=torch.float32, device=x_stack.device)
    if b == 0 or v == 0:
        return out
    with torch.cuda.device(x_stack.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(
            x_stack.data_ptr(), x_stack.stride(0), x_stack.stride(1),
            w1s.data_ptr(), b1s.data_ptr(), w2s.data_ptr(), b2s.data_ptr(),
            out.data_ptr(), v, b, d, h, c, stream,
        )
    if code != 0:
        raise RuntimeError(f"evidential_head kernel launch failed: {_error_string(code)}")
    evidential_heads_stacked.launches += 1
    return out


evidential_heads_stacked.launches = 0


def evidential_head_fused(x, w1, b1, w2, b2):
    """One evidential head: x (B, D); w1 (D, H); b1 (H,); w2 (H, C); b2 (C,)
    -> (B, C) evidence, through the same kernel with V = 1."""
    return evidential_heads_stacked(
        x[None], w1[None], b1[None], w2[None], b2[None]
    )[:, 0]

"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

``evidential_heads_stacked`` launches ``csrc/evidential_head.cu``: the
evidential-head forward Dense -> ReLU -> Dense -> saturated-exp evidence for
V stacked heads in one launch. It replaces the Pallas TPU kernel
``evidential_head_fused`` / ``evidential_heads_stacked`` of
``disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53-105``.
``evidential_heads_stacked_bf16`` is the same heads in the bf16 compute mode
of ``--dtype bfloat16`` (the kernel's bf16 build, at the end of the same
source): operands and each layer's output rounded to bf16 where JAX's
``StackedMLP(dtype=bf16)`` rounds them, products summed in f32, the
evidence in f32; the parameters and x reach the kernel in float32 and are
rounded there (a bfloat16 x is widened to float32 by the wrapper, exactly).

On an H100 at the serving shape (B=256, V=7, D=200, H=128, C=10) the f32
kernel is bound by f32 operations (96.3 MFLOP, 1.44 us at 67 TFLOP/s) more
than by bytes (~2.26 MB, 0.68 us at 3.35 TB/s); at B=1 the weights make it
bound by bytes. Its design keeps relu(h) on chip so the hidden activations
never reach device memory (see the source for the rest). The bf16 build is
bound by bytes at every main-path shape (989 TFLOP/s on the tensor cores);
it multiplies on the tensor cores (bf16 ``mma.sync``, f32 sums) from a ring
of TMA copies fed by a warp of its own, and keeps relu(h) on chip too.

Both go through the operator ``dmf::evidential_heads`` (``ops/head_op.py``),
so a ``torch.export`` of a served model holds the kernel's call. Neither
has a backward: the wrappers raise when a gradient is wanted (grad mode on
and an input requiring grad), on any device, so a training forward cannot
silently lose its gradient. For tensors on the CPU the operator runs the
plain version; for CUDA tensors it launches the kernel or raises, and a
bf16 mode input never reaches the f32 kernel. Under ``torch.func.vmap``
(the seed-batched trainer's validation and evaluation) its batching rule
folds the vmapped axis into the heads, so S seeds of V heads are one launch
at S*V heads. The counters ``kernels.evidential_heads`` and
``kernels.evidential_heads_bf16`` (``core/logging.py``) count the launches
of each build (plain ints, exact while one thread at a time launches); a
launch captured into a CUDA graph counts at each replay, not at the capture
(``core/logging.py``'s ``held_counts``, ``core/serve.py``).
"""

from __future__ import annotations

import torch

from ..core.logging import count
from . import head_op
from .head_op import evidential_heads_stacked_bf16_plain, evidential_heads_stacked_plain

KERNEL_SOURCE = "evidential_head"

__all__ = ["KERNEL_SOURCE", "evidential_head_fused", "evidential_heads_stacked",
           "evidential_heads_stacked_bf16", "evidential_heads_stacked_plain",
           "evidential_heads_stacked_bf16_plain", "library_path"]


def library_path():
    """The built library of ``csrc/evidential_head.cu`` (built on first use)."""
    from .cuda_build import build

    return build([KERNEL_SOURCE])[KERNEL_SOURCE].library


def _count(bf16: bool) -> None:
    count("kernels.evidential_heads_bf16" if bf16 else "kernels.evidential_heads")


head_op.find_library = library_path
head_op.on_launch = _count


def _heads(bf16: bool, x_stack, w1s, b1s, w2s, b2s):
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x_stack, w1s, b1s, w2s, b2s)
    ):
        raise RuntimeError(
            "evidential_heads_stacked has no backward; call it under torch.no_grad() "
            "or use the plain path for training"
        )
    return torch.ops.dmf.evidential_heads(x_stack, w1s, b1s, w2s, b2s, bf16)


def evidential_heads_stacked(x_stack, w1s, b1s, w2s, b2s):
    """V evidential heads over V inputs in one kernel launch.

    x_stack: (V, B, D), any strides with a unit last stride; w1s (V, D, H),
    b1s (V, H), w2s (V, H, C), b2s (V, C) contiguous; all float32 on one
    device. Returns (B, V, C) evidence. Forward only: raises when grad mode
    is on and an input requires grad. Under ``torch.func.vmap`` over S
    instances it makes one launch at S*V heads.
    """
    return _heads(False, x_stack, w1s, b1s, w2s, b2s)


def evidential_heads_stacked_bf16(x_stack, w1s, b1s, w2s, b2s):
    """:func:`evidential_heads_stacked` in the bf16 compute mode (the
    kernel's bf16 build): x_stack float32 or bfloat16, the parameters
    float32. Its plain version is ``evidential_heads_stacked_bf16_plain``."""
    return _heads(True, x_stack, w1s, b1s, w2s, b2s)


def evidential_head_fused(x, w1, b1, w2, b2):
    """One evidential head: x (B, D); w1 (D, H); b1 (H,); w2 (H, C); b2 (C,)
    -> (B, C) evidence, through the same kernel with V = 1."""
    return evidential_heads_stacked(
        x[None], w1[None], b1[None], w2[None], b2[None]
    )[:, 0]

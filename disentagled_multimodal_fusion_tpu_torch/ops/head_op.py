"""The evidential head kernel as a PyTorch operator, ``dmf::evidential_heads``.

    dmf::evidential_heads(x (V, B, D), w1s (V, D, H), b1s (V, H),
                          w2s (V, H, C), b2s (V, C), bf16) -> (B, V, C)

V evidential heads, Dense -> ReLU -> Dense -> saturated-exp evidence, in one
call (the Pallas kernel ``evidential_head_fused`` / ``evidential_heads_stacked``
of ``disentagled_multimodal_fusion_tpu/ops/pallas_kernels.py:53-105``). With
``bf16`` it computes in the bf16 mode of ``--dtype bfloat16`` (operands and
both layers' outputs rounded to bf16 where flax's ``Dense(dtype=bf16)``
rounds them, the evidence in f32); the weights are float32 in both modes.

On CUDA tensors it launches the hand-written kernel of
``csrc/evidential_head.cu`` through ctypes on the current stream (the C
entries ``dmf_evidential_heads`` and ``dmf_evidential_heads_bf16``); a
failed launch raises. On CPU tensors it runs the plain versions below. Its
fake implementation gives ``torch.export`` the output's shape, so an exported
program holds one call of the operator per forward, not a decomposition.
Its vmap rule folds the vmapped axis into the heads: S instances of V heads
are one call at S*V heads. It has no backward.

This file stands alone: it imports torch, ctypes and the standard library
only, so a serving process can replay an exported artifact without the
package. Load the file by path, give it the built library (CUDA artifacts
only; a CPU artifact needs the file alone), then load the program:

    spec = importlib.util.spec_from_file_location("dmf_head_op", "head_op.py")
    op = importlib.util.module_from_spec(spec); spec.loader.exec_module(op)
    op.load("evidential_head-<hash>.so")
    outputs = torch.export.load("dmvae_cml_HandWritten_seed0_b8.pt2").module()(xs)

Inside the package, ``ops/cuda_kernels.py`` sets ``find_library`` (the build
of ``csrc/evidential_head.cu``) and ``on_launch`` (its launch counters).
"""

import ctypes
import math
import os

import torch

LOG1E13 = 13.0 * math.log(10.0)
CLIP = 10.0

# the loaded kernel library, or None; ``find_library()`` gives its path when
# it is first needed and nothing was loaded
library = None
find_library = None
# called with ``bf16`` after every successful kernel launch
on_launch = None


def load(path):
    """Load the built kernel library at ``path`` (a file, relative to the
    working directory or absolute) for the CUDA implementation."""
    global library
    lib = ctypes.CDLL(os.path.abspath(path))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dmf_evidential_heads.argtypes = [p, i64, i64, p, p, p, p, p, i32, i32, i32, i32, i32, p]
    lib.dmf_evidential_heads.restype = i32
    lib.dmf_evidential_heads_bf16.argtypes = lib.dmf_evidential_heads.argtypes
    lib.dmf_evidential_heads_bf16.restype = i32
    lib.dmf_error_string.argtypes = [i32]
    lib.dmf_error_string.restype = ctypes.c_char_p
    library = lib
    return lib


def _library():
    if library is None:
        if find_library is None:
            raise RuntimeError("dmf::evidential_heads has no kernel library: call "
                               "load(path) with the build of csrc/evidential_head.cu")
        load(find_library())
    return library


def saturated_exp(z):
    """The saturated exponential exp(z) 1e13 / (exp(z) + 1e13) of an already
    clipped z, in log space (``ops/evidence.py``'s ``evidence_activation``
    clips with JAX's gradient first)."""
    log1e13 = torch.tensor(LOG1E13, dtype=z.dtype, device=z.device)
    return torch.exp(z + log1e13 - torch.logaddexp(z, log1e13))


def _evidence(z):
    """The evidence of logits z: z clipped to +-10, then its saturated
    exponential."""
    return saturated_exp(torch.clamp(z, -CLIP, CLIP))


def evidential_heads_stacked_plain(x_stack, w1s, b1s, w2s, b2s):
    """Plain PyTorch version of the f32 kernel: x_stack (V, B, D); w1s (V,
    D, H); b1s (V, H); w2s (V, H, C); b2s (V, C) -> (B, V, C) evidence."""
    h = torch.relu(torch.einsum("vbd,vdh->vbh", x_stack, w1s) + b1s[:, None, :])
    logits = torch.einsum("vbh,vhc->vbc", h, w2s) + b2s[:, None, :]
    return _evidence(logits).transpose(0, 1)


def evidential_heads_stacked_bf16_plain(x_stack, w1s, b1s, w2s, b2s):
    """Plain PyTorch version of the bf16 kernel, with its roundings (those
    of JAX's ``StackedMLP(dtype=bf16)``): operands in bf16, each product
    summed in f32 and rounded to bf16, the bias added in bf16, and the
    evidence of the bf16 logits computed in f32. Same shapes as
    :func:`evidential_heads_stacked_plain`; x f32 or bf16."""
    bf = torch.bfloat16
    h = torch.relu(torch.einsum("vbd,vdh->vbh", x_stack.to(bf), w1s.to(bf))
                   + b1s.to(bf)[:, None, :])
    logits = torch.einsum("vbh,vhc->vbc", h, w2s.to(bf)) + b2s.to(bf)[:, None, :]
    return _evidence(logits.float()).transpose(0, 1)


def launch(x_stack, w1s, b1s, w2s, b2s, bf16):
    """One checked launch of the kernel on CUDA tensors: (B, V, C) float32."""
    v, b, d = x_stack.shape
    h, c = w1s.shape[-1], w2s.shape[-1]
    expect = {"w1s": (v, d, h), "b1s": (v, h), "w2s": (v, h, c), "b2s": (v, c)}
    tensors = {"w1s": w1s, "b1s": b1s, "w2s": w2s, "b2s": b2s}
    for name, t in tensors.items():
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expect[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 parameters")
    for name, t in {"x_stack": x_stack, **tensors}.items():
        if t.device != x_stack.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all inputs must be on one CUDA device")
    if bf16 and x_stack.dtype == torch.bfloat16:
        # the bf16 build reads a float32 x and rounds it to bf16 itself; a
        # bf16 x is widened here, exactly (every bf16 value is a float32)
        x_stack = x_stack.float()
    if x_stack.dtype != torch.float32:
        raise TypeError(f"x_stack is {x_stack.dtype}; the {'bf16' if bf16 else 'f32'} kernel "
                        f"takes {'float32 or bfloat16' if bf16 else 'float32'}")
    if x_stack.stride(2) != 1 and d > 1:
        raise ValueError("x_stack must have a unit stride along D")
    out = torch.empty((b, v, c), dtype=torch.float32, device=x_stack.device)
    if b == 0 or v == 0:
        return out
    lib = _library()
    with torch.cuda.device(x_stack.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (w1s.data_ptr(), b1s.data_ptr(), w2s.data_ptr(), b2s.data_ptr(), out.data_ptr(),
                v, b, d, h, c, stream)
        entry = lib.dmf_evidential_heads_bf16 if bf16 else lib.dmf_evidential_heads
        code = entry(x_stack.data_ptr(), x_stack.stride(0), x_stack.stride(1), *ptrs)
    if code != 0:
        raise RuntimeError(f"evidential_head kernel launch failed: "
                           f"{lib.dmf_error_string(code).decode()}")
    if on_launch is not None:
        on_launch(bf16)
    return out


@torch.library.custom_op("dmf::evidential_heads", mutates_args=())
def evidential_heads(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor, w2s: torch.Tensor,
                     b2s: torch.Tensor, bf16: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        plain = evidential_heads_stacked_bf16_plain if bf16 else evidential_heads_stacked_plain
        return plain(x, w1s, b1s, w2s, b2s).contiguous()
    return launch(x, w1s, b1s, w2s, b2s, bf16)


@evidential_heads.register_fake
def _(x, w1s, b1s, w2s, b2s, bf16):
    v, b, _ = x.shape
    return x.new_empty((b, v, w2s.shape[-1]), dtype=torch.float32)


def _vmap(info, in_dims, x, w1s, b1s, w2s, b2s, bf16):
    """S instances of V heads as one call at S*V heads, (S*V, B, D) -> (B,
    S*V, C), handed back as (S, B, V, C); an input without the vmapped axis
    is broadcast over it."""
    s = info.batch_size

    def fold(t, dim):
        t = t.expand(s, *t.shape) if dim is None else t.movedim(dim, 0)
        return t.reshape(s * t.shape[1], *t.shape[2:])

    args = (fold(t, d) for t, d in zip((x, w1s, b1s, w2s, b2s), in_dims))
    out = evidential_heads(*args, bf16)
    return out.unflatten(1, (s, -1)).movedim(1, 0), 0


torch.library.register_vmap("dmf::evidential_heads", _vmap)

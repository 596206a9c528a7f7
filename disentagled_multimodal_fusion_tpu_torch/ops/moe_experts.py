"""The routed experts of a mixture-of-experts layer: routing, dispatch and one grouped product.

Added for the DeepSeek-V2 text tower (``models/text_tower.py``); it replaces
no TPU kernel (the JAX package has no expert layer). ``route`` scores the
experts in float32 and keeps each token's greedy top-k with its softmax
weight; ``dispatch`` orders the T x k (token, expert) pairs by expert and
cuts each expert's rows into tiles of ``BLOCK_M`` rows; ``moe_experts``
runs every expert's SiLU-gated MLP on exactly the rows routed to it and
returns the weighted sum over each token's k experts in float32. No token
is dropped and no expert runs on a token not routed to it.

Nothing here reads a value back to the host (no ``nonzero``, ``item``,
boolean indexing or Python loop over per-expert counts): the counts come
from ``scatter_add_``, the offsets from ``cumsum``, and the tile table has
a static size, ceil(T k / BLOCK_M) + E slots, of which a slot past the
last expert's tiles is idle. So a CUDA graph captures the whole layer
(``core/serve.py``'s ``CudaGraphs``).

**The kernel** (``moe_experts_kernel`` in ``csrc/moe_experts.cu``, CUDA
C++ built by ``ops/cuda_build.py`` with nvcc on first use and called
through ctypes on the current stream) is launched twice a layer over the
same tile table: (1) the gate and up products of the rows gathered from
the tokens, both summed in float32 in one block and multiplied as
silu(g) u in its epilogue, stored bf16 in expert order; (2) the down
product of those rows, scaled by each row's routing weight in the
epilogue and stored float32 straight to the row's (token, slot) place, so
the combine is a sum over k with no scatter and no atomics (the same bits
on every run, eager or replayed). Each block computes one tile of
BLOCK_M rows of one expert by 128 output columns (64 of the gate beside
the same 64 of the up product in the gated launch), with mma.sync from
a four-stage cp.async ring; its A rows are copied through the row index
(gathered), its weight tile from that expert's slice.

Bound: operations. A layer at 16 384 tokens, k = 6, hidden 2048 and
expert width 1408 is 2 x 98 304 x 3 x 2048 x 1408 = 1.70 TFLOP (1.72 ms at
989 TFLOP/s in bf16) against 1.11 GB of expert weights and about 1.2 GB of
activations (0.69 ms at 3.35 TB/s). This first version is plain: no
wgmma, no TMA, no persistent scheduling (the source says more); its time
beside the bound is in PERF.md.

The plain version (``grouped_product_plain``) computes the same tiles from
the same table with gathers and batched products in float32; the wrapper
takes it for tensors on the CPU and launches the kernel for CUDA tensors.
Each launch adds one to the counter ``kernels.moe_experts``
(``core/logging.py``; inside a CUDA graph's capture it is held and counted
at each replay).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.logging import count

KERNEL_SOURCE = "moe_experts"  # csrc/moe_experts.cu
# the kernel's name, as the device trace shows it
EXPERT_KERNEL = "moe_experts_kernel"
# rows a tile, both launches (the tile table is cut at it; the kernel's BM)
BLOCK_M = 128

__all__ = ["KERNEL_SOURCE", "EXPERT_KERNEL", "BLOCK_M", "route", "dispatch", "tile_table",
           "moe_experts", "grouped_product", "grouped_product_plain", "Dispatch"]


def route(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int, scaling: float = 1.0):
    """(weights (T, k) float32, experts (T, k) int64): the softmax over the
    experts of x (T, H) W_g^T, both in float32, and each token's greedy
    top-k, the weights not renormalised, times ``scaling``."""
    scores = torch.softmax(F.linear(x.float(), gate_weight.float()), dim=-1)
    weights, experts = torch.topk(scores, top_k, dim=-1)
    return weights * scaling, experts


class Dispatch(NamedTuple):
    """The (token, slot) pairs in expert order: ``order`` (M,) the flat
    index token k + slot of each row, ``token`` (M,) its token, and the tile
    table ``tile_expert``, ``tile_start``, ``tile_end`` (each (S,) int32:
    the expert of a slot, -1 when idle, its first row and its expert's
    row end)."""

    order: torch.Tensor
    token: torch.Tensor
    tile_expert: torch.Tensor
    tile_start: torch.Tensor
    tile_end: torch.Tensor


def tile_table(counts: torch.Tensor, block_m: int, slots: int):
    """(expert, start, end) of ``slots`` tiles of ``block_m`` rows over
    experts holding ``counts`` (E,) consecutive rows each: expert e's tiles
    follow expert e - 1's; slots past the last tile get expert -1."""
    tiles = (counts + block_m - 1) // block_m
    tile_ends = torch.cumsum(tiles, 0)
    row_ends = torch.cumsum(counts, 0)
    slot = torch.arange(slots, device=counts.device)
    expert = torch.searchsorted(tile_ends, slot, right=True)
    e = expert.clamp(max=counts.shape[0] - 1)
    start = row_ends[e] - counts[e] + (slot - (tile_ends[e] - tiles[e])) * block_m
    idle = expert >= counts.shape[0]
    return (torch.where(idle, -1, expert).int(), start.int(), row_ends[e].int())


def dispatch(experts: torch.Tensor, num_experts: int) -> Dispatch:
    """The rows of the (T, k) routing in expert order (a stable sort, so a
    token's rows keep their slot order within an expert), and the tiles of
    ``BLOCK_M`` rows."""
    t, k = experts.shape
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(num_experts, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    slots = -(-t * k // BLOCK_M) + num_experts
    return Dispatch(order, order // k, *tile_table(counts, BLOCK_M, slots))


def grouped_product_plain(a, w1, w2, d: Dispatch, out, rows=None, dest=None, scale=None):
    """The kernel's arithmetic by tiles, in float32: for each slot of the
    table, rows [start, min(start + BLOCK_M, end)) of ``a`` (through
    ``rows`` when given) times expert e's ``w1`` (E, N, K) transposed;
    silu(that) times the same of ``w2`` when ``w2`` is given, else times
    ``scale`` of each row; written to ``out`` at the row (through ``dest``
    when given). Returns ``out``."""
    r = d.tile_start.long()[:, None] + torch.arange(BLOCK_M, device=a.device)
    valid = (r < d.tile_end.long()[:, None]) & (d.tile_expert[:, None] >= 0)
    r = torch.where(valid, r, 0)
    e = d.tile_expert.long().clamp(min=0)
    x = a[rows[r] if rows is not None else r].float()                     # (S, BM, K)
    y = torch.bmm(x, w1[e].float().transpose(1, 2))                       # (S, BM, N)
    if w2 is not None:
        y = F.silu(y) * torch.bmm(x, w2[e].float().transpose(1, 2))
    else:
        y = y * scale[r].float()[..., None]
    at = torch.where(valid, dest[r] if dest is not None else r, out.shape[0])
    whole = torch.cat([out, out.new_empty((1, out.shape[1]))])           # row M: idle rows
    whole.index_put_((at.reshape(-1),), y.reshape(-1, y.shape[-1]).to(out.dtype))
    out.copy_(whole[:-1])
    return out


@functools.lru_cache(maxsize=None)
def _library():
    from .cuda_build import load_library

    lib = load_library(KERNEL_SOURCE)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dmf_moe_experts.argtypes = [p] * 10 + [i32] * 4 + [i64] * 4 + [p]
    lib.dmf_moe_experts.restype = i32
    lib.dmf_error_string.argtypes = [i32]
    lib.dmf_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(a, w1, w2, d: Dispatch, out, rows, dest, scale):
    for name, t in (("a", a), ("w1", w1), ("out", out)) + ((("w2", w2),) if w2 is not None
                                                           else ()):
        if not t.is_contiguous():
            raise ValueError(f"moe_experts: {name} must be contiguous")
    if a.dtype != torch.bfloat16 or w1.dtype != torch.bfloat16:
        raise TypeError(f"moe_experts: the kernel takes bf16 rows and weights, not "
                        f"{a.dtype} and {w1.dtype}")
    gated = w2 is not None
    want = (torch.bfloat16 if gated else torch.float32, torch.int64, torch.int64, torch.float32)
    for name, t, dtype in zip(("out", "rows", "dest", "scale"), (out, rows, dest, scale), want):
        if t is not None and t.dtype != dtype:
            raise TypeError(f"moe_experts: {name} must be {dtype}, not {t.dtype}")
    lib = _library()
    n, k = w1.shape[1], w1.shape[2]
    err = lib.dmf_moe_experts(
        a.data_ptr(), _ptr(rows), w1.data_ptr(), _ptr(w2), out.data_ptr(), _ptr(dest),
        _ptr(scale), d.tile_expert.data_ptr(), d.tile_start.data_ptr(), d.tile_end.data_ptr(),
        d.tile_expert.shape[0], BLOCK_M, n, k, a.stride(0), w1.stride(0), w1.stride(1),
        out.stride(0), torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_experts: the launch failed ({lib.dmf_error_string(err).decode()}"
                           f"; N={n}, K={k}, block_m={BLOCK_M})")
    count("kernels.moe_experts")
    return out


def grouped_product(a, w1, w2, d: Dispatch, out, rows=None, dest=None, scale=None):
    """:func:`grouped_product_plain`'s product: the kernel for CUDA
    tensors, the plain version for tensors on the CPU."""
    if a.is_cuda:
        return _launch(a, w1, w2, d, out, rows, dest, scale)
    return grouped_product_plain(a, w1, w2, d, out, rows, dest, scale)


def moe_experts(x: torch.Tensor, weights: torch.Tensor, experts: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """sum_k weights[t, k] E_{experts[t, k]}(x[t]) in float32, (T, H), where
    E_e(x) = W_down[e] (silu(W_gate[e] x) * W_up[e] x): x (T, H), weights and
    experts (T, k), w_gate and w_up (E, I, H), w_down (E, H, I)."""
    t, k = experts.shape
    d = dispatch(experts, w_gate.shape[0])
    h = grouped_product(x, w_gate, w_up, d, x.new_empty((t * k, w_gate.shape[1])),
                        rows=d.token)
    y = grouped_product(h, w_down, None, d,
                        torch.empty((t * k, w_down.shape[1]), dtype=torch.float32,
                                    device=x.device),
                        dest=d.order, scale=weights.reshape(-1)[d.order].contiguous())
    return y.view(t, k, -1).sum(dim=1)

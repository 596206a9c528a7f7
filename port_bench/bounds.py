"""Peaks of one NVIDIA H100 SXM and the least time the head kernel's work can take.

The peaks are NVIDIA's data sheet (dense, at the full 700 W power limit):
67 TFLOP/s in float32 outside the tensor cores, 989 TFLOP/s in bf16 on
them, 3.35 TB/s of HBM3. The port keeps TF32 off, so its float32 products
run against the first. ``head_work`` counts the evidential heads' work from
the model's published widths (unpadded view widths for late fusion), each
input byte read once and each output byte written once, whatever a kernel
reads again; with equal widths it is the arithmetic of ``head_bound`` in
the repository's ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def head_work(views: Sequence[int], rows: int, hidden: int, classes: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of V evidential heads (Dense -> ReLU -> Dense ->
    evidence) over ``rows`` rows, head v reading ``views[v]`` features:
    the two products' multiply-adds, and float32 inputs, weights, biases
    and the (rows, V, C) evidence moved once."""
    v = len(views)
    flops = 2.0 * rows * sum(d * hidden + hidden * classes for d in views)
    nbytes = 4.0 * (rows * sum(views) + hidden * sum(views) + v * hidden
                    + v * hidden * classes + v * classes + rows * v * classes)
    return flops, nbytes


def head_bound_s(views: Sequence[int], rows: int, hidden: int, classes: int,
                 peak_flops: float = PEAK_F32_FLOPS) -> Tuple[float, str]:
    """(seconds, 'operations' | 'bytes'): the larger of the heads' FLOPs
    over ``peak_flops`` and their bytes over the memory rate."""
    flops, nbytes = head_work(views, rows, hidden, classes)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def dense_flops(widths: Sequence[int]) -> int:
    """FLOPs a row of an MLP with layer widths (in, h1, ..., out)."""
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def conv3x3_flops(cin: int, cout: int, height: int, width: int) -> int:
    """FLOPs a row of a 3 x 3 'SAME' convolution over a (cin, height,
    width) map: 2 * 9 * cin multiply-adds at each of cout * height * width
    outputs."""
    return 2 * 9 * cin * cout * height * width

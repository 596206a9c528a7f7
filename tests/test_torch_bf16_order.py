"""The order in which the head kernel's bf16 build sums, emulated on the CPU.

The bf16 build (``csrc/evidential_head.cu``, ``evidential_heads_bf16_kernel``)
multiplies on the tensor cores: bf16 operands, f32 sums, 16-deep steps
(``mma.sync.m16n8k16``) taken in k order, each step's 16 products (exact in
f32) added to the running f32 sum; each layer's sum is rounded to bf16 once
after its whole K loop, then the bias is added and rounded. The emulation
below sums each step's products exactly, rounds the step to f32 and adds it
to an f32 accumulator in k order, then rounds as flax rounds. It is held
against the kernel's plain version (``evidential_heads_stacked_bf16_plain``,
torch's own bf16 product order) and against float64 of the bf16-rounded
operands under the bf16 rule of tests/test_torch_bf16.py (log-evidence
within 2 bf16 ulps but for 1 in 1000 entries, none beyond 4 ulps of its own
size or of the tensor's rms), at every head shape that ``--dtype bfloat16``
launches the build at (chip_smoke.py's ``BF16_SHAPES``). So the tolerance
that phase 3 of chip_smoke.py holds the kernel to on the card covers the
tensor cores' order before any card runs it.
"""

import numpy as np
import pytest
import torch
from test_torch_kernels import _assert_bf16_evidence_close

from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck
from disentagled_multimodal_fusion_tpu_torch.ops.evidence import evidence_activation

STEP = 16  # the depth of one mma.sync.m16n8k16

# (V, B, D, H, C): HandWritten's probe and late-fusion heads and (7, 256);
# LUMA's (3|4, 840|160) and its five stacked seeds (15|20, 840), (20, 4200);
# CUB's late fusion (D = 1024), PIE's (D = 484, C = 68), Scene's (D = 59,
# C = 15) and the synthetic sweep's (D = 16, C = 3); --vmap-seeds's five
# seeds of HandWritten, the synthetic sweep and Scene
SHAPES = [(7, 400, 200, 128, 10), (6, 400, 200, 128, 10), (6, 400, 240, 128, 10),
          (7, 256, 200, 128, 10), (3, 840, 200, 128, 42), (4, 840, 200, 128, 42),
          (3, 160, 200, 128, 42), (4, 160, 200, 128, 42), (15, 840, 200, 128, 42),
          (20, 840, 200, 128, 42), (20, 4200, 200, 128, 42), (2, 120, 1024, 128, 10),
          (3, 136, 484, 128, 68), (3, 897, 59, 128, 15), (3, 2000, 16, 128, 3),
          (35, 400, 200, 128, 10), (30, 400, 200, 128, 10), (30, 400, 240, 128, 10),
          (15, 2000, 16, 128, 3), (10, 2000, 32, 128, 3), (15, 897, 59, 128, 15),
          (20, 897, 200, 128, 15)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs this file beside other test
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(t):
    return t.to(torch.bfloat16)


def steps_sum(a, w):
    """a (V, B, K) @ w (V, K, N) of bf16 values as the kernel sums it: each
    16-deep step exactly, rounded to f32, added to an f32 sum in k order (K
    padded with zeros to a whole step)."""
    k = a.shape[-1]
    acc = torch.zeros(a.shape[0], a.shape[1], w.shape[-1], dtype=torch.float32)
    for k0 in range(0, k, STEP):
        part = torch.bmm(a[..., k0:k0 + STEP].double(), w[:, k0:k0 + STEP].double())
        acc = acc + part.float()
    return acc


def heads_in_kernel_order(x, w1, b1, w2, b2):
    """The bf16 heads with the kernel's summation order: (B, V, C) f32."""
    h = torch.relu(_bf16(steps_sum(_bf16(x), _bf16(w1))) + _bf16(b1)[:, None, :])
    z = _bf16(steps_sum(h, _bf16(w2))) + _bf16(b2)[:, None, :]
    return evidence_activation(z.float()).transpose(0, 1)


def heads_float64(x, w1, b1, w2, b2):
    """The bf16 heads with every sum exact: the operands rounded to bf16, each
    product summed in float64 and rounded to bf16, the bias added and
    rounded, the evidence in float64."""
    def r(t):
        return _bf16(t).double()

    h = torch.relu(r(r(torch.bmm(r(x), r(w1))) + r(b1)[:, None, :]))
    z = r(r(torch.bmm(h, r(w2))) + r(b2)[:, None, :])
    return evidence_activation(z).transpose(0, 1)


def _inputs(v, b, d, h, c, seed):
    """chip_smoke.py's inputs: xavier-sized weights, so the logits stay
    mostly inside the evidence clip."""
    rng = np.random.default_rng(seed)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return (t((v, b, d), 1.0), t((v, d, h), (2.0 / (d + h)) ** 0.5), t((v, h), 0.05),
            t((v, h, c), (2.0 / (h + c)) ** 0.5), t((v, c), 0.05))


@pytest.mark.parametrize("v,b,d,h,c", SHAPES, ids=lambda s: str(s))
def test_kernel_summation_order_is_inside_the_bf16_rule(v, b, d, h, c):
    args = _inputs(v, b, d, h, c, seed=v * 7919 + b)
    got = heads_in_kernel_order(*args)
    assert got.shape == (b, v, c) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    _assert_bf16_evidence_close(got, ck.evidential_heads_stacked_bf16_plain(*args))
    _assert_bf16_evidence_close(got, heads_float64(*args))

"""The port's evidential head kernel module against the JAX Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode. The cases and the tolerance
(rtol 1e-5, atol 1e-6) are those of tests/test_pallas.py: both sides are
float32 and differ only in summation order. The CUDA kernel itself is held
against the plain version by the ``gpu`` test below and by chip_smoke.py.

The JAX kernels are imported inside the tests that use them, so that the
``gpu`` test also runs on a CUDA machine without JAX:

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck

TOL = dict(rtol=1e-5, atol=1e-6)


def _head_inputs(rng, b, d, h, c, scale, bias_scale):
    x = rng.standard_normal((b, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, h)) * scale).astype(np.float32)
    b1 = (rng.standard_normal(h) * bias_scale).astype(np.float32)
    w2 = (rng.standard_normal((h, c)) * scale).astype(np.float32)
    b2 = (rng.standard_normal(c) * bias_scale).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize(
    "b,d,h,c,scale,bias_scale",
    [
        (100, 200, 128, 10, 0.05, 0.01),  # the probe head's shape
        (13, 47, 33, 68, 0.1, 0.0),       # deliberately unaligned
        (600, 40, 32, 10, 0.1, 0.0),      # ragged tail past a 512-row tile
    ],
)
def test_head_matches_jax(b, d, h, c, scale, bias_scale):
    from disentagled_multimodal_fusion_tpu.ops import pallas_kernels

    args = _head_inputs(np.random.default_rng(b), b, d, h, c, scale, bias_scale)
    ref = np.asarray(pallas_kernels.evidential_head_fused(*args, interpret=True))
    out = ck.evidential_head_fused(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_stacked_matches_jax():
    from disentagled_multimodal_fusion_tpu.ops import pallas_kernels

    rng = np.random.default_rng(3)
    v, b, d, h, c = 3, 32, 16, 24, 5
    xs = rng.standard_normal((v, b, d)).astype(np.float32)
    w1s = (rng.standard_normal((v, d, h)) * 0.1).astype(np.float32)
    b1s = (rng.standard_normal((v, h)) * 0.1).astype(np.float32)
    w2s = (rng.standard_normal((v, h, c)) * 0.1).astype(np.float32)
    b2s = (rng.standard_normal((v, c)) * 0.1).astype(np.float32)
    ref = np.asarray(
        pallas_kernels.evidential_heads_stacked(xs, w1s, b1s, w2s, b2s, interpret=True)
    )
    args = [torch.from_numpy(a) for a in (xs, w1s, b1s, w2s, b2s)]
    out = ck.evidential_heads_stacked(*args)
    assert out.shape == (b, v, c)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the probe hands over its (B, V, D) stack as a strided (V, B, D) view
    strided = torch.from_numpy(np.ascontiguousarray(xs.transpose(1, 0, 2))).transpose(0, 1)
    np.testing.assert_allclose(ck.evidential_heads_stacked(strided, *args[1:]).numpy(), ref, **TOL)


def test_plain_path_is_not_counted_as_a_launch():
    before = ck.evidential_heads_stacked.launches
    args = _head_inputs(np.random.default_rng(0), 4, 6, 5, 3, 0.1, 0.1)
    ck.evidential_head_fused(*(torch.from_numpy(a) for a in args))
    assert ck.evidential_heads_stacked.launches == before


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure

    configure()  # the plain version on cuBLAS in full float32, no TF32
    rng = np.random.default_rng(7)
    for v, b, d, h, c in [(7, 256, 200, 128, 10), (6, 1, 240, 128, 10), (1, 13, 47, 33, 68)]:
        xs = torch.from_numpy(rng.standard_normal((v, b, d)).astype(np.float32)).cuda()
        ws = [
            torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32)).cuda()
            for s in ((v, d, h), (v, h), (v, h, c), (v, c))
        ]
        before = ck.evidential_heads_stacked.launches
        out = ck.evidential_heads_stacked(xs, *ws)
        torch.cuda.synchronize()
        assert ck.evidential_heads_stacked.launches == before + 1
        ref = ck.evidential_heads_stacked_plain(xs, *ws)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)

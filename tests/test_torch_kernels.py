"""The port's evidential head kernel module against the JAX Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode. The cases and the tolerance
(rtol 1e-5, atol 1e-6) are those of tests/test_pallas.py: both sides are
float32 and differ only in summation order. The CUDA kernels themselves (the
evidential head, its bf16 build and the probe epoch) are held against their
plain versions by the ``gpu`` tests below and by chip_smoke.py; the bf16
build at the bf16 tolerance of tests/test_torch_bf16.py (its plain version
is held against the JAX package there).

The JAX kernels are imported inside the tests that use them, so that the
``gpu`` tests also run on a CUDA machine without JAX:

    python -m pytest -o addopts= --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu_torch.core.logging import counters
from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck
from disentagled_multimodal_fusion_tpu_torch.ops import head_op

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
        # the main path's late-fusion widths, narrowed in B: CUB (D=1024),
        # PIE (D=484, C=68), Scene (D=59, C=15), and a head wider than 128
        (120, 1024, 128, 10, 0.03, 0.01),
        (136, 484, 128, 68, 0.05, 0.01),
        (97, 59, 128, 15, 0.1, 0.01),
        (64, 200, 256, 10, 0.05, 0.01),
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
    before = counters()["kernels.evidential_heads"]
    args = _head_inputs(np.random.default_rng(0), 4, 6, 5, 3, 0.1, 0.1)
    ck.evidential_head_fused(*(torch.from_numpy(a) for a in args))
    assert counters()["kernels.evidential_heads"] == before


def _stacked_head_inputs(rng, s, v, b, d, h, c):
    shapes = ((s, v, b, d), (s, v, d, h), (s, v, h), (s, v, h, c), (s, v, c))
    return [torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32))
            for shape in shapes]


def test_head_wrapper_under_vmap_folds_seeds_into_heads(monkeypatch):
    """Under torch.func.vmap the wrapper makes one call at S * V heads (on
    the CPU its plain version; on the card one launch), equal to the
    per-seed calls and to the plain version vmapped; an input without the
    vmapped axis (one dataset shared by every seed) is broadcast. The
    plain version is the one the operator ``dmf::evidential_heads`` runs on
    the CPU (``ops/head_op.py``)."""
    s, v, b, d, h, c = 3, 4, 9, 12, 8, 5
    stacked = _stacked_head_inputs(np.random.default_rng(5), s, v, b, d, h, c)
    plain = ck.evidential_heads_stacked_plain
    calls = []

    def recorded(*args):
        calls.append(tuple(args[0].shape))
        return plain(*args)

    monkeypatch.setattr(head_op, "evidential_heads_stacked_plain", recorded)
    with torch.no_grad():
        got = torch.func.vmap(ck.evidential_heads_stacked)(*stacked)
        shared = torch.func.vmap(ck.evidential_heads_stacked, in_dims=(None, 0, 0, 0, 0))(
            stacked[0][0], *stacked[1:])
    assert calls == [(s * v, b, d), (s * v, b, d)]
    assert got.shape == (s, b, v, c)
    np.testing.assert_array_equal(got.numpy(), torch.func.vmap(plain)(*stacked).numpy())
    for i in range(s):
        np.testing.assert_allclose(got[i].numpy(), plain(*(t[i] for t in stacked)).numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(shared[i].numpy(),
                                   plain(stacked[0][0], *(t[i] for t in stacked[1:])).numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
def test_cuda_head_kernel_under_vmap_is_one_launch():
    _needs_cuda()
    seeds = 5
    for v, b, d in ((7, 400, 200), (6, 400, 200), (6, 400, 240)):
        stacked = [t.cuda() for t in _stacked_head_inputs(np.random.default_rng(v + d), seeds,
                                                         v, b, d, 128, 10)]
        before = counters()["kernels.evidential_heads"]
        with torch.no_grad():
            got = torch.func.vmap(ck.evidential_heads_stacked)(*stacked)
        torch.cuda.synchronize()
        assert counters()["kernels.evidential_heads"] == before + 1
        for i in range(seeds):
            ref = ck.evidential_heads_stacked(*(t[i] for t in stacked))
            np.testing.assert_allclose(got[i].cpu().numpy(), ref.cpu().numpy(),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure

    configure()  # the plain version on cuBLAS in full float32, no TF32
    rng = np.random.default_rng(7)
    shapes = [(7, 256, 200, 128, 10), (6, 1, 240, 128, 10), (1, 13, 47, 33, 68)]
    # validation on HandWritten's test split, and the other datasets' late
    # fusion and probe widths
    shapes += [(7, 400, 200, 128, 10), (6, 400, 240, 128, 10), (2, 120, 1024, 128, 10),
               (3, 136, 484, 128, 68), (3, 97, 59, 128, 15), (4, 897, 200, 128, 15),
               (7, 256, 200, 256, 10)]
    # LUMA at C = 42: the cut corpus's test and OOD rows, and the full corpus's
    shapes += [(3, 840, 200, 128, 42), (4, 160, 200, 128, 42), (4, 4200, 200, 128, 42),
               (3, 800, 200, 128, 42)]
    for v, b, d, h, c in shapes:
        xs = torch.from_numpy(rng.standard_normal((v, b, d)).astype(np.float32)).cuda()
        ws = [
            torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32)).cuda()
            for s in ((v, d, h), (v, h), (v, h, c), (v, c))
        ]
        before = counters()["kernels.evidential_heads"]
        out = ck.evidential_heads_stacked(xs, *ws)
        torch.cuda.synchronize()
        assert counters()["kernels.evidential_heads"] == before + 1
        ref = ck.evidential_heads_stacked_plain(xs, *ws)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


def _assert_bf16_evidence_close(got, ref):
    """tests/test_torch_bf16.py's rule on the log of the evidence: within 2
    bf16 ulps but for 1 in 1000 entries, none beyond 4 ulps of its own size
    or of the tensor's rms."""
    g, r = got.double().log(), ref.double().log()
    err = (g - r).abs()
    assert int((err > 2.0 ** -7 * r.abs() + 1e-3).sum()) <= got.numel() // 1000
    assert bool((err <= 2.0 ** -6 * (r.abs() + r.pow(2).mean().sqrt())).all())


@pytest.mark.gpu
def test_cuda_bf16_head_kernel_matches_plain():
    """The bf16 build against its plain version on the card: from a float32
    x (one launch each), from a bf16 x and from a strided x (the same bits),
    and under torch.func.vmap (one launch at S x V heads); the f32 build
    refuses a bf16 x. The shapes take the kernel's tile edges: B one past a
    32- or 64-row tile and short of one, D = 16, 59 (4-byte copies), 300
    and 1024 (W1 streamed), H = 33 and 40 (n-tiles of padding) and 256 (two
    passes), C = 3, 15, 42 and 68, V = 1; and blocks of several row tiles
    with W1 resident and one or two chunks per tile (the seed-batched
    synthetic and Scene heads, up to 16 tiles a block), where a tile's h
    is written while the last tile's may still be read."""
    _needs_cuda()
    rng = np.random.default_rng(11)
    shapes = [(7, 256, 200, 128, 10), (3, 840, 200, 128, 42), (4, 160, 200, 128, 42),
              (20, 840, 200, 128, 42), (1, 13, 47, 33, 68), (2, 50, 300, 256, 15),
              (3, 2000, 16, 128, 3), (3, 97, 59, 128, 15), (2, 120, 1024, 128, 10),
              (3, 136, 484, 128, 68), (5, 33, 200, 128, 42), (1, 65, 16, 40, 3),
              (6, 63, 240, 128, 10), (15, 2000, 16, 128, 3), (10, 2000, 32, 128, 3),
              (15, 897, 59, 128, 15), (66, 2000, 16, 128, 3), (20, 1000, 16, 256, 3)]
    for v, b, d, h, c in shapes:
        xs = torch.from_numpy(rng.standard_normal((v, b, d)).astype(np.float32)).cuda()
        ws = [torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32)).cuda()
              for s in ((v, d, h), (v, h), (v, h, c), (v, c))]
        before = counters()["kernels.evidential_heads_bf16"]
        out = ck.evidential_heads_stacked_bf16(xs, *ws)
        out_bf16_x = ck.evidential_heads_stacked_bf16(xs.to(torch.bfloat16), *ws)
        strided = xs.transpose(0, 1).contiguous().transpose(0, 1)
        out_strided = ck.evidential_heads_stacked_bf16(strided, *ws)
        torch.cuda.synchronize()
        assert counters()["kernels.evidential_heads_bf16"] == before + 3
        assert torch.equal(out, out_bf16_x) and torch.equal(out, out_strided), (v, b, d, h, c)
        _assert_bf16_evidence_close(out, ck.evidential_heads_stacked_bf16_plain(xs, *ws))
    stacked = [t.cuda() for t in _stacked_head_inputs(np.random.default_rng(3), 5, 3, 840, 200,
                                                      128, 42)]
    before = counters()["kernels.evidential_heads_bf16"]
    with torch.no_grad():
        got = torch.func.vmap(ck.evidential_heads_stacked_bf16)(*stacked)
    torch.cuda.synchronize()
    assert counters()["kernels.evidential_heads_bf16"] == before + 1
    _assert_bf16_evidence_close(got, torch.func.vmap(ck.evidential_heads_stacked_bf16_plain)(
        *stacked))
    with pytest.raises(TypeError):
        ck.evidential_heads_stacked(xs.to(torch.bfloat16), *ws)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from disentagled_multimodal_fusion_tpu_torch.core.setup import configure

    configure()  # the plain versions on cuBLAS in full float32, no TF32


@pytest.mark.gpu
def test_cuda_head_kernel_refuses_a_gradient():
    _needs_cuda()
    args = [torch.randn(s, device="cuda") for s in ((2, 3, 4), (2, 4, 5), (2, 5), (2, 5, 3), (2, 3))]
    args[1].requires_grad_()
    before = counters()["kernels.evidential_heads"]
    with pytest.raises(RuntimeError, match="no backward"):
        ck.evidential_heads_stacked(*args)
    assert counters()["kernels.evidential_heads"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("v,b,d,h,c,tail", [
    (3, 16, 12, 8, 5, 6),
    (7, 100, 200, 128, 10, None),
    (8, 50, 37, 30, 68, 17),      # more classes than lanes, the most views, odd widths
    (4, 100, 200, 128, 15, None),
    (3, 128, 16, 128, 3, None),   # the synthetic sweep's probe: C = 3, a whole 128-row chunk
    (3, 100, 200, 128, 10, 80),   # CUB's probe with its ragged tail of 80
])
def test_cuda_probe_epoch_kernel_matches_plain(v, b, d, h, c, tail):
    """One epoch of S = 3 steps, kernel against plain version on the card, at
    the tolerances of the CPU parity test (losses rtol 2e-5 / atol 2e-6;
    p, m, v rtol 5e-3 / atol 5e-5). D and H that are not multiples of 4 take
    the forward kernel's 4-byte copies. The moments start small and random,
    as in chip_smoke.py: from zero moments Adam's first steps map a gradient
    near zero to about +-lr, and at V=4, C=15 the float32 plain version
    itself then misses its float64 twin on one W1 entry."""
    from disentagled_multimodal_fusion_tpu_torch.ops import probe_megakernel as pm

    _needs_cuda()
    rng = np.random.default_rng(v)
    s, keep = 3, 0.7

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).cuda()

    xs = rng.standard_normal((s, v, b, d))
    rmasks = np.ones((s, b, 1))
    if tail is not None:
        rmasks[-1, tail:] = 0.0
        xs[-1, :, tail:] = 0.0
    yohs = np.eye(c)[rng.integers(0, c, (s, b))] * rmasks
    counts = np.arange(1, s + 1, dtype=np.float32)
    streams = [t(xs), t(rng.random((s, v, b, h)) < keep), t(yohs), t(rmasks),
               t((1 - np.float32(0.9) ** counts)[:, None]),
               t((1 - np.float32(0.999) ** counts)[:, None])]
    shapes = [(v, d, h), (v, h), (v, h, c), (v, c)]
    params = tuple(t((rng.random(sh) * 2 - 1) * 0.2) for sh in shapes)
    mus = tuple(t(rng.standard_normal(sh) * 1e-3) for sh in shapes)
    nus = tuple(t(rng.random(sh) * 1e-6) for sh in shapes)
    kw = dict(keep=keep, fused=1.0, num_classes=c, weight_decay=1e-2)
    ref = pm.run_epoch_plain(*streams, 3e-3, 0.4, 0.68, params, mus, nus, **kw)
    before = counters()["kernels.probe_epoch"]
    clone = lambda ts: tuple(x.clone() for x in ts)  # noqa: E731
    got = pm.run_epoch_kernel(*streams, 3e-3, 0.4, 0.68, clone(params), clone(mus), clone(nus),
                              **kw)
    torch.cuda.synchronize()
    assert counters()["kernels.probe_epoch"] == before + 1
    np.testing.assert_allclose(got[3].cpu().numpy(), ref[3].cpu().numpy(), rtol=2e-5, atol=2e-6)
    for group in range(3):
        for a, r in zip(got[group], ref[group]):
            np.testing.assert_allclose(a.cpu().numpy(), r.cpu().numpy(), rtol=5e-3, atol=5e-5)

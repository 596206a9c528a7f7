"""The port's bf16 compute mode (``--dtype bfloat16``) against the JAX
package's ``dtype=jnp.bfloat16`` modules, on the CPU.

Each case builds the flax module with ``dtype=bfloat16``, carries its
float32 parameters over with ``convert.py`` into the port's module built
with ``dtype="bfloat16"``, and compares the forward on the same numpy
inputs (the JAX draws recorded and fed in where a forward draws):

* FusedDMVAE's ``get_embedding`` and its training loss with every term;
  the per-modality DMVAE's too (its statistics, draws, PoE and KL terms are
  bf16 in both packages);
* StackedMLP in training mode (bf16 dropout, ``h / keep`` in bf16);
* every registry fusion on bf16 views: the JAX ops' output type (bf16
  for the parameter-free ``concat`` and ``tensor``, float32 where the views
  meet float32 parameters) and values (those of float32 inputs made of the
  same bf16 numbers: rtol 1e-4 / atol 1e-5 of tests/test_torch_fusions.py,
  its bound for a reordered contraction, against the largest entry);
* the four probes, FusedLateFusion and LateFusion, and IntermediateFusion
  over ``concat`` and ``lrtf`` (the fused heads through the operator
  ``dmf::evidential_heads``, whose CPU implementation is the bf16 kernel's
  plain version);
* the three LUMA encoders with ``dtype=bfloat16``, in eval mode and in
  train mode (the JAX keep-masks fed in), with BatchNorm's new running
  statistics (float32 in both);
* the head kernel's plain bf16 version against JAX's bf16 StackedMLP plus
  the float32 evidence at V = 7, B = 256, C = 10 and V = 3, B = 840, C = 42,
  and under ``torch.func.vmap`` over S = 5 stacked heads.

Tolerance (``assert_bf16_close``): an embedding, logit or loss entry is
within 2 bf16 ulps, |d| <= 2^-7 |ref| + 1e-3, but for at most 1 in 1000
entries; and none is beyond 4 ulps of its own size or of the tensor's
typical one, |d| <= 2^-6 (|ref| + rms(ref)). XLA and torch both sum a bf16
product in float32 and round once, but in another order, so an entry that
lies within rounding of a bf16 boundary may round apart by one ulp, and a
ReLU or the next layer carries that on. The outlier bound is the tensor's
and not the entry's because a bias that cancels most of a product passes
on the product's rounding: z = bf16(bf16(h W2) + b2) near 0.1 carries the
ulp of h W2 near 3 (0.0156), 4.9 times the 4-ulp bound of z itself at
(3, 840, 42), the one entry of 105 840 that the first bound (none beyond
2^-6 |ref| + 2e-3) refused. Evidence (up to e^10 ~ 2.2e4) is compared
through its log, the logit it came from (``assert_evidence_close``): the
same budget carried through exp. A flat rtol of 2^-6 on the evidence was
refused once in 105 840 entries at (3, 840): at a logit near 8 one bf16
ulp is 2^-5 to 2^-4, so one ulp moves the evidence by 3-6 %. The BatchNorm
statistics, float32 means over bf16 activations, at rtol 1e-3 / atol 1e-4.

The convolutional encoders in train mode (image, 2-D audio) are held to
the outlier bound alone: BatchNorm over the batch divides by the batch's
standard deviation, so a one-ulp difference of a convolution output x
becomes ulp(x) / std in the normalised value, several of its own ulps
where x sits near the batch mean; the next convolution sums 288 or more
such terms. The first BatchNorm's output already had 596 of 393 216
entries beyond 2 ulps, and the image encoder's output 58 of 192, while
none came near the outlier bound (largest 0.77 of it).

``PYTHONPATH=. python tests/test_torch_bf16.py`` runs these tests and prints every
comparison's reading (entries beyond 2 ulps, their count, the largest gap
over the outlier bound) as one JSON line; PERF.md section 2 has them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_luma import jitted_draws, split_draws

from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.models import baselines as jbase
from disentagled_multimodal_fusion_tpu.models import dmvae as jdmvae
from disentagled_multimodal_fusion_tpu.models import dmvae_fused as jfused
from disentagled_multimodal_fusion_tpu.models import fusions as jfusions
from disentagled_multimodal_fusion_tpu.models import layers as jlayers
from disentagled_multimodal_fusion_tpu.models import probes as jprobes
from disentagled_multimodal_fusion_tpu.ops.evidence import evidence_activation as jevidence
from disentagled_multimodal_fusion_tpu_torch.convert import flax_to_state_dict, load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core.logging import counters
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.models import baselines as tbase
from disentagled_multimodal_fusion_tpu_torch.models import dmvae as tdmvae
from disentagled_multimodal_fusion_tpu_torch.models import dmvae_fused as tfused
from disentagled_multimodal_fusion_tpu_torch.models import fusions as tfusions
from disentagled_multimodal_fusion_tpu_torch.models import layers as tlayers
from disentagled_multimodal_fusion_tpu_torch.models import probes as tprobes
from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck

BF16 = jnp.bfloat16
X_DIMS = (12, 10, 7)
STATS_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs this file beside other test
    processes, as tests/test_torch_luma.py does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(a):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float64)


def bf16_gaps(got, ref):
    """(entries beyond 2 ulps, the largest gap over the outlier bound)."""
    got, ref = _np(got), _np(ref)
    err = np.abs(got - ref)
    beyond = int(np.count_nonzero(err > 2.0 ** -7 * np.abs(ref) + 1e-3))
    worst = 2.0 ** -6 * (np.abs(ref) + np.sqrt(np.mean(ref ** 2)))
    return beyond, float(np.max(err / np.maximum(worst, 1e-30)))


READINGS = []


def assert_bf16_close(got, ref, label="", compounded=False):
    """Within 2 bf16 ulps entry by entry, but for at most 1 in 1000 entries
    (not held where ``compounded``), none beyond 4 of its own size or the
    tensor's (module docstring)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    assert np.all(np.isfinite(got)), label
    beyond, ratio = bf16_gaps(got, ref)
    READINGS.append(dict(label=label, beyond_2_ulps=beyond, entries=got.size,
                         outlier_ratio=round(ratio, 4)))
    if not compounded:
        assert beyond <= got.size // 1000, (label, beyond, got.size)
    assert ratio <= 1.0, (label, ratio)


def assert_evidence_close(got, ref, label=""):
    """Evidence through its log, at the logits' tolerance."""
    got, ref = _np(got), _np(ref)
    assert np.all(got > 0) and np.all(ref > 0), label
    assert_bf16_close(np.log(got), np.log(ref), label)


def _gen(seed=123):
    return torch.Generator().manual_seed(seed)


def _views(rows=9, dims=X_DIMS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, d)).astype(np.float32) for d in dims]


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


# ------------------------------------------------------------------ DMVAE
def _dmvae_pair(fused, **kw):
    jcls, tcls = (jfused.FusedDMVAE, tfused.FusedDMVAE) if fused else (jdmvae.DMVAE, tdmvae.DMVAE)
    cfg = dict(x_dims=X_DIMS, hidden_dim=32, embed_dim=8, a=0.3, **kw)
    xs = _views()
    jmodel = jcls(**cfg, dtype=BF16)
    params = jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
                          "dropout": jax.random.PRNGKey(1)},
                         [jnp.asarray(x) for x in xs], train=True)["params"]
    port = load_flax_params(tcls(generator=_gen(), **cfg, dtype="bfloat16").eval(),
                            jax.device_get(params))
    return jmodel, params, port, xs


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dmvae_bf16_embedding_and_loss_match_jax(fused):
    jmodel, params, port, xs = _dmvae_pair(fused)
    jxs = [jnp.asarray(x) for x in xs]
    ref_zc, ref_zp = jmodel.apply({"params": params}, jxs, method="get_embedding")
    with torch.no_grad():
        zc, zp = port.get_embedding(_t(xs))
    assert_bf16_close(zc, ref_zc, "zc")
    for i, (a, b) in enumerate(zip(zp, ref_zp)):
        assert_bf16_close(a, b, f"zp{i}")

    mask = np.ones(len(xs[0]), np.float32)
    mask[-2:] = 0.0
    run, kinds = jitted_draws(lambda p: jmodel.apply(
        {"params": p}, jxs, train=True, mask=jnp.asarray(mask),
        rngs={"noise": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)}))
    (ref_loss, ref_logs), rec = run(params)
    # the per-modality DMVAE draws its noise in bf16, as its statistics are
    normals = [torch.from_numpy(np.asarray(d, np.float32)) for n, d in zip(kinds, rec)
               if n == "normal"]
    if fused:
        noise = tuple(normals)
    else:  # per modality: N private, N unimodal, one PoE
        n = len(X_DIMS)
        noise = (torch.stack(normals[:n], dim=1), torch.stack(normals[n:2 * n], dim=1),
                 normals[2 * n])
    with torch.no_grad():
        loss, logs = port(_t(xs), noise, torch.from_numpy(mask))
    assert loss.dtype == torch.float32
    assert_bf16_close(loss, ref_loss, "loss")
    for k, v in logs.items():
        assert_bf16_close(v, ref_logs[k], k)


def test_stacked_mlp_bf16_dropout_matches_jax():
    """Training mode: the keep-masks applied as where(mask, h / keep, 0) in
    bf16, the output back in float32."""
    jm = jfused.StackedMLP(in_dims=(12, 9), hidden=(16, 8), out_dims=(5, 5), dropout=0.3,
                           dtype=BF16)
    x = np.random.default_rng(2).standard_normal((11, 2, 12)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    run, kinds = jitted_draws(lambda p: jm.apply({"params": p}, jnp.asarray(x), train=True,
                                                 rngs={"dropout": jax.random.PRNGKey(4)}))
    ref, rec = run(params)
    masks, _ = split_draws(kinds, rec)
    port = load_flax_params(tfused.StackedMLP((12, 9), (16, 8), (5, 5), _gen(), "bfloat16"),
                            jax.device_get(params))
    got = port(torch.from_numpy(x), masks, 0.7)
    assert got.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    assert_bf16_close(got, ref, "stacked mlp")


# ------------------------------------------------------------------ heads
PROBES = {
    "fused": (jprobes.FusedEvidentialProbe, tprobes.FusedEvidentialProbe, True),
    "unfused": (jprobes.EvidentialProbe, tprobes.EvidentialProbe, True),
    "fused_disentangled": (jprobes.FusedDisentangledEvidentialProbe,
                           tprobes.FusedDisentangledEvidentialProbe, False),
    "disentangled": (jprobes.DisentangledEvidentialProbe, tprobes.DisentangledEvidentialProbe,
                     False),
}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_bf16_matches_jax(name):
    jcls, tcls, shared = PROBES[name]
    cfg = dict(num_modalities=3, num_classes=6, input_dim=8, hidden_dim=(16,))
    if shared:
        cfg["shared_input_dim"] = 11
    zc, *zp = _views(rows=40, dims=(11, 8, 8, 8), seed=1)
    args = ([jnp.asarray(zc)] if shared else []) + [[jnp.asarray(z) for z in zp]]
    jmodel = jcls(**cfg, dtype=BF16)
    params = jmodel.init(jax.random.PRNGKey(2), *args)["params"]
    params = jax.tree.map(lambda a: 3.0 * a, params)  # logits over several binades
    ref = jmodel.apply({"params": params}, *args, train=False)
    port = load_flax_params(tcls(generator=_gen(), **cfg, dtype="bfloat16").eval(),
                            jax.device_get(params))
    targs = ([torch.from_numpy(zc)] if shared else []) + [_t(zp)]
    with torch.no_grad():
        got = port(*targs)
    assert got.dtype == torch.float32
    assert_evidence_close(got, ref, name)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_late_fusion_bf16_matches_jax(fused):
    jcls, tcls = ((jbase.FusedLateFusion, tbase.FusedLateFusion) if fused
                  else (jbase.LateFusion, tbase.LateFusion))
    cfg = dict(output_dims=X_DIMS, num_classes=5, hidden_dim=(16,))
    xs = _views(rows=30, seed=3)
    jmodel = jcls(**cfg, dtype=BF16)
    params = jmodel.init(jax.random.PRNGKey(4), [jnp.asarray(x) for x in xs])["params"]
    ref = jmodel.apply({"params": params}, [jnp.asarray(x) for x in xs], train=False)
    port = load_flax_params(tcls(generator=_gen(), **cfg, dtype="bfloat16").eval(),
                            jax.device_get(params))
    with torch.no_grad():
        assert_evidence_close(port(_t(xs)), ref)


@pytest.mark.parametrize("fusion", ["concat", "lrtf"])
def test_intermediate_fusion_bf16_matches_jax(fusion):
    """The views and the fusion in float32, the head in bf16, as the JAX
    builder computes them."""
    dims, n = (12, 10, 7), 30
    xs = _views(rows=n, dims=dims, seed=4)
    kw = dict(output_dims=dims, num_classes=4, hidden_dim=16, dropout=0.2, fusion=fusion,
              fusion_output_dim=8, fusion_rank=3, dtype="bfloat16")
    jtask = jtasks.build_intermediate_fusion_task(rng=jax.random.PRNGKey(0), **kw)
    ttask = ttasks.build_intermediate_fusion_task(seed=5, device="cpu", **kw)
    load_flax_params(ttask.model, jax.device_get(jtask.params))
    ref = jtask.evidences_fn(jtask.params, {"xs": tuple(jnp.asarray(x) for x in xs)})
    with torch.no_grad():
        got = ttask.evidences_fn({"xs": tuple(_t(xs))})
    assert_evidence_close(got, ref, fusion)


@pytest.mark.parametrize("name", jfusions.INTERMEDIATE_FUSIONS)
def test_fusion_keeps_the_jax_type_on_bf16_views(name):
    dims = (12, 10) if name in ("mi_matrix", "mi_vector") else (12, 10, 7)
    views = [jnp.asarray(x, BF16) for x in _views(rows=6, dims=dims, seed=5)]
    jmod, _ = jfusions.build_fusion(name, dims, output_dim=8, rank=3)
    variables = jmod.init(jax.random.PRNGKey(0), views)
    ref = jmod.apply(variables, views)
    port, _ = tfusions.build_fusion(name, dims, output_dim=8, rank=3, generator=_gen())
    if variables.get("params"):
        load_flax_params(port, jax.device_get(variables["params"]))
    with torch.no_grad():
        got = port([torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
                    for v in views])
    assert str(got.dtype).split(".")[-1] == str(ref.dtype), (got.dtype, ref.dtype)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))


# ------------------------------------------------------------------ LUMA encoders
ENCODERS = {
    "image": (lambda: jlayers.ImageEncoder(output_dim=16, dropout=0.2, dtype=BF16),
              ("ImageEncoder", dict(output_dim=16, dropout=0.2)), (3072,)),
    "audio": (lambda: jlayers.AudioEncoder(input_dim=40, output_dim=16, dropout=0.2, dtype=BF16),
              ("AudioEncoder", dict(input_dim=40, output_dim=16, dropout=0.2)), (40,)),
    "audio_2d": (lambda: jlayers.AudioEncoder(input_dim=40, output_dim=16, dropout=0.2,
                                              use_2d=True, dtype=BF16),
                 ("AudioEncoder", dict(input_dim=40, output_dim=16, dropout=0.2, use_2d=True)),
                 (40, 21)),
    "text": (lambda: jlayers.TextEncoder(input_dim=128, output_dim=16, dropout=0.2, dtype=BF16),
             ("TextEncoder", dict(input_dim=128, output_dim=16, dropout=0.2)), (128,)),
}


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_bf16_matches_jax(name, train_mode):
    jmake, (cls, kw), shape = ENCODERS[name]
    jenc, rows = jmake(), 12
    x = np.random.default_rng(0).standard_normal((rows, *shape)).astype(np.float32)
    variables = jenc.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)
    stats = jax.tree.map(lambda a: a + 0.3 * jnp.arange(a.shape[0]) / a.shape[0],
                         variables.get("batch_stats", {}))
    port = tlayers.ENCODER_REGISTRY[cls](_gen(1), **kw, dtype="bfloat16")
    load_flax_params(port, jax.device_get(variables["params"]), jax.device_get(stats))
    full = {"params": variables["params"], **({"batch_stats": stats} if stats else {})}
    if not train_mode:
        ref = jenc.apply(full, jnp.asarray(x), train=False)
        got = port(torch.from_numpy(x))
        assert got.dtype == torch.bfloat16 and ref.dtype == BF16
        assert_bf16_close(got, ref, f"{name} eval")
        return
    run, kinds = jitted_draws(lambda v, x, k: jenc.apply(
        v, x, train=True, rngs={"dropout": k}, mutable=["batch_stats"]))
    (ref, new), rec = run(full, jnp.asarray(x), jax.random.PRNGKey(7))
    masks, _ = split_draws(kinds, rec)
    got = port(torch.from_numpy(x), masks)
    assert_bf16_close(got, ref, f"{name} train", compounded=bool(stats))
    if stats:
        ref_stats = flax_to_state_dict({}, jax.device_get(new["batch_stats"]))
        for key, value in ref_stats.items():
            mine = port.state_dict()[key]
            assert mine.dtype == torch.float32, key
            np.testing.assert_allclose(mine.numpy(), value.numpy(), err_msg=key, **STATS_TOL)


# ------------------------------------------------------------------ the head kernel's bf16 plain version
def _jax_heads(v, b, d, h, c, seed, scale=3.0):
    x = np.random.default_rng(seed).standard_normal((b, v, d)).astype(np.float32)
    jm = jfused.StackedMLP(in_dims=(d,) * v, hidden=(h,), out_dims=(c,) * v, dtype=BF16)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: scale * a, params)  # logits over several binades
    return jm, x, params


@pytest.mark.parametrize("v,b,c", [(7, 256, 10), (3, 840, 42)])
def test_bf16_kernel_plain_version_matches_jax(v, b, c):
    jm, x, params = _jax_heads(v, b, 200, 128, c, seed=v)
    ref = jevidence(jm.apply({"params": params}, jnp.asarray(x)))
    w = {k: torch.from_numpy(np.array(a)) for k, a in jax.device_get(params).items()}
    xt = torch.from_numpy(x).transpose(0, 1)
    got = ck.evidential_heads_stacked_bf16(xt, w["w1"], w["b1"], w["w2"], w["b2"])
    assert got.shape == (b, v, c) and got.dtype == torch.float32
    assert_evidence_close(got, ref, f"{(v, b, c)}")
    # the same from a bf16 x, and equal to the plain version itself
    plain = ck.evidential_heads_stacked_bf16_plain(xt.to(torch.bfloat16), w["w1"], w["b1"],
                                                   w["w2"], w["b2"])
    assert torch.equal(got, plain)
    assert counters()["kernels.evidential_heads_bf16"] == 0  # no launch on the CPU


def test_bf16_kernel_plain_version_under_vmap_matches_jax():
    """Five stacked seeds of (3, 840) heads at C = 42 in one call at 15
    heads, against JAX's vmapped bf16 StackedMLP."""
    s, v, b, c = 5, 3, 840, 42
    jm, x, params = _jax_heads(v, b, 200, 128, c, seed=11)
    keys = jax.random.split(jax.random.PRNGKey(3), s)
    stacked = jax.vmap(lambda k: jax.tree.map(lambda a: 3.0 * a, jm.init(k, jnp.asarray(x))
                                              ["params"]))(keys)
    ref = jax.vmap(lambda p: jevidence(jm.apply({"params": p}, jnp.asarray(x))))(stacked)
    w = {k: torch.from_numpy(np.array(a)) for k, a in jax.device_get(stacked).items()}
    xt = torch.from_numpy(x).transpose(0, 1)
    with torch.no_grad():
        got = torch.func.vmap(ck.evidential_heads_stacked_bf16, in_dims=(None, 0, 0, 0, 0))(
            xt, w["w1"], w["b1"], w["w2"], w["b2"])
    assert got.shape == (s, b, v, c)
    assert_evidence_close(got, ref, "vmap")


if __name__ == "__main__":
    import json
    import sys

    code = pytest.main([__file__, "-q", "-p", "no:cacheprovider", "-o", "addopts="])
    print(json.dumps(sys.modules["test_torch_bf16"].READINGS))
    sys.exit(code)

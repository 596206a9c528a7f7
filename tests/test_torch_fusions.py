"""The port's fusion library (``models/fusions.py``) against the JAX package's.

* Every registry fusion, the four ``output`` modes of the 2-modal
  multiplicative interactions, ``NLgate``, ``EarlyFusionTransformer`` and
  the stateless ops: the same numpy inputs and the same parameters (the
  flax ones, carried over by ``convert.py``) on both sides; the forward, its
  gradient with respect to the inputs and to every parameter under one
  random cotangent. Both sides run float32 on the CPU: rtol 1e-5 / atol 1e-6,
  except where a contraction's order differs (the products over d0 * d1 of
  matrix3D, the outer products of tensor fusion, the transformers' three
  layers of softmax and LayerNorm): rtol 1e-4 / atol 1e-5 there.
* ``build_fusion`` / ``fusion_dim``: the same fused width, and the same
  refusal with the same text, for every registry name at the view widths of
  HandWritten, CUB, PIE and Scene.
* The init laws: the std of every parameter within 5 % of the JAX
  module's, over enough draws (>= 20 000 values per parameter, pooled over
  seeds) that sampling noise stays near 0.5 %; constant parameters equal.
* mi3 builds no per-sample weight tensor: under a ``TorchDispatchMode`` no
  operation of its forward returns a non-view tensor of B * d1 * p * q
  elements or more (B = 64, d = 32, output 16: its parameters are smaller
  than that), in place of the JAX package's HLO check
  (tests/test_models.py:369).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from disentagled_multimodal_fusion_tpu.models import fusions as jf
from disentagled_multimodal_fusion_tpu_torch.convert import flax_to_state_dict, load_flax_params
from disentagled_multimodal_fusion_tpu_torch.models import fusions as tf

TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)  # a longer or reordered contraction

DATASET_DIMS = {
    "HandWritten": (240, 76, 216, 47, 64, 6),
    "CUB": (1024, 300),
    "PIE": (484, 256, 279),
    "Scene": (20, 59, 40),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs these files beside other test
    processes, and torch's thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(kind, dims, g):
    """(JAX module, port module) of one case."""
    if kind in jf.INTERMEDIATE_FUSIONS:
        return jf.build_fusion(kind, dims)[0], tf.build_fusion(kind, dims, generator=g)[0]
    if kind.startswith("mi2_"):
        output = kind[4:]
        od = (3, 4) if output == "matrix3D" else 5
        kw = dict(output=output, flip=kind.endswith("matrix"), clip=(-1.5, 1.5))
        return (jf.MultiplicativeInteractions2Modal(input_dims=dims, output_dim=od, **kw),
                tf.MultiplicativeInteractions2Modal(dims, od, g, **kw))
    if kind == "nlgate":
        kw = dict(thw_dim=2, c_dim=3, tf_dim=4, q_linear=(dims[0], 6), k_linear=None,
                  v_linear=(dims[1], 12))
        return jf.NLgate(**kw), tf.NLgate(generator=g, **kw)
    if kind == "nlgate_kq":
        kw = dict(thw_dim=2, c_dim=3, tf_dim=4, q_linear=None, k_linear=(dims[1], 12),
                  v_linear=(dims[1], 12))
        return jf.NLgate(**kw), tf.NLgate(generator=g, **kw)
    raise KeyError(kind)


# (kind, view widths, tolerance)
CASES = [
    ("concat", (7, 5), TIGHT),
    ("concat_linear", (7, 5), TIGHT),
    ("mi_matrix", (7, 5), TIGHT),
    ("mi_vector", (7, 5), TIGHT),
    ("mi3", (6, 5, 4), LOOSE),
    ("tensor", (4, 3, 2), LOOSE),
    ("lrtf", (7, 5, 3), TIGHT),
    ("lft", (7, 5), LOOSE),
    ("mi2_matrix3D", (7, 5), LOOSE),
    ("mi2_matrix", (7, 5), TIGHT),
    ("mi2_vector", (7, 5), TIGHT),
    ("mi2_scalar", (7, 1), TIGHT),
    ("nlgate", (7, 12), TIGHT),
    ("nlgate_kq", (6, 5), TIGHT),
]


def _grads_match(port_grads, ref_grads, names, tol):
    ref_state = flax_to_state_dict(jax.device_get(ref_grads))
    assert set(ref_state) == set(names)
    for name, g in zip(names, port_grads):
        np.testing.assert_allclose(g.numpy(), ref_state[name].numpy(), err_msg=name, **tol)


def _check(jmod, tmod, inputs, tol, seed=0):
    """Forward, input gradients and parameter gradients of ``jmod`` (on its
    own init) and ``tmod`` (on the same parameters) under one cotangent."""
    jin = jax.tree.map(jnp.asarray, inputs)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), jin).get("params", {})
    load_flax_params(tmod, jax.device_get(params))
    ref = np.asarray(jax.jit(jmod.apply)({"params": params}, jin))
    cot = np.random.default_rng(seed + 1).standard_normal(ref.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jmod.apply({"params": p}, x) * cot)

    ref_pgrad, ref_xgrad = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jin)
    tin = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), inputs)
    out = tmod(tin)
    np.testing.assert_allclose(out.detach().numpy(), ref, **tol)
    names = [n for n, _ in tmod.named_parameters()]
    leaves = jax.tree.leaves(tin)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)),
                                leaves + list(tmod.parameters()))
    for g, r in zip(grads[:len(leaves)], jax.tree.leaves(ref_xgrad)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)
    _grads_match(grads[len(leaves):], ref_pgrad, names, tol)


@pytest.mark.parametrize("kind,dims,tol", CASES, ids=[c[0] for c in CASES])
def test_fusion_forward_and_gradients_match_jax(kind, dims, tol):
    rng = np.random.default_rng(len(kind))
    widths = dims[::-1] if kind == "mi2_matrix" else dims  # flip: the views come swapped
    views = [rng.standard_normal((6, d)).astype(np.float32) for d in widths]
    jmod, tmod = _pair(kind, dims, torch.Generator().manual_seed(0))
    _check(jmod, tmod, views, tol)


def test_early_fusion_transformer_matches_jax():
    x = np.random.default_rng(3).standard_normal((4, 6, 5)).astype(np.float32)
    _check(jf.EarlyFusionTransformer(n_features=5),
           tf.EarlyFusionTransformer(5, torch.Generator().manual_seed(0)), x, LOOSE)


def test_stateless_ops_match_jax():
    rng = np.random.default_rng(4)
    seq = [rng.standard_normal((3, 4, d)).astype(np.float32) for d in (2, 5)]
    flat = [rng.standard_normal((3, d)).astype(np.float32) for d in (4, 4)]
    for fn, inputs in (("concat_early", seq), ("stack", flat), ("concat", seq),
                       ("tensor_fusion", flat), ("tensor_fusion", flat[:1])):
        ref = np.asarray(getattr(jf, fn)([jnp.asarray(a) for a in inputs]))
        out = getattr(tf, fn)([torch.from_numpy(a) for a in inputs]).numpy()
        np.testing.assert_allclose(out, ref, err_msg=fn, **TIGHT)
    # one view: returned as it is, by both 2-modal and tensor fusion
    one = torch.from_numpy(flat[0])
    assert tf.tensor_fusion([one]) is one
    assert tf.MultiplicativeInteractions2Modal((4, 4), 3, torch.Generator())([one]) is one


@pytest.mark.parametrize("dataset", sorted(DATASET_DIMS))
def test_build_fusion_refuses_and_sizes_as_jax(dataset):
    dims = DATASET_DIMS[dataset]
    for name in jf.INTERMEDIATE_FUSIONS:
        try:
            _, want = jf.build_fusion(name, dims)
        except ValueError as e:
            for fn in (tf.fusion_dim, tf.build_fusion):
                with pytest.raises(ValueError) as err:
                    fn(name, dims)
                assert str(err.value) == str(e), (name, fn.__name__)
            continue
        assert tf.fusion_dim(name, dims) == want, name
        assert tf.build_fusion(name, dims)[1] == want, name
    with pytest.raises(ValueError, match="unknown fusion"):
        tf.fusion_dim("nope", dims)


def _law_case(name, dims, **kw):
    return (jf.build_fusion(name, dims, **kw)[0],
            lambda g: tf.build_fusion(name, dims, generator=g, **kw)[0],
            [(2, d) for d in dims])


# modules at a moderate size for the init laws; lft's laws are those of its
# parts: the token embedding (a Dense from width 1), the attention's four
# projections and the feed-forward (LayerNorm is constant)
LAW_CASES = {
    "concat_linear": lambda: _law_case("concat_linear", (40, 24)),
    "mi_matrix": lambda: _law_case("mi_matrix", (30, 20), output_dim=1000),
    "mi_vector": lambda: _law_case("mi_vector", (8, 2500)),
    "mi3": lambda: _law_case("mi3", (12, 10, 8), output_dim=400),
    "lrtf": lambda: _law_case("lrtf", (30, 20), output_dim=16, rank=400),
    "lft_embedding": lambda: (jf.nn.Dense(4096, use_bias=False),
                              lambda g: tf.Dense(1, 4096, g, bias=False), [(2, 1)]),
    "lft_attention": lambda: (jf.nn.MultiHeadDotProductAttention(num_heads=3),
                              lambda g: tf.MultiHeadAttention(48, 3, g), [(2, 5, 48)]),
    "lft_layer": lambda: (jf._TransformerEncoderLayer(9, nhead=3),
                          lambda g: tf.TransformerEncoderLayer(9, 3, g), [(2, 5, 9)]),
}


@pytest.mark.parametrize("case", sorted(LAW_CASES))
def test_init_laws_match_jax(case):
    jmod, make_port, shapes = LAW_CASES[case]()
    xs = [jnp.zeros(s) for s in shapes]
    xs = xs[0] if case.startswith("lft_") else xs
    init = jax.jit(lambda k: jmod.init(k, xs)["params"])
    first = flax_to_state_dict(jax.device_get(init(jax.random.PRNGKey(0))))
    smallest = min(v.numel() for v in first.values() if float(v.std()) > 0.0)
    ref, port = {}, {}
    for r in range(math.ceil(20_000 / smallest)):
        for k, v in flax_to_state_dict(jax.device_get(init(jax.random.PRNGKey(r)))).items():
            ref.setdefault(k, []).append(v.reshape(-1))
        for k, v in make_port(torch.Generator().manual_seed(r)).state_dict().items():
            port.setdefault(k, []).append(v.reshape(-1))
    assert set(ref) == set(port)
    for k in ref:
        a, b = torch.cat(ref[k]), torch.cat(port[k])
        if float(a.std()) == 0.0:  # the constant ones and zeros: LayerNorm, biases
            assert torch.equal(a, b), k
            continue
        ratio = float(b.std()) / float(a.std())
        assert abs(ratio - 1.0) < 0.05, (k, ratio)
        assert abs(float(b.mean()) - float(a.mean())) < 0.05 * float(a.std()), k


class _Outputs(TorchDispatchMode):
    """Records the element count of every non-view output of the ops run."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor) and not func._schema.is_mutable and not (
                    func.is_view):
                self.sizes.append((str(func), t.numel()))
        return out


def test_mi3_never_builds_the_per_sample_weight_tensor():
    b, d, od = 64, 32, 16
    mod, _ = tf.build_fusion("mi3", (d, d, d), output_dim=od,
                             generator=torch.Generator().manual_seed(0))
    per_sample = b * d * d * od  # (B, d1, p, q) with p = d2 = d, q = od
    assert max(p.numel() for p in mod.parameters()) < per_sample
    xs = [torch.randn(b, d, generator=torch.Generator().manual_seed(i)) for i in range(3)]
    with torch.no_grad(), _Outputs() as seen:
        out = mod(xs)
    assert out.shape == (b, od)
    big = [(op, n) for op, n in seen.sizes if n >= per_sample]
    assert not big, big
    assert seen.sizes  # the mode saw the forward

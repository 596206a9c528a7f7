"""The port's ops (evidence, fusions, Gaussian PoE, Dirichlet uncertainty)
against the JAX package's, on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-6: float32 on both sides, where XLA:CPU and
torch differ by an ulp or two in exp/log/digamma and in reduction order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.ops import dirichlet as jdir
from disentagled_multimodal_fusion_tpu.ops import evidence as jev
from disentagled_multimodal_fusion_tpu.ops import gaussian as jgau
from disentagled_multimodal_fusion_tpu_torch.ops import dirichlet as tdir
from disentagled_multimodal_fusion_tpu_torch.ops import evidence as tev
from disentagled_multimodal_fusion_tpu_torch.ops import gaussian as tgau

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("activation", ["exp", "softplus"])
def test_evidence_activation_with_clipped_tail(activation):
    h = np.concatenate([
        np.linspace(-15.0, 15.0, 301),
        np.random.default_rng(0).standard_normal(200) * 6.0,
    ]).astype(np.float32).reshape(-1, 1)
    ref = np.asarray(jev.evidence_activation(jnp.asarray(h), activation))
    np.testing.assert_allclose(tev.evidence_activation(_t(h), activation).numpy(), ref, **TOL)


@pytest.mark.parametrize("name", sorted(jev.AGGREGATIONS))
def test_fusions_match_jax(name):
    rng = np.random.default_rng(1)
    ev = np.exp(rng.standard_normal((16, 4, 5)) * 2.0).astype(np.float32)
    ev[0, 1] = 0.0  # a view with no evidence at all
    ref = np.asarray(jev.AGGREGATIONS[name](jnp.asarray(ev)))
    np.testing.assert_allclose(tev.AGGREGATIONS[name](_t(ev)).numpy(), ref, **TOL)


@pytest.mark.parametrize("temperature,include_prior", [(1.0, True), (1.5, True), (1.5, False)])
def test_product_of_experts_matches_jax(temperature, include_prior):
    rng = np.random.default_rng(2)
    mus = rng.standard_normal((3, 8, 6)).astype(np.float32)
    logvars = (rng.standard_normal((3, 8, 6)) * 2.0).astype(np.float32)
    ref_mu, ref_lv = jgau.product_of_experts(
        jnp.asarray(mus), jnp.asarray(logvars), temperature, include_prior
    )
    mu, lv = tgau.product_of_experts(_t(mus), _t(logvars), temperature, include_prior)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), **TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(ref_lv), **TOL)


def test_gaussian_kl_and_reparameterize_match_jax():
    rng = np.random.default_rng(3)
    mu = rng.standard_normal((8, 6)).astype(np.float32)
    lv = rng.standard_normal((8, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tgau.gaussian_kl_standard(_t(mu), _t(lv)).numpy(),
        np.asarray(jgau.gaussian_kl_standard(jnp.asarray(mu), jnp.asarray(lv))), **TOL,
    )
    key = jax.random.PRNGKey(0)
    eps = np.asarray(jax.random.normal(key, mu.shape, jnp.float32))  # the JAX draw, injected
    np.testing.assert_allclose(
        tgau.reparameterize(_t(eps), _t(mu), _t(lv)).numpy(),
        np.asarray(jgau.reparameterize(key, jnp.asarray(mu), jnp.asarray(lv))), **TOL,
    )


def test_dirichlet_uncertainties_match_jax():
    rng = np.random.default_rng(4)
    ev = np.exp(rng.standard_normal((32, 10)) * 3.0).astype(np.float32)
    ev[0] = 0.0
    ev[1, 3] = 1e13  # the saturated tail of the evidence activation
    ref_e, ref_a = jdir.dirichlet_uncertainties(jnp.asarray(ev), 10)
    epi, ale = tdir.dirichlet_uncertainties(_t(ev), 10)
    np.testing.assert_allclose(epi.numpy(), np.asarray(ref_e), **TOL)
    np.testing.assert_allclose(ale.numpy(), np.asarray(ref_a), **TOL)

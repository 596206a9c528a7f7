"""The port's models against the JAX package's, with the JAX init carried
over by ``convert.py``.

Each case initialises the flax model, loads its parameters into the port's
module (built from another seed, so every weight must come across) and
compares the eval-mode forward on the same numpy inputs. Tolerance rtol 1e-5
/ atol 1e-6: float32 on both sides, dot products of up to 32 terms summed in
another order by XLA:CPU and torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.models import baselines as jbase
from disentagled_multimodal_fusion_tpu.models import dmvae as jdmvae
from disentagled_multimodal_fusion_tpu.models import dmvae_fused as jfused
from disentagled_multimodal_fusion_tpu.models import probes as jprobes
from disentagled_multimodal_fusion_tpu_torch.convert import load_flax_params
from disentagled_multimodal_fusion_tpu_torch.models import baselines as tbase
from disentagled_multimodal_fusion_tpu_torch.models import dmvae as tdmvae
from disentagled_multimodal_fusion_tpu_torch.models import dmvae_fused as tfused
from disentagled_multimodal_fusion_tpu_torch.models import probes as tprobes

TOL = dict(rtol=1e-5, atol=1e-6)
X_DIMS = (12, 10, 7)


def _gen(seed=123):
    return torch.Generator().manual_seed(seed)


def _views(rows=9, dims=X_DIMS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((rows, d), dtype=np.float32) for d in dims]


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("return_poe", [True, False])
def test_dmvae_get_embedding_matches_jax(fused, return_poe):
    jcls, tcls = (jfused.FusedDMVAE, tfused.FusedDMVAE) if fused else (jdmvae.DMVAE, tdmvae.DMVAE)
    cfg = dict(x_dims=X_DIMS, hidden_dim=32, embed_dim=8, poe_temperature=1.5)
    xs = _views()
    jmodel = jcls(**cfg)
    params = jmodel.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        [jnp.asarray(x) for x in xs], train=False,
    )["params"]
    ref_zc, ref_zp = jmodel.apply(
        {"params": params}, [jnp.asarray(x) for x in xs], return_poe=return_poe,
        method="get_embedding",
    )
    port = load_flax_params(tcls(generator=_gen(), **cfg).eval(), jax.device_get(params))
    with torch.no_grad():
        zc, zp = port.get_embedding([torch.from_numpy(x) for x in xs], return_poe=return_poe)
    _close(zc, ref_zc)
    assert len(zp) == len(ref_zp)
    for a, b in zip(zp, ref_zp):
        _close(a, b)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("hidden", [(16,), (16, 8)])
def test_probe_matches_jax(fused, hidden):
    jcls, tcls = (
        (jprobes.FusedEvidentialProbe, tprobes.FusedEvidentialProbe) if fused
        else (jprobes.EvidentialProbe, tprobes.EvidentialProbe)
    )
    cfg = dict(num_modalities=3, num_classes=4, input_dim=8, hidden_dim=hidden,
               shared_input_dim=11)  # a wider shared input exercises the padding
    zc, *zp = _views(rows=10, dims=(11, 8, 8, 8), seed=1)
    jmodel = jcls(**cfg)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(zc), [jnp.asarray(z) for z in zp])
    ref = jmodel.apply(params, jnp.asarray(zc), [jnp.asarray(z) for z in zp], train=False)
    port = load_flax_params(tcls(generator=_gen(), **cfg).eval(), jax.device_get(params["params"]))
    with torch.no_grad():
        _close(port(torch.from_numpy(zc), [torch.from_numpy(z) for z in zp]), ref)


@pytest.mark.parametrize("fused", [True, False])
def test_disentangled_probe_matches_jax(fused):
    jcls, tcls = (
        (jprobes.FusedDisentangledEvidentialProbe, tprobes.FusedDisentangledEvidentialProbe)
        if fused else (jprobes.DisentangledEvidentialProbe, tprobes.DisentangledEvidentialProbe)
    )
    cfg = dict(num_modalities=3, num_classes=4, input_dim=8, hidden_dim=(16,))
    zp = _views(rows=10, dims=(8, 8, 8), seed=2)
    jmodel = jcls(**cfg)
    params = jmodel.init(jax.random.PRNGKey(3), [jnp.asarray(z) for z in zp])
    ref = jmodel.apply(params, [jnp.asarray(z) for z in zp], train=False)
    port = load_flax_params(tcls(generator=_gen(), **cfg).eval(), jax.device_get(params["params"]))
    with torch.no_grad():
        _close(port([torch.from_numpy(z) for z in zp]), ref)


@pytest.mark.parametrize("fused", [True, False])
def test_late_fusion_matches_jax(fused):
    jcls, tcls = (
        (jbase.FusedLateFusion, tbase.FusedLateFusion) if fused
        else (jbase.LateFusion, tbase.LateFusion)
    )
    cfg = dict(output_dims=X_DIMS, num_classes=5, hidden_dim=(16,))
    xs = _views(seed=3)
    jmodel = jcls(**cfg)
    params = jmodel.init(jax.random.PRNGKey(4), [jnp.asarray(x) for x in xs])
    ref = jmodel.apply(params, [jnp.asarray(x) for x in xs], train=False)
    port = load_flax_params(tcls(generator=_gen(), **cfg).eval(), jax.device_get(params["params"]))
    with torch.no_grad():
        _close(port([torch.from_numpy(x) for x in xs]), ref)


def test_stacked_init_follows_the_per_slice_laws():
    """Each slice draws with its own modality's fans (xavier kernel bound
    sqrt(6/(fan_in+fan_out)), bias bound 1/sqrt(fan_in)); padding stays 0."""
    stack = tfused.StackedMLP((12, 5), (16,), (3, 3), _gen())
    for i, fan in enumerate((12, 5)):
        assert stack.w1[i, :fan].abs().max() <= np.sqrt(6.0 / (fan + 16))
        assert stack.b1[i].abs().max() <= 1.0 / np.sqrt(fan)
        assert stack.w1[i, :fan].abs().max() > 0.0
    assert torch.count_nonzero(stack.w1[1, 5:]) == 0
    again = tfused.StackedMLP((12, 5), (16,), (3, 3), _gen())
    assert all(torch.equal(a, b) for a, b in zip(stack.parameters(), again.parameters()))

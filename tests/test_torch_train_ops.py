"""The training half of the port's ops and models against the JAX package.

Same numpy inputs on both sides: the Stirling series (with the port's
trigamma against ``jax.grad`` of the digamma series), the AvgTrusted loss
and its gradient with respect to the evidences, the FusedDMVAE ELBO and its
gradients at converted parameters with the JAX noise draws injected, and the
satellite fix: a training forward of the fused heads keeps its gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.models import dmvae_fused as jfused
from disentagled_multimodal_fusion_tpu.ops import dirichlet as jdir
from disentagled_multimodal_fusion_tpu.ops import special as jspecial
from disentagled_multimodal_fusion_tpu_torch.convert import flax_to_state_dict, load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.models import dmvae_fused as tfused
from disentagled_multimodal_fusion_tpu_torch.ops import cuda_kernels as ck
from disentagled_multimodal_fusion_tpu_torch.ops import dirichlet as tdir
from disentagled_multimodal_fusion_tpu_torch.ops import special as tspecial


def _grid():
    """[1, 1e14] on a log grid plus the small integers."""
    return np.concatenate([np.logspace(0, 14, 400), np.arange(1, 40)]).astype(np.float32)


@pytest.mark.parametrize("name", ["gammaln_stirling", "digamma_stirling"])
def test_stirling_series_match_jax(name):
    x = _grid()
    ref = np.asarray(getattr(jspecial, name)(jnp.asarray(x)))
    port = getattr(tspecial, name)(torch.from_numpy(x)).numpy()
    # the bound tests/test_special.py pins against the library functions;
    # both sides evaluate one series in float32
    np.testing.assert_allclose(port, ref, rtol=2e-6, atol=2e-6)


def test_trigamma_is_the_derivative_of_the_digamma_series():
    x = _grid()
    ref = np.asarray(jax.vmap(jax.grad(jspecial.digamma_stirling))(jnp.asarray(x)))
    port = tspecial.trigamma_stirling(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, ref, rtol=2e-6, atol=1e-30)
    # and it is the derivative of the port's own series under autograd
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_()
    (g,) = torch.autograd.grad(tspecial.digamma_stirling(xt).sum(), xt)
    np.testing.assert_allclose(tspecial.trigamma_stirling(xt.detach()).numpy(), g.numpy(),
                               rtol=1e-12)


def _evidences(b, v, c, seed):
    rng = np.random.default_rng(seed)
    ev = np.exp(rng.standard_normal((b, v, c)) * 3.0).astype(np.float32)
    ev[0, 0, 2] = 1e13   # the saturated tail of the evidence activation
    ev[1, :, :] = 0.0    # a row with no evidence at all
    y = rng.integers(0, c, b)
    return ev, y


@pytest.mark.parametrize("masked", [False, True])
def test_avg_trusted_loss_and_gradient_match_jax(masked):
    b, v, c = 12, 3, 5
    ev, y = _evidences(b, v, c, seed=1)
    mask = np.ones(b, np.float32)
    mask[-4:] = 0.0  # a ragged tail padded to the batch
    m = mask if masked else None
    kw = dict(annealing_step=3, num_views=v, annealing_start=5.0, fused=1.0)

    def jloss(e):
        return jdir.avg_trusted_loss(e, jnp.asarray(y), None,
                                     mask=None if m is None else jnp.asarray(m), **kw)

    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(ev))
    et = torch.from_numpy(ev).requires_grad_()
    loss = tdir.avg_trusted_loss(et, torch.from_numpy(y), None,
                                 mask=None if m is None else torch.from_numpy(m), **kw)
    (grad,) = torch.autograd.grad(loss, et)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-9)


def _capture_normals(fn):
    """Run fn with jax.random.normal recorded: (fn's result, the draws)."""
    draws, orig = [], jax.random.normal

    def spy(*a, **k):
        out = orig(*a, **k)
        draws.append(np.asarray(out))
        return out

    jax.random.normal = spy
    try:
        return fn(), draws
    finally:
        jax.random.normal = orig


def test_fused_dmvae_elbo_and_gradients_match_jax():
    dims, hidden, embed = (12, 10, 7), 16, 4
    rng = np.random.default_rng(0)
    xs = [rng.random((9, d), dtype=np.float32) for d in dims]
    mask = np.ones(9, np.float32)
    mask[-2:] = 0.0
    jmodel = jfused.FusedDMVAE(x_dims=dims, hidden_dim=hidden, embed_dim=embed, a=0.3)
    jxs = [jnp.asarray(x) for x in xs]
    params = jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                         jxs, train=True)["params"]
    key = jax.random.PRNGKey(5)

    def jloss(p):
        return jmodel.apply({"params": p}, jxs, train=True, mask=jnp.asarray(mask),
                            rngs={"noise": key})[0]

    (ref, ref_grads), draws = _capture_normals(lambda: jax.value_and_grad(jloss)(params))
    assert [d.shape for d in draws] == [(9, 3, embed), (9, 3, embed), (9, embed)]

    port = load_flax_params(
        tfused.FusedDMVAE(dims, torch.Generator().manual_seed(3), hidden_dim=hidden,
                          embed_dim=embed, a=0.3), jax.device_get(params))
    loss, logs = port([torch.from_numpy(x) for x in xs],
                      tuple(torch.from_numpy(np.array(d)) for d in draws), torch.from_numpy(mask))
    assert set(logs) == {"loss", "loss_joint_recon", "loss_cross_recon", "kl_private",
                         "kl_shared_poe", "kl_shared_uni_sum"}
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4, atol=1e-5)
    ref_state = flax_to_state_dict(jax.device_get(ref_grads))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_state[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _probe_task():
    return ttasks.build_probe_task(num_modalities=2, num_classes=3, input_dim=5,
                                   hidden_dim=(4,), dropout=0.5, device="cpu")


def test_training_forward_of_fused_heads_keeps_its_gradient():
    """The head kernel has no backward, so a training forward must take the
    plain path: evidence with a grad_fn, and gradients on the heads."""
    task = _probe_task()
    data = {"zc": torch.randn(6, 5), "zp": torch.randn(6, 2, 5), "y": torch.tensor([0, 1, 2] * 2)}
    for masks in (None, [torch.rand(6, 3, 4) < 0.5]):
        ev = task.evidences_fn(data, masks)
        assert ev.grad_fn is not None
    loss, _ = task.loss_fn(data, torch.ones(6), 1, _Draws())
    grads = torch.autograd.grad(loss, list(task.model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(g.abs().sum() > 0 for g in grads)
    with torch.no_grad():  # the eval forward goes through the head kernel's wrapper
        assert task.evidences_fn(data).grad_fn is None


class _Draws:
    def bernoulli(self, p, shape):
        return torch.rand(shape, generator=torch.Generator().manual_seed(0)) < p


def test_head_kernel_wrapper_refuses_a_gradient():
    args = [torch.randn(2, 3, 4), torch.randn(2, 4, 5), torch.randn(2, 5),
            torch.randn(2, 5, 3), torch.randn(2, 3)]
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ck.evidential_heads_stacked(*args)
    with torch.no_grad():
        assert ck.evidential_heads_stacked(*args).shape == (3, 2, 3)

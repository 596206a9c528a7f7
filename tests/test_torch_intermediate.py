"""The port's intermediate-fusion fits and its unfused DMVAE against the JAX
package's.

* ``single_evidential_loss``: value and gradient, with and without a row
  mask; rtol 2e-5, the AvgTrusted loss's bound in
  tests/test_torch_train_ops.py.
* ``IntermediateFusion`` over concat, lrtf and lft on ``convert.py``-carried
  parameters: the eval forward, and the training forward with the flax
  dropout mask replayed, with the gradients of the one-head loss; rtol
  1e-4 / atol 1e-5 (lft's three encoder layers reorder their sums).
* A few epochs of an intermediate fit (concat and lrtf: Adam + plateau,
  dropout, a ragged tail, validation) on JAX ``train``'s permutations and
  dropout masks, replayed: the epoch-kernel tests' tolerances, losses rtol
  2e-5 / atol 2e-6 and parameters rtol 5e-3 / atol 5e-5 (Adam divides by
  sqrt(v) + eps, so op-level differences grow on entries whose gradient is
  near zero); validation accuracy equal. lft's fit is held differently,
  because its f32 trajectory is chaotic at rounding level: the port in
  float64 on the same draws measures how far f32 rounding alone moves this
  fit, and the port's f32 fit must lie within twice that of JAX's, plus
  the tolerances above.
* The unfused DMVAE's ELBO and gradients (and the fused one's, both with
  ``lambda_per_modality`` and dropout) on the JAX noise and masks: rtol
  1e-4 / atol 1e-5, the FusedDMVAE ELBO test's bound; and a short unfused
  fit with dropout against JAX ``train`` with replayed draws (losses at
  that bound, parameters at rtol 5e-3 / atol 5e-5).
* The sequential engine's intermediate-fusion seeds never meet its slots or
  the seed-batched fold seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.core.train import StepInfo
from disentagled_multimodal_fusion_tpu.core.train import train as jax_train
from disentagled_multimodal_fusion_tpu.models import dmvae as jdmvae
from disentagled_multimodal_fusion_tpu.models import dmvae_fused as jfused
from disentagled_multimodal_fusion_tpu.ops import dirichlet as jdir
from disentagled_multimodal_fusion_tpu_torch.convert import flax_to_state_dict, load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.train import train
from disentagled_multimodal_fusion_tpu_torch.models import dmvae as tdmvae
from disentagled_multimodal_fusion_tpu_torch.models import dmvae_fused as tfused
from disentagled_multimodal_fusion_tpu_torch.ops import dirichlet as tdir

LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
STATE_TOL = dict(rtol=5e-3, atol=5e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
FOLD = 0x5CA1AB1E  # JAX core/train.py:333 folds the fit's key with it


def _record(names, fn):
    """Run fn with the named jax.random functions recorded, in call order:
    (fn's result, [(name, draw)])."""
    draws, origs = [], {n: getattr(jax.random, n) for n in names}

    def spy(name):
        def wrapped(*a, **k):
            out = origs[name](*a, **k)
            draws.append((name, out))
            return out
        return wrapped

    for n in names:
        setattr(jax.random, n, spy(n))
    try:
        return fn(), draws
    finally:
        for n, f in origs.items():
            setattr(jax.random, n, f)


class Replay:
    """The port's Randomness interface over one fit's recorded JAX draws."""

    def __init__(self, perms, masks=(), normals=()):
        self.perms, self.masks, self.normals = list(perms), list(masks), list(normals)

    def permutation(self, n):
        p = self.perms.pop(0)
        assert p.shape == (n,)
        return torch.from_numpy(p.astype(np.int64))

    def bernoulli(self, p, shape):
        m = self.masks.pop(0)
        assert m.shape == tuple(shape), (m.shape, shape)
        return torch.from_numpy(np.array(m))

    def normal(self, shape):
        z = self.normals.pop(0)
        assert z.shape == tuple(shape), (z.shape, shape)
        return torch.from_numpy(np.array(z))


def jitted_draws(fn, names=("bernoulli", "normal")):
    """``fn`` under jit with the named jax.random draws it makes recorded:
    ``(run, kinds)``, ``run(*args) -> (fn(*args), [draw])`` and ``kinds``
    the draws' names in call order, filled when ``run`` is first traced."""
    kinds = []

    def traced(*args):
        out, rec = _record(names, lambda: fn(*args))
        kinds[:] = [name for name, _ in rec]
        return out, [d for _, d in rec]

    return jax.jit(traced), kinds


def jax_fit_draws(loss_fn, params, batch_of, key, epochs, n, batch):
    """The permutations and per-step draws (bernoulli masks, normals) of a
    JAX ``train`` from ``key``: fold_in(key, FOLD), then per epoch
    split(key, 3) -> (key, k_perm, k_steps), the permutation, and each step
    key of split(k_steps, steps) given to ``loss_fn`` (its draws recorded
    while it is traced under jit, once per row count)."""
    sizes = [batch] * (n // batch) + ([n % batch] if n % batch else [])
    runs = {rows: jitted_draws(lambda k, rows=rows: loss_fn(
        params, batch_of(rows), jnp.ones(rows), StepInfo(0, 0), k)[0]) for rows in set(sizes)}
    key = jax.random.fold_in(key, FOLD)
    perms, masks, normals = [], [], []
    for _ in range(epochs):
        key, k_perm, k_steps = jax.random.split(key, 3)
        perms.append(np.asarray(jax.random.permutation(k_perm, n)))
        for k, rows in zip(jax.random.split(k_steps, len(sizes)), sizes):
            run, kinds = runs[rows]
            _, draws = run(k)
            for name, d in zip(kinds, draws):
                (masks if name == "bernoulli" else normals).append(np.asarray(d))
    return perms, masks, normals


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs these files beside other test
    processes, and torch's thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the loss
@pytest.mark.parametrize("masked", [False, True])
def test_single_evidential_loss_and_gradient_match_jax(masked):
    rng = np.random.default_rng(2)
    b, c = 12, 5
    ev = np.exp(rng.standard_normal((b, c)) * 3.0).astype(np.float32)
    ev[0, 2] = 1e13   # the saturated tail of the evidence activation
    ev[1] = 0.0       # a row with no evidence
    y = rng.integers(0, c, b)
    mask = np.ones(b, np.float32)
    mask[-4:] = 0.0
    m = mask if masked else None

    def jloss(e):
        return jdir.single_evidential_loss(e, jnp.asarray(y), 3, annealing_start=5.0,
                                           mask=None if m is None else jnp.asarray(m))

    ref, ref_grad = jax.value_and_grad(jloss)(jnp.asarray(ev))
    et = torch.from_numpy(ev).requires_grad_()
    loss = tdir.single_evidential_loss(et, torch.from_numpy(y), 3, annealing_start=5.0,
                                       mask=None if m is None else torch.from_numpy(m))
    (grad,) = torch.autograd.grad(loss, et)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-9)


# ------------------------------------------------------- IntermediateFusion
DIMS = (7, 5, 4)


def _tasks(fusion, dims=DIMS, classes=3, dropout=0.3, lr=3e-3):
    kw = dict(output_dims=dims, num_classes=classes, dropout=dropout, lr=lr,
              annealing_start=2, fusion=fusion, fusion_output_dim=6, fusion_rank=3)
    jtask = jtasks.build_intermediate_fusion_task(rng=jax.random.PRNGKey(0), **kw)
    ttask = ttasks.build_intermediate_fusion_task(device="cpu", **kw)
    load_flax_params(ttask.model, jax.device_get(jtask.params))
    return jtask, ttask


def _views(n, dims, classes, seed):
    rng = np.random.default_rng(seed)
    xs = tuple(rng.standard_normal((n, d)).astype(np.float32) for d in dims)
    return xs, rng.integers(0, classes, n)


@pytest.mark.parametrize("fusion", ["concat", "lrtf", "lft"])
def test_intermediate_fusion_forward_and_gradients_match_jax(fusion):
    jtask, ttask = _tasks(fusion)
    xs, y = _views(9, DIMS, 3, seed=5)
    jdata = {"xs": tuple(jnp.asarray(x) for x in xs), "y": jnp.asarray(y)}
    tdata = {"xs": tuple(torch.from_numpy(x) for x in xs), "y": torch.from_numpy(y)}
    ev = ttask.evidences_fn(tdata)
    ref = jtask.evidences_fn(jtask.params, jdata)
    assert ev.shape == (9, 1, 3)
    np.testing.assert_allclose(ev.detach().numpy(), np.asarray(ref), **MODEL_TOL)
    # the training forward: the one-head loss with JAX's dropout mask
    key = jax.random.PRNGKey(4)
    mask = jnp.ones(9).at[-2:].set(0.0)

    def jloss(p):
        return jtask.loss_fn(p, jdata, mask, StepInfo(1, 0), key)[0]

    _, rec = jitted_draws(jloss)[0](jtask.params)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(jtask.params)
    drops = [np.asarray(d) for d in rec]
    assert [d.shape for d in drops] == [(9, 32)]
    loss, _ = ttask.loss_fn.compute(tdata, torch.from_numpy(np.array(mask)), 1,
                                    [torch.from_numpy(d) for d in drops])
    names = [n for n, _ in ttask.model.named_parameters()]
    grads = torch.autograd.grad(loss, list(ttask.model.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref_loss), **MODEL_TOL)
    ref_state = flax_to_state_dict(jax.device_get(ref_grads))
    assert set(ref_state) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_state[name].numpy(), err_msg=name, **MODEL_TOL)


def _port_fit(fusion, xs, y, draws, epochs, batch, dtype=torch.float32):
    """The port's fit of ``fusion`` on the JAX task's weights and replayed
    draws, with its weights and views in ``dtype``: (result, {name: final
    parameter as float64})."""
    _, ttask = _tasks(fusion)
    ttask.model.to(dtype)
    tdata = {"xs": tuple(torch.from_numpy(x).to(dtype) for x in xs), "y": torch.from_numpy(y)}
    tval = {"xs": tuple(x[:20] for x in tdata["xs"]), "y": tdata["y"][:20]}
    res = train(model=ttask.model, loss_fn=ttask.loss_fn, data=tdata, n_train=len(y),
                optimizer=ttask.optimizer, epochs=epochs, batch_size=batch,
                randomness=Replay(*draws[:2]), val_fn=ttask.val_fn, val_data=tval)
    return res, {k: p.detach().double().numpy() for k, p in ttask.model.named_parameters()}


@pytest.mark.parametrize("fusion", ["concat", "lrtf", "lft"])
def test_intermediate_fit_matches_jax_with_replayed_draws(fusion):
    """concat and lrtf at the epoch-kernel tests' tolerances. lft's 2048-wide
    ReLU feed-forward leaves entries whose gradient is at f32 noise level
    and above Adam's eps; Adam's first steps turn their random signs into
    steps of the learning rate's size, so two f32 fits of lft (JAX's, or
    the port's at another thread count) part by up to 1e-3 in loss. There
    the port's own f32 rounding, its fit against its float64 fit, sets the
    bound: JAX's f32 fit must lie within twice that of the port's f32 fit,
    plus the tolerances of the other fusions. The attention key biases,
    whose exact gradient is zero, may only drift by less than a step of
    the learning rate (3e-3) per step."""
    n, batch, epochs = 46, 16, 3
    jtask, _ = _tasks(fusion)
    xs, y = _views(n, DIMS, 3, seed=7)
    jdata = {"xs": tuple(jnp.asarray(x) for x in xs), "y": jnp.asarray(y)}
    jval = jax.tree.map(lambda a: a[:20], jdata)
    key = jax.random.PRNGKey(9)
    draws = jax_fit_draws(jtask.loss_fn, jtask.params,
                          lambda rows: {"xs": tuple(jnp.zeros((rows, d)) for d in DIMS),
                                        "y": jnp.zeros(rows, jnp.int32)},
                          key, epochs, n, batch)
    ref = jax_train(rng=key, params=jtask.params, loss_fn=jtask.loss_fn, data=jdata, n_train=n,
                    optimizer=jtask.optimizer, epochs=epochs, batch_size=batch,
                    val_fn=jtask.val_fn, val_data=jval, donate=False)
    ref_state = {k: v.double().numpy()
                 for k, v in flax_to_state_dict(jax.device_get(ref.params)).items()}
    res, state = _port_fit(fusion, xs, y, draws, epochs, batch)
    if fusion != "lft":
        np.testing.assert_allclose(res.train_loss, np.asarray(ref.train_loss), **LOSS_TOL)
        np.testing.assert_allclose(res.val_loss, np.asarray(ref.val_loss), **LOSS_TOL)
        np.testing.assert_array_equal(res.val_acc, np.asarray(ref.val_acc))
        for name, p in state.items():
            np.testing.assert_allclose(p, ref_state[name], err_msg=name, **STATE_TOL)
        return
    exact, exact_state = _port_fit(fusion, xs, y, draws, epochs, batch, torch.float64)
    for field in ("train_loss", "val_loss"):
        port, jref = np.asarray(getattr(res, field)), np.asarray(getattr(ref, field))
        spread = np.abs(port - np.asarray(getattr(exact, field)))
        bound = 2 * spread + LOSS_TOL["atol"] + LOSS_TOL["rtol"] * np.abs(jref)
        assert np.all(np.abs(port - jref) <= bound), (field, port, jref, spread)
    right = lambda acc: np.rint(np.asarray(acc) * 20)  # noqa: E731 -- of 20 validation rows
    assert np.all(np.abs(right(res.val_acc) - right(ref.val_acc))
                  <= 2 * np.abs(right(res.val_acc) - right(exact.val_acc)))
    steps = epochs * -(-n // batch)
    for name, p in state.items():
        if name.endswith("attn.key.bias"):  # softmax ignores it: its exact gradient is 0,
            for b in (p, ref_state[name]):  # so it moves on rounding noise alone
                assert np.max(np.abs(b)) <= steps * 3e-3, name
            continue
        spread = np.linalg.norm(p - exact_state[name])
        bound = 2 * spread + np.linalg.norm(STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(p))
        assert np.linalg.norm(p - ref_state[name]) <= bound, name


# ---------------------------------------------------------------- DMVAE
@pytest.mark.parametrize("fused", [False, True])
def test_dmvae_elbo_with_lambda_and_dropout_matches_jax(fused):
    dims, hidden, embed, b = (12, 10, 7), 16, 4, 9
    rng = np.random.default_rng(0)
    xs = [rng.random((b, d), dtype=np.float32) for d in dims]
    mask = np.ones(b, np.float32)
    mask[-2:] = 0.0
    kw = dict(x_dims=dims, hidden_dim=hidden, embed_dim=embed, a=0.3, dropout=0.25,
              lambda_per_modality=(1.0, 0.5, 2.0))
    jmodel = (jfused.FusedDMVAE if fused else jdmvae.DMVAE)(**kw)
    jxs = [jnp.asarray(x) for x in xs]
    params = jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
                          "dropout": jax.random.PRNGKey(1)}, jxs, train=True)["params"]
    keys = jax.random.split(jax.random.PRNGKey(5))

    def jloss(p):
        return jmodel.apply({"params": p}, jxs, train=True, mask=jnp.asarray(mask),
                            rngs={"noise": keys[0], "dropout": keys[1]})[0]

    run, kinds = jitted_draws(jloss)
    _, rec = run(params)
    ref, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    normals = [np.asarray(d) for name, d in zip(kinds, rec) if name == "normal"]
    masks = [np.asarray(d) for name, d in zip(kinds, rec) if name == "bernoulli"]
    cls = tfused.FusedDMVAE if fused else tdmvae.DMVAE
    kw.pop("x_dims")
    port = load_flax_params(cls(dims, torch.Generator().manual_seed(3), **kw),
                            jax.device_get(params))
    if fused:
        noise = tuple(torch.from_numpy(d) for d in normals)
    else:  # the JAX DMVAE draws per modality: N private, N unimodal, one PoE
        n = len(dims)
        noise = (torch.from_numpy(np.stack(normals[:n], axis=1)),
                 torch.from_numpy(np.stack(normals[n:2 * n], axis=1)),
                 torch.from_numpy(normals[2 * n]))
    assert [tuple(z.shape) for z in noise] == list(port.noise_shapes(b))
    assert [m.shape for m in masks] == list(port.drop_shapes(b))
    loss, logs = port([torch.from_numpy(x) for x in xs], noise, torch.from_numpy(mask),
                      [torch.from_numpy(m) for m in masks])
    assert set(logs) == {"loss", "loss_joint_recon", "loss_cross_recon", "kl_private",
                         "kl_shared_poe", "kl_shared_uni_sum"}
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    np.testing.assert_allclose(loss.item(), float(ref), **MODEL_TOL)
    ref_state = flax_to_state_dict(jax.device_get(ref_grads))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_state[name].numpy(), err_msg=name, **MODEL_TOL)


def test_unfused_dmvae_fit_matches_jax_with_replayed_draws():
    dims, hidden, embed, n, batch, epochs = (12, 10, 7), 16, 4, 40, 16, 3
    rng = np.random.default_rng(1)
    xs = tuple(rng.random((n, d), dtype=np.float32) for d in dims)
    kw = dict(output_dim=dims, hidden_dim=hidden, embed_dim=embed, a=0.3, dropout=0.2,
              lambda_per_modality=(1.0, 0.5, 2.0), fused_modalities=False)
    _, jparams, jloss, jopt, _ = jtasks.build_dmvae_task(
        rng=jax.random.PRNGKey(0), xs_sample=[jnp.asarray(x) for x in xs], lr=1e-3,
        num_epochs=epochs, **kw)
    key = jax.random.PRNGKey(3)
    perms, masks, normals = jax_fit_draws(
        jloss, jparams, lambda rows: {"xs": [jnp.zeros((rows, d)) for d in dims]}, key,
        epochs, n, batch)
    ref = jax_train(rng=key, params=jparams, loss_fn=jloss,
                    data={"xs": tuple(jnp.asarray(x) for x in xs)}, n_train=n, optimizer=jopt,
                    epochs=epochs, batch_size=batch, donate=False)
    model = load_flax_params(ttasks.build_dmvae_task(device="cpu", **kw),
                             jax.device_get(jparams))
    assert isinstance(model, tdmvae.DMVAE)
    # the JAX DMVAE draws its normals per modality (N private, N unimodal,
    # one PoE, per step): stack them into the port's three draws
    k = len(dims)
    grouped = []
    for s in range(0, len(normals), 2 * k + 1):
        step = normals[s:s + 2 * k + 1]
        grouped += [np.stack(step[:k], axis=1), np.stack(step[k:2 * k], axis=1), step[2 * k]]
    loss_fn, opt = ttasks.dmvae_objective(model, lr=1e-3, num_epochs=epochs)
    res = train(model=model, loss_fn=loss_fn, data={"xs": tuple(torch.from_numpy(x) for x in xs)},
                n_train=n, optimizer=opt, epochs=epochs, batch_size=batch,
                randomness=Replay(perms, masks, grouped))
    np.testing.assert_allclose(res.train_loss, np.asarray(ref.train_loss), **MODEL_TOL)
    ref_state = flax_to_state_dict(jax.device_get(ref.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_state[name].numpy(), err_msg=name,
                                   **STATE_TOL)


# ---------------------------------------------------------------- seeds
def test_intermediate_seeds_never_meet_the_slots_or_the_fold_seeds():
    """A CPU generator keeps a seed's low 32 bits: the intermediate jobs'
    seeds must differ there from the sequential slots and the fold seeds."""
    from disentagled_multimodal_fusion_tpu_torch.models.fusions import INTERMEDIATE_FUSIONS
    from disentagled_multimodal_fusion_tpu_torch.runners.common import (
        MAX_FOLD_CELL,
        cell_seed,
        fold_seed,
        intermediate_seed,
    )

    cells = [cell_seed(s, ds, c) for s in range(8) for ds in ("CUB", "HandWritten", "PIE", "Scene")
             for c in (False, True)] + [MAX_FOLD_CELL - 1]
    slots = {(c * 16 + k) % 2**32 for c in cells for k in range(16)}
    folds = {fold_seed(c, i) % 2**32 for c in cells for i in range(256)}
    jobs = 6 + len(INTERMEDIATE_FUSIONS)
    keys = [*range(1, len(INTERMEDIATE_FUSIONS)), *(8 + i for i in range(7, jobs))]
    seeds = {intermediate_seed(c, m) % 2**32 for c in cells for m in keys}
    assert len(seeds) == len(cells) * len(keys)  # no two keys share a seed
    assert not seeds & slots
    assert not seeds & folds
    for bad in ((MAX_FOLD_CELL, 0), (-1, 0), (0, 32)):
        with pytest.raises(ValueError):
            intermediate_seed(*bad)

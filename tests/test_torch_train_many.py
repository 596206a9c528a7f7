"""The port's seed-batched trainer ``train_many`` against the JAX package's,
against the port's own ``train`` seed by seed, and segmented against whole.

The cases are tests/test_train_many.py's at S = 2 and tiny widths (a
plateau fit, a ragged tail), plus a dropout probe on plateau (per-seed LR
state) and the FusedDMVAE. Against JAX ``train_many`` the port replays each
seed's JAX draws (permutations, dropout masks, the DMVAE's normals) from
``fold_in(k_s, 0x5CA1AB1E)``, as JAX ``core/train.py:403`` folds them.
Tolerances: losses rtol 2e-5 / atol 2e-6 and parameters rtol 5e-3 / atol
5e-5, tests/test_probe_megakernel.py's (Adam divides by sqrt(v) + eps, so
op-level differences grow on entries whose gradient is near zero); the
DMVAE's losses at rtol 1e-4 / atol 1e-5, the tolerance of its ELBO test in
tests/test_torch_train_ops.py. Seed by seed against ``train`` and segmented
against whole, the port runs the same operations on the CPU: rtol 1e-6
(atol 1e-7: a batched and a single product of tiny matrices may round
apart by an ulp).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.core.train import OptimizerConfig as JaxOptimizerConfig
from disentagled_multimodal_fusion_tpu.core.train import train_many as jax_train_many
from disentagled_multimodal_fusion_tpu.ops import probe_megakernel as jpm
from disentagled_multimodal_fusion_tpu_torch.convert import load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.train import (
    Objective,
    OptimizerConfig,
    Randomness,
    stack_params,
    train,
    train_many,
)

LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
STATE_TOL = dict(rtol=5e-3, atol=5e-5)
DMVAE_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
# a parameter that crosses zero has no relative scale: atol 1e-7 is about
# two float32 ulps at the weights' magnitude (~0.5)
SAME = dict(rtol=1e-6, atol=1e-7)
S = 2
FOLD = 0x5CA1AB1E


class Replay:
    """The port's Randomness interface over one seed's recorded JAX draws."""

    def __init__(self, perms, masks=(), normals=()):
        self.perms, self.masks, self.normals = list(perms), list(masks), list(normals)

    def permutation(self, n):
        p = self.perms.pop(0)
        assert p.shape == (n,)
        return torch.from_numpy(p.astype(np.int64))

    def bernoulli(self, p, shape):
        m = self.masks.pop(0)
        assert m.shape == tuple(shape)
        return torch.from_numpy(np.array(m))

    def normal(self, shape):
        z = self.normals.pop(0)
        assert z.shape == tuple(shape)
        return torch.from_numpy(np.array(z))

    def state(self):
        return None


def _sizes(n, batch):
    return [batch] * (n // batch) + ([n % batch] if n % batch else [])


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _epoch_draws(key, n, batch, mask_shape, keep):
    key, k_perm, k_steps = jax.random.split(key, 3)
    step_keys = jax.random.split(k_steps, len(_sizes(n, batch)))
    masks = [] if mask_shape is None or keep >= 1.0 else [
        jax.random.bernoulli(jpm.dropout_mask_key(k), keep, (rows, *mask_shape))
        for k, rows in zip(step_keys, _sizes(n, batch))]
    return key, jax.random.permutation(k_perm, n), step_keys, masks


def jax_draws(key, epochs, n, batch, mask_shape=None, keep=1.0, normals_of=None):
    """One seed's draws in a JAX fit from ``key``: per epoch split(key, 3) ->
    (key, k_perm, k_steps), the permutation, then per step key of
    split(k_steps, steps) the flax dropout mask (rows, *mask_shape) or the
    normals ``normals_of(step_key, rows)`` (each epoch's draws jitted as
    one program: the same bits as drawn one by one, in a fraction of the
    time)."""
    perms, masks, normals = [], [], []
    for _ in range(epochs):
        key, perm, step_keys, epoch_masks = _epoch_draws(key, n, batch, mask_shape, keep)
        perms.append(np.asarray(perm))
        masks += [np.asarray(m) for m in epoch_masks]
        if normals_of is not None:
            for k, rows in zip(step_keys, _sizes(n, batch)):
                normals += normals_of(k, rows)
    return perms, masks, normals


def _perturbed(params, seed):
    """Another seed's initial weights: ``params`` moved by 0.05 normals
    (one JAX init program per model instead of one per seed)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + np.float32(0.05) * rng.standard_normal(a.shape, dtype=np.float32)), params)


# ---------------------------------------------------------------- the problems
def _logistic_problem(seed, n):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int64)


def _jax_loss(params, batch, mask, t, key):
    logits = batch["x"] @ params["w"] + params["b"]
    ll = -jax.nn.log_softmax(logits)[jnp.arange(logits.shape[0]), batch["y"]]
    return jnp.sum(ll * mask) / jnp.maximum(jnp.sum(mask), 1.0), {}


def _jax_val(params, data, t):
    logits = data["x"] @ params["w"] + params["b"]
    ll = -jax.nn.log_softmax(logits)[jnp.arange(logits.shape[0]), data["y"]]
    return jnp.mean(ll), jnp.mean((jnp.argmax(logits, 1) == data["y"]).astype(jnp.float32))


class Logistic(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(6, 3))
        self.b = nn.Parameter(torch.zeros(3))

    def nll(self, data):
        logits = data["x"] @ self.w + self.b
        return -torch.gather(torch.log_softmax(logits, -1), 1, data["y"][:, None])[:, 0], logits


def _logistic_fns(model):
    def loss(batch, mask, epoch, draws):
        ll, _ = model.nll(batch)
        return torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0), {}

    def val(data, epoch):
        ll, logits = model.nll(data)
        return torch.mean(ll), torch.mean((torch.argmax(logits, 1) == data["y"]).float())

    return Objective(lambda randomness, rows: None, loss), val


LOGISTIC = {
    "plateau": dict(n=80, opt=dict(name="adam", lr=0.03, schedule="plateau",
                                   plateau_patience=4), epochs=12),
    "ragged_tail_cosine": dict(n=70, opt=dict(name="adam", lr=0.03, schedule="cosine",
                                              cosine_t_max=10), epochs=10),
}


def _logistic_case(case):
    problems = [_logistic_problem(i, case["n"]) for i in range(S)]
    data = {"x": np.stack([p[0] for p in problems]), "y": np.stack([p[1] for p in problems])}
    models = [Logistic() for _ in range(S)]
    loss_fn, val_fn = _logistic_fns(models[0])
    return data, models, loss_fn, val_fn


def _stack_torch(data):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}


def _seed(data, s):
    return {k: v[s] for k, v in data.items()}


@pytest.mark.parametrize("name", sorted(LOGISTIC))
def test_logistic_train_many_matches_jax_and_train(name):
    case = LOGISTIC[name]
    data, models, loss_fn, val_fn = _logistic_case(case)
    keys = [jax.random.PRNGKey(i) for i in range(S)]
    fit = dict(n_train=case["n"], epochs=case["epochs"], batch_size=16)
    ref = jax_train_many(
        rngs=jnp.stack(keys), params_stack={"w": jnp.zeros((S, 6, 3)), "b": jnp.zeros((S, 3))},
        loss_fn=_jax_loss, data_stack={k: jnp.asarray(v) for k, v in data.items()},
        optimizer=JaxOptimizerConfig(**case["opt"]), val_fn=_jax_val,
        val_data_stack={k: jnp.asarray(v) for k, v in data.items()}, **fit)
    opt = OptimizerConfig(**case["opt"])
    tdata = _stack_torch(data)
    replays = [Replay(jax_draws(jax.random.fold_in(k, FOLD), case["epochs"], case["n"], 16)[0])
               for k in keys]
    res = train_many(model=models[0], params=stack_params(models), loss_fn=loss_fn, data=tdata,
                     optimizer=opt, randomness=replays, val_fn=val_fn, val_data=tdata, **fit)
    np.testing.assert_allclose(res.train_loss.numpy(), np.asarray(ref.train_loss), **LOSS_TOL)
    np.testing.assert_allclose(res.val_loss.numpy(), np.asarray(ref.val_loss), **LOSS_TOL)
    np.testing.assert_allclose(res.val_acc.numpy(), np.asarray(ref.val_acc), atol=1e-6)
    np.testing.assert_allclose(res.final_lr.numpy(), np.asarray(ref.final_lr), rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(res.params[k].numpy(), np.asarray(ref.params[k]), **STATE_TOL)

    # seed by seed, the port's train from the same generators
    many = train_many(model=models[0], params=stack_params(models), loss_fn=loss_fn, data=tdata,
                      optimizer=opt, randomness=[Randomness(5 + s, "cpu") for s in range(S)],
                      val_fn=val_fn, val_data=tdata, **fit)
    for s, model in enumerate(models):
        seq_loss, seq_val = _logistic_fns(model)
        one = train(model=model, loss_fn=seq_loss, data=_seed(tdata, s), optimizer=opt,
                    randomness=Randomness(5 + s, "cpu"), val_fn=seq_val,
                    val_data=_seed(tdata, s), **fit)
        np.testing.assert_allclose(many.train_loss[s].numpy(), one.train_loss, **SAME)
        np.testing.assert_allclose(many.val_loss[s].numpy(), one.val_loss, **SAME)
        np.testing.assert_allclose(float(many.final_lr[s]), one.final_lr, **SAME)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(many.params[k][s].numpy(), p.detach().numpy(), **SAME)


def _probe_data(n, mods, d, seed):
    rng = np.random.default_rng(seed)
    return {"zp": rng.standard_normal((S, n, mods, d)).astype(np.float32),
            "y": rng.integers(0, 5, (S, n))}


def test_plateau_probe_train_many_matches_jax_and_train():
    """The disentangled probe: AdamW + plateau (each seed its own LR state),
    dropout masks drawn per seed, a ragged tail and validation."""
    n, mods, d, epochs = 70, 3, 12, 4
    kw = dict(num_modalities=mods, num_classes=5, input_dim=d, hidden_dim=(8,), lr=3e-3,
              dropout=0.3, annealing_start=2, num_epochs=epochs)
    jt = jtasks.build_disentangled_probe_task(rng=jax.random.PRNGKey(10), **kw)
    inits = [jt.params] + [_perturbed(jt.params, s) for s in range(1, S)]
    tt = [ttasks.build_disentangled_probe_task(device="cpu", **kw) for _ in range(S)]
    for p, t in zip(inits, tt):
        load_flax_params(t.model, jax.device_get(p))
    data = _probe_data(n, mods, d, 0)
    val = {k: v[:, :30] for k, v in data.items()}
    keys = [jax.random.PRNGKey(20 + s) for s in range(S)]
    fit = dict(n_train=n, epochs=epochs, batch_size=16)
    ref = jax_train_many(
        rngs=jnp.stack(keys), params_stack=jax.tree.map(lambda *a: jnp.stack(a), *inits),
        loss_fn=jt.loss_fn, data_stack={k: jnp.asarray(v) for k, v in data.items()},
        optimizer=jt.optimizer, val_fn=jt.val_fn,
        val_data_stack={k: jnp.asarray(v) for k, v in val.items()}, **fit)
    replays = [Replay(*jax_draws(jax.random.fold_in(k, FOLD), epochs, n, 16, (mods, 8), 0.7)[:2])
               for k in keys]
    tdata, tval = _stack_torch(data), _stack_torch(val)
    models = [t.model for t in tt]
    many_kw = dict(model=models[0], loss_fn=tt[0].loss_fn, data=tdata, optimizer=tt[0].optimizer,
                   val_fn=tt[0].val_fn, val_data=tval, **fit)
    res = train_many(params=stack_params(models), randomness=replays, **many_kw)
    np.testing.assert_allclose(res.train_loss.numpy(), np.asarray(ref.train_loss), **LOSS_TOL)
    np.testing.assert_allclose(res.val_loss.numpy(), np.asarray(ref.val_loss), **LOSS_TOL)
    np.testing.assert_allclose(res.val_acc.numpy(), np.asarray(ref.val_acc), atol=1e-6)
    np.testing.assert_allclose(res.final_lr.numpy(), np.asarray(ref.final_lr), rtol=1e-6)
    inner = ref.params["StackedMLP_0"]
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(res.params[f"stack.{k}"].numpy(), np.asarray(inner[k]),
                                   **STATE_TOL)

    many = train_many(params=stack_params(models), randomness=[Randomness(30 + s, "cpu")
                                                               for s in range(S)], **many_kw)
    for s, t in enumerate(tt):
        one = train(model=t.model, loss_fn=t.loss_fn, data=_seed(tdata, s),
                    optimizer=t.optimizer, randomness=Randomness(30 + s, "cpu"),
                    val_fn=t.val_fn, val_data=_seed(tval, s), **fit)
        np.testing.assert_allclose(many.train_loss[s].numpy(), one.train_loss, **SAME)
        np.testing.assert_allclose(many.val_loss[s].numpy(), one.val_loss, **SAME)
        np.testing.assert_allclose(float(many.final_lr[s]), one.final_lr, **SAME)
        for k, p in t.model.named_parameters():
            np.testing.assert_allclose(many.params[k][s].numpy(), p.detach().numpy(), **SAME)


def _normals_of(loss_fn, params, dims):
    """``(step_key, rows) -> draws``: the standard normals the JAX DMVAE loss
    draws from a step key, in call order (recorded while the loss is traced
    under jit, so each row count compiles once)."""
    def draws(key, rows):
        recorded, orig = [], jax.random.normal

        def spy(*a, **k):
            out = orig(*a, **k)
            recorded.append(out)
            return out

        jax.random.normal = spy
        try:
            loss_fn(params, {"xs": [jnp.zeros((rows, d)) for d in dims]}, jnp.ones(rows), None,
                    key)
        finally:
            jax.random.normal = orig
        return recorded

    jitted = jax.jit(draws, static_argnums=1)
    return lambda key, rows: [np.asarray(z) for z in jitted(key, rows)]


def test_dmvae_train_many_matches_jax_and_train():
    dims, hidden, embed, n, epochs = (12, 10, 7), 16, 4, 40, 3
    rng = np.random.default_rng(1)
    xs = [rng.random((S, n, d), dtype=np.float32) for d in dims]
    _, jparams, jloss, jopt, _ = jtasks.build_dmvae_task(
        rng=jax.random.PRNGKey(0), xs_sample=[jnp.asarray(x[0]) for x in xs], output_dim=dims,
        hidden_dim=hidden, embed_dim=embed, a=0.3, lr=1e-3, num_epochs=epochs,
        fused_modalities=True)
    inits = [jparams] + [_perturbed(jparams, s) for s in range(1, S)]
    keys = [jax.random.PRNGKey(40 + s) for s in range(S)]
    fit = dict(n_train=n, epochs=epochs, batch_size=16)
    ref = jax_train_many(
        rngs=jnp.stack(keys), params_stack=jax.tree.map(lambda *a: jnp.stack(a), *inits),
        loss_fn=jloss, data_stack={"xs": tuple(jnp.asarray(x) for x in xs)}, optimizer=jopt,
        **fit)

    normals_of = _normals_of(jloss, jparams, dims)

    def replay(key):
        perms, _, normals = jax_draws(jax.random.fold_in(key, FOLD), epochs, n, 16,
                                      normals_of=normals_of)
        return Replay(perms, normals=normals)

    models = [ttasks.build_dmvae_task(output_dim=dims, hidden_dim=hidden, embed_dim=embed, a=0.3,
                                      fused_modalities=True, device="cpu") for _ in range(S)]
    for p, m in zip(inits, models):
        load_flax_params(m, jax.device_get(p))
    loss_fn, opt = ttasks.dmvae_objective(models[0], lr=1e-3, num_epochs=epochs)
    tdata = {"xs": tuple(torch.from_numpy(x) for x in xs)}
    res = train_many(model=models[0], params=stack_params(models), loss_fn=loss_fn, data=tdata,
                     optimizer=opt, randomness=[replay(k) for k in keys], **fit)
    np.testing.assert_allclose(res.train_loss.numpy(), np.asarray(ref.train_loss),
                               **DMVAE_LOSS_TOL)
    for k, v in res.params.items():
        layer, leaf = k.split(".")
        np.testing.assert_allclose(v.numpy(), np.asarray(ref.params[layer][leaf]), **STATE_TOL)

    many = train_many(model=models[0], params=stack_params(models), loss_fn=loss_fn, data=tdata,
                      optimizer=opt, randomness=[Randomness(50 + s, "cpu") for s in range(S)],
                      **fit)
    for s, m in enumerate(models):
        seq_loss, _ = ttasks.dmvae_objective(m, lr=1e-3, num_epochs=epochs)
        one = train(model=m, loss_fn=seq_loss, data={"xs": tuple(x[s] for x in tdata["xs"])},
                    optimizer=opt, randomness=Randomness(50 + s, "cpu"), **fit)
        np.testing.assert_allclose(many.train_loss[s].numpy(), one.train_loss, **SAME)
        for k, p in m.named_parameters():
            np.testing.assert_allclose(many.params[k][s].numpy(), p.detach().numpy(), **SAME)


@pytest.mark.parametrize("broadcast", [False, True])
def test_segmented_train_many_equals_whole(broadcast):
    """7 + 7 + 7 + 3 epochs resumed exactly (optimizer, plateau and
    generator states) equal one 24-epoch fit; with ``data_broadcast`` every
    seed reads one shared dataset."""
    n, mods, d, epochs = 70, 3, 12, 24
    kw = dict(num_modalities=mods, num_classes=5, input_dim=d, hidden_dim=(8,), lr=3e-3,
              dropout=0.3, annealing_start=2, num_epochs=epochs)
    tasks = [ttasks.build_disentangled_probe_task(seed=s, device="cpu", **kw) for s in range(S)]
    data = _stack_torch(_probe_data(n, mods, d, 3))
    if broadcast:
        data = _seed(data, 0)
    models = [t.model for t in tasks]
    fit = dict(model=models[0], loss_fn=tasks[0].loss_fn, data=data, n_train=n,
               optimizer=tasks[0].optimizer, epochs=epochs, batch_size=16,
               val_fn=tasks[0].val_fn, val_data=data, data_broadcast=broadcast)
    whole = train_many(params=stack_params(models),
                       randomness=[Randomness(60 + s, "cpu") for s in range(S)], **fit)
    seg = train_many(params=stack_params(models), segment_epochs=7,
                     randomness=[Randomness(60 + s, "cpu") for s in range(S)], **fit)
    for field in ("train_loss", "val_loss", "val_acc", "final_lr"):
        np.testing.assert_allclose(getattr(seg, field).numpy(), getattr(whole, field).numpy(),
                                   **SAME)
    for k in whole.params:
        np.testing.assert_allclose(seg.params[k].numpy(), whole.params[k].numpy(), **SAME)
    if broadcast:  # one shared dataset: seed 1 is seed 0's fit with its own init and draws
        one = train(model=models[1], loss_fn=tasks[1].loss_fn, data=data, n_train=n,
                    optimizer=tasks[1].optimizer, epochs=epochs, batch_size=16,
                    randomness=Randomness(61, "cpu"), val_fn=tasks[1].val_fn, val_data=data)
        np.testing.assert_allclose(whole.train_loss[1].numpy(), one.train_loss, **SAME)

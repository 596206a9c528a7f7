"""The port's probe-epoch kernel module and its programs against the JAX package.

On the CPU the port's ``run_epoch_kernel`` wrapper runs ``run_epoch_plain``;
the JAX side runs its Pallas kernel in interpret mode, as
tests/test_probe_megakernel.py does. The programs are held against JAX's
with the JAX permutations and dropout masks replayed into the port's
injectable randomness (the ``jax.random`` split chain of
``core/megakernel.py``), and the port's two engines against each other for
one generator. Tolerances are tests/test_probe_megakernel.py's: losses
rtol 2e-5 / atol 2e-6; parameters rtol 5e-3 / atol 5e-5 (Adam divides by
sqrt(v) + eps, so op-level differences grow on entries whose gradient is
near zero); val_acc equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu.core import megakernel as jmk
from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.core.train import make_train_program
from disentagled_multimodal_fusion_tpu.ops import probe_megakernel as jpm
from disentagled_multimodal_fusion_tpu_torch.convert import load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core.logging import counters
from disentagled_multimodal_fusion_tpu_torch.core import megakernel as tmk
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.train import OptimizerConfig, Randomness, train
from disentagled_multimodal_fusion_tpu_torch.ops import probe_megakernel as tpm

LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
STATE_TOL = dict(rtol=5e-3, atol=5e-5)


def epoch_inputs(s, v, b, d, h, c, keep, tail, seed, ties=False):
    """One epoch's inputs as numpy arrays; the last step keeps ``tail`` rows.

    With ``ties``, views 0 and 1 get w2[:, 0] = 0 and b2[0] = +10, so class
    0's logit sits exactly at +10 (the clip's tie) in the first step, and
    row 0 of those views has x = 0 and b1 < 0, so its logits are b2 exactly
    and the two views' alphas are equal (the tie of |p_0 - p_1|). Every row
    is then labelled 0: a saturated wrong class (alpha ~ 2.2e4) would make
    the KL's lgamma terms cancel from ~2e5 in float32, where any two
    summation orders differ by ~1e-3.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xs = rng.standard_normal((s, v, b, d)).astype(f32)
    drops = (rng.random((s, v, b, h)) < keep).astype(f32)
    y = np.zeros((s, b), np.int64) if ties else rng.integers(0, c, (s, b))
    yohs = np.eye(c, dtype=f32)[y]
    rmasks = np.ones((s, b, 1), f32)
    rmasks[-1, tail:] = 0.0
    xs[-1, :, tail:] = 0.0
    yohs[-1, tail:] = 0.0
    counts = np.arange(1, s + 1, dtype=f32)
    bc1s = (f32(1) - f32(0.9) ** counts)[:, None]
    bc2s = (f32(1) - f32(0.999) ** counts)[:, None]
    w1 = ((rng.random((v, d, h)) * 2 - 1) * np.sqrt(6.0 / (d + h))).astype(f32)
    b1 = ((rng.random((v, h)) * 2 - 1) / np.sqrt(d)).astype(f32)
    w2 = ((rng.random((v, h, c)) * 2 - 1) * np.sqrt(6.0 / (h + c))).astype(f32)
    b2 = ((rng.random((v, c)) * 2 - 1) / np.sqrt(h)).astype(f32)
    if ties:
        xs[0, :2, 0] = 0.0
        b1[:2] = -np.abs(b1[:2]) - 0.01
        b2[1] = b2[0]
        w2[:2, :, 0] = 0.0
        b2[:2, 0] = 10.0
    params = (w1, b1, w2, b2)
    mus = tuple((rng.standard_normal(p.shape) * 1e-3).astype(f32) for p in params)
    nus = tuple((rng.random(p.shape) * 1e-6).astype(f32) for p in params)
    return (xs, drops, yohs, rmasks, bc1s, bc2s), (params, mus, nus)


@pytest.mark.parametrize("views,ties", [(2, False), (3, False), (2, True), (3, True)])
def test_run_epoch_plain_matches_jax_kernel(views, ties):
    streams, state = epoch_inputs(3, views, 16, 12, 8, 5, keep=0.7, tail=6, seed=views,
                                  ties=ties)
    scalars = (3e-3, 0.4, 0.68)  # lr, coef, gamma_t
    kw = dict(keep=0.7, fused=1.0, num_classes=5, weight_decay=1e-2)
    ref = jpm.run_epoch_kernel(*(jnp.asarray(a) for a in streams),
                               *(jnp.float32(x) for x in scalars),
                               *(tuple(jnp.asarray(a) for a in g) for g in state),
                               interpret=True, **kw)
    port_state = [tuple(torch.from_numpy(a) for a in g) for g in state]
    out = tpm.run_epoch_kernel(*(torch.from_numpy(a) for a in streams), *scalars,
                               *port_state, **kw)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), **LOSS_TOL)
    for group in range(3):
        for a, b in zip(out[group], ref[group]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **STATE_TOL)
    # the inputs are left as they are
    for a, b in zip(port_state[0], state[0]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_plain_epoch_is_not_counted_as_a_launch():
    streams, state = epoch_inputs(1, 2, 4, 3, 2, 3, keep=1.0, tail=4, seed=0)
    before = counters()["kernels.probe_epoch"]
    tpm.run_epoch_kernel(*(torch.from_numpy(a) for a in streams), 1e-3, 0.0, 0.2,
                         *[tuple(torch.from_numpy(a) for a in g) for g in state],
                         keep=1.0, fused=1.0, num_classes=3, weight_decay=0.0)
    assert counters()["kernels.probe_epoch"] == before


class Replay:
    """The port's Randomness interface over recorded JAX draws."""

    def __init__(self, perms, masks):
        self.perms, self.masks = list(perms), list(masks)

    def permutation(self, n):
        p = self.perms.pop(0)
        assert p.shape == (n,)
        return torch.from_numpy(p.astype(np.int64))

    def bernoulli(self, p, shape):
        m = self.masks.pop(0)
        assert m.shape == tuple(shape)
        return torch.from_numpy(np.array(m))


def jax_draws(key, epochs, n, batch, views, hidden, keep):
    """The permutations and flax dropout masks of a JAX probe fit from
    ``key``: per epoch split(key, 3) -> (key, k_perm, k_steps), one
    permutation, split(k_steps, steps) step keys, and one bernoulli
    (rows, V, H) mask per step under flax's dropout key."""
    sizes = [batch] * (n // batch) + ([n % batch] if n % batch else [])
    perms, masks = [], []
    for _ in range(epochs):
        key, k_perm, k_steps = jax.random.split(key, 3)
        perms.append(np.asarray(jax.random.permutation(k_perm, n)))
        step_keys = jax.random.split(k_steps, len(sizes))
        if keep < 1.0:
            masks += [np.asarray(jax.random.bernoulli(jpm.dropout_mask_key(k), keep,
                                                      (rows, views, hidden)))
                      for k, rows in zip(step_keys, sizes)]
    return perms, masks


def _data(n, mods, d, ds, classes):
    zc = jax.random.normal(jax.random.PRNGKey(1), (n, ds or d))
    zp = jax.random.normal(jax.random.PRNGKey(2), (n, mods, d))
    y = jax.random.randint(jax.random.PRNGKey(3), (n,), 0, classes)
    return {"zc": zc, "zp": zp, "y": y}


# the cases of tests/test_probe_megakernel.py, with fewer epochs where the
# case does not need them (the JAX kernel runs in interpret mode)
CASES = {
    "no_dropout_no_val": dict(shared=True, mods=3, classes=5, d=12, ds=None, dropout=0.0,
                              start=2, agg="cml", epochs=2, n=64, val=False, lr=3e-3),
    "dropout_val_ragged_tail": dict(shared=True, mods=3, classes=5, d=12, ds=None,
                                    dropout=0.3, start=2, agg="cml", epochs=2, n=70, val=True,
                                    lr=3e-3),
    "wider_shared_input": dict(shared=True, mods=2, classes=4, d=10, ds=20, dropout=0.2,
                               start=3, agg="joint", epochs=2, n=64, val=True, lr=1e-3),
    "plateau": dict(shared=False, mods=3, classes=5, d=12, ds=None, dropout=0.3, start=2,
                    agg="cml", epochs=4, n=70, val=True, lr=3e-3),
}


def _tasks(case):
    kw = dict(num_modalities=case["mods"], num_classes=case["classes"], input_dim=case["d"],
              hidden_dim=(8,), lr=case["lr"], dropout=case["dropout"],
              annealing_start=case["start"], num_epochs=case["epochs"])
    if case["shared"]:
        jtask = jtasks.build_probe_task(rng=jax.random.PRNGKey(0), aggregation=case["agg"],
                                        shared_input_dim=case["ds"], **kw)
        ttask = ttasks.build_probe_task(aggregation=case["agg"], shared_input_dim=case["ds"],
                                        device="cpu", **kw)
    else:
        jtask = jtasks.build_disentangled_probe_task(rng=jax.random.PRNGKey(0), **kw)
        ttask = ttasks.build_disentangled_probe_task(device="cpu", **kw)
    load_flax_params(ttask.model, jax.device_get(jtask.params))
    return jtask, ttask


def _port_fit(case, ttask, data, val, randomness, engine):
    return train(model=ttask.model, loss_fn=ttask.loss_fn, data=data, n_train=case["n"],
                 optimizer=ttask.optimizer, epochs=case["epochs"], batch_size=16,
                 randomness=randomness, val_fn=ttask.val_fn if case["val"] else None,
                 val_data=val, megakernel=ttask.megakernel if engine == "megakernel" else None)


def _assert_fit_close(res, params, ref_loss, ref_val, ref_acc, ref_params):
    np.testing.assert_allclose(res.train_loss, ref_loss, **LOSS_TOL)
    if ref_val is not None:
        np.testing.assert_allclose(res.val_loss, ref_val, **LOSS_TOL)
        np.testing.assert_array_equal(res.val_acc, ref_acc)
    for a, b in zip(params, ref_params):
        np.testing.assert_allclose(a, b, **STATE_TOL)


def _port_params(model):
    s = model.stack
    return [t.detach().numpy().copy() for t in (s.w1, s.b1, s.w2, s.b2)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_programs_match_jax_and_each_other(name):
    case = CASES[name]
    jdata = _data(case["n"], case["mods"], case["d"], case["ds"], case["classes"])
    jval = jax.tree.map(lambda a: a[:32], jdata) if case["val"] else None
    jtask, _ = _tasks(case)
    desc = jmk.ProbeMegakernelDesc(case["mods"], case["classes"], case["d"], case["ds"], 8,
                                   case["dropout"], 1.0, float(case["start"]), case["shared"])
    common = dict(n_train=case["n"], optimizer=jtask.optimizer, epochs=case["epochs"],
                  batch_size=16, drop_last=False, shuffle=True,
                  val_fn=jtask.val_fn if case["val"] else None)
    step_prog = make_train_program(loss_fn=jtask.loss_fn, has_state=False, **common)
    kernel_prog = jmk.make_probe_megakernel_program(desc=desc, interpret=True, **common)
    rkey = jax.random.PRNGKey(7)
    refs = {
        "step": step_prog(jtask.params, rkey, jdata, jval, None),
        "megakernel": kernel_prog(jtask.params, rkey, jdata, jval, None),
    }
    views = case["mods"] + (1 if case["shared"] else 0)
    data = {k: torch.from_numpy(np.array(v)) for k, v in jdata.items()}
    val = None if jval is None else {k: torch.from_numpy(np.array(v)) for k, v in jval.items()}
    fits = {}
    for engine, ref in refs.items():
        _, ttask = _tasks(case)
        draws = jax_draws(rkey, case["epochs"], case["n"], 16, views, 8, 1.0 - case["dropout"])
        res = _port_fit(case, ttask, data, val, Replay(*draws), engine)
        params = _port_params(ttask.model)
        inner = ref.params["StackedMLP_0"]
        _assert_fit_close(res, params, np.asarray(ref.train_loss),
                          np.asarray(ref.val_loss) if case["val"] else None,
                          np.asarray(ref.val_acc), [np.asarray(inner[k])
                                                    for k in ("w1", "b1", "w2", "b2")])
        if name == "plateau":
            np.testing.assert_allclose(res.final_lr, float(ref.final_lr), rtol=1e-6)
        # the port's own engines, from one torch generator
        _, ttask = _tasks(case)
        fits[engine] = (_port_fit(case, ttask, data, val, Randomness(11, "cpu"), engine),
                        _port_params(ttask.model))
    (rk, pk), (rs, ps) = fits["megakernel"], fits["step"]
    _assert_fit_close(rk, pk, rs.train_loss, rs.val_loss if case["val"] else None, rs.val_acc, ps)


def test_supports_guard():
    desc = tmk.ProbeMegakernelDesc(3, 5, 12, None, 8, 0.3, 1.0, 2.0, True)
    adamw = OptimizerConfig(name="adamw", lr=1e-3, weight_decay=1e-4, schedule="cosine")
    assert tmk.supports_probe_megakernel(desc, adamw)
    assert not tmk.supports_probe_megakernel(None, adamw)
    assert not tmk.supports_probe_megakernel(desc, OptimizerConfig(name="adam", lr=1e-3))


@pytest.mark.parametrize("mods,hidden", [(3, 129), (8, 16)])  # H = 129; V = 8 + 1 = 9 heads
def test_probes_the_kernel_refuses_run_the_step_loop(mods, hidden, monkeypatch):
    """The epoch kernel takes at most 8 heads of at most 128 hidden units:
    the predicate declines wider probes, so train() fits them through the
    step loop on the same randomness stream, as the JAX package trains
    them."""
    task = ttasks.build_probe_task(num_modalities=mods, num_classes=5, input_dim=12,
                                   hidden_dim=(hidden,), lr=3e-3, dropout=0.3,
                                   annealing_start=2, num_epochs=2, device="cpu")
    assert not tmk.supports_probe_megakernel(task.megakernel, task.optimizer)

    def refuse(**kw):
        raise AssertionError("the epoch-kernel program was built for a fit it cannot run")

    monkeypatch.setattr(tmk, "make_probe_megakernel_program", refuse)
    rng = np.random.default_rng(mods)
    data = {"zc": torch.from_numpy(rng.standard_normal((40, 12)).astype(np.float32)),
            "zp": torch.from_numpy(rng.standard_normal((40, mods, 12)).astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, 5, 40))}
    kernel = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=40,
                   optimizer=task.optimizer, epochs=2, batch_size=16,
                   randomness=Randomness(3, "cpu"), megakernel=task.megakernel)
    task = ttasks.build_probe_task(num_modalities=mods, num_classes=5, input_dim=12,
                                   hidden_dim=(hidden,), lr=3e-3, dropout=0.3,
                                   annealing_start=2, num_epochs=2, device="cpu")
    step = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=40,
                 optimizer=task.optimizer, epochs=2, batch_size=16,
                 randomness=Randomness(3, "cpu"))
    np.testing.assert_array_equal(kernel.train_loss, step.train_loss)

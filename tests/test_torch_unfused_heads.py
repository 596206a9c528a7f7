"""The port's unfused heads as trainable tasks: ``build_probe_task``,
``build_disentangled_probe_task`` and ``build_late_fusion_task`` with
``fused_heads=False`` (``EvidentialProbe``, ``DisentangledEvidentialProbe``,
``LateFusion``, one ``EvidentialNN`` per head, with dropout).

* Each against JAX ``train`` on the JAX builder's unfused task, its
  permutations and per-head dropout masks replayed (flax draws one mask per
  head and hidden layer, the encoders' before their head's; the port draws
  the stacked (B, V, hidden) masks after every encoder's, head v taking
  slice v): a probe with a shared head of its own width, a private-only
  probe with two hidden layers, late fusion on raw views and late fusion
  over a 2-D audio and a text encoder that carry BatchNorm state (at the
  LUMA config's learning rate, 3e-4, as tests/test_torch_luma.py trains
  them; the others at 3e-3). A few
  epochs with a ragged tail and validation; losses rtol 2e-5 / atol 2e-6,
  parameters and running statistics rtol 5e-3 / atol 5e-5, validation
  accuracy equal: tests/test_torch_intermediate.py's tolerances. A
  convolution's bias before a BatchNorm has a true gradient of 0, so Adam
  moves it on rounding noise alone: it is held to lie within two learning
  rates per step of JAX's, as in tests/test_torch_luma.py.
* Each against its fused twin in the port on the same weights
  (``convert.stack_heads``) and the same ``Randomness``: through the step
  loop, and for the probes through the epoch-kernel program's plain
  version, at the same tolerances, parameters compared in the stacked
  layout.
* An unfused probe through ``train_many`` at S = 2 against ``train`` per
  seed (rtol 1e-6 / atol 1e-7, tests/test_torch_train_many.py's: the same
  operations, batched and single).
* The task: no epoch-kernel descriptor, the fused twin's optimizer, and an
  eval forward equal bit for bit to the heads called one by one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_intermediate import FOLD, LOSS_TOL, STATE_TOL, Replay, jitted_draws

from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.core.train import StepInfo
from disentagled_multimodal_fusion_tpu.core.train import train as jax_train
from disentagled_multimodal_fusion_tpu.models import layers as jlayers
from disentagled_multimodal_fusion_tpu_torch.convert import (flax_to_state_dict, load_flax_params,
                                                             stack_heads)
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.train import (Randomness, stack_params, train,
                                                                train_many)

SAME = dict(rtol=1e-6, atol=1e-7)
N, BATCH, EPOCHS, C, LR = 23, 8, 3, 3, 3e-3
N_VAL = 9
# the BatchNorm case's encoders: a 2-D audio map (8, 5) through three conv
# blocks with BatchNorm, and a text vector of 10
ENCODERS = (("AudioEncoder", dict(input_dim=8, output_dim=6, dropout=0.1, use_2d=True)),
            ("TextEncoder", dict(input_dim=10, output_dim=6, dropout=0.1)))
ENCODER_INPUTS = [(8, 5), 10]
# the learning rate of late fusion over LUMA's encoders (the LUMA config's
# luma_lr, tests/test_torch_luma.py's): a convolution's bias before a
# BatchNorm, and entries whose gradient cancels to rounding, move by Adam
# steps of this size on rounding noise alone
LUMA_LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs these files beside other test
    processes, and torch's thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ the cases
CASES = {
    "probe": (jtasks.build_probe_task, ttasks.build_probe_task,
              dict(num_modalities=2, num_classes=C, input_dim=4, shared_input_dim=5,
                   hidden_dim=(8,), lr=LR, dropout=0.3, annealing_start=2, aggregation="avg",
                   fused=0.5, num_epochs=EPOCHS)),
    "disentangled": (jtasks.build_disentangled_probe_task, ttasks.build_disentangled_probe_task,
                     dict(num_modalities=3, num_classes=C, input_dim=4, hidden_dim=(8, 6),
                          lr=LR, dropout=0.3, annealing_start=2, num_epochs=EPOCHS)),
    "late": (jtasks.build_late_fusion_task, ttasks.build_late_fusion_task,
             dict(output_dims=(7, 5, 4), num_classes=C, hidden_dim=(8,), lr=LR, dropout=0.3,
                  annealing_start=2, aggregation="cml")),
    "late_bn": (jtasks.build_late_fusion_task, ttasks.build_late_fusion_task,
                dict(output_dims=(6, 6), num_classes=C, hidden_dim=(8,), lr=LUMA_LR,
                     dropout=0.3, annealing_start=2, aggregation="avg")),
}


def _jax_encoders():
    return (jlayers.AudioEncoder(input_dim=8, output_dim=6, dropout=0.1, use_2d=True),
            jlayers.TextEncoder(input_dim=10, output_dim=6, dropout=0.1))


def _tasks(name, fused_heads=False):
    """(JAX task, port task) of case ``name``, the port's on the JAX
    task's weights and BatchNorm statistics."""
    jbuild, tbuild, kw = CASES[name]
    jkw, tkw = dict(kw), dict(kw)
    if name == "late_bn":
        jkw.update(feature_encoders=_jax_encoders(), input_dims=ENCODER_INPUTS)
        tkw.update(feature_encoders=ENCODERS)
    jtask = jbuild(rng=jax.random.PRNGKey(0), fused_heads=fused_heads, **jkw)
    ttask = tbuild(device="cpu", fused_heads=fused_heads, **tkw)
    state = getattr(jtask, "model_state", None)
    load_flax_params(ttask.model, jax.device_get(jtask.params),
                     None if state is None else jax.device_get(state))
    return jtask, ttask


def _data(name, n, seed):
    """(JAX data, port data) of case ``name``: n rows made with numpy."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, C, n)
    kw = CASES[name][2]
    if name in ("probe", "disentangled"):
        mods, d = kw["num_modalities"], kw["input_dim"]
        arrays = {"zp": rng.standard_normal((n, mods, d)).astype(np.float32)}
        if name == "probe":
            arrays["zc"] = rng.standard_normal((n, kw["shared_input_dim"])).astype(np.float32)
        jdata = {k: jnp.asarray(v) for k, v in arrays.items()}
        tdata = {k: torch.from_numpy(v) for k, v in arrays.items()}
    else:
        shapes = ENCODER_INPUTS if name == "late_bn" else kw["output_dims"]
        xs = [rng.standard_normal((n, *np.atleast_1d(s))).astype(np.float32) for s in shapes]
        jdata = {"xs": tuple(jnp.asarray(x) for x in xs)}
        tdata = {"xs": tuple(torch.from_numpy(x) for x in xs)}
    jdata["y"], tdata["y"] = jnp.asarray(y), torch.from_numpy(y)
    return jdata, tdata


def _port_mask(m):
    """A flax keep-mask in the port's layout: channel dropout's (B, 1, 1, C)
    becomes (B, C, 1, 1)."""
    m = np.asarray(m)
    return np.ascontiguousarray(m.transpose(0, 3, 1, 2) if m.ndim == 4 else m)


def _step_masks(ttask, masks):
    """One step's flax masks, in call order (each view's encoder masks,
    then its head's, one per hidden layer), in the port's order: every
    encoder's masks, then one (rows, V, hidden) mask per hidden layer."""
    model = ttask.model
    heads = list(getattr(model, "heads", None) or getattr(model, "spec_heads", None)
                 or [model.x_shared, *model.x_specs])
    layers = len(heads[0].mlp.hidden)
    enc = [len(s) for s in model.enc_drop_shapes(1)] if hasattr(model, "enc_drop_shapes") else []
    enc = enc or [0] * len(heads)
    encoders, own, i = [], [], 0
    for count in enc:
        encoders += masks[i:i + count]
        own.append(masks[i + count:i + count + layers])
        i += count + layers
    assert i == len(masks)
    return encoders + [np.stack([head[j] for head in own], axis=1) for j in range(layers)]


def jax_fit_masks(jtask, ttask, jdata, key, epochs, n, batch):
    """The permutations and per-step keep-masks, in the port's layout, of
    JAX ``train`` on ``jtask`` from ``key``: fold_in(key, FOLD), then per
    epoch split(key, 3) -> (key, k_perm, k_steps), the permutation, and each
    step's key of split(k_steps, steps) given to the loss (its masks
    recorded while it is traced under jit, once per row count)."""
    sizes = [batch] * (n // batch) + ([n % batch] if n % batch else [])
    state = getattr(jtask, "model_state", None)

    def loss_at(rows):
        part = jax.tree.map(lambda a: a[:rows], jdata)
        args = (jtask.params, part, jnp.ones(rows), StepInfo(0, 0))
        if state is None:
            return lambda k: jtask.loss_fn(*args, k)[0]
        return lambda k: jtask.loss_fn(*args, k, state)[0]

    runs = {rows: jitted_draws(loss_at(rows), names=("bernoulli",)) for rows in set(sizes)}
    key = jax.random.fold_in(key, FOLD)
    perms, masks = [], []
    for _ in range(epochs):
        key, k_perm, k_steps = jax.random.split(key, 3)
        perms.append(np.asarray(jax.random.permutation(k_perm, n)))
        for k, rows in zip(jax.random.split(k_steps, len(sizes)), sizes):
            _, draws = runs[rows][0](k)
            masks += _step_masks(ttask, [_port_mask(d) for d in draws])
    return perms, masks


def _fit(task, data, val, randomness, megakernel=None):
    return train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=N,
                 optimizer=task.optimizer, epochs=EPOCHS, batch_size=BATCH,
                 randomness=randomness, val_fn=task.val_fn, val_data=val, megakernel=megakernel)


def assert_state(got, want, lr):
    """Every entry of the state dict ``got`` against ``want`` at
    ``STATE_TOL``, but a convolution's bias before a BatchNorm: its true
    gradient is 0, so it is held within two learning rates per step."""
    assert set(got) == set(want)
    steps = EPOCHS * -(-N // BATCH)
    for k, w in want.items():
        if ".conv." in k and k.endswith(".bias"):
            assert np.abs(got[k].numpy() - w.numpy()).max() <= 2 * lr * steps, k
        else:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k, **STATE_TOL)


# ------------------------------------------------------------------ the tests
@pytest.mark.parametrize("name", sorted(CASES))
def test_unfused_fit_matches_jax_with_replayed_draws(name):
    jtask, ttask = _tasks(name)
    assert ttask.megakernel is None and jtask.megakernel is None
    jdata, tdata = _data(name, N, seed=1)
    jval, tval = _data(name, N_VAL, seed=2)
    key = jax.random.PRNGKey(7)
    perms, masks = jax_fit_masks(jtask, ttask, jdata, key, EPOCHS, N, BATCH)
    state = getattr(jtask, "model_state", None)
    ref = jax_train(rng=key, params=jtask.params, loss_fn=jtask.loss_fn, data=jdata, n_train=N,
                    optimizer=jtask.optimizer, epochs=EPOCHS, batch_size=BATCH,
                    val_fn=jtask.val_fn, val_data=jval, model_state=state, donate=False)
    replay = Replay(perms, masks)
    res = _fit(ttask, tdata, tval, replay)
    assert not replay.masks and not replay.perms  # every replayed draw was taken
    np.testing.assert_allclose(res.train_loss, np.asarray(ref.train_loss), **LOSS_TOL)
    np.testing.assert_allclose(res.val_loss, np.asarray(ref.val_loss), **LOSS_TOL)
    np.testing.assert_array_equal(res.val_acc, np.asarray(ref.val_acc))
    want = flax_to_state_dict(jax.device_get(ref.params),
                              None if state is None else jax.device_get(ref.model_state))
    assert_state(ttask.model.state_dict(), want, CASES[name][2]["lr"])


@pytest.mark.parametrize("name,engine", [("probe", "step"), ("probe", "megakernel"),
                                         ("disentangled_1", "step"),
                                         ("disentangled_1", "megakernel"), ("late_bn", "step")])
def test_unfused_fit_matches_its_fused_twin(name, engine):
    """The same weights (stacked by ``convert.stack_heads``) and the same
    ``Randomness``: the unfused and the fused fit draw the same masks. Late
    fusion has no epoch-kernel descriptor, in either package."""
    base = name.split("_1")[0]
    build, kw = CASES[base][1], dict(CASES[base][2])
    if name == "disentangled_1":
        kw["hidden_dim"] = (8,)  # the epoch kernel's heads have one hidden layer
    if base == "late_bn":
        kw["feature_encoders"] = ENCODERS
    unfused = build(device="cpu", fused_heads=False, seed=3, **kw)
    fused = build(device="cpu", seed=4, **kw)
    fused.model.load_state_dict(stack_heads(unfused.model.state_dict()))
    _, data = _data(base, N, seed=5)
    _, val = _data(base, N_VAL, seed=6)
    want = _fit(unfused, data, val, Randomness(8, "cpu"))
    mk = fused.megakernel if engine == "megakernel" else None
    assert (mk is not None) == (engine == "megakernel")
    got = _fit(fused, data, val, Randomness(8, "cpu"), megakernel=mk)
    np.testing.assert_allclose(got.train_loss, want.train_loss, **LOSS_TOL)
    np.testing.assert_allclose(got.val_loss, want.val_loss, **LOSS_TOL)
    np.testing.assert_array_equal(got.val_acc, want.val_acc)
    assert_state(fused.model.state_dict(), stack_heads(unfused.model.state_dict()), kw["lr"])


def test_unfused_probe_train_many_matches_train_per_seed():
    kw = dict(CASES["probe"][2])
    _, data = _data("probe", N, seed=9)
    _, val = _data("probe", N_VAL, seed=10)
    tasks = [ttasks.build_probe_task(device="cpu", fused_heads=False, seed=20 + s, **kw)
             for s in range(2)]
    many = train_many(model=tasks[0].model, params=stack_params([t.model for t in tasks]),
                      loss_fn=tasks[0].loss_fn, data=data, n_train=N,
                      optimizer=tasks[0].optimizer, epochs=EPOCHS, batch_size=BATCH,
                      randomness=[Randomness(30 + s, "cpu") for s in range(2)],
                      val_fn=tasks[0].val_fn, val_data=val, data_broadcast=True)
    for s, task in enumerate(tasks):
        one = _fit(task, data, val, Randomness(30 + s, "cpu"))
        np.testing.assert_allclose(many.train_loss[s].numpy(), one.train_loss, **SAME)
        np.testing.assert_allclose(many.val_loss[s].numpy(), one.val_loss, **SAME)
        np.testing.assert_array_equal(many.val_acc[s].numpy(), one.val_acc)
        for k, p in task.model.named_parameters():
            np.testing.assert_allclose(many.params[k][s].numpy(), p.detach().numpy(),
                                       err_msg=k, **SAME)


@pytest.mark.parametrize("name", sorted(CASES))
def test_unfused_task_evaluates_head_by_head(name):
    """No epoch-kernel descriptor, the fused twin's optimizer, and an eval
    forward equal bit for bit to each head called alone (the forward that
    evaluation and ``convert.py``'s carried parameters ran before the heads
    could train)."""
    build, kw = CASES[name][1], dict(CASES[name][2])
    if name == "late_bn":
        kw["feature_encoders"] = ENCODERS
    task = build(device="cpu", fused_heads=False, seed=1, **kw)
    assert task.megakernel is None
    assert task.optimizer == build(device="cpu", seed=1, **kw).optimizer
    _, data = _data(name, N_VAL, seed=3)
    model = task.model
    with torch.no_grad():
        got = task.evidences_fn(data)
        if name in ("probe", "disentangled"):
            zp = list(data["zp"].unbind(dim=1))
            pairs = (zip([model.x_shared, *model.x_specs], [data["zc"], *zp]) if name == "probe"
                     else zip(model.spec_heads, zp))
        else:
            feats = [x.float() for x in data["xs"]]
            if model.feat_encs is not None:
                feats = [enc(x) for enc, x in zip(model.feat_encs, feats)]
            pairs = zip(model.heads, feats)
        want = torch.stack([head(x) for head, x in pairs], dim=1)
    assert torch.equal(got, want)

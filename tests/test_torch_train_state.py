"""The port's trainers over model state and their mid-training resume.

* ``train_many`` with the LUMA encoders' BatchNorm statistics stacked per
  seed (``model_state``): a late fusion over the Audio, Text and Image
  encoders at S = 2 against JAX ``train_many(model_state_stack=)`` with each
  seed's JAX draws replayed (losses rtol 2e-5 / atol 2e-6, parameters and
  running statistics rtol 5e-3 / atol 5e-5, the bounds of
  tests/test_torch_train_many.py; the convolutions' biases, whose true
  gradient is 0 under the BatchNorm after them, within two learning rates
  per step, as in tests/test_torch_luma.py); segmented against whole at
  rtol 1e-6 / atol 1e-7, the statistics included; against the port's
  ``train`` seed by seed, the losses and validation at rtol 1e-6 / atol
  1e-7, and the parameters and statistics by :func:`assert_same_but_noise`:
  under vmap the convolutions' weight gradients are batched products that
  sum in another order than one seed's, and Adam turns a gradient at
  rounding level (a convolution's bias feeds a BatchNorm: its true gradient
  is 0) into steps of up to lr of either sign.
* ``train(start_epoch=, resume=)`` split at epoch k against one
  uninterrupted fit, at rtol 1e-6 / atol 1e-7: the step loop over a stateful
  late fusion, and the epoch-kernel program (its plain version on the CPU)
  over a probe, whose state the step loop resumes too; and the port's
  resumed fit against the JAX package's resumed and uninterrupted fits
  (tests/test_train_many.py::test_resume_matches_uninterrupted's problem)
  at the loss and state bounds above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_luma import (  # noqa: F401 (offline_and_one_thread is an autouse fixture)
    _data,
    _jax_fit_draws,
    _late_tasks,
    assert_state,
    offline_and_one_thread,
)
from test_torch_luma import Replay as LumaReplay
from test_torch_train_many import (
    LOSS_TOL,
    SAME,
    STATE_TOL,
    Replay,
    _jax_loss,
    _jax_val,
    _logistic_fns,
    _logistic_problem,
    _perturbed,
    jax_draws,
)

from disentagled_multimodal_fusion_tpu.core.train import OptimizerConfig as JaxOptimizerConfig
from disentagled_multimodal_fusion_tpu.core.train import train as jax_train
from disentagled_multimodal_fusion_tpu.core.train import train_many as jax_train_many
from disentagled_multimodal_fusion_tpu_torch.convert import flax_to_state_dict, load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.train import (
    OptimizerConfig,
    Randomness,
    load_params,
    model_state_names,
    stack_model_state,
    stack_params,
    train,
    train_many,
)

S = 2
N, BATCH, EPOCHS = 11, 4, 2  # a ragged tail of 3 rows, whose statistics are its own
# What a vmapped seed's fit may differ by from its single fit outside the
# conv biases: at most 1 entry in 200 of a tensor (and always 1) beyond SAME,
# none by more than half an Adam step at LUMA's lr of 3e-4. Measured on the
# CPU: at most 39 of 12 288 entries (the image encoder's 512 -> 24 kernel),
# 179 of 1 048 576 (its 2048 -> 512 kernel), 1 of 128 (a running variance);
# the largest gap 9.27e-5 (its third convolution's kernel).
NOISE_SHARE, NOISE_CAP = 1 / 200, 1.5e-4


class StatelessReplay(LumaReplay):
    def state(self):
        return None


def _conv_biases(names):
    return sorted(k for k in names if ".conv." in k and k.endswith(".bias"))


def _jax_seeds():
    """Two seeds of the LUMA late fusion: seed 1's weights moved by 0.05
    normals and its running statistics moved off their init, so a mix-up of
    the seeds' statistics shows."""
    jtask, _ = _late_tasks("late")
    rng = np.random.default_rng(7)
    stats1 = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + np.float32(0.1) * np.abs(rng.standard_normal(a.shape, dtype=np.float32))),
        jtask.model_state)
    return jtask, [(jtask.params, jtask.model_state), (_perturbed(jtask.params, 1), stats1)]


def _port_models(inits):
    tasks = []
    for params, stats in inits:
        _, ttask = _late_tasks("late")
        load_flax_params(ttask.model, jax.device_get(params), jax.device_get(stats))
        tasks.append(ttask)
    return tasks


def test_stateful_train_many_matches_jax():
    jtask, inits = _jax_seeds()
    jdata, tdata = _data(N, 5)
    jval, tval = _data(5, 9)
    keys = [jax.random.PRNGKey(30 + s) for s in range(S)]
    stack = lambda trees: jax.tree.map(lambda *a: jnp.stack(a), *trees)  # noqa: E731
    ref = jax_train_many(
        rngs=jnp.stack(keys), params_stack=stack([p for p, _ in inits]), loss_fn=jtask.loss_fn,
        data_stack=jdata, n_train=N, optimizer=jtask.optimizer, epochs=EPOCHS, batch_size=BATCH,
        val_fn=jtask.val_fn, val_data_stack=jval, model_state_stack=stack([m for _, m in inits]),
        data_broadcast=True)
    tasks = _port_models(inits)
    models = [t.model for t in tasks]
    replays = [StatelessReplay(*_jax_fit_draws(jtask, N, BATCH, EPOCHS, k, jdata)) for k in keys]
    res = train_many(model=models[0], params=stack_params(models),
                     model_state=stack_model_state(models), loss_fn=tasks[0].loss_fn, data=tdata,
                     n_train=N, optimizer=tasks[0].optimizer, epochs=EPOCHS, batch_size=BATCH,
                     randomness=replays, val_fn=tasks[0].val_fn, val_data=tval,
                     data_broadcast=True)
    np.testing.assert_allclose(res.train_loss.numpy(), np.asarray(ref.train_loss), **LOSS_TOL)
    np.testing.assert_allclose(res.val_loss.numpy(), np.asarray(ref.val_loss), **LOSS_TOL)
    np.testing.assert_array_equal(res.val_acc.numpy(), np.asarray(ref.val_acc))
    assert sorted(res.state.model_state) == sorted(model_state_names(models[0])) != []
    load_params(models, res.params, res.state.model_state)
    lr = tasks[0].optimizer.lr
    for s, model in enumerate(models):
        want = flax_to_state_dict(jax.device_get(jax.tree.map(lambda a: a[s], ref.params)),
                                  jax.device_get(jax.tree.map(lambda a: a[s], ref.model_state)))
        free = _conv_biases(want)
        assert len(free) == 3
        assert_state(model, want, STATE_TOL, names=sorted(set(want) - set(free)))
        got = model.state_dict()
        for k in free:
            assert np.abs(got[k].numpy() - want[k].numpy()).max() <= 2 * lr * 6, k


def assert_same_but_noise(got, want, lr, steps):
    """``got`` and ``want`` (state dicts) at rtol 1e-6 / atol 1e-7, but for
    what Adam makes of gradients at rounding level after ``steps`` steps of
    ``lr``: the convolutions' biases within 2 lr per step; the running means
    (1 - momentum = 0.01 of each step's bias drift carried) within 0.01 lr
    steps (steps + 1) more; in any other tensor at most ``NOISE_SHARE`` of
    the entries (and always 1) beyond the tight bound and none beyond
    ``NOISE_CAP``."""
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        err = np.abs(g - w)
        if k in _conv_biases(want):
            assert err.max() <= 2 * lr * steps, (k, err.max())
            continue
        atol = SAME["atol"] + (0.01 * lr * steps * (steps + 1) if k.endswith(".mean") else 0.0)
        bad = err > atol + SAME["rtol"] * np.abs(w)
        cap = max(atol, NOISE_CAP)
        assert bad.sum() <= max(1, int(w.size * NOISE_SHARE)) and err.max() <= cap, (
            k, bad.sum(), err.max())


def _fit_kw(task, data, val):
    return dict(loss_fn=task.loss_fn, data=data, n_train=N, optimizer=task.optimizer,
                batch_size=BATCH, val_fn=task.val_fn, val_data=val)


def test_stateful_train_many_matches_train_and_segmented_whole():
    _, inits = _jax_seeds()
    _, tdata = _data(N, 5)
    _, tval = _data(5, 9)
    epochs = 3
    tasks = _port_models(inits)
    models = [t.model for t in tasks]
    kw = dict(model=models[0], params=stack_params(models), model_state=stack_model_state(models),
              epochs=epochs, data_broadcast=True, **_fit_kw(tasks[0], tdata, tval))
    whole = train_many(randomness=[Randomness(40 + s, "cpu") for s in range(S)], **kw)
    seg = train_many(randomness=[Randomness(40 + s, "cpu") for s in range(S)], segment_epochs=2,
                     **kw)
    for field in ("train_loss", "val_loss", "val_acc", "final_lr"):
        np.testing.assert_allclose(getattr(seg, field).numpy(), getattr(whole, field).numpy(),
                                   **SAME)
    for k in whole.params:
        np.testing.assert_allclose(seg.params[k].numpy(), whole.params[k].numpy(), **SAME)
    for k, v in whole.state.model_state.items():
        np.testing.assert_allclose(seg.state.model_state[k].numpy(), v.numpy(), **SAME)
    for s, task in enumerate(tasks):
        before = {k: v.clone() for k, v in task.model.state_dict().items()}
        one = train(model=task.model, randomness=Randomness(40 + s, "cpu"), epochs=epochs,
                    **_fit_kw(task, tdata, tval))
        np.testing.assert_allclose(whole.train_loss[s].numpy(), one.train_loss, **SAME)
        np.testing.assert_allclose(whole.val_loss[s].numpy(), one.val_loss, **SAME)
        np.testing.assert_array_equal(whole.val_acc[s].numpy(), one.val_acc)
        state = task.model.state_dict()
        for k in whole.state.model_state:
            assert not torch.equal(state[k], before[k]), k  # the fit moved the statistics
        got = {k: v[s] for k, v in {**whole.params, **whole.state.model_state}.items()}
        assert_same_but_noise(got, {k: state[k] for k in got}, task.optimizer.lr, 3 * epochs)


def _assert_same_fit(first, second, whole):
    for field in ("train_loss", "val_loss", "val_acc"):
        np.testing.assert_allclose(
            np.concatenate([getattr(first, field), getattr(second, field)]),
            getattr(whole, field), **SAME)
    np.testing.assert_allclose(second.final_lr, whole.final_lr, **SAME)
    assert second.state.count == whole.state.count


def test_resumed_train_equals_uninterrupted_with_model_state():
    _, inits = _jax_seeds()
    _, tdata = _data(N, 5)
    _, tval = _data(5, 9)
    whole_task, first_task = _port_models(inits[:1] * 2)
    whole = train(model=whole_task.model, randomness=Randomness(3, "cpu"), epochs=3,
                  **_fit_kw(whole_task, tdata, tval))
    first = train(model=first_task.model, randomness=Randomness(3, "cpu"), epochs=1,
                  **_fit_kw(first_task, tdata, tval))
    # the second segment picks up the generator from the state, not from
    # the object handed in
    second = train(model=first_task.model, randomness=Randomness(99, "cpu"), epochs=2,
                   start_epoch=1, resume=first.state, **_fit_kw(first_task, tdata, tval))
    _assert_same_fit(first, second, whole)
    got, want = first_task.model.state_dict(), whole_task.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **SAME)


def _probe_task():
    return ttasks.build_probe_task(num_modalities=2, num_classes=4, input_dim=12,
                                   hidden_dim=(16,), lr=3e-3, dropout=0.3, annealing_start=2,
                                   num_epochs=6, device="cpu")


def test_resumed_epoch_kernel_program_equals_uninterrupted():
    """The epoch-kernel program (its plain version here) split at epoch 2 of
    6, and a kernel fit's state resumed by the step loop: equal to the
    uninterrupted fits."""
    from disentagled_multimodal_fusion_tpu_torch.core.megakernel import supports_probe_megakernel

    rng = np.random.default_rng(4)
    n = 70
    data = {"zc": torch.from_numpy(rng.standard_normal((n, 12), dtype=np.float32)),
            "zp": torch.from_numpy(rng.standard_normal((n, 2, 12), dtype=np.float32)),
            "y": torch.from_numpy(rng.integers(0, 4, n))}
    tasks = [_probe_task() for _ in range(4)]
    assert supports_probe_megakernel(tasks[0].megakernel, tasks[0].optimizer)
    kw = lambda t, **k: dict(model=t.model, loss_fn=t.loss_fn, data=data, n_train=n,  # noqa: E731
                             optimizer=t.optimizer, batch_size=16, val_fn=t.val_fn,
                             val_data=data, **k)
    whole = train(randomness=Randomness(5, "cpu"), epochs=6,
                  **kw(tasks[0], megakernel=tasks[0].megakernel))
    first = train(randomness=Randomness(5, "cpu"), epochs=2,
                  **kw(tasks[1], megakernel=tasks[1].megakernel))
    second = train(randomness=Randomness(0, "cpu"), epochs=4, start_epoch=2, resume=first.state,
                   **kw(tasks[1], megakernel=tasks[1].megakernel))
    _assert_same_fit(first, second, whole)
    for (k, p), q in zip(tasks[1].model.named_parameters(), tasks[0].model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), err_msg=k, **SAME)

    # a step-loop fit resumed from the kernel program's state, and the
    # other way round, against the uninterrupted fits of each program
    step_whole = _probe_task()
    step_w = train(randomness=Randomness(5, "cpu"), epochs=6, **kw(step_whole))
    mixed = [_probe_task(), _probe_task()]
    a = train(randomness=Randomness(5, "cpu"), epochs=2,
              **kw(mixed[0], megakernel=mixed[0].megakernel))
    b = train(randomness=Randomness(0, "cpu"), epochs=4, start_epoch=2, resume=a.state,
              **kw(mixed[0]))
    np.testing.assert_allclose(np.concatenate([a.train_loss, b.train_loss]), step_w.train_loss,
                               **LOSS_TOL)
    c = train(randomness=Randomness(5, "cpu"), epochs=2, **kw(mixed[1]))
    d = train(randomness=Randomness(0, "cpu"), epochs=4, start_epoch=2, resume=c.state,
              **kw(mixed[1], megakernel=mixed[1].megakernel))
    np.testing.assert_allclose(np.concatenate([c.train_loss, d.train_loss]), whole.train_loss,
                               **LOSS_TOL)
    for p, q in zip(mixed[1].model.parameters(), tasks[0].model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **STATE_TOL)


def test_resumed_train_matches_jax_resume():
    """tests/test_train_many.py::test_resume_matches_uninterrupted's fit (12
    + 13 epochs of 80 rows, Adam + cosine) in both packages."""
    from test_torch_train_many import Logistic

    x, y = _logistic_problem(7, 80)
    jdata = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    opt = dict(name="adam", lr=0.03, schedule="cosine", cosine_t_max=25)
    params0 = {"w": jnp.zeros((6, 3)), "b": jnp.zeros(3)}
    common = dict(loss_fn=_jax_loss, data=jdata, n_train=80, optimizer=JaxOptimizerConfig(**opt),
                  batch_size=16, val_fn=_jax_val, val_data=jdata, donate=False)
    key = jax.random.PRNGKey(9)
    full = jax_train(rng=key, params=params0, epochs=25, **common)
    seg1 = jax_train(rng=key, params=params0, epochs=12, **common)
    seg2 = jax_train(rng=key, params=seg1.params, epochs=13, start_epoch=12,
                     resume=(seg1.opt_state, seg1.plateau_state, seg1.rng), **common)
    perms = jax_draws(jax.random.fold_in(key, 0x5CA1AB1E), 25, 80, 16)[0]

    model = Logistic()
    loss_fn, val_fn = _logistic_fns(model)
    tdata = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    replay = Replay(perms)
    kw = dict(model=model, loss_fn=loss_fn, data=tdata, n_train=80,
              optimizer=OptimizerConfig(**opt), batch_size=16, val_fn=val_fn, val_data=tdata)
    first = train(randomness=replay, epochs=12, **kw)
    second = train(randomness=replay, epochs=13, start_epoch=12, resume=first.state, **kw)
    got = np.concatenate([first.train_loss, second.train_loss])
    np.testing.assert_allclose(got, np.concatenate([np.asarray(seg1.train_loss),
                                                    np.asarray(seg2.train_loss)]), **LOSS_TOL)
    np.testing.assert_allclose(got, np.asarray(full.train_loss), **LOSS_TOL)
    np.testing.assert_allclose(np.concatenate([first.val_loss, second.val_loss]),
                               np.asarray(full.val_loss), **LOSS_TOL)
    for name, ref in (("w", full.params["w"]), ("b", full.params["b"])):
        np.testing.assert_allclose(getattr(model, name).detach().numpy(), np.asarray(ref),
                                   **STATE_TOL)

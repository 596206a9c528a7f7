"""The port's DisentangledSSL backbone and its ops against the JAX package.

Same numpy inputs on both sides, every random draw handed to the port as
JAX drew it: the schedulers (rtol 1e-6), the augmentations (bit for bit),
SupCon and the orthogonality loss (rtol 1e-5 / atol 1e-6), the vMF rotation
of JAX's (w, v) (rtol 1e-5) and the port's own w sampler against 20 000
JAX draws (two-sample KS p > 1e-3, means within 0.02: w lies in [-1, 1],
and at kappa = 1 the standard error of the difference of the two means is
0.0025), the module from converted parameters (embedding and loss rtol
1e-5), a two-epoch fit with JAX's permutations and draws replayed (the
tolerances of tests/test_torch_probe_megakernel.py: losses rtol 2e-5,
parameters rtol 5e-3 / atol 5e-5), and ``runners/run.py --backbone dssl``
on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.core.train import OptimizerConfig as JaxOptimizerConfig
from disentagled_multimodal_fusion_tpu.core.train import train as jax_train
from disentagled_multimodal_fusion_tpu.models.disentangledssl import DisentangledSSL as JaxDSSL
from disentagled_multimodal_fusion_tpu.models.disentangledssl import disentangledssl_loss
from disentagled_multimodal_fusion_tpu.ops import augment as jaug
from disentagled_multimodal_fusion_tpu.ops import contrastive as jcon
from disentagled_multimodal_fusion_tpu.ops import schedulers as jsched
from disentagled_multimodal_fusion_tpu.ops import vmf as jvmf
from disentagled_multimodal_fusion_tpu_torch.convert import flax_to_state_dict, load_flax_params
from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.train import OptimizerConfig, Randomness, train
from disentagled_multimodal_fusion_tpu_torch.models.disentangledssl import DisentangledSSL
from disentagled_multimodal_fusion_tpu_torch.ops import augment as taug
from disentagled_multimodal_fusion_tpu_torch.ops import contrastive as tcon
from disentagled_multimodal_fusion_tpu_torch.ops import schedulers as tsched
from disentagled_multimodal_fusion_tpu_torch.ops import vmf as tvmf

TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=2e-5)
STATE_TOL = dict(rtol=5e-3, atol=5e-5)
T = torch.from_numpy
# one compile per shape: an eager call would trace and compile its
# while_loop anew each time
jax_sample_w = jax.jit(jvmf._sample_w_rej, static_argnums=2)


@pytest.mark.parametrize("name,args", [
    ("linear_schedule", (0.2, 1.5, 100, 3)),
    ("exponential_schedule", (1e-4, 1.0, 100, 3)),
    ("exponential_schedule", (1e-3, 0.5, 7, 0)),
])
def test_schedulers_match_jax(name, args):
    for it in (0, 1, 3, 4, 5, 50, 99, 102, 103, 104, 500):
        ref = float(getattr(jsched, name)(it, *args))
        np.testing.assert_allclose(getattr(tsched, name)(it, *args), ref, rtol=1e-6)


def test_exponential_schedule_refuses_zero():
    with pytest.raises(ValueError, match="undefined at 0"):
        tsched.exponential_schedule(3, 0.0, 1.0, 10)


def _aug_draws(key, b, d):
    """JAX augment_data's draws from ``key``: (choice, noise, scores)."""
    k_choice, k_noise, k_drop = jax.random.split(key, 3)
    return (np.asarray(jax.random.randint(k_choice, (b,), 0, 3)),
            np.asarray(jax.random.normal(k_noise, (b, d))),
            np.asarray(jax.random.uniform(k_drop, (b, d))))


@pytest.mark.parametrize("d", [10, 32, 7])
def test_augmentations_match_jax_bitwise(d):
    b, key = 40, jax.random.PRNGKey(d)
    x = np.random.default_rng(d).standard_normal((b, d)).astype(np.float32)
    choice, eps, scores = _aug_draws(key, b, d)
    assert set(np.unique(choice)) == {0, 1, 2}
    _, k_noise, k_drop = jax.random.split(key, 3)
    np.testing.assert_array_equal(taug.noise(T(x), T(eps)).numpy(),
                                  np.asarray(jaug.noise(k_noise, jnp.asarray(x))))
    dropped = taug.random_drop(T(x), T(scores)).numpy()
    np.testing.assert_array_equal(dropped, np.asarray(jaug.random_drop(k_drop, jnp.asarray(x))))
    assert np.all(np.sum(dropped == 0, axis=1) == d // 10)
    got = taug.augment_data(T(x), (T(choice), T(eps), T(scores))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jaug.augment_data(key, jnp.asarray(x))))


def _features(b, v, d, seed):
    f = np.random.default_rng(seed).standard_normal((b, v, d)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("labelled", [False, True])
def test_supcon_loss_matches_jax(labelled):
    f = _features(24, 2, 9, seed=1)
    labels = np.random.default_rng(2).integers(0, 4, 24) if labelled else None
    ref = jcon.supcon_loss(jnp.asarray(f), None if labels is None else jnp.asarray(labels))
    ft = T(f).requires_grad_()
    got = tcon.supcon_loss(ft, None if labels is None else T(labels))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **TOL)
    assert not got[1].requires_grad and not got[2].requires_grad
    ref_grad = jax.grad(lambda x: jcon.supcon_loss(
        x, None if labels is None else jnp.asarray(labels))[0])(jnp.asarray(f))
    (grad,) = torch.autograd.grad(got[0], ft)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-4, atol=1e-6)


def test_ortho_loss_matches_jax():
    rng = np.random.default_rng(3)
    z1, zs = (rng.standard_normal((30, 6)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(tcon.ortho_loss(T(z1), T(zs)).item(),
                               float(jcon.ortho_loss(jnp.asarray(z1), jnp.asarray(zs))), **TOL)


def _loc(b, m, seed):
    loc = np.random.default_rng(seed).standard_normal((b, m)).astype(np.float32)
    return loc / np.linalg.norm(loc, axis=-1, keepdims=True)


@pytest.mark.parametrize("m", [16, 3])
def test_vmf_rotation_of_jax_draws_matches_jax(m):
    b, key, kappa = 64, jax.random.PRNGKey(m), 2.0
    loc = _loc(b, m, seed=m)
    scale = jnp.full((b, 1), kappa)
    ref = np.asarray(jax.jit(jvmf.vmf_rsample)(key, jnp.asarray(loc), scale))
    k_w, k_v = jax.random.split(key)
    w = (jvmf._sample_w3(k_w, scale, scale.shape) if m == 3
         else jax_sample_w(k_w, scale, m))
    v = jax.random.normal(k_v, (b, m - 1))
    got = tvmf.vmf_rotate(T(np.asarray(w)), T(np.asarray(v)), T(loc)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    x = np.concatenate([np.asarray(w), np.zeros((b, m - 1), np.float32)], axis=1)
    np.testing.assert_allclose(tvmf.householder_rotation(T(x), T(loc)).numpy(),
                               np.asarray(jvmf._householder_rotation(jnp.asarray(x),
                                                                     jnp.asarray(loc))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,kappa", [(16, 1.0), (16, 10.5), (16, 50.0), (3, 1.0)])
def test_vmf_w_sampler_matches_jax_in_distribution(m, kappa):
    n = 20000
    scale = jnp.full((n, 1), kappa)
    key = jax.random.PRNGKey(int(10 * kappa) + m)
    ref = np.asarray(jvmf._sample_w3(key, scale, scale.shape) if m == 3
                     else jax_sample_w(key, scale, m))[:, 0]
    randomness = Randomness(int(10 * kappa) + m, "cpu")
    w = randomness.vmf_w(kappa, m, n).numpy()
    assert w.shape == (n,) and np.all(np.abs(w) <= 1.0)
    if m == 3:
        assert randomness.vmf_syncs == 0  # the closed form
    else:
        assert 1 <= randomness.vmf_syncs <= 5  # one count per block of proposals
    p = scipy.stats.ks_2samp(w, ref).pvalue
    assert p > 1e-3, p
    assert abs(w.mean() - ref.mean()) <= 0.02, (w.mean(), ref.mean())


def test_vmf_rejection_returns_only_accepted_proposals(monkeypatch):
    """A row whose every proposal in a block is rejected waits for the next
    block; its w is the first accepted proposal, never a rejected one."""
    calls = []
    real = tvmf._proposals

    def spy(randomness, shape, m):
        e, u = real(randomness, shape, m)
        if not calls:
            u = u.clone()
            u[:, 0] = 1.0  # row 0 rejects every proposal of the first block
        calls.append(shape)
        return e, u

    monkeypatch.setattr(tvmf, "_proposals", spy)
    w, syncs = tvmf.sample_w(Randomness(0, "cpu"), 1.0, 16, 50)
    assert calls[0] == (4, 50) and calls[1][1] >= 1 and syncs >= 3
    assert torch.all(w.abs() <= 1.0)


# ---------------------------------------------------------------- the module
DIMS, HIDDEN, EMBED = (12, 10), 8, 6
LMD = dict(lmd_start_value=1e-3, lmd_end_value=1.0, lmd_n_iterations=10)


@functools.lru_cache(maxsize=None)
def _jax_task(distribution):
    """(model, params, loss_fn) of the JAX package's DSSL task, built once.
    The parameters come from flax's init through ``get_embedding``, which
    creates every parameter without running the vMF sampler: the values of
    ``build_disentangledssl_task``'s init at the same key, some seconds
    sooner."""
    model = JaxDSSL(output_dim=DIMS, hidden_dim=HIDDEN, embed_dim=EMBED,
                    distribution=distribution, **LMD)
    xs = [jnp.zeros((4, d)) for d in DIMS]
    params = model.init({"params": jax.random.PRNGKey(0)}, xs,
                        method=JaxDSSL.get_embedding)["params"]
    return model, params, jtasks._ssl_closures(model)


def _port_task(distribution, params, **kw):
    """The port's (model, objective, optimizer) with JAX's parameters."""
    model, objective, opt = ttasks.build_disentangledssl_task(
        output_dim=DIMS, hidden_dim=HIDDEN, embed_dim=EMBED, distribution=distribution,
        device="cpu", **LMD, **kw)
    if params is not None:
        load_flax_params(model, jax.device_get(params))
    return model, objective, opt


def _views(b, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, d)).astype(np.float32) for d in DIMS]


def jax_step_draws(model, params, key, b, dims=DIMS):
    """Every draw of JAX's ``disentangledssl_loss`` at ``key``, in the
    port's layout: the two views' augmentation draws (views of widths
    ``dims``), then w (b, 4) and v (b, 4, m - 1) for vMF heads or eps (b, 4,
    m) for normal heads. The heads' key is flax's ``make_rng('noise')`` of
    the loss forward."""
    k_a1, k_a2, k_fwd = jax.random.split(key, 3)
    draws = [*_aug_draws(k_a1, b, dims[0]), *_aug_draws(k_a2, b, dims[1])]
    k_noise = model.apply({"params": params}, method=lambda mdl: mdl.make_rng("noise"),
                          rngs={"noise": k_fwd})
    keys = jax.random.split(k_noise, 4)
    if model.distribution == "normal":
        return draws + [np.stack([np.asarray(jax.random.normal(k, (b, EMBED))) for k in keys], 1)]
    ws, vs = [], []
    for k in keys:
        k_w, k_v = jax.random.split(k)
        ws.append(np.asarray(jax_sample_w(k_w, jnp.full((b, 1), model.vmfkappa), EMBED))[:, 0])
        vs.append(np.asarray(jax.random.normal(k_v, (b, EMBED - 1))))
    return draws + [np.stack(ws, 1), np.stack(vs, 1)]


def test_convert_carries_a_dssl_tree():
    _, params, _ = _jax_task("vmf")
    model = DisentangledSSL(DIMS, torch.Generator().manual_seed(1), hidden_dim=HIDDEN,
                            embed_dim=EMBED)
    state = flax_to_state_dict(jax.device_get(params))
    assert set(state) == set(model.state_dict())
    assert {k.split(".")[0] for k in state} == {"encoder_x1s", "encoder_x2s", "encoder_x1",
                                                "encoder_x2"}
    assert state["encoder_x1.layers.0.weight"].shape == (HIDDEN, DIMS[0] + EMBED)


def test_get_embedding_matches_jax():
    jmodel, params, _ = _jax_task("vmf")
    xs = _views(20, seed=4)
    zc, zp = jtasks.embed_dataset_ssl(jmodel, params, [jnp.asarray(x) for x in xs])
    got_zc, got_zp = ttasks.embed_dataset_ssl(_port_task("vmf", params)[0], [T(x) for x in xs])
    np.testing.assert_allclose(got_zc.numpy(), np.asarray(zc), **TOL)
    np.testing.assert_allclose(got_zp.numpy(), np.asarray(zp), **TOL)
    assert got_zc.shape == (20, 2 * EMBED) and got_zp.shape == (20, 2, EMBED)


@pytest.mark.parametrize("distribution", ["vmf", "normal"])
def test_loss_and_logs_match_jax_with_replayed_draws(distribution):
    jmodel, params, _ = _jax_task(distribution)
    xs, b, step, key = _views(16, seed=5), 16, 4, jax.random.PRNGKey(3)
    ref, ref_logs = jax.jit(functools.partial(disentangledssl_loss, jmodel))(
        params, [jnp.asarray(x) for x in xs], step, key)
    draws = tuple(T(np.asarray(d)) for d in jax_step_draws(jmodel, params, key, b))
    loss, logs = _port_task(distribution, params)[0].loss([T(x) for x in xs], draws, step)
    assert set(logs) == set(ref_logs)
    for k, v in ref_logs.items():
        np.testing.assert_allclose(float(logs[k]), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)


class Replay:
    """The port's Randomness interface over recorded JAX draws, taken in the
    order the port asks for them (method and shape checked)."""

    def __init__(self, queue):
        self.queue, self.vmf_syncs = list(queue), 0

    def _pop(self, kind, shape):
        got_kind, value = self.queue.pop(0)
        assert got_kind == kind and value.shape == tuple(shape), (kind, shape, got_kind,
                                                                  value.shape)
        return torch.from_numpy(np.array(value))

    def permutation(self, n):
        return self._pop("permutation", (n,)).long()

    def integers(self, high, shape):
        return self._pop("integers", shape).long()

    def normal(self, shape):
        return self._pop("normal", shape)

    def uniform(self, shape):
        return self._pop("uniform", shape)

    def vmf_w(self, kappa, m, n):
        return self._pop("vmf_w", (n,))


def jax_fit_draws(jmodel, params, key, epochs, n, b):
    """The permutations and loss draws of a JAX ``train`` of the SSL loss
    with drop_last from ``key``, as the port's fit asks for them per epoch."""
    key = jax.random.fold_in(key, 0x5CA1AB1E)
    queue = []
    for _ in range(epochs):
        key, k_perm, k_steps = jax.random.split(key, 3)
        queue.append(("permutation", np.asarray(jax.random.permutation(k_perm, n))))
        steps = [jax_step_draws(jmodel, params, k, b)
                 for k in jax.random.split(k_steps, n // b)]
        kinds = ["integers", "normal", "uniform"] * 2 + ["vmf_w", "normal"]
        for i, kind in enumerate(kinds):
            cat = np.concatenate([s[i] for s in steps])
            queue.append((kind, cat.reshape(-1) if kind == "vmf_w" else cat))
    return queue


@pytest.fixture(scope="module")
def jax_fit():
    jmodel, params, loss_fn = _jax_task("vmf")
    xs = _views(512, seed=6)
    opt = JaxOptimizerConfig(name="adam", lr=3e-3, schedule="cosine", cosine_t_max=2)
    key = jax.random.PRNGKey(9)
    ref = jax_train(rng=key, params=params, loss_fn=loss_fn,
                    data={"xs": tuple(jnp.asarray(x) for x in xs)}, n_train=512, optimizer=opt,
                    epochs=2, batch_size=128, drop_last=True, donate=False)
    return jmodel, params, xs, key, ref


def test_short_fit_matches_jax_with_replayed_draws(jax_fit):
    jmodel, params, xs, key, ref = jax_fit
    model, objective, opt = _port_task("vmf", params, lr=3e-3, epochs=2)
    assert opt == OptimizerConfig(name="adam", lr=3e-3, schedule="cosine", cosine_t_max=2)
    replay = Replay(jax_fit_draws(jmodel, params, key, 2, 512, 128))
    res = train(model=model, loss_fn=objective, data={"xs": tuple(T(x) for x in xs)},
                n_train=512, optimizer=opt, epochs=2, batch_size=128, randomness=replay,
                drop_last=True)
    assert not replay.queue
    np.testing.assert_allclose(res.train_loss, np.asarray(ref.train_loss), **LOSS_TOL)
    ref_state = flax_to_state_dict(jax.device_get(ref.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_state[name].numpy(), **STATE_TOL,
                                   err_msg=name)


def test_the_lambda_ramp_follows_the_global_step():
    """lmd_end_value > 0 ramps lambda by exponential_schedule over the
    optimizer steps taken (JAX ``StepInfo.step``), not the epoch."""
    model, objective, opt = _port_task("vmf", None, epochs=2)
    seen = []
    real = model.lmd_at
    model.lmd_at = lambda it: seen.append(it) or real(it)
    xs = tuple(T(x) for x in _views(70, seed=7))
    train(model=model, loss_fn=objective, data={"xs": xs}, n_train=70, optimizer=opt,
          epochs=2, batch_size=16, randomness=Randomness(0, "cpu"), drop_last=True)
    assert seen == list(range(8))  # 4 steps per epoch, the tail of 6 rows dropped
    assert model.lmd_at(0) == pytest.approx(1e-3) and model.lmd_at(10) == pytest.approx(1.0)


def test_dssl_task_trains_and_embeds_on_the_cpu():
    model, objective, opt = ttasks.build_disentangledssl_task(
        output_dim=DIMS, hidden_dim=HIDDEN, embed_dim=EMBED, distribution="normal", epochs=2,
        device="cpu")
    xs = tuple(T(x) for x in _views(300, seed=8))
    before = [p.detach().clone() for p in model.parameters()]
    res = train(model=model, loss_fn=objective, data={"xs": xs}, n_train=300, optimizer=opt,
                epochs=2, batch_size=128, randomness=Randomness(0, "cpu"), drop_last=True)
    assert np.all(np.isfinite(res.train_loss))
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    with pytest.raises(ValueError, match="drop_last=True with n_train=100 < batch_size=128"):
        train(model=model, loss_fn=objective, data={"xs": xs}, n_train=100, optimizer=opt,
              epochs=1, batch_size=128, randomness=Randomness(0, "cpu"), drop_last=True)


# ---------------------------------------------------------------- the runner
def _tiny_config():
    """The UQ sweep's config at narrow widths (the test_torch_run.py cut)."""
    from disentagled_multimodal_fusion_tpu_torch.runners import common

    cfg = common.load_config()
    cfg["dmvae"].update(hidden_dim=16, embed_dim=8, num_epochs=2)
    cfg["probes"].update(input_dim=8, model_hidden_dim=[8], model_epochs=2)
    return common.make_getter(cfg)


def test_run_backbone_dssl_writes_dssl_rows(tmp_path, monkeypatch):
    from disentagled_multimodal_fusion_tpu_torch.runners import common, run

    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    tiny = _tiny_config()
    monkeypatch.setattr(common, "make_getter", lambda cfg: tiny)
    rows = run.main(["--backbone", "dssl", "--datasets", "CUB", "--quick", "--seeds", "0",
                     "--conditions", "Normal", "--device", "cpu"])
    models = rows[0]["Normal"]["CUB"]
    assert sorted(models) == sorted(["dssl_dis", "dssl_cml", "dssl_joint", "dbf_fusion",
                                     "cml_fusion", "avg_fusion"])
    assert all(0.0 <= m["fused"]["accuracy"] <= 1.0 for m in models.values())
    assert (tmp_path / "checkpoints" / "dssl_datasetCUB_seed0_normal.pt").is_file()
    assert (tmp_path / "checkpoints" / "dssl_cml_fusion_dsCUB_seed0.pt").is_file()
    assert (tmp_path / "logs" / "dssl_dataset_analysis_all_results.csv").is_file()
    assert not (tmp_path / "logs" / "dataset_analysis_all_results.csv").exists()


@pytest.mark.parametrize("argv,message", [
    (["--backbone", "dssl", "--vmap-seeds"], "sequential engine only"),
    (["--backbone", "dssl", "--one-program-cells"], "sequential engine only"),
])
def test_run_refuses_dssl_on_the_seed_batched_engines(argv, message, capsys):
    from disentagled_multimodal_fusion_tpu_torch.runners import run

    with pytest.raises(SystemExit):
        run.parse_args(argv)
    assert message in capsys.readouterr().err


def test_run_refuses_dssl_on_a_dataset_of_more_views(tmp_path, monkeypatch):
    from disentagled_multimodal_fusion_tpu_torch.runners import run

    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(tmp_path))
    with pytest.raises(ValueError, match="2-modal"):
        run.main(["--backbone", "dssl", "--datasets", "HandWritten", "--quick", "--seeds", "0",
                  "--conditions", "Normal", "--device", "cpu"])


# ------------------------------------------------- with LUMA feature encoders
RAW = (40, 128)  # the audio MFCCs and the text ids, encoded to DIMS


def _encoder_specs():
    return (("AudioEncoder", dict(input_dim=RAW[0], output_dim=DIMS[0], dropout=0.1)),
            ("TextEncoder", dict(input_dim=RAW[1], output_dim=DIMS[1], dropout=0.1)))


def test_feature_encoders_loss_and_gradients_match_jax():
    """DSSL over LUMA's Audio and Text encoders (JAX ``models/disentangledssl.py:44-54``):
    the loss (rtol 1e-5) and every gradient (rtol 1e-4 / atol 1e-6, the
    tolerance of the SupCon gradient above) with JAX's augmentation, head
    and dropout draws fed in; the port draws the encoders' masks ahead of
    its own, in the forward's call order."""
    from disentagled_multimodal_fusion_tpu.models import layers as jlayers
    from test_torch_luma import jitted_draws, port_mask

    encoders = (jlayers.AudioEncoder(input_dim=RAW[0], output_dim=DIMS[0], dropout=0.1),
                jlayers.TextEncoder(input_dim=RAW[1], output_dim=DIMS[1], dropout=0.1))
    jmodel = JaxDSSL(output_dim=RAW, hidden_dim=HIDDEN, embed_dim=EMBED, **LMD,
                     feature_encoders=encoders)
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         [jnp.zeros((4, d)) for d in RAW], method=JaxDSSL.get_embedding)["params"]
    b, step, key = 16, 4, jax.random.PRNGKey(3)
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((b, d)).astype(np.float32) for d in RAW]
    jxs = [jnp.asarray(x) for x in xs]

    def jloss(p, k):
        return disentangledssl_loss(jmodel, p, jxs, step, k)[0]

    run, kinds = jitted_draws(jax.value_and_grad(jloss), names=("bernoulli",))
    (ref, ref_grads), masks = run(params, key)
    assert kinds == ["bernoulli"] * 8  # two hidden layers per call, four calls
    own = [T(np.asarray(d)) for d in jax_step_draws(jmodel, params, key, b, dims=RAW)]

    model, objective, _ = ttasks.build_disentangledssl_task(
        output_dim=RAW, hidden_dim=HIDDEN, embed_dim=EMBED, device="cpu", **LMD,
        feature_encoders=_encoder_specs())
    load_flax_params(model, jax.device_get(params))
    draws = tuple(port_mask(m) for m in masks) + tuple(own)
    loss, _ = model.loss([T(x) for x in xs], draws, step)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = flax_to_state_dict(jax.device_get(ref_grads))
    assert set(want) == set(names) and any(n.startswith("feat_encs.1.") for n in names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)

    # the port's own draws: the encoders' masks lead each step's tuple
    steps = objective.draw_epoch(Randomness(1, "cpu"), [b, 5])
    shapes = [tuple(t.shape) for t in steps[1][:8]]
    assert shapes == [(5, 128), (5, 256)] * 2 + [(5, 256), (5, 256)] * 2
    assert [tuple(t.shape) for t in steps[1][8:14]] == [(5,), (5, RAW[0]), (5, RAW[0]),
                                                      (5,), (5, RAW[1]), (5, RAW[1])]
    with torch.no_grad():
        zc, zp = ttasks.embed_dataset_ssl(model, [T(x) for x in xs])
    jzc, jzp = jtasks.embed_dataset_ssl(jmodel, params, jxs)
    np.testing.assert_allclose(zc.numpy(), np.asarray(jzc), **TOL)
    np.testing.assert_allclose(zp.numpy(), np.asarray(jzp), **TOL)

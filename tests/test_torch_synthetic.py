"""The port's synthetic dependence sweep against the JAX package.

* the data copy equals JAX's ``make_simple_plus_splits`` bit for bit, and
  ``SYNTHETIC_CONFIG`` equals the parsed YAML;
* ``train`` and ``train_many`` with ``drop_last`` and unshuffled epochs
  against JAX ``train`` on a logistic problem (same step count, losses rtol
  2e-5 / atol 2e-6, parameters rtol 5e-3 / atol 5e-5, the tolerances of
  tests/test_torch_probe_megakernel.py), and the ``ValueError`` when no
  step is left;
* the epoch-kernel program with ``drop_last`` (no tail step, Adam counting
  full steps only) against JAX's kernel program in interpret mode with the
  JAX draws replayed, and against the port's step loop from one generator;
* ``runners/run_synthetic.py --quick`` over both backbones, over the
  unfused DMVAE (``--no-fused-dmvae``) and with ``--vmap-seeds``: the JAX
  package's models, report columns (its flattener on the same rows) and
  artifact names; its refusals; and ``runners/evaluate.py --dataset
  synthetic`` reproducing the sweep's row.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch import nn

from disentagled_multimodal_fusion_tpu.core import megakernel as jmk
from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
from disentagled_multimodal_fusion_tpu.core.train import OptimizerConfig as JaxOptimizerConfig
from disentagled_multimodal_fusion_tpu.core.train import train as jax_train
from disentagled_multimodal_fusion_tpu.data import synthetic as jsyn
from disentagled_multimodal_fusion_tpu.eval import analysis as janalysis
from disentagled_multimodal_fusion_tpu.ops import probe_megakernel as jpm
from disentagled_multimodal_fusion_tpu_torch.configs.config import SYNTHETIC_CONFIG
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
from disentagled_multimodal_fusion_tpu_torch.data import synthetic as tsyn
from disentagled_multimodal_fusion_tpu_torch.eval import analysis as tanalysis
from disentagled_multimodal_fusion_tpu_torch.runners import evaluate as tevaluate
from disentagled_multimodal_fusion_tpu_torch.runners import run_synthetic as trs
from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter

LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
STATE_TOL = dict(rtol=5e-3, atol=5e-5)
YAML = "disentagled_multimodal_fusion_tpu/configs/synthetic_config.yaml"


@pytest.mark.parametrize("preset,dep", [("med", 0), ("med", 50), ("hard", 0), ("hard", 50)])
def test_data_copy_equals_jax_bitwise(preset, dep):
    kw = trs.preset_data_kwargs(make_getter(load_config("synthetic_config.yaml")), preset, False)
    kw["n_samples"] = 1000
    rho = dep / 100.0
    ref = jsyn.make_simple_plus_splits(batch_size=128, seed=0, rho=rho, shared_class_frac=rho,
                                       **kw)
    got = tsyn.make_simple_plus_splits(batch_size=128, seed=0, rho=rho, shared_class_frac=rho,
                                       **kw)
    for (xs, y), (rxs, ry) in zip(got[1:], ref[1:]):
        for x, rx in zip(xs, rxs):
            assert x.dtype == rx.dtype == np.float32
            np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
    assert got[1][0][0].shape == (800, 16 + kw["d_spurious"])


def test_synthetic_config_equals_the_yaml():
    with open(Path(__file__).resolve().parent.parent / YAML) as f:
        assert SYNTHETIC_CONFIG == yaml.safe_load(f)


# ------------------------------------------------------- drop_last, unshuffled
class Logistic(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(6, 3))
        self.b = nn.Parameter(torch.zeros(3))


def _problem(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    return x, (x @ rng.standard_normal((6, 3))).argmax(1)


def _jax_loss(params, batch, mask, t, key):
    logits = batch["x"] @ params["w"] + params["b"]
    ll = -jnp.take_along_axis(jax.nn.log_softmax(logits), batch["y"][:, None], 1)[:, 0]
    return jnp.sum(ll * mask) / jnp.maximum(jnp.sum(mask), 1.0), {}


def _port_objective(model, calls):
    def loss(batch, mask, epoch, draws):
        calls.append(int(mask.shape[0]))
        logits = batch["x"] @ model.w + model.b
        ll = -torch.gather(torch.log_softmax(logits, -1), 1, batch["y"][:, None])[:, 0]
        return torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0), {}

    return Objective(lambda randomness, rows: None, loss)


class Perms:
    """Replays JAX's epoch permutations (the problem draws nothing else)."""

    def __init__(self, key, epochs, n):
        key = jax.random.fold_in(key, 0x5CA1AB1E)
        self.perms = []
        for _ in range(epochs):
            key, k_perm, _ = jax.random.split(key, 3)
            self.perms.append(np.asarray(jax.random.permutation(k_perm, n)))

    def permutation(self, n):
        return torch.from_numpy(self.perms.pop(0).astype(np.int64))


@pytest.mark.parametrize("drop_last,shuffle", [(True, False), (True, True), (False, False)])
def test_train_drop_last_and_unshuffled_match_jax(drop_last, shuffle):
    n, b, epochs = 70, 16, 3
    x, y = _problem(n, seed=1)
    key = jax.random.PRNGKey(4)
    opt = dict(name="adam", lr=0.05, schedule="cosine", cosine_t_max=epochs)
    ref = jax_train(rng=key, params={"w": jnp.zeros((6, 3)), "b": jnp.zeros(3)},
                    loss_fn=_jax_loss, data={"x": jnp.asarray(x), "y": jnp.asarray(y)},
                    n_train=n, optimizer=JaxOptimizerConfig(**opt), epochs=epochs, batch_size=b,
                    drop_last=drop_last, shuffle=shuffle, donate=False)
    model, calls = Logistic(), []
    res = train(model=model, loss_fn=_port_objective(model, calls),
                data={"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, n_train=n,
                optimizer=OptimizerConfig(**opt), epochs=epochs, batch_size=b,
                randomness=Perms(key, epochs, n) if shuffle else None, drop_last=drop_last,
                shuffle=shuffle)
    steps = [16] * 4 + ([] if drop_last else [6])
    assert calls == steps * epochs
    np.testing.assert_allclose(res.train_loss, np.asarray(ref.train_loss), **LOSS_TOL)
    for k in ("w", "b"):
        np.testing.assert_allclose(getattr(model, k).detach().numpy(), np.asarray(ref.params[k]),
                                   **STATE_TOL)


def test_train_many_with_drop_last_equals_train_per_seed():
    n, b, epochs, s_count = 70, 16, 2, 2
    problems = [_problem(n, seed=s) for s in range(s_count)]
    data = {"x": torch.from_numpy(np.stack([p[0] for p in problems])),
            "y": torch.from_numpy(np.stack([p[1] for p in problems]))}
    opt = OptimizerConfig(name="adam", lr=0.05, schedule="cosine", cosine_t_max=epochs)
    models = [Logistic() for _ in range(s_count)]
    calls = []
    many = train_many(model=models[0], params=stack_params(models),
                      loss_fn=_port_objective(models[0], calls), data=data, n_train=n,
                      optimizer=opt, epochs=epochs, batch_size=b,
                      randomness=[Randomness(5 + s, "cpu") for s in range(s_count)],
                      drop_last=True)
    assert calls == [16] * 4 * epochs
    for s, model in enumerate(models):
        one = train(model=model, loss_fn=_port_objective(model, []),
                    data={k: v[s] for k, v in data.items()}, n_train=n, optimizer=opt,
                    epochs=epochs, batch_size=b, randomness=Randomness(5 + s, "cpu"),
                    drop_last=True)
        np.testing.assert_allclose(many.train_loss[s].numpy(), one.train_loss, rtol=1e-6)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(many.params[k][s].numpy(), p.detach().numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_drop_last_without_a_full_batch_raises():
    model = Logistic()
    x, y = _problem(10, seed=0)
    with pytest.raises(ValueError, match="zero optimizer steps"):
        train(model=model, loss_fn=_port_objective(model, []),
              data={"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, n_train=10,
              optimizer=OptimizerConfig(name="adam", lr=0.1), epochs=1, batch_size=16,
              randomness=Randomness(0, "cpu"), drop_last=True)


# ------------------------------------------------------- the epoch kernel
class Replay:
    """Permutations and dropout masks of a JAX probe fit, replayed."""

    def __init__(self, perms, masks):
        self.perms, self.masks = list(perms), list(masks)

    def permutation(self, n):
        return torch.from_numpy(self.perms.pop(0).astype(np.int64))

    def bernoulli(self, p, shape):
        m = self.masks.pop(0)
        assert m.shape == tuple(shape)
        return torch.from_numpy(np.array(m))


def _probe_case():
    """The synthetic probe at tiny widths: C = 3, V = 3, fused = 0, a
    shared input wider than the private ones (as over DSSL)."""
    return dict(num_modalities=2, num_classes=3, input_dim=5, shared_input_dim=8,
                hidden_dim=(8,), lr=3e-3, dropout=0.1, annealing_start=2, aggregation="cml",
                fused=0.0, num_epochs=2)


def test_epoch_kernel_program_with_drop_last_matches_jax_and_the_step_loop():
    n, b, epochs, views, keep = 40, 16, 2, 3, 0.9  # 2 steps per epoch, 8 rows dropped
    kw = _probe_case()
    jtask = jtasks.build_probe_task(rng=jax.random.PRNGKey(0), **kw)
    rng = np.random.default_rng(3)
    jdata = {"zc": jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32)),
             "zp": jnp.asarray(rng.standard_normal((n, 2, 5)).astype(np.float32)),
             "y": jnp.asarray(rng.integers(0, 3, n))}
    jval = jax.tree.map(lambda a: a[:32], jdata)
    desc = jmk.ProbeMegakernelDesc(2, 3, 5, 8, 8, 0.1, 0.0, 2.0, True)
    program = jmk.make_probe_megakernel_program(
        desc=desc, n_train=n, optimizer=jtask.optimizer, epochs=epochs, batch_size=b,
        drop_last=True, shuffle=True, val_fn=jtask.val_fn, interpret=True)
    key = jax.random.PRNGKey(7)
    ref = program(jtask.params, key, jdata, jval, None)
    # the JAX draws: per epoch a permutation and one (16, V, H) mask per full step
    perms, masks, k = [], [], key  # the program itself (train() would fold the key first)
    for _ in range(epochs):
        k, k_perm, k_steps = jax.random.split(k, 3)
        perms.append(np.asarray(jax.random.permutation(k_perm, n)))
        masks += [np.asarray(jax.random.bernoulli(jpm.dropout_mask_key(sk), keep, (b, views, 8)))
                  for sk in jax.random.split(k_steps, n // b)]
    data = {k: torch.from_numpy(np.array(v)) for k, v in jdata.items()}
    val = {k: torch.from_numpy(np.array(v)) for k, v in jval.items()}
    results = {}
    for engine, randomness in (("replay", Replay(perms, masks)),
                               ("megakernel", Randomness(11, "cpu")),
                               ("step", Randomness(11, "cpu"))):
        task = ttasks.build_probe_task(device="cpu", **kw)
        load_flax_params(task.model, jax.device_get(jtask.params))
        res = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=n,
                    optimizer=task.optimizer, epochs=epochs, batch_size=b, randomness=randomness,
                    val_fn=task.val_fn, val_data=val, drop_last=True,
                    megakernel=None if engine == "step" else task.megakernel)
        results[engine] = (res, [p.detach().numpy().copy() for p in task.model.parameters()])
    res, params = results["replay"]
    np.testing.assert_allclose(res.train_loss, np.asarray(ref.train_loss), **LOSS_TOL)
    np.testing.assert_allclose(res.val_loss, np.asarray(ref.val_loss), **LOSS_TOL)
    inner = ref.params["StackedMLP_0"]
    for p, name in zip(params, ("w1", "b1", "w2", "b2")):
        np.testing.assert_allclose(p, np.asarray(inner[name]), **STATE_TOL)
    (rk, pk), (rs, ps) = results["megakernel"], results["step"]
    np.testing.assert_allclose(rk.train_loss, rs.train_loss, **LOSS_TOL)
    np.testing.assert_allclose(rk.val_loss, rs.val_loss, **LOSS_TOL)
    np.testing.assert_array_equal(rk.val_acc, rs.val_acc)
    for a, b_ in zip(pk, ps):
        np.testing.assert_allclose(a, b_, **STATE_TOL)


def test_the_step_loop_takes_full_steps_only_with_drop_last(monkeypatch):
    """The epoch kernel's inputs: 4 steps of 16 rows per epoch at n = 70,
    all rows real (no padded, masked tail step)."""
    from disentagled_multimodal_fusion_tpu_torch.core import megakernel as tmk

    seen = []
    real = tmk.run_epoch_kernel

    def spy(xs, drops, ys, rmasks, *args, **kw):
        seen.append((tuple(xs.shape), float(rmasks.sum()), tuple(args[0].flatten().tolist())))
        return real(xs, drops, ys, rmasks, *args, **kw)

    monkeypatch.setattr(tmk, "run_epoch_kernel", spy)
    task = ttasks.build_probe_task(device="cpu", **_probe_case())
    rng = np.random.default_rng(0)
    data = {"zc": torch.randn(70, 8), "zp": torch.randn(70, 2, 5),
            "y": torch.from_numpy(rng.integers(0, 3, 70))}
    train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=70,
          optimizer=task.optimizer, epochs=2, batch_size=16, randomness=Randomness(0, "cpu"),
          drop_last=True, megakernel=task.megakernel)
    assert [s[:2] for s in seen] == [((4, 3, 16, 8), 64.0)] * 2
    # Adam's bias corrections count 4 steps per epoch: 1-4, then 5-8
    np.testing.assert_allclose(seen[1][2], [1 - 0.9 ** k for k in range(5, 9)], rtol=1e-6)


# ------------------------------------------------------- the runner
ENGINES = {
    "dmvae": ["--seeds", "0"],
    "dssl": ["--seeds", "0", "--backbone", "dssl"],
    "unfused": ["--seeds", "0", "--no-fused-dmvae"],
    "vmap": ["--seeds", "0", "1", "--vmap-seeds"],
}


@pytest.fixture(scope="module")
def narrow_widths():
    """The runners' synthetic config at narrow hidden widths (the embedding
    stays 16 wide, the probes' input width): the quick sweep's shapes
    otherwise."""
    from disentagled_multimodal_fusion_tpu_torch.runners import common

    real = common.make_getter

    def narrow(cfg):
        if "dmvae_fusion" in cfg:  # the synthetic config, a private copy
            cfg["dmvae"]["hidden_dim"] = 32
            cfg["dmvae_fusion"]["hidden_dim"] = cfg["latefusion"]["hidden_dim"] = [8]
        return real(cfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "make_getter", narrow)
        yield


@pytest.fixture(scope="module", params=sorted(ENGINES))
def sweep(request, tmp_path_factory, narrow_widths):
    root = tmp_path_factory.mktemp(f"synthetic_{request.param}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMF_ARTIFACT_ROOT", str(root))
        rows = trs.main(["--quick", "--deps", "50", "--device", "cpu", *ENGINES[request.param]])
    return request.param, rows, root


def test_the_sweep_has_the_jax_models_columns_and_artifact_names(sweep):
    engine, rows, root = sweep
    seeds = [0, 1] if engine == "vmap" else [0]
    assert sorted(rows) == seeds
    for s in seeds:
        assert list(rows[s]) == [50]
        assert sorted(rows[s][50]) == ["avg", "cml", "dmvae_cml"]
        backbone = "dssl" if engine == "dssl" else "dmvae"
        names = [f"{backbone}_seed{s}_dep50", f"dmvae_fusion_seed{s}_dep50",
                 f"late_fusion_seed{s}_dep50_aggcml", f"late_fusion_seed{s}_dep50_aggavg"]
        for name in names:
            assert (root / "checkpoints" / f"{name}.pt").is_file(), name
        state = torch.load(root / "checkpoints" / f"{names[0]}.pt", weights_only=True)
        if engine in ("dmvae", "unfused", "vmap"):  # the per-modality DMVAE's MLPs, or stacked
            assert ("encoders.0.layers.0.weight" in state) == (engine == "unfused"), engine
        for name in names[1:]:
            assert (root / "logs" / name / "metrics.csv").is_file(), name
    columns, _ = tanalysis.build_metrics_rows(rows)
    assert columns == list(janalysis.build_metrics_dataframe(rows).columns)
    header = (root / "logs" / "synthetic_dataset_all_results.csv").read_text().splitlines()[0]
    assert header.split(",") == columns
    grouped = (root / "logs" / "synthetic_dataset_main_grouped.csv").read_text().splitlines()
    assert grouped[0].startswith("dep,model,seed,")
    assert [r.split(",")[:2] for r in grouped[1:]] == [["50.0", m] for m in ("avg", "cml",
                                                                            "dmvae_cml")]


@pytest.mark.parametrize("model", ["dmvae_cml", "cml_fusion", "avg_fusion"])
def test_evaluate_reproduces_the_sweeps_row(sweep, model, monkeypatch):
    engine, rows, root = sweep
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(root))
    label = "dmvae_cml" if model == "dmvae_cml" else model.split("_")[0]
    if engine == "dssl" and model == "dmvae_cml":
        # the JAX branch has no DSSL case: it rebuilds a DMVAE backbone
        with pytest.raises(FileNotFoundError, match="dmvae_seed0_dep50"):
            tevaluate.main(["--model", model, "--dataset", "synthetic", "--seed", "0", "--dep",
                            "50", "--quick", "--device", "cpu"])
        return
    for s in rows:
        info = tevaluate.main(["--model", model, "--dataset", "synthetic", "--seed", str(s),
                               "--dep", "50", "--quick", "--device", "cpu",
                               *(["--no-fused-dmvae"] if engine == "unfused" else [])])
        want = rows[s][50][label]
        for block in ("fused", "shared"):
            if block in want:
                assert info[block]["accuracy"] == want[block]["accuracy"], (s, block)
                np.testing.assert_allclose(info[block]["evidence_mean"],
                                           want[block]["evidence_mean"], rtol=1e-6)


@pytest.mark.parametrize("flags,message", [
    (["--vmap-seeds", "--probe-engine", "megakernel"], "sequential path only"),
    (["--vmap-seeds", "--backbone", "dssl"], "DMVAE backbone only"),
    (["--dtype", "bfloat16", "--model-parallel", "2"],
     "--nproc-per-node 2 -m <runner> --data-parallel 1 --model-parallel 2"),
    (["--data-parallel", "2", "--model-parallel", "2"],
     "--nproc-per-node 4 -m <runner> --data-parallel 2 --model-parallel 2"),
])
def test_run_synthetic_refuses(flags, message, capsys, monkeypatch):
    """The seed-batched engine's refusals; --model-parallel (with --dtype
    bfloat16 and --data-parallel too) parses, and without a process group
    of its data x model ranks the runner exits naming that launch."""
    from disentagled_multimodal_fusion_tpu_torch.parallel.distributed import CLUSTER_ENV

    for var in CLUSTER_ENV:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as exit_info:
        trs.main([*flags, "--device", "cpu"])
    assert message in capsys.readouterr().err + str(exit_info.value)


def test_evaluate_synthetic_refuses_the_models_the_sweep_does_not_train():
    with pytest.raises(SystemExit, match="trains only"):
        tevaluate.main(["--model", "dmvae_dis", "--dataset", "synthetic", "--device", "cpu"])

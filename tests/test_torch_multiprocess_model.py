"""The mesh's ``model`` axis of the port in real multi-process runs on the CPU.

Two gloo clusters, of 2 ranks (mesh 1 x 2) and of 4 (2 x 2), each rank this
file run as a script (``python tests/test_torch_multiprocess_model.py
OUT_DIR``) with torch's launcher environment, as
``tests/test_torch_multiprocess.py`` starts its data-axis clusters. Every
rank runs, on ``make_mesh(model_parallel=2)``:

* legs A-F of ``tests/test_torch_multiprocess.py`` with each single fit
  cutting its hidden width (``train(tp_hidden_dim=)``: the DMVAEs' and
  DisentangledSSL's 16, the probe's 8, and in leg E the late-fusion heads'
  32, which is also the audio encoder's first convolution's channel count,
  so that convolution and its BatchNorm are gathered whole where they are
  used); ``train_many``, ``run_cell`` and serving split their seeds and rows
  over ``data`` alone;
* the first step of nine fits (``core.train.step_gradients``): both
  DMVAEs with dropout, the probe and its unfused twin (one module per
  head, ``fused_heads=False``), leg E's late fusion with its encoders at
  32 and at 128 (where the audio encoder's 128 -> 6 Dense is a row layer
  whose whole input carries a gradient), an IntermediateFusion over
  ``concat_linear``, whose Dense (a fusion op's, gathered whole) and head
  (fused width = hidden width) are both cut, and the FusedDMVAE and the
  probe with ``dtype="bfloat16"`` (the row layers' partial products summed
  in float32 and rounded once);
* leg A in bf16 (``leg_bf16``): the bf16 FusedDMVAE and probe fits with
  the cut, the probe's validation and evaluation running the bf16 head
  kernel's operator on the gathered weights;
* a FusedDMVAE fit whose draws replay the JAX package's
  ``train(mesh=make_mesh(2 | 4, model_parallel=2), tp_hidden_dim=16)``;
* what a rank holds through a fit with the cut (``leg_memory``), read at
  its last step from inside it (``core.train.live_fit``): the FusedDMVAE
  cutting its 16, the unfused probe its 8 and leg E's late fusion its 32
  (a convolution and its BatchNorm gathered on use). Every parameter of
  the model that the plan cuts holds no storage, the fit trains tensors of
  exactly the plan's block shapes, and the distinct storages of the
  model's parameters, the fit's and their Adam moments hold exactly three
  times the plan's blocks in float32; after the fit, and after a fit whose
  loss raises at its second step on every rank, the model's parameters are
  whole again.

The launcher runs the legs and the first steps in process without a mesh
and holds every rank to them: the legs at ``tests/test_torch_multiprocess.py``'s
tolerances (its ``_close``), the gradients and the first step's loss
elementwise at rtol 1e-4 / atol 1e-5 (the bf16 ones, and the bf16 fits'
losses and evidence, at ``tests/test_torch_bf16.py``'s bound; the bf16
fits' accuracies within one of 20 rows and weights within 1e-2 of their
norm), the JAX fit at
``tests/test_parallel.py``'s tolerances for its model-axis DMVAE fit
(parameters rtol 2e-3 / atol 2e-5, losses rtol 1e-3 / atol 1e-6). The
ranks of a cluster hold the same results bit for bit.

A third cluster runs ``runners/run_synthetic.py --quick --model-parallel 2
--device cpu`` as two ranks, held to one process's rows within
``chip_smoke.py`` phase 27 (b)'s limits, and ``runners/evaluate.py``
restores rank 0's probe checkpoint and reproduces the run's fused accuracy.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_multiprocess import (
    BATCH,
    ENCODERS,
    EPOCHS,
    N,
    _close,
    _collect,
    _free_port,
    _history,
    _labels,
    _params,
    _views,
    run_legs,
)

from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.train import (OptimizerConfig, Randomness,
                                                                step_gradients, train)
from disentagled_multimodal_fusion_tpu_torch.eval.analysis import (
    evaluate_subjective_model_with_shared,
)
from disentagled_multimodal_fusion_tpu_torch.parallel import distributed as pdist

REPO_ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 240
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# tests/test_parallel.py's tolerances for the JAX model-axis DMVAE fit
JAX_PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
JAX_LOSS_TOL = dict(rtol=1e-3, atol=1e-6)
JAX_DIMS, JAX_HIDDEN, JAX_N, JAX_EPOCHS = (12, 10, 7), 16, 40, 3
# chip_smoke.py phase 27 (b)'s limits: late fusions within one row of 400,
# the backbone's printed last loss within 1e-4 and its weights within 1e-3
# of their norm, the probe within 0.03
LATE_GAP, LOSS_GAP, BACKBONE_NORM_TOL, PROBE_GAP = 1 / 400, 1e-4, 1e-3, 0.03
# the bf16 fits (leg A): accuracies within one of the 20 validation rows,
# weights within 1e-2 of each tensor's norm (phase 27's limit for the probe:
# Adam turns a gradient's rounding into lr-sized steps where it is near 0)
BF16_ACC_GAP, BF16_NORM_TOL = 1 / 20, 1e-2
RUNNER = ["--quick", "--seeds", "0", "--deps", "50", "--device", "cpu"]


# ------------------------------------------------------------------ the legs
def _first_steps():
    """(name, model, objective, data, hidden width cut) of the six fits
    whose first step is held elementwise."""
    xs = _views(N, (12, 8), 0)
    y = _labels(N, 1)
    fits = []
    for fused in (True, False):
        bb = ttasks.build_dmvae_task(output_dim=(12, 8), hidden_dim=16, embed_dim=4,
                                     dropout=0.2, fused_modalities=fused, seed=0, device="cpu")
        loss_fn, _ = ttasks.dmvae_objective(bb, lr=1e-3, num_epochs=3)
        fits.append(("dmvae" if fused else "dmvae_unfused", bb, loss_fn, {"xs": xs}, 16))
    zc, zp = torch.randn(N, 4, generator=torch.Generator().manual_seed(2)), \
        torch.randn(N, 2, 4, generator=torch.Generator().manual_seed(3))
    for name, fused_heads in (("probe", True), ("probe_unfused", False)):
        probe = ttasks.build_probe_task(num_modalities=2, num_classes=3, input_dim=4,
                                        hidden_dim=(8,), dropout=0.3, annealing_start=2, seed=2,
                                        fused_heads=fused_heads, device="cpu")
        fits.append((name, probe.model, probe.loss_fn, {"zc": zc, "zp": zp, "y": y}, 8))
    rng = np.random.default_rng(12)
    enc_xs = (torch.from_numpy(rng.standard_normal((N, 8, 5)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((N, 10)).astype(np.float32)))
    late = ttasks.build_late_fusion_task(output_dims=(6, 6), num_classes=3, hidden_dim=(32,),
                                         dropout=0.3, annealing_start=2,
                                         feature_encoders=ENCODERS, seed=11, device="cpu")
    fits.append(("late_bn", late.model, late.loss_fn, {"xs": enc_xs, "y": y}, 32))
    # at 128 the cut reaches the audio encoder's last convolution and its
    # 128 -> 6 Dense, a row layer whose whole input carries a gradient
    late = ttasks.build_late_fusion_task(output_dims=(6, 6), num_classes=3, hidden_dim=(128,),
                                         dropout=0.3, annealing_start=2,
                                         feature_encoders=ENCODERS, seed=12, device="cpu")
    fits.append(("late_bn128", late.model, late.loss_fn, {"xs": enc_xs, "y": y}, 128))
    inter = ttasks.build_intermediate_fusion_task(
        output_dims=(12, 8), num_classes=3, hidden_dim=8, dropout=0.3, annealing_start=2,
        fusion="concat_linear", fusion_output_dim=8, seed=5, device="cpu")
    fits.append(("inter", inter.model, inter.loss_fn, {"xs": xs, "y": y}, 8))
    # --dtype bfloat16: the row layers' partial products summed in float32
    bb = _bf16_dmvae()
    fits.append(("dmvae_bf16", bb, ttasks.dmvae_objective(bb, lr=1e-3, num_epochs=3)[0],
                 {"xs": xs}, 16))
    probe = _bf16_probe(2)
    fits.append(("probe_bf16", probe.model, probe.loss_fn, {"zc": zc, "zp": zp, "y": y}, 8))
    return fits


def _bf16_dmvae():
    return ttasks.build_dmvae_task(output_dim=(12, 8), hidden_dim=16, embed_dim=4, dropout=0.2,
                                   fused_modalities=True, seed=0, device="cpu",
                                   dtype="bfloat16")


def _bf16_probe(seed):
    return ttasks.build_probe_task(num_modalities=2, num_classes=3, input_dim=4,
                                   hidden_dim=(8,), lr=3e-3, dropout=0.3, annealing_start=2,
                                   num_epochs=EPOCHS, seed=seed, device="cpu", dtype="bfloat16")


def leg_bf16(mesh):
    """Leg A in bf16 compute mode: a FusedDMVAE fit cutting its 16 and a
    probe fit cutting its 8, with validation and evaluation (the heads'
    eval forward on the gathered weights through the bf16 head kernel's
    operator, on the CPU its plain version)."""
    xs = _views(N, (12, 8), 0)
    bb = _bf16_dmvae()
    loss_fn, opt = ttasks.dmvae_objective(bb, lr=1e-3, num_epochs=EPOCHS)
    res = train(model=bb, loss_fn=loss_fn, data={"xs": xs}, n_train=N, optimizer=opt,
                epochs=EPOCHS, batch_size=BATCH, randomness=Randomness(1, "cpu"), mesh=mesh,
                tp_hidden_dim=16)
    out = {**_params("bf16.dmvae", bb), "bf16.dmvae.train_loss": res.train_loss}
    zc, zp = ttasks.embed_dataset(bb, xs)
    data = {"zc": zc, "zp": zp, "y": _labels(N, 1)}
    val = {k: v[:20] for k, v in data.items()}
    task = _bf16_probe(3)
    res = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=N,
                optimizer=task.optimizer, epochs=EPOCHS, batch_size=BATCH,
                randomness=Randomness(3, "cpu"), val_fn=task.val_fn, val_data=val, mesh=mesh,
                tp_hidden_dim=8)
    info = evaluate_subjective_model_with_shared(task, val, mesh)
    out.update(_params("bf16.probe", task.model), **_history("bf16.probe", res))
    out["bf16.probe.eval"] = np.array([info["fused"]["accuracy"], info["fused"]["evidence_mean"],
                                       info["shared"]["accuracy"]])
    return out


def _watched(loss_fn, at_call, then):
    """``loss_fn`` (an Objective) whose loss, at its ``at_call``-th call,
    first calls ``then()``."""
    from disentagled_multimodal_fusion_tpu_torch.core.train import Objective

    calls = [0]

    def loss(*args):
        calls[0] += 1
        if calls[0] == at_call:
            then()
        return loss_fn.loss(*args)

    return Objective(None, loss, draw_epoch=loss_fn.draw_epoch, with_step=loss_fn.with_step,
                     rows=loss_fn.rows)


def _whole(model, shapes):
    """1.0 when every parameter of ``model`` has its whole shape and a
    storage of exactly its size."""
    return float(all(tuple(p.shape) == shapes[k]
                     and p.untyped_storage().nbytes() == p.numel() * p.element_size()
                     for k, p in model.named_parameters()))


def leg_memory(mesh):
    """What this rank holds through fits with the cut, by ``mem.`` keys:
    ``released`` (the model's cut parameters holding no storage, the plan's
    cuts), ``blocks`` (1.0 when the fit trains tensors of the plan's block
    shapes), ``bytes`` (the distinct storages of the model's parameters,
    the fit's and their moments; three times the plan's blocks in float32),
    ``after`` and ``raised`` (1.0 when the model is whole after the fit and
    after a fit that raises at its second step)."""
    from disentagled_multimodal_fusion_tpu_torch.core.train import live_fit, resident_bytes
    from disentagled_multimodal_fusion_tpu_torch.parallel.mesh import ShardPlan

    fits = {name: fit for name, *fit in _first_steps()
            if name in ("dmvae", "probe_unfused", "late_bn")}
    out, steps = {}, EPOCHS * -(-N // 16)
    for name, (model, loss_fn, data, tp) in fits.items():
        own = dict(model.named_parameters())
        shapes = {k: tuple(p.shape) for k, p in own.items()}
        plan = ShardPlan(model, list(own), mesh, tp)
        blocks = {k: tuple(plan.block(k, p.detach()).shape) for k, p in own.items()}
        planned = 3 * 4 * sum(int(np.prod(b)) for b in blocks.values())
        reading = {}

        def read(plan=plan, own=own, blocks=blocks, reading=reading):
            fit = live_fit()
            reading["released"] = [sum(own[k].untyped_storage().nbytes() == 0
                                       for k in plan.cuts), len(plan.cuts)]
            reading["blocks"] = [float([tuple(p.shape) for p in fit.params]
                                       == list(blocks.values()))]
            reading["bytes"] = [resident_bytes(), planned]

        def fit(objective):
            train(model=model, loss_fn=objective, data=data, n_train=N,
                  optimizer=OptimizerConfig(name="adam", lr=1e-3), epochs=EPOCHS,
                  batch_size=16, randomness=Randomness(5, "cpu"), mesh=mesh, tp_hidden_dim=tp)

        fit(_watched(loss_fn, steps, read))
        out.update({f"mem.{name}.{k}": np.array(v) for k, v in reading.items()})
        out[f"mem.{name}.after"] = np.array([_whole(model, shapes)])

        def stop():
            raise RuntimeError("stop")

        with pytest.raises(RuntimeError, match="stop"):
            fit(_watched(loss_fn, 2, stop))
        out[f"mem.{name}.raised"] = np.array([_whole(model, shapes)])
    return out


def leg_grads(mesh):
    """Each fit's first-step loss and gradients; on a mesh also how many of
    its parameters the model axis cuts, as (taken as blocks by the
    Megatron layers, gathered on use)."""
    from disentagled_multimodal_fusion_tpu_torch.parallel.mesh import ShardPlan

    out = {}
    for name, model, loss_fn, data, tp in _first_steps():
        if mesh is not None:
            cuts = ShardPlan(model, [k for k, _ in model.named_parameters()], mesh, tp).cuts
            taken = sum(c.takes_block for c in cuts.values())
            out[f"cuts.{name}"] = np.array([taken, len(cuts) - taken])
        loss, grads = step_gradients(model=model, loss_fn=loss_fn, data=data, n_train=N,
                                     batch_size=16, randomness=Randomness(7, "cpu"), mesh=mesh,
                                     tp_hidden_dim=tp)
        out[f"grad.{name}.loss"] = loss.numpy()
        out.update({f"grad.{name}.{k}": g.numpy() for k, g in grads.items()})
    return out


class Replay:
    """A Randomness that hands out recorded JAX permutations and normals."""

    def __init__(self, perms, normals):
        self.perms, self.normals = list(perms), list(normals)

    def permutation(self, n):
        return torch.from_numpy(self.perms.pop(0).astype(np.int64))

    def normal(self, shape):
        z = self.normals.pop(0)
        assert z.shape == tuple(shape)
        return torch.from_numpy(np.array(z))

    def state(self):
        return None


def jax_leg(mesh, inputs):
    """The port's FusedDMVAE fit on the replayed JAX draws."""
    model = ttasks.build_dmvae_task(output_dim=JAX_DIMS, hidden_dim=JAX_HIDDEN, embed_dim=4,
                                    a=0.3, fused_modalities=True, device="cpu")
    model.load_state_dict(inputs["init"])
    loss_fn, opt = ttasks.dmvae_objective(model, lr=1e-3, num_epochs=JAX_EPOCHS)
    res = train(model=model, loss_fn=loss_fn,
                data={"xs": tuple(torch.from_numpy(x) for x in inputs["xs"])}, n_train=JAX_N,
                optimizer=opt, epochs=JAX_EPOCHS, batch_size=16,
                randomness=Replay(inputs["perms"], inputs["normals"]), mesh=mesh,
                tp_hidden_dim=JAX_HIDDEN)
    return {"jax.train_loss": res.train_loss,
            **{f"jax.{k}": v.detach().numpy().copy() for k, v in model.named_parameters()}}


# ------------------------------------------------------------------ the worker
def _worker(out_dir: Path) -> None:
    from disentagled_multimodal_fusion_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    assert pdist.initialize(backend="gloo", device="cpu", timeout=RANK_TIMEOUT_S)
    mesh = make_mesh(model_parallel=2)
    assert (mesh.data_index, mesh.model_index) == divmod(pdist.rank(), 2)
    out = {**run_legs(mesh, mesh.shape["data"], cut=True), **leg_grads(mesh), **leg_bf16(mesh),
           **leg_memory(mesh)}
    out.update(jax_leg(mesh, torch.load(out_dir / "jax_inputs.pt", weights_only=False)))
    np.savez(out_dir / f"rank{pdist.rank()}.npz", **out)


# ------------------------------------------------------------------ the launcher
def _spawn(argv, nproc: int, out_dir: Path):
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(nproc), PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1",
               DMF_ARTIFACT_ROOT=str(out_dir))
    procs = [subprocess.Popen(argv, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              cwd=str(out_dir), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(nproc)]
    return procs, out_dir


def _jax_reference(out_dirs):
    """The JAX package's model-axis FusedDMVAE fit (one init, one key):
    writes the inputs that replay it in the port (init, views, draws) to
    each of ``out_dirs`` and returns ``fit(n)``, which runs it on
    ``make_mesh(n, model_parallel=2)`` -> (params by port name, train
    loss)."""
    import jax
    import jax.numpy as jnp
    from test_torch_train_many import FOLD, _normals_of, jax_draws

    from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
    from disentagled_multimodal_fusion_tpu.core.train import train as jax_train
    from disentagled_multimodal_fusion_tpu.parallel.mesh import make_mesh as jax_mesh
    from disentagled_multimodal_fusion_tpu_torch.convert import flax_to_state_dict

    rng = np.random.default_rng(30)
    xs = [rng.random((JAX_N, d), dtype=np.float32) for d in JAX_DIMS]
    _, params, loss_fn, opt, bstats = jtasks.build_dmvae_task(
        rng=jax.random.PRNGKey(31), xs_sample=[jnp.asarray(x) for x in xs],
        output_dim=JAX_DIMS, hidden_dim=JAX_HIDDEN, embed_dim=4, a=0.3, lr=1e-3,
        num_epochs=JAX_EPOCHS, fused_modalities=True)
    key = jax.random.PRNGKey(32)
    perms, _, normals = jax_draws(jax.random.fold_in(key, FOLD), JAX_EPOCHS, JAX_N, 16,
                                  normals_of=_normals_of(loss_fn, params, JAX_DIMS))
    inputs = {"init": flax_to_state_dict(jax.device_get(params)), "xs": xs, "perms": perms,
              "normals": normals}
    for out_dir in out_dirs:
        torch.save(inputs, out_dir / "jax_inputs.pt")

    def fit(n):
        res = jax_train(rng=key, params=params, loss_fn=loss_fn,
                        data={"xs": tuple(jnp.asarray(x) for x in xs)}, n_train=JAX_N,
                        optimizer=opt, epochs=JAX_EPOCHS, batch_size=16, model_state=bstats,
                        mesh=jax_mesh(n, model_parallel=2), tp_hidden_dim=JAX_HIDDEN,
                        donate=False)
        trained = flax_to_state_dict(jax.device_get(res.params))
        return {k: v.numpy() for k, v in trained.items()}, np.asarray(res.train_loss)

    return fit


def _runner_rows(root: Path):
    from disentagled_multimodal_fusion_tpu_torch.core.checkpoint import checkpoint_file
    from disentagled_multimodal_fusion_tpu_torch.runners.run_synthetic import checkpoint_name

    rows = json.loads((root / "rows.json").read_text())
    backbone = torch.load(checkpoint_file(str(root / "checkpoints" / checkpoint_name(
        "backbone", 0, 50))), map_location="cpu", weights_only=True)
    return rows, backbone


def _world_one_legs():
    """Legs A-F with the cut's widths in this process without a mesh, for
    the clusters of 2 (one data index) and 4 (two) ranks: legs B and C are
    sized by the data axis, the rest are run once."""
    from test_torch_multiprocess import (leg_batchnorm, leg_corpus, leg_dssl, leg_many,
                                         leg_serve, leg_train)

    common = {**leg_train(None, cut=True), **leg_corpus(None),
              **leg_batchnorm(None, cut=True), **leg_dssl(None, cut=True)}
    return {n: {**common, **leg_many(None, n), **leg_serve(None, n // 2)} for n in (2, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({2: rank outputs, 4: rank outputs}, the references: the JAX fits,
    the legs and first steps without a mesh; the runner cluster's and one
    process's directories). Every cluster and the one-process runner run
    while this process computes the references."""
    dirs = {n: tmp_path_factory.mktemp(f"model{n}") for n in (2, 4)}
    runner_dir, one_dir = tmp_path_factory.mktemp("runner2"), tmp_path_factory.mktemp("runner1")
    script = str(REPO_ROOT / "tests" / Path(__file__).name)
    clusters, started = {}, []
    try:
        fit = _jax_reference(dirs.values())
        for n, out_dir in dirs.items():
            clusters[n] = _spawn([sys.executable, script, str(out_dir)], n, out_dir)
            started += clusters[n][0]
        runner = _spawn([sys.executable, script, "--runner", str(runner_dir)], 2, runner_dir)
        started += runner[0]
        env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1",
                   DMF_ARTIFACT_ROOT=str(one_dir))
        for var in pdist.CLUSTER_ENV:
            env.pop(var, None)
        one = subprocess.Popen([sys.executable, script, "--runner", str(one_dir)], env=env,
                               cwd=str(one_dir), stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        started.append(one)
        torch.set_num_threads(1)
        reference = {"jax": {n: fit(n) for n in dirs}, "legs": _world_one_legs(),
                     "grads": leg_grads(None), "bf16": leg_bf16(None)}
        one_log = one.communicate(timeout=RANK_TIMEOUT_S)[0]
        assert one.returncode == 0, one_log[-3000:]
        ranks = {n: _collect(cluster) for n, cluster in clusters.items()}
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in runner[0]]
        assert all(p.returncode == 0 for p in runner[0]), "\n".join(x[-3000:] for x in logs)
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ranks, reference, (runner_dir, logs[0]), (one_dir, one_log)


@pytest.mark.parametrize("nproc", [2, 4])
def test_cluster_matches_the_world_one_run(runs, nproc):
    ranks = runs[0][nproc]
    for key, value in ranks[0].items():
        for r in ranks[1:]:  # every rank holds the same results, bit for bit
            np.testing.assert_array_equal(r[key], value, err_msg=key)
    np.testing.assert_array_equal(ranks[0]["corpus.guard"], [1.0])
    ref = runs[1]["legs"][nproc]
    assert set(ref) == {k for k in ranks[0]
                        if not k.startswith(("grad.", "cuts.", "jax.", "bf16.", "mem."))}
    for key, value in ref.items():
        if key != "corpus.guard":
            _close(key, ranks[0][key], value)


@pytest.mark.parametrize("nproc", [2, 4])
def test_first_step_gradients_match_one_process(runs, nproc):
    """Every parameter's gradient of the first step, gathered whole,
    elementwise: a missing sum over the model group shows here."""
    from test_torch_bf16 import assert_bf16_close

    port = runs[0][nproc][0]
    for name in ("dmvae", "dmvae_unfused", "probe", "probe_unfused", "late_bn", "late_bn128",
                 "inter", "dmvae_bf16", "probe_bf16"):
        taken, gathered = port[f"cuts.{name}"]
        assert taken > 0 and (gathered > 0) == name.startswith(("late_bn", "inter")), name
    ref = runs[1]["grads"]
    assert set(ref) == {k for k in port if k.startswith("grad.")}
    for key, want in ref.items():
        if "_bf16." in key:  # tests/test_torch_bf16.py's bound
            assert_bf16_close(port[key], want, key)
        else:
            np.testing.assert_allclose(port[key], want, err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("nproc", [2, 4])
def test_ranks_hold_only_their_blocks(runs, nproc):
    """On every rank, through a fit with the cut: the model's cut
    parameters hold no storage and the fit's parameters and moments hold
    exactly the plan's blocks; after the fit, and after one that raised,
    the model is whole."""
    for r, rank in enumerate(runs[0][nproc]):
        for name in ("dmvae", "probe_unfused", "late_bn"):
            released, cuts = rank[f"mem.{name}.released"]
            have, planned = rank[f"mem.{name}.bytes"]
            assert cuts > 0 and released == cuts, (r, name, released, cuts)
            assert have == planned, (r, name, have, planned)
            for key in ("blocks", "after", "raised"):
                assert rank[f"mem.{name}.{key}"][0] == 1.0, (r, name, key)


@pytest.mark.parametrize("nproc", [2, 4])
def test_bf16_fits_match_one_process(runs, nproc):
    """Leg A in bf16 with the cut against one bf16 process: the losses and
    the evidence at ``tests/test_torch_bf16.py``'s bound, the accuracies
    within one of the 20 validation rows, the weights within
    ``BF16_NORM_TOL`` of each tensor's norm."""
    from test_torch_bf16 import assert_bf16_close

    port = runs[0][nproc][0]
    ref = runs[1]["bf16"]
    assert set(ref) == {k for k in port if k.startswith("bf16.")}
    for key, want in ref.items():
        have = port[key]
        if key.endswith(("train_loss", "val_loss")):
            assert_bf16_close(have, want, key)
        elif key.endswith("val_acc"):
            np.testing.assert_allclose(have, want, err_msg=key, atol=BF16_ACC_GAP + 1e-6)
        elif key.endswith(".eval"):  # fused accuracy, evidence mean, shared accuracy
            np.testing.assert_allclose(have[[0, 2]], want[[0, 2]], err_msg=key,
                                       atol=BF16_ACC_GAP + 1e-6)
            assert_bf16_close(have[1:2], want[1:2], key)
        else:
            gap = float(np.linalg.norm(have - want) / max(np.linalg.norm(want), 1e-30))
            assert gap <= BF16_NORM_TOL, (key, gap)


@pytest.mark.parametrize("nproc", [2, 4])
def test_model_axis_fit_matches_the_jax_package(runs, nproc):
    port = runs[0][nproc][0]
    params, loss = runs[1]["jax"][nproc]
    for k, want in params.items():
        np.testing.assert_allclose(port[f"jax.{k}"], want, err_msg=k, **JAX_PARAM_TOL)
    np.testing.assert_allclose(port["jax.train_loss"], loss, **JAX_LOSS_TOL)


def test_run_synthetic_model_parallel_matches_one_process(runs):
    (root, log), (one_root, one_log) = runs[2], runs[3]
    assert "mesh: {'data': 1, 'model': 2} over 2 rank(s) (gloo)" in log
    rows, backbone = _runner_rows(root)
    one_rows, one_backbone = _runner_rows(one_root)
    got, want = rows["0"]["50"], one_rows["0"]["50"]
    assert set(got) == set(want) == {"dmvae_cml", "cml", "avg"}
    for name in ("cml", "avg"):
        gap = got[name]["fused"]["accuracy"] - want[name]["fused"]["accuracy"]
        assert abs(gap) <= LATE_GAP + 1e-9, (name, gap)
    gap = got["dmvae_cml"]["fused"]["accuracy"] - want["dmvae_cml"]["fused"]["accuracy"]
    assert abs(gap) <= PROBE_GAP + 1e-9, gap
    assert abs(got["dmvae_cml"]["backbone_loss"] - want["dmvae_cml"]["backbone_loss"]) \
        <= LOSS_GAP
    assert set(backbone) == set(one_backbone)
    for k, v in one_backbone.items():  # rank 0's checkpoint: the one-process names and shapes
        assert backbone[k].shape == v.shape, k
        gap = float((backbone[k] - v).double().norm() / v.double().norm().clamp_min(1e-30))
        assert gap <= BACKBONE_NORM_TOL, (k, gap)


def test_evaluate_restores_the_model_parallel_checkpoint(runs, monkeypatch):
    """runners/evaluate.py restores the probe checkpoint rank 0 wrote and
    reproduces the run's fused accuracy."""
    from disentagled_multimodal_fusion_tpu_torch.runners import evaluate

    root = runs[2][0]
    rows, _ = _runner_rows(root)
    monkeypatch.setenv("DMF_ARTIFACT_ROOT", str(root))
    info = evaluate.main(["--model", "dmvae_cml", "--dataset", "synthetic", "--seed", "0",
                          "--dep", "50", "--quick", "--device", "cpu"])
    np.testing.assert_allclose(info["fused"]["accuracy"],
                               rows["0"]["50"]["dmvae_cml"]["fused"]["accuracy"], atol=1e-6)


def _runner(out_dir: Path) -> None:
    """``run_synthetic.py --quick`` in ``out_dir``: as a rank of a 1 x 2
    mesh under a launcher's environment, else as one process; the rows (and
    the backbone's last train loss, which the rows do not carry) to
    ``rows.json``."""
    import contextlib
    import io
    import re

    from disentagled_multimodal_fusion_tpu_torch.runners import run_synthetic

    torch.set_num_threads(1)
    argv = RUNNER + (["--model-parallel", "2"] if pdist.cluster_env() else [])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rows = run_synthetic.main(argv)
    print(text.getvalue())
    loss = float(re.search(r"dmvae fit[^\n]*last train loss ([0-9.]+)", text.getvalue()).group(1))
    if pdist.is_writer():
        rows[0][50]["dmvae_cml"]["backbone_loss"] = loss
        (out_dir / "rows.json").write_text(json.dumps(rows, default=float))


if __name__ == "__main__":
    if sys.argv[1] == "--runner":
        _runner(Path(sys.argv[2]))
    else:
        _worker(Path(sys.argv[1]))

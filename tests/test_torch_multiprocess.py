"""The mesh's ``data`` axis of the port in real multi-process runs on the CPU.

The tests spawn gloo clusters of 2 and 3 ranks, each rank this file run as
a script (``python tests/test_torch_multiprocess.py OUT_DIR``) with torch's
launcher environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), so ``parallel.distributed.initialize()``
joins the group the way ``torchrun`` makes it do. Every rank runs the same
legs on the mesh over all ranks:

  A. ``train(mesh=)``: a FusedDMVAE fit with dropout (its decoder masks
     hold the rows on their second axis), the per-modality DMVAE's (rows in
     N blocks), and a probe fit with validation and its evaluation split
     over the ranks; 34 rows in batches of 16 leave a tail of 2 rows, which
     gives one rank of three no rows;
  B. ``train_many(mesh=)`` over 2 x n_dp seeds and ``run_cell(mesh=)``;
  C. row-split serving through ``ServingEngine(divisor=n_dp)``;
  D. host-local corpus feeding (each rank loads only ``process_rows``) and
     ``place_global``'s guard;
  E. a late-fusion fit over feature encoders with BatchNorm (the moments of
     the global batch), with the same ragged tail;
  F. a DisentangledSSL fit (SupCon's negatives and the orthogonality
     penalty of the global batch).

Each rank runs with its own ``PYTHONHASHSEED``, and also reads a small
LUMA corpus through ``runners/run_luma.py::luma_features`` with the hashed
text ids (no BERT vocabulary): every rank must hold rank 0's features, bit
for bit, though its own featurization differs.

The launcher runs the same legs in process without a mesh (world size 1)
and holds each rank to that run at the tolerances of ``train_many`` against
``train``: losses rtol 2e-5 / atol 2e-6, parameters rtol 5e-3 / atol 5e-5
(the ranks' partial sums add the rows' gradients in another order, and
Adam's normalisation carries that into the last float32 digits of small
steps; SupCon and BatchNorm also sum their moments and negatives in
blocks); validation accuracies to 1e-6 (sums of the ranks' weighted
means) and predictions equal. A convolution's bias
that feeds a BatchNorm is held in shape only: its gradient is rounding
noise (the batch mean takes the bias out), which Adam scales up to steps of
the learning rate; its drift reaches the running means and the
validation, so those are held on the same fit at lr 0. The ranks' results
are equal bit for bit: each applies the same summed gradient.

The two-rank cluster also runs two legs held against the JAX package's own
mesh runs (``tests/test_parallel.py``): a probe fit through JAX
``train(mesh=make_mesh(2))`` with its draws replayed into the port's
two-rank fit, at that file's tolerances for its mesh fit (parameters rtol
1e-4 / atol 1e-5, losses rtol 1e-4 / atol 1e-6), and JAX
``build_inference_fn(mesh=)`` of late fusion with ``ServingEngine(divisor=2)``
against the port's two-rank serving of the same weights (``convert.py``), at
``tests/test_torch_serve.py``'s tolerances (evidence and probs rtol 1e-4 /
atol 1e-5, epistemic and aleatoric rtol 1e-4 / atol 1e-6, ``pred`` equal).

Every subprocess and rendezvous has a timeout, so a lost rank fails the test
and does not hang it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from disentagled_multimodal_fusion_tpu_torch.core import tasks as ttasks
from disentagled_multimodal_fusion_tpu_torch.core.serve import ServingEngine, build_inference_fn
from disentagled_multimodal_fusion_tpu_torch.core.sweep_cell import CellJob, run_cell
from disentagled_multimodal_fusion_tpu_torch.core.train import (
    Randomness,
    stack_params,
    train,
    train_many,
)
from disentagled_multimodal_fusion_tpu_torch.eval.analysis import (
    evaluate_subjective_model_with_shared,
    fetch,
)
from disentagled_multimodal_fusion_tpu_torch.parallel import distributed as pdist

REPO_ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 240
DIMS = (12, 8)
N, BATCH, EPOCHS, C = 34, 16, 3, 3
# the tolerances of train_many against train (tests/test_torch_train_many.py,
# chip_smoke.py phase 12): batched and split sums round apart
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
# tests/test_parallel.py's tolerances for the JAX mesh fit against one device
JAX_PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
# tests/test_torch_serve.py's tolerances for the port's serving against JAX's
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
UNC_TOL = dict(rtol=1e-4, atol=1e-6)


def _views(n, dims, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)) for d in dims)


def _labels(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, C, n))


def _params(prefix, model):
    return {f"{prefix}.{k}": v.detach().numpy().copy() for k, v in model.named_parameters()}


def _history(prefix, res):
    return {f"{prefix}.train_loss": np.asarray(res.train_loss),
            f"{prefix}.val_loss": np.asarray(res.val_loss),
            f"{prefix}.val_acc": np.asarray(res.val_acc)}


def _probe(seed, dropout=0.3, input_dim=4):
    return ttasks.build_probe_task(num_modalities=2, num_classes=C, input_dim=input_dim,
                                   hidden_dim=(8,), lr=3e-3, dropout=dropout, annealing_start=2,
                                   aggregation="cml", num_epochs=EPOCHS, seed=seed, device="cpu")


# ------------------------------------------------------------------ the legs
# ``cut``: on a mesh with a model axis, each fit cuts its hidden width
# (tests/test_torch_multiprocess_model.py); the fits are the same without it
def _tp(cut, width):
    return width if cut else None


def leg_train(mesh, cut=False):
    out = {}
    xs = _views(N, DIMS, 0)
    for fused in (True, False):
        bb = ttasks.build_dmvae_task(output_dim=DIMS, hidden_dim=16, embed_dim=4, dropout=0.2,
                                     fused_modalities=fused, seed=0, device="cpu")
        loss_fn, opt = ttasks.dmvae_objective(bb, lr=1e-3, num_epochs=EPOCHS)
        res = train(model=bb, loss_fn=loss_fn, data={"xs": xs}, n_train=N, optimizer=opt,
                    epochs=EPOCHS if fused else 1, batch_size=BATCH,
                    randomness=Randomness(1, "cpu"), mesh=mesh, tp_hidden_dim=_tp(cut, 16))
        name = "dmvae" if fused else "dmvae_unfused"
        out.update(_params(name, bb), **{f"{name}.train_loss": res.train_loss})
    zc, zp = ttasks.embed_dataset(bb, xs)
    y = _labels(N, 1)
    data = {"zc": zc, "zp": zp, "y": y}
    val = {k: v[:20] for k, v in data.items()}
    task = _probe(2)
    res = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=N,
                optimizer=task.optimizer, epochs=EPOCHS, batch_size=BATCH,
                randomness=Randomness(3, "cpu"), val_fn=task.val_fn, val_data=val, mesh=mesh,
                tp_hidden_dim=_tp(cut, 8))
    info = evaluate_subjective_model_with_shared(task, val, mesh)
    out.update(_params("probe", task.model), **_history("probe", res))
    out["probe.eval"] = np.array([info["fused"]["accuracy"], info["fused"]["ece"],
                                  info["fused"]["evidence_mean"], info["shared"]["accuracy"]])
    return out


def _seed_data(s_count, n, seed):
    rng = np.random.default_rng(seed)
    return {"zc": torch.from_numpy(rng.standard_normal((s_count, n, 4)).astype(np.float32)),
            "zp": torch.from_numpy(rng.standard_normal((s_count, n, 2, 4)).astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, C, (s_count, n)))}


def leg_many(mesh, s_count):
    out = {}
    tasks = [_probe(10 + s) for s in range(s_count)]
    data = _seed_data(s_count, N, 5)
    val = {k: v[:, :20] for k, v in data.items()}
    res = train_many(model=tasks[0].model, params=stack_params([t.model for t in tasks]),
                     loss_fn=tasks[0].loss_fn, data=data, n_train=N, optimizer=tasks[0].optimizer,
                     epochs=EPOCHS, batch_size=BATCH,
                     randomness=[Randomness(100 + s, "cpu") for s in range(s_count)],
                     val_fn=tasks[0].val_fn, val_data=val, mesh=mesh)
    out.update({f"many.{k}": v.numpy() for k, v in res.params.items()})
    out.update({"many.train_loss": res.train_loss.numpy(), "many.val_acc": res.val_acc.numpy(),
                "many.final_lr": res.final_lr.numpy()})

    xs = tuple(torch.stack([x] * s_count) for x in _views(N, DIMS, 6))
    y = torch.stack([_labels(N, 7)] * s_count)
    bbs = [ttasks.build_dmvae_task(output_dim=DIMS, hidden_dim=16, embed_dim=4,
                                   fused_modalities=True, seed=20 + s, device="cpu")
           for s in range(s_count)]
    loss_fn, opt = ttasks.dmvae_objective(bbs[0], lr=1e-3, num_epochs=2)
    job = CellJob(name="dmvae_cml", tasks=[_probe(30 + s) for s in range(s_count)],
                  randomness=[Randomness(40 + s, "cpu") for s in range(s_count)], kind="probe",
                  epochs=2, shared_layout=True)
    cell = fetch(run_cell(backbone=bbs[0], bb_params=stack_params(bbs), bb_loss_fn=loss_fn,
                          bb_optimizer=opt, bb_epochs=2,
                          bb_randomness=[Randomness(50 + s, "cpu") for s in range(s_count)],
                          jobs=[job], xs_tr=xs, xs_te=tuple(x[:, :20] for x in xs), y_tr=y,
                          y_te=y[:, :20], n_train=N, batch_size=BATCH, mesh=mesh))
    result = cell["jobs"]["dmvae_cml"]
    out["cell.backbone_train_loss"] = cell["backbone_train_loss"]
    out["cell.train_loss"] = result["train_loss"]
    out["cell.fused_acc"] = np.array([m["fused_block"]["accuracy"] for m in result["metrics"]])
    return out


def leg_serve(mesh, n_dp):
    bb = ttasks.build_dmvae_task(output_dim=DIMS, hidden_dim=16, embed_dim=4,
                                 fused_modalities=True, seed=8, device="cpu")
    task = _probe(9)
    engine = ServingEngine(build_inference_fn(task, backbone=bb, mesh=mesh), buckets=(4, 8),
                           divisor=n_dp)
    served = engine(tuple(x.numpy() for x in _views(2 * n_dp + 1, DIMS, 10)))
    return {f"serve.{k}": v for k, v in served.items()}


def leg_corpus(mesh):
    world = pdist.world_size()
    n = 27
    full = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    local = full[pdist.process_rows(n)]  # what a host-local loader reads
    total = pdist.all_reduce(torch.tensor([local.sum(), local.size], dtype=torch.float64))
    guard = 0.0
    if world > 1:
        try:
            pdist.place_global(np.zeros((2 * world + 1, 3), np.float32), ("data",))
        except ValueError as e:
            guard = float("divide evenly" in str(e))
    return {"corpus.mean": np.array([float(total[0] / total[1]), full.mean()]),
            "corpus.guard": np.array([guard])}


ENCODERS = (("AudioEncoder", dict(input_dim=8, output_dim=6, dropout=0.1, use_2d=True)),
            ("TextEncoder", dict(input_dim=10, output_dim=6, dropout=0.1)))


def leg_batchnorm(mesh, cut=False):
    """The fit's parameters and losses; then the same fit at lr 0, whose
    running statistics and validation hold the global moments alone (at a
    learning rate, the drift of the biases before BatchNorm, see _close,
    reaches the running means and the validation). With ``cut`` the heads'
    hidden width is the audio encoder's first convolution's 32 channels, so
    the model axis cuts that convolution and its BatchNorm too."""
    hidden = 32 if cut else 8
    out = {}
    rng = np.random.default_rng(12)
    xs = (torch.from_numpy(rng.standard_normal((N, 8, 5)).astype(np.float32)),
          torch.from_numpy(rng.standard_normal((N, 10)).astype(np.float32)))
    data = {"xs": xs, "y": _labels(N, 13)}
    val = {"xs": tuple(x[:20] for x in xs), "y": data["y"][:20]}
    for name, lr in (("bn", 3e-3), ("bn_lr0", 0.0)):
        task = ttasks.build_late_fusion_task(output_dims=(6, 6), num_classes=C,
                                             hidden_dim=(hidden,), dropout=0.3, lr=lr,
                                             annealing_start=2, aggregation="cml",
                                             feature_encoders=ENCODERS, seed=11, device="cpu")
        res = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=N,
                    optimizer=task.optimizer, epochs=EPOCHS, batch_size=BATCH,
                    randomness=Randomness(14, "cpu"), val_fn=task.val_fn, val_data=val,
                    mesh=mesh, tp_hidden_dim=_tp(cut, hidden))
        out[f"{name}.train_loss"] = res.train_loss
        if lr:
            out.update(_params(name, task.model))
        else:
            out.update(_history(name, res))
            out.update({f"{name}.{k}": v.numpy().copy() for k, v in task.model.named_buffers()})
    return out


def leg_dssl(mesh, cut=False):
    model, loss_fn, opt = ttasks.build_disentangledssl_task(
        output_dim=(6, 5), hidden_dim=16, embed_dim=4, distribution="vmf",
        lmd_start_value=0.5, epochs=2, seed=15, device="cpu")
    xs = _views(40, (6, 5), 16)
    res = train(model=model, loss_fn=loss_fn, data={"xs": xs}, n_train=40, optimizer=opt,
                epochs=2, batch_size=BATCH, randomness=Randomness(17, "cpu"), drop_last=True,
                mesh=mesh, tp_hidden_dim=_tp(cut, 16))
    return {**_params("dssl", model), "dssl.train_loss": res.train_loss}


def leg_luma(corpus):
    """The LUMA arrays as ``run_luma`` reads them under a process group, and
    this rank's own featurization of the text (the ids salted by its
    ``PYTHONHASHSEED``)."""
    from disentagled_multimodal_fusion_tpu_torch.data.luma import get_luma_arrays
    from disentagled_multimodal_fusion_tpu_torch.runners.common import load_config, make_getter
    from disentagled_multimodal_fusion_tpu_torch.runners.run_luma import (
        feature_configs,
        luma_features,
    )

    audio, text, image = feature_configs(make_getter(load_config("luma_config.yaml")))
    text = dict(text, use_pretrained=False)  # the hashed ids, whatever is installed
    xs_tr, y_tr, xs_te, y_te, classes, _, (xs_ood, y_ood) = luma_features(
        corpus, audio, text, image, ood_eval=True)
    out = {"luma.y_tr": y_tr, "luma.y_te": y_te, "luma.y_ood": y_ood,
           "luma.classes": np.array([classes])}
    for split, xs in (("tr", xs_tr), ("te", xs_te), ("ood", xs_ood)):
        out.update({f"luma.{view}_{split}": x for view, x in zip(("audio", "text", "image"), xs)})
    out["luma_own.text_tr"] = get_luma_arrays(corpus, audio, text, image, cache=False)[0][1]
    return out


def run_legs(mesh, n_dp, cut=False):
    """Legs A-F on ``mesh`` (None: one process); ``n_dp`` sizes the
    seed-batched and serving legs alike in both; ``cut`` cuts the single
    fits' hidden widths on the mesh's model axis."""
    return {**leg_train(mesh, cut), **leg_many(mesh, 2 * n_dp), **leg_serve(mesh, n_dp),
            **leg_corpus(mesh), **leg_batchnorm(mesh, cut), **leg_dssl(mesh, cut)}


# ------------------------------------------------------------------ JAX legs
class Replay:
    """A Randomness that hands out recorded JAX permutations and masks."""

    def __init__(self, perms, masks):
        self.perms, self.masks = list(perms), list(masks)

    def permutation(self, n):
        return torch.from_numpy(self.perms.pop(0).astype(np.int64))

    def bernoulli(self, p, shape):
        m = self.masks.pop(0)
        assert m.shape == tuple(shape)
        return torch.from_numpy(np.array(m))

    def state(self):
        return None


JAX_PROBE = dict(num_modalities=2, num_classes=C, input_dim=6, hidden_dim=(8,), lr=3e-3,
                 dropout=0.3, annealing_start=2, aggregation="cml", num_epochs=EPOCHS)
SERVE_DIMS = (12, 10)


def _jax_probe_data():
    rng = np.random.default_rng(18)
    return {"zc": rng.standard_normal((N, 6)).astype(np.float32),
            "zp": rng.standard_normal((N, 2, 6)).astype(np.float32),
            "y": rng.integers(0, C, N)}


def _serve_task():
    return ttasks.build_late_fusion_task(output_dims=SERVE_DIMS, num_classes=C,
                                         hidden_dim=(16,), aggregation="cml", device="cpu")


def jax_legs(mesh, inputs):
    """The port's half of the legs held against the JAX package."""
    task = ttasks.build_probe_task(device="cpu", **JAX_PROBE)
    task.model.load_state_dict(inputs["probe_init"])
    data = {k: torch.from_numpy(v) for k, v in _jax_probe_data().items()}
    val = {k: v[:20] for k, v in data.items()}
    res = train(model=task.model, loss_fn=task.loss_fn, data=data, n_train=N,
                optimizer=task.optimizer, epochs=EPOCHS, batch_size=BATCH,
                randomness=Replay(inputs["perms"], inputs["masks"]), val_fn=task.val_fn,
                val_data=val, mesh=mesh)
    out = {**_params("jax_probe", task.model), **_history("jax_probe", res)}
    stask = _serve_task()
    stask.model.load_state_dict(inputs["serve"])
    engine = ServingEngine(build_inference_fn(stask, mesh=mesh), buckets=(4, 8), divisor=2)
    served = engine(inputs["serve_xs"])
    return {**out, **{f"jax_serve.{k}": v for k, v in served.items()}}


# ------------------------------------------------------------------ the worker
def _worker(out_dir: Path) -> None:
    from disentagled_multimodal_fusion_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    assert pdist.initialize(backend="gloo", device="cpu", timeout=RANK_TIMEOUT_S)
    assert pdist.initialize()  # a second call finds the live group
    mesh = make_mesh()
    out = run_legs(mesh, mesh.shape["data"])
    out.update(leg_luma(str(out_dir / "luma")))
    inputs = out_dir / "jax_inputs.pt"
    if inputs.exists():
        out.update(jax_legs(mesh, torch.load(inputs, weights_only=False)))
    np.savez(out_dir / f"rank{pdist.rank()}.npz", **out)


# ------------------------------------------------------------------ the launcher
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(nproc: int, out_dir: Path):
    """Start ``nproc`` ranks on ``out_dir``; :func:`_collect` waits for them."""
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(nproc), PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1",
               DMF_ARTIFACT_ROOT=str(out_dir))
    from disentagled_multimodal_fusion_tpu_torch.data.luma import make_fake_luma

    make_fake_luma(str(out_dir / "luma"), n_classes=3, train_per_class=4, test_per_class=2,
                   ood_classes=1)
    # each rank salts Python's hash its own way, as unrelated processes do
    procs = [subprocess.Popen([sys.executable, __file__, str(out_dir)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r),
                                       PYTHONHASHSEED=str(r + 1)), cwd=str(REPO_ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(nproc)]
    return procs, out_dir


def _collect(cluster):
    """Each rank's outputs, once every rank has exited 0 (or the timeout)."""
    procs, out_dir = cluster
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(len(procs))]


def _jax_reference(out_dir: Path):
    """The JAX package's mesh runs of the probe fit and of serving (8
    virtual CPU devices, ``make_mesh(2)``); writes the inputs that replay
    them in the port (the draws, the converted weights, the request) to
    ``out_dir``."""
    import jax
    import jax.numpy as jnp
    from test_torch_train_many import FOLD, jax_draws

    from disentagled_multimodal_fusion_tpu.core import serve as jserve
    from disentagled_multimodal_fusion_tpu.core import tasks as jtasks
    from disentagled_multimodal_fusion_tpu.core.train import train as jax_train
    from disentagled_multimodal_fusion_tpu.parallel.mesh import make_mesh as jax_mesh
    from disentagled_multimodal_fusion_tpu_torch.convert import load_flax_params

    mesh = jax_mesh(2)
    jt = jtasks.build_probe_task(rng=jax.random.PRNGKey(19), **JAX_PROBE)
    data = _jax_probe_data()
    key = jax.random.PRNGKey(20)
    ref = jax_train(rng=key, params=jt.params, loss_fn=jt.loss_fn,
                    data={k: jnp.asarray(v) for k, v in data.items()}, n_train=N,
                    optimizer=jt.optimizer, epochs=EPOCHS, batch_size=BATCH, val_fn=jt.val_fn,
                    val_data={k: jnp.asarray(v[:20]) for k, v in data.items()}, mesh=mesh,
                    donate=False)
    perms, masks, _ = jax_draws(jax.random.fold_in(key, FOLD), EPOCHS, N, BATCH, (3, 8), 0.7)
    init = ttasks.build_probe_task(device="cpu", **JAX_PROBE)
    load_flax_params(init.model, jax.device_get(jt.params))

    jlate = jtasks.build_late_fusion_task(rng=jax.random.PRNGKey(21), output_dims=SERVE_DIMS,
                                          num_classes=C, hidden_dim=(16,), aggregation="cml")
    engine = jserve.ServingEngine(jserve.build_inference_fn(jlate, jlate.params, mesh=mesh),
                                  buckets=(4, 8), divisor=2)
    xs = tuple(x.numpy() for x in _views(5, SERVE_DIMS, 23))
    served = {k: np.asarray(v) for k, v in engine(xs).items()}
    stask = _serve_task()
    load_flax_params(stask.model, jax.device_get(jlate.params))

    torch.save({"probe_init": init.model.state_dict(), "perms": perms, "masks": masks,
                "serve": stask.model.state_dict(),
                "serve_xs": xs}, out_dir / "jax_inputs.pt")
    inner = ref.params["StackedMLP_0"]
    return {"params": {k: np.asarray(inner[k]) for k in ("w1", "b1", "w2", "b2")},
                     "train_loss": np.asarray(ref.train_loss),
                     "val_loss": np.asarray(ref.val_loss), "val_acc": np.asarray(ref.val_acc),
                     "served": served}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({2: rank outputs (with the JAX legs), 3: rank outputs}, the JAX
    references); the three-rank cluster runs while JAX computes."""
    three = _spawn(3, tmp_path_factory.mktemp("cluster3"))
    try:
        two_dir = tmp_path_factory.mktemp("cluster2")
        reference = _jax_reference(two_dir)
        two = _spawn(2, two_dir)
    except BaseException:
        for p in three[0]:
            p.kill()
            p.wait()
        raise
    return {3: _collect(three), 2: _collect(two)}, reference


def _close(key, a, b):
    if ".blocks.conv." in key and key.endswith(".bias"):
        # a bias before BatchNorm has no gradient but rounding noise (the
        # batch mean takes it out), which Adam scales up to lr-sized steps:
        # only its shape is held, as the LUMA step checks leave it out
        assert a.shape == b.shape, key
    elif key.endswith(".pred"):
        np.testing.assert_array_equal(a, b, err_msg=key)
    elif key.endswith("val_acc"):  # a sum of the ranks' weighted means
        np.testing.assert_allclose(a, b, err_msg=key, atol=1e-6)
    elif key.endswith(("train_loss", "val_loss")):
        np.testing.assert_allclose(a, b, err_msg=key, **LOSS_TOL)
    else:
        np.testing.assert_allclose(a, b, err_msg=key, **PARAM_TOL)


@pytest.mark.parametrize("nproc", [2, 3])
def test_cluster_matches_the_world_one_run(runs, nproc):
    ranks = runs[0][nproc]
    for key, value in ranks[0].items():
        if key.startswith(("jax_", "luma_own.")):
            continue
        for r in ranks[1:]:  # every rank holds the same results, bit for bit
            np.testing.assert_array_equal(r[key], value, err_msg=key)
    np.testing.assert_array_equal(ranks[0]["corpus.guard"], [1.0])
    np.testing.assert_allclose(*ranks[0]["corpus.mean"], rtol=1e-12)
    torch.set_num_threads(1)
    ref = run_legs(None, nproc)
    assert set(ref) == {k for k in ranks[0] if not k.startswith(("jax_", "luma"))}
    for key, value in ref.items():
        if key != "corpus.guard":
            _close(key, ranks[0][key], value)


@pytest.mark.parametrize("nproc", [2, 3])
def test_every_rank_holds_rank0s_luma_features(runs, nproc):
    """run_luma's arrays are rank 0's on every rank (the loop above holds
    them equal bit for bit), although each rank's own hashed text ids
    differ: the ranks train on one global dataset."""
    ranks = runs[0][nproc]
    assert ranks[0]["luma.y_tr"].shape == (12,) and ranks[0]["luma.y_ood"].shape == (2,)
    np.testing.assert_array_equal(ranks[0]["luma_own.text_tr"], ranks[0]["luma.text_tr"])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["luma.text_tr"], ranks[0]["luma.text_tr"])
        assert not np.array_equal(r["luma_own.text_tr"], r["luma.text_tr"])


def test_mesh_fit_and_serving_match_the_jax_package(runs):
    port, ref = runs[0][2][0], runs[1]
    for k, want in ref["params"].items():
        np.testing.assert_allclose(port[f"jax_probe.stack.{k}"], want, err_msg=k, **JAX_PARAM_TOL)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(port[f"jax_probe.{k}"], ref[k], err_msg=k, **JAX_LOSS_TOL)
    np.testing.assert_allclose(port["jax_probe.val_acc"], ref["val_acc"], atol=1e-6)
    served = ref["served"]
    np.testing.assert_array_equal(port["jax_serve.pred"], served["pred"])
    for k in ("evidence", "fused_evidence", "probs"):
        np.testing.assert_allclose(port[f"jax_serve.{k}"], served[k], err_msg=k, **SERVE_TOL)
    for k in ("epistemic", "aleatoric"):
        np.testing.assert_allclose(port[f"jax_serve.{k}"], served[k], err_msg=k, **UNC_TOL)


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))

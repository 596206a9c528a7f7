"""UQ-datasets sweep: seeds x {Normal, Conflict, Noise} x datasets x 6 models.

Counterpart of ``disentagled_multimodal_fusion_tpu/runners/run.py``: its
three engines (``run_condition``, ``run_condition_vmapped``,
``run_condition_onejit``), ``main`` and ``write_sweep_report``. Per (seed,
condition, dataset):

1. the 80/20 split on the legacy ``np.random`` stream seeded with the seed;
   Conflict (Noise) injects cross-class view conflicts (Gaussian noise) into
   the test rows only;
2. the backbone fit: FusedDMVAE (Adam + cosine, exact ragged tail), or
   with ``--backbone dssl`` DisentangledSSL (Adam + cosine, ``drop_last``:
   SupCon couples the whole batch), for two-view datasets only;
3. frozen embeddings of both splits;
4. six head fits with val = test: ``dmvae_dis`` (private-only probe),
   ``dmvae_cml`` and ``dmvae_joint`` (shared + private probes), and
   ``dbf``/``cml``/``avg`` ``_fusion`` (late fusion on the raw views);
5. with ``--include-intermediate`` / ``--intermediate-fusion NAME...``,
   one IntermediateFusion head fit per named library fusion
   (``models/fusions.py``), on the raw views: ``intermediate_fusion`` for
   ``concat``, ``intermediate_{name}`` for the others. A fusion that
   ``build_fusion`` refuses for the dataset (a view count, a size cap) is
   skipped with a ``{"skipped": reason}`` row;
6. evaluation (``dmvae_dis`` and the intermediate fusions in the per-view
   layout, every other model in the with-shared layout, which labels late
   fusion's view 0 "shared", a reference quirk kept for column parity), CSV
   logs, checkpoints, and the three-sheet report at
   ``logs/dataset_analysis.xlsx`` with CSV mirrors and one UQ figure per
   cell under ``logs/uq_plots/`` (where matplotlib is installed).

``--no-fused-dmvae`` trains the per-modality DMVAE in every engine (same
checkpoint names). ``--rows-file PATH`` writes the rows to PATH after every
(condition, dataset) cell; a rerun resumes from it, skips each cell whose
every seed has all its rows (skip rows count) and writes the report once.
``--profile`` records the sweep with ``torch.profiler`` into
``logs/traces/uq_sweep/trace.json``, written also when the sweep fails.

Over the DisentangledSSL backbone the probes' shared input is the two
shared codes side by side (2E wide) and their private inputs are E wide,
with E = ``dssl.embed_dim`` (default ``dmvae.embed_dim``). The backbone's
checkpoint is ``dssl_dataset{ds}_seed{s}_{cond}``, the probes report and
checkpoint as ``dssl_dis``, ``dssl_cml`` and ``dssl_joint``, and the report
goes to ``logs/dssl_dataset_analysis.xlsx``, so a DSSL sweep never
overwrites the DMVAE one.

Engines:

* sequential (the default): one cell per seed. ``--probe-engine step``
  (the JAX package's ``xla``) runs every fit as the eager step loop of
  ``core/train.py``; ``megakernel`` runs the three probe fits through the
  whole-epoch CUDA kernel (``core/megakernel.py``). The late-fusion fits are
  Adam fits and keep the step loop either way, as in the JAX package.
* ``--vmap-seeds``: all seeds of a (dataset, condition) cell at once. Each
  fit is one ``core.train.train_many`` over the stacked seeds, so one set
  of operations per step serves all S seeds, and each eval forward is one
  head-kernel launch at S x V heads. Rows, checkpoints and CSV logs are
  written per seed under the sequential engine's names, so ``serve.py``
  and ``evaluate.py`` read them.
* ``--one-program-cells``: the fits of ``--vmap-seeds``, the whole cell in
  one call (``core/sweep_cell.py``) with one fetch at its end; its rows,
  checkpoints and logs are written on a thread while the next cell runs.
  Its rows equal ``--vmap-seeds``' bit for bit.

``--probe-engine megakernel`` runs the sequential engine only (the epoch
kernel has no seed-batched program), as in the JAX package; so does
``--backbone dssl``.

``--data-parallel N`` (JAX lines 801, 833-837) runs the sweep as N ranks of
a process group, one per card (``torchrun --nproc-per-node N``; with
``--device cpu``, or ranks that share a card, they talk over gloo), each
running the whole runner:
every fit of the sequential engine splits each step's rows over the ranks
(``core.train.train(mesh=)``) and each evaluation its test rows; the
seed-batched engines split the seeds (their count must divide by N). The
results are the same on every rank, and rank 0 alone writes the
checkpoints, logs, rows file and report. ``--probe-engine megakernel`` is
refused with it, as in the JAX package (the epoch kernel is one device's
program). ``--model-parallel M`` runs the mesh's ``model`` axis, the world
size --data-parallel x M: every single fit cuts its MLPs' hidden width
over M ranks (the Megatron cut, ``parallel/mesh.py``; the backbone at its
hidden width, the heads at the probes' ``probes.model_hidden_dim``), the
JAX runner's ``tp_hidden_dim``; the seed-batched engines split their
seeds over ``data`` alone and repeat their work on ``model``.
``--force-vmap-seeds`` is accepted for the JAX CLI's sake: the port never
falls back from ``--vmap-seeds`` to the sequential engine.

Randomness. Let c = ``cell_seed(seed, dataset, conflict)``.

* The sequential engine has 16 key slots, slot k seeding
  ``torch.Generator(c * 16 + k)``: slot 0 draws the backbone's weights, 1
  its fit's shuffles and noise, 2-7 the six heads' weights and 8-13 their
  fits' shuffles and dropout masks (the JAX package's ``keys[0..13]`` of
  ``jax.random.split(PRNGKey(c), 16)``).
* The seed-batched engines use fold indices (the JAX package's
  ``fold_in(PRNGKey(c), i)``), index i seeding
  ``torch.Generator(fold_seed(c, i))`` = ``2**31 + c * 256 + i``: i = 0 the
  backbone's weights, 1 its fit, 10 + j head j's weights and 100 + j head
  j's fit, j in the roster order of :func:`build_cell_head_specs`. These
  seeds lie in [2**31, 2**32), so their low 32 bits (all a CPU generator
  keeps) never meet a sequential slot; ``runners.common.fold_seed`` refuses
  cell seeds that could.

* The intermediate-fusion jobs follow the JAX key layout. In the
  sequential engine concat's weights come from slot 15 and job i's fit
  from slot 8 + i for i < 7. The JAX package folds the other keys (the
  weights of registry fusion m from ``fold_in(keys[15], m)``, the fit of job
  i >= 7 from ``fold_in(keys[8], 1000 + i)``); their stand-ins are
  ``runners.common.intermediate_seed(c, m)`` for the weights and
  ``intermediate_seed(c, 8 + i)`` for the fit, = ``2**27 + c * 32 + m``,
  which lie in [2**27, 2**27 + 2**28) for every cell seed below 2**23 and
  so meet neither the slots (below 2**27) nor the fold seeds (at or above
  2**31). In the seed-batched
  engines the intermediate jobs follow the six heads in the roster, so they
  take fold indices 10 + j and 100 + j like any head.

Weights are drawn on the CPU; a fit's draws come from a generator on its
device. So seed s of a seed-batched cell is a sequential fit of the same
weights and generators, which ``tests/test_torch_run.py`` replays.

``--dtype bfloat16`` (JAX lines 813-821) builds the backbone, the six heads
and the intermediate fusions' heads with the bf16 compute type
(``core/tasks.py``): their products run in bf16, the parameters, Adam's
state and the losses stay float32, so the checkpoints have the float32
format that ``evaluate.py`` and ``serve.py`` restore. A bf16 probe has no
epoch-kernel descriptor, so ``--probe-engine megakernel`` trains it through
the step loop, as the JAX package does; its validation and evaluation go
through the head kernel's bf16 build. The DSSL backbone stays float32.

Examples:
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run \
      --seeds 0 --datasets HandWritten --conditions Normal --probe-engine megakernel
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run \
      --vmap-seeds --seeds 0 1 2 3 4 --datasets HandWritten --conditions Normal
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run \
      --quick --seeds 0 --datasets CUB --conditions Normal --device cpu
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run \
      --quick --seeds 0 --datasets CUB --conditions Normal --device cpu \
      --include-intermediate --intermediate-fusion lrtf --rows-file rows.json
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.logging import trace

CONDITIONS = (("Normal", False, False), ("Conflict", True, False), ("Noise", False, True))


def condition_name(conflict: bool, noise: bool) -> str:
    return "conflict" if conflict else ("noise" if noise else "normal")


class CellSettings(NamedTuple):
    """The config values one cell's fits read."""

    batch_size: int
    lr: float
    probe_hidden: tuple
    probe_dropout: float
    annealing_start: float
    probe_epochs: int
    probe_input_dim: int
    dmvae_epochs: int
    dmvae_hidden: int
    embed_dim: int
    dmvae_a: float
    dmvae_dropout: float
    dmvae_lr: float
    dtype: Optional[str] = None  # the compute type of --dtype (None: float32)


def cell_settings(C, dataset_name: str, quick: bool, dtype=None) -> CellSettings:
    lr = C("optim.dataset_lr", {}).get(
        dataset_name,
        {"CalTech": 3e-4, "Scene": 0.01, "CUB": 3e-3, "HandWritten": 3e-3, "PIE": 3e-3}[
            dataset_name
        ],
    )
    return CellSettings(
        batch_size=C("dataloader.batch_size", 100), lr=lr,
        probe_hidden=tuple(C("probes.model_hidden_dim", (128,))),
        probe_dropout=C("probes.dropout_p", 0.1),
        annealing_start=C("probes.annealing_start", 50),
        probe_epochs=2 if quick else C("probes.model_epochs", 200),
        probe_input_dim=C("probes.input_dim", 200),
        dmvae_epochs=2 if quick else C("dmvae.num_epochs", 100),
        dmvae_hidden=C("dmvae.hidden_dim", 512), embed_dim=C("dmvae.embed_dim", 200),
        dmvae_a=C("dmvae.a", 1e-5), dmvae_dropout=C("dmvae.dropout", 0.0),
        dmvae_lr=C("dmvae.lr", 1e-4), dtype=dtype,
    )


def split_cell(C, seed: int, dataset_name: str, conflict: bool, noise: bool):
    """The cell's split on the legacy ``np.random`` stream seeded with
    ``seed``, with the condition's perturbation of the test rows:
    (views, labels, train_idx, test_idx, dims, num_classes)."""
    from ..data.multiview import DATASET_REGISTRY

    np.random.seed(seed)
    dataset = DATASET_REGISTRY[dataset_name]()
    n = len(dataset)
    idx = np.arange(n)
    np.random.shuffle(idx)
    n_tr = int(C("data.split.train_frac", 0.8) * n)
    train_idx, test_idx = idx[:n_tr], idx[n_tr:]
    if conflict or noise:
        pp = C("data.conflict", {}) or {}
        dataset.postprocessing(
            test_idx,
            addNoise=noise or pp.get("addNoise", False),
            sigma=pp.get("sigma", 0.5),
            ratio_noise=1.0 if noise else pp.get("ratio_noise", 0.0),
            addConflict=conflict and pp.get("addConflict", True),
            ratio_conflict=pp.get("ratio_conflict", 1.0),
            rng=None,
        )
    views, labels = dataset.arrays()
    dims = [int(d[0]) for d in dataset.dims]
    return views, labels, train_idx, test_idx, dims, dataset.num_classes


def build_backbone(st: CellSettings, dims, seed: int, device, fused: bool = True):
    """The cell's DMVAE: FusedDMVAE, or the per-modality DMVAE when not
    ``fused`` (``--no-fused-dmvae``)."""
    from ..core.tasks import build_dmvae_task

    return build_dmvae_task(seed=seed, output_dim=dims, hidden_dim=st.dmvae_hidden,
                            embed_dim=st.embed_dim, a=st.dmvae_a, dropout=st.dmvae_dropout,
                            fused_modalities=fused, dtype=st.dtype, device=device)


def intermediate_job_name(fusion: str) -> str:
    return "intermediate_fusion" if fusion == "concat" else f"intermediate_{fusion}"


class HeadSpec(NamedTuple):
    name: str
    builder: object      # seed -> task
    kind: str            # 'probe' (trains on embeddings) or 'raw' (on views)
    shared_layout: bool  # evaluated with the shared-embedding layout
    fusion: str | None = None  # the intermediate jobs' registry fusion


def build_cell_head_specs(*, st: CellSettings, dims, num_classes: int, device,
                          input_dim=None, shared_input_dim=None, intermediate_fusions=(),
                          tag: str = ""):
    """The cell's head roster, one for every engine: ([HeadSpec], {job name:
    reason}), in the JAX package's order: the six heads, then one
    IntermediateFusion per fusion of ``intermediate_fusions`` that
    ``build_fusion`` accepts for ``dims``. The fusions it refuses are
    announced as ``skipping`` (after ``tag``) and returned with the reason.
    The order fixes each head's key slots and fold indices. ``input_dim``
    and ``shared_input_dim`` override the probes' input widths (the DSSL
    backbone's)."""
    from ..core.tasks import (
        build_disentangled_probe_task,
        build_intermediate_fusion_task,
        build_late_fusion_task,
        build_probe_task,
    )
    from ..models.fusions import fusion_dim

    head = dict(num_classes=num_classes, hidden_dim=st.probe_hidden, lr=st.lr,
                dropout=st.probe_dropout, annealing_start=st.annealing_start, dtype=st.dtype,
                device=device)
    probe = dict(head, num_modalities=len(dims), input_dim=input_dim or st.probe_input_dim,
                 num_epochs=st.probe_epochs)

    def dis(seed):
        return build_disentangled_probe_task(seed=seed, **probe)

    def shared_private(agg):
        return lambda seed: build_probe_task(seed=seed, aggregation=agg, fused=1.0,
                                             shared_input_dim=shared_input_dim, **probe)

    def late(agg):
        return lambda seed: build_late_fusion_task(seed=seed, output_dims=dims, aggregation=agg,
                                                   fused=1.0, **head)

    def intermediate(fusion):
        return lambda seed: build_intermediate_fusion_task(
            seed=seed, output_dims=dims, num_classes=num_classes, dropout=st.probe_dropout,
            lr=st.lr, annealing_start=st.annealing_start, fusion=fusion, dtype=st.dtype,
            device=device)

    specs = [
        HeadSpec("dmvae_dis", dis, "probe", False),
        HeadSpec("dmvae_cml", shared_private("cml"), "probe", True),
        HeadSpec("dmvae_joint", shared_private("joint"), "probe", True),
        HeadSpec("dbf_fusion", late("dbf"), "raw", True),
        HeadSpec("cml_fusion", late("cml"), "raw", True),
        HeadSpec("avg_fusion", late("avg"), "raw", True),
    ]
    skipped = {}
    for fusion in intermediate_fusions:
        jname = intermediate_job_name(fusion)
        try:
            fusion_dim(fusion, dims)
        except ValueError as e:
            print(f"  {tag} skipping {jname}: {e}", flush=True)
            skipped[jname] = str(e)
            continue
        specs.append(HeadSpec(jname, intermediate(fusion), "raw", False, fusion))
    return specs, skipped


def fit_backbone(*, C, st: CellSettings, backbone: str, dims, xs_tr, n_train: int,
                 seeds: tuple, device, tag: str, drop_last: bool, fused_dmvae: bool = True,
                 mesh=None, tp_hidden_dim=None):
    """Build and fit the cell's backbone, DMVAE (fused unless
    ``fused_dmvae`` is off) or DisentangledSSL (weights from generator seed
    ``seeds[0]``, fit draws from ``seeds[1]``), and print its fit time (and
    the vMF sampler's host syncs per epoch); returns (model, the probes'
    input widths over it, {backbone_fit_seconds, vmf_syncs_per_epoch}).
    ``mesh`` splits each step's rows over its ranks, and its model axis
    cuts ``tp_hidden_dim`` (by default the backbone's hidden width, as the
    JAX runner passes it)."""
    from ..core.tasks import build_disentangledssl_task, dmvae_objective
    from ..core.train import Randomness, train

    widths = {}
    if backbone == "dssl":
        if len(dims) != 2:
            raise ValueError(f"--backbone dssl is 2-modal (disentangledssl.py:17-194); {tag} "
                             f"has {len(dims)} views; use CUB")
        embed = C("dssl.embed_dim", st.embed_dim)
        model, loss_fn, opt = build_disentangledssl_task(
            seed=seeds[0], output_dim=dims, hidden_dim=C("dssl.hidden_dim", 512),
            embed_dim=embed, a=C("dssl.a", 1.0), distribution=C("dssl.distribution", "vmf"),
            vmfkappa=C("dssl.vmfkappa", 1.0), lr=C("dssl.lr", 1e-3), epochs=st.dmvae_epochs,
            device=device)
        widths = dict(input_dim=embed, shared_input_dim=2 * embed)
        hidden = C("dssl.hidden_dim", 512)
    else:
        model = build_backbone(st, dims, seeds[0], device, fused=fused_dmvae)
        loss_fn, opt = dmvae_objective(model, lr=st.dmvae_lr, num_epochs=st.dmvae_epochs)
        backbone = "dmvae" if fused_dmvae else "dmvae (unfused)"
        hidden = st.dmvae_hidden
    randomness = Randomness(seeds[1], device)
    t_fit = time.perf_counter()
    res = train(model=model, loss_fn=loss_fn, data={"xs": xs_tr}, n_train=n_train,
                optimizer=opt, epochs=st.dmvae_epochs, batch_size=st.batch_size,
                randomness=randomness, drop_last=drop_last, mesh=mesh,
                tp_hidden_dim=hidden if tp_hidden_dim is None else tp_hidden_dim)
    fit_s = time.perf_counter() - t_fit
    syncs = randomness.vmf_syncs / st.dmvae_epochs
    print(f"  {tag} {backbone} fit: {fit_s:.2f} s, {1e3 * fit_s / st.dmvae_epochs:.3f} ms/epoch"
          + (f", {syncs:.2f} vMF syncs/epoch" if backbone == "dssl" else "")
          + f", last train loss {float(res.train_loss[-1]):.4f}", flush=True)
    return model, widths, {"backbone_fit_seconds": fit_s, "vmf_syncs_per_epoch": syncs}


def run_condition(*, C, seed, dataset_name, conflict, quick, device, rows_out,
                  noise=False, probe_engine="step", backbone="dmvae", fused_dmvae=True,
                  intermediate_fusions=(), dtype=None, mesh=None):
    """Train and evaluate the six models of one cell, and the intermediate
    fusions asked for, into ``rows_out``; ``mesh`` splits every fit's and
    evaluation's rows over its ranks."""
    from ..core.checkpoint import save_checkpoint
    from ..core.logging import log_training_csv
    from ..core.sweep_cell import head_data
    from ..core.tasks import embed_dataset
    from ..core.train import Randomness, train
    from ..eval.analysis import evaluate_subjective_model, evaluate_subjective_model_with_shared
    from ..models.fusions import INTERMEDIATE_FUSIONS
    from .common import backbone_checkpoint, cell_seed, head_name, intermediate_seed

    t0 = time.time()
    views, labels, train_idx, test_idx, dims, num_classes = split_cell(
        C, seed, dataset_name, conflict, noise)

    def upload(rows):
        return (tuple(torch.from_numpy(np.ascontiguousarray(v[rows])).to(device) for v in views),
                torch.from_numpy(labels[rows]).to(device))

    xs_tr, y_tr = upload(train_idx)
    xs_te, y_te = upload(test_idx)
    n_train = len(train_idx)
    st = cell_settings(C, dataset_name, quick, dtype)
    base = cell_seed(seed, dataset_name, conflict)

    def slot(k):
        return base * 16 + k

    cond = condition_name(conflict, noise)
    model, widths, _ = fit_backbone(
        C=C, st=st, backbone=backbone, dims=dims, xs_tr=xs_tr, n_train=n_train,
        seeds=(slot(0), slot(1)), device=device, tag=f"[{dataset_name}/{cond}/seed{seed}]",
        drop_last=backbone == "dssl", fused_dmvae=fused_dmvae, mesh=mesh)
    save_checkpoint(backbone_checkpoint(dataset_name, seed, cond, backbone), model,
                    {"dataset": dataset_name, "seed": seed, "cond": cond})
    data = head_data(embed_dataset(model, xs_tr), embed_dataset(model, xs_te),
                     xs_tr, xs_te, y_tr, y_te)

    specs, skipped = build_cell_head_specs(
        st=st, dims=dims, num_classes=num_classes, device=device,
        intermediate_fusions=intermediate_fusions, tag=f"[{dataset_name}]", **widths)
    rows_out.update({name: {"skipped": reason} for name, reason in skipped.items()})
    for j, (name, builder, kind, shared_layout, fusion) in enumerate(specs):
        if backbone == "dssl":  # the probes over SSL report and checkpoint as dssl_*
            name = name.replace("dmvae_", "dssl_")
        if fusion is None:
            task = builder(slot(2 + j))
        elif fusion == "concat":
            task = builder(slot(15))
        else:
            task = builder(intermediate_seed(base, INTERMEDIATE_FUSIONS.index(fusion)))
        fit_seed = slot(8 + j) if j < 7 else intermediate_seed(base, 8 + j)
        tr_data, te_data = data[kind]
        t_fit = time.perf_counter()
        res_m = train(
            model=task.model, loss_fn=task.loss_fn, data=tr_data, n_train=n_train,
            optimizer=task.optimizer, epochs=st.probe_epochs, batch_size=st.batch_size,
            randomness=Randomness(fit_seed, device), val_fn=task.val_fn, val_data=te_data,
            megakernel=task.megakernel if probe_engine == "megakernel" else None, mesh=mesh,
            tp_hidden_dim=st.probe_hidden[0],
        )
        fit_s = time.perf_counter() - t_fit
        evaluate = (evaluate_subjective_model_with_shared if shared_layout
                    else evaluate_subjective_model)
        info = evaluate(task, te_data, mesh)
        model_name = head_name(name, dataset_name, seed, cond)
        log_training_csv(model_name, res_m)
        info["path"] = save_checkpoint(f"checkpoints/{model_name}", task.model,
                                       {"model": name, "dataset": dataset_name, "seed": seed})
        info["fit_seconds"] = fit_s
        rows_out[name] = info
        print(
            f"  [{dataset_name}/{cond}/seed{seed}] {name}: "
            f"fused_acc={info['fused']['accuracy']:.4f} "
            f"val_acc_last={float(res_m.val_acc[-1]):.4f} "
            f"fit {fit_s:.2f} s, {1e3 * fit_s / st.probe_epochs:.3f} ms/epoch",
            flush=True,
        )
    print(f"  {dataset_name}/{cond}/seed{seed} done in {time.time() - t0:.1f}s", flush=True)


# ------------------------------------------------------------ seed-batched engines
def prepare_cell_data(*, C, seeds, dataset_name, conflict, noise, device):
    """Every seed's split (the sequential engine's, seed by seed), stacked on
    a leading seed axis on ``device``: (xs_tr (S, n, S_i) per view, xs_te,
    y_tr (S, n), y_te, dims, num_classes)."""
    splits = [split_cell(C, seed, dataset_name, conflict, noise) for seed in seeds]
    dims, num_classes = splits[0][4:]

    def stack(arrays):
        return torch.from_numpy(np.stack(arrays)).to(device)

    xs_tr = tuple(stack([sp[0][v][sp[2]] for sp in splits]) for v in range(len(dims)))
    xs_te = tuple(stack([sp[0][v][sp[3]] for sp in splits]) for v in range(len(dims)))
    y_tr = stack([sp[1][sp[2]] for sp in splits])
    y_te = stack([sp[1][sp[3]] for sp in splits])
    return xs_tr, xs_te, y_tr, y_te, dims, num_classes


class _SeedBatchedCell(NamedTuple):
    """What both seed-batched engines set up for one cell."""

    cond: str
    data: tuple        # (xs_tr, xs_te, y_tr, y_te)
    n_train: int
    settings: CellSettings
    backbones: list    # one per seed, holding its initial weights
    bb_loss_fn: object
    bb_optimizer: object
    bb_randomness: list
    jobs: list         # core.sweep_cell.CellJob per head, in roster order


def _setup_seed_batched(*, C, seeds, dataset_name, conflict, noise, quick, device,
                        rows_by_seed, fused_dmvae=True, intermediate_fusions=(), dtype=None):
    from ..core.sweep_cell import CellJob
    from ..core.tasks import dmvae_objective
    from ..core.train import Randomness
    from .common import cell_seed, fold_seed

    xs_tr, xs_te, y_tr, y_te, dims, num_classes = prepare_cell_data(
        C=C, seeds=seeds, dataset_name=dataset_name, conflict=conflict, noise=noise,
        device=device)
    st = cell_settings(C, dataset_name, quick, dtype)
    cells = [cell_seed(s, dataset_name, conflict) for s in seeds]
    backbones = [build_backbone(st, dims, fold_seed(c, 0), device, fused=fused_dmvae)
                 for c in cells]
    loss_fn, opt = dmvae_objective(backbones[0], lr=st.dmvae_lr, num_epochs=st.dmvae_epochs)
    specs, skipped = build_cell_head_specs(
        st=st, dims=dims, num_classes=num_classes, device=device,
        intermediate_fusions=intermediate_fusions, tag=f"[{dataset_name}]")
    for name, reason in skipped.items():
        for s in seeds:
            rows_by_seed[s][name] = {"skipped": reason}
    jobs = [
        CellJob(name=spec.name, tasks=[spec.builder(fold_seed(c, 10 + j)) for c in cells],
                randomness=[Randomness(fold_seed(c, 100 + j), device) for c in cells],
                kind=spec.kind, epochs=st.probe_epochs, shared_layout=spec.shared_layout)
        for j, spec in enumerate(specs)
    ]
    return _SeedBatchedCell(
        cond=condition_name(conflict, noise), data=(xs_tr, xs_te, y_tr, y_te),
        n_train=xs_tr[0].shape[1], settings=st, backbones=backbones, bb_loss_fn=loss_fn,
        bb_optimizer=opt, bb_randomness=[Randomness(fold_seed(c, 1), device) for c in cells],
        jobs=jobs,
    )


def _save_backbones(cell: _SeedBatchedCell, params, seeds, dataset_name):
    from ..core.checkpoint import save_checkpoint
    from ..core.train import load_params
    from .common import backbone_checkpoint

    load_params(cell.backbones, params)
    for backbone, seed in zip(cell.backbones, seeds):
        save_checkpoint(backbone_checkpoint(dataset_name, seed, cell.cond), backbone,
                        {"dataset": dataset_name, "seed": seed, "cond": cell.cond})


def _write_job(job, fetched, seeds, dataset_name, cond, rows_by_seed, **extra):
    """Rows, CSV logs and checkpoints of one fetched head fit, per seed,
    under the sequential engine's names."""
    from ..core.checkpoint import save_checkpoint
    from ..core.logging import log_training_csv
    from ..core.sweep_cell import job_rows
    from ..core.train import TrainResult, load_params
    from .common import head_name

    rows = job_rows(job, fetched, seeds)
    load_params([t.model for t in job.tasks], fetched["params"])
    for s, seed in enumerate(seeds):
        model_name = head_name(job.name, dataset_name, seed, cond)
        log_training_csv(model_name, TrainResult(
            train_loss=fetched["train_loss"][s], val_loss=fetched["val_loss"][s],
            val_acc=fetched["val_acc"][s], final_lr=float(fetched["final_lr"][s])))
        info = rows[int(seed)]
        info["path"] = save_checkpoint(f"checkpoints/{model_name}", job.tasks[s].model,
                                       {"model": job.name, "dataset": dataset_name, "seed": seed})
        info.update(extra)
        rows_by_seed[seed][job.name] = info
    accs = [rows_by_seed[s][job.name]["fused"]["accuracy"] for s in seeds]
    return f"fused_acc {np.mean(accs):.4f} +/- {np.std(accs):.4f}"


def run_condition_vmapped(*, C, seeds, dataset_name, conflict, quick, device, rows_by_seed,
                          noise=False, fused_dmvae=True, intermediate_fusions=(), dtype=None,
                          mesh=None):
    """All seeds of one cell at once, each fit a ``train_many`` over the
    stacked seeds, its results fetched and written when it ends. Every head
    row carries ``fit_seconds`` (its seed-batched fit, evaluation and fetch)
    and ``backbone_fit_seconds``. ``mesh`` splits the seeds over its ranks."""
    from ..core.sweep_cell import fit_job, head_data
    from ..core.tasks import embed_many
    from ..core.train import stack_params, train_many
    from ..eval.analysis import fetch

    t0 = time.time()
    cell = _setup_seed_batched(C=C, seeds=seeds, dataset_name=dataset_name, conflict=conflict,
                               noise=noise, quick=quick, device=device, rows_by_seed=rows_by_seed,
                               fused_dmvae=fused_dmvae, intermediate_fusions=intermediate_fusions,
                               dtype=dtype)
    st, tag, s_count = cell.settings, f"[{dataset_name}/{cell.cond}]", len(seeds)
    xs_tr, xs_te, y_tr, y_te = cell.data
    t_fit = time.perf_counter()
    res = train_many(model=cell.backbones[0], params=stack_params(cell.backbones),
                     loss_fn=cell.bb_loss_fn, data={"xs": xs_tr}, n_train=cell.n_train,
                     optimizer=cell.bb_optimizer, epochs=st.dmvae_epochs,
                     batch_size=st.batch_size, randomness=cell.bb_randomness, mesh=mesh)
    last = res.train_loss[:, -1].tolist()
    bb_s = time.perf_counter() - t_fit
    print(f"  {tag} dmvae fit x{s_count} seeds: {bb_s:.2f} s, "
          f"{1e3 * bb_s / st.dmvae_epochs:.3f} ms/epoch, last train losses "
          f"{[round(x, 4) for x in last]}", flush=True)
    _save_backbones(cell, res.params, seeds, dataset_name)
    data = head_data(embed_many(cell.backbones[0], res.params, xs_tr),
                     embed_many(cell.backbones[0], res.params, xs_te), xs_tr, xs_te, y_tr, y_te)
    for job in cell.jobs:
        t_fit = time.perf_counter()
        fetched = fetch(fit_job(job, data[job.kind], cell.n_train, st.batch_size, mesh=mesh))
        fit_s = time.perf_counter() - t_fit
        accs = _write_job(job, fetched, seeds, dataset_name, cell.cond, rows_by_seed,
                          fit_seconds=fit_s, backbone_fit_seconds=bb_s)
        print(f"  {tag} {job.name} x{s_count}: {accs}, fit {fit_s:.2f} s, "
              f"{1e3 * fit_s / st.probe_epochs:.3f} ms/epoch", flush=True)
    print(f"  {dataset_name}/{cell.cond} ({s_count} seeds) done in {time.time() - t0:.1f}s",
          flush=True)


def run_condition_onejit(*, C, seeds, dataset_name, conflict, quick, device, rows_by_seed,
                         noise=False, fused_dmvae=True, intermediate_fusions=(),
                         defer_artifacts=False, dtype=None, mesh=None):
    """The whole cell, all seeds, in one ``core.sweep_cell.run_cell`` call
    with one fetch at its end; the same fits as :func:`run_condition_vmapped`.

    With ``defer_artifacts`` it returns ``finish()``, which fetches the
    result and writes the rows, checkpoints and CSV logs, for the caller to
    run while the next cell runs on the device. On CUDA the fetch runs on a
    stream of its own that waits only for this cell's last operation, so it
    never waits for what the next cell has issued since."""
    from ..core.sweep_cell import run_cell
    from ..core.train import stack_params
    from ..eval.analysis import fetch

    t0 = time.time()
    cell = _setup_seed_batched(C=C, seeds=seeds, dataset_name=dataset_name, conflict=conflict,
                               noise=noise, quick=quick, device=device, rows_by_seed=rows_by_seed,
                               fused_dmvae=fused_dmvae, intermediate_fusions=intermediate_fusions,
                               dtype=dtype)
    st, tag, s_count = cell.settings, f"[{dataset_name}/{cell.cond}]", len(seeds)
    xs_tr, xs_te, y_tr, y_te = cell.data
    result = run_cell(
        backbone=cell.backbones[0], bb_params=stack_params(cell.backbones),
        bb_loss_fn=cell.bb_loss_fn, bb_optimizer=cell.bb_optimizer, bb_epochs=st.dmvae_epochs,
        bb_randomness=cell.bb_randomness, jobs=cell.jobs, xs_tr=xs_tr, xs_te=xs_te, y_tr=y_tr,
        y_te=y_te, n_train=cell.n_train, batch_size=st.batch_size, mesh=mesh,
    )
    ready = None
    if device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    t_issued = time.time()
    print(f"  {tag} one-program cell ({s_count} seeds x {len(cell.jobs) + 1} fits) issued in "
          f"{t_issued - t0:.1f}s", flush=True)

    def finish():
        if ready is None:
            fetched = fetch(result)
        else:
            side = torch.cuda.Stream(device=device)
            side.wait_event(ready)
            with torch.cuda.stream(side):
                fetched = fetch(result)
        _save_backbones(cell, fetched["backbone_params"], seeds, dataset_name)
        for job in cell.jobs:
            accs = _write_job(job, fetched["jobs"][job.name], seeds, dataset_name, cell.cond,
                              rows_by_seed)
            print(f"  {tag} {job.name} x{s_count}: {accs}", flush=True)
        print(f"  {dataset_name}/{cell.cond} ({s_count} seeds) one-program cell done in "
              f"{time.time() - t0:.1f}s (artifacts {time.time() - t_issued:.1f}s)", flush=True)

    if defer_artifacts:
        return finish
    finish()
    return None


def write_sweep_report(rows, excel_path):
    """Flatten nested rows[seed][condition][dataset][model] and write the
    three-sheet report (main_grouped, all_results, grouped_results) and the
    UQ figures (``eval/uq_plots.py``) beside it, under ``uq_plots/``. Skip
    rows (``{"skipped": reason}``) carry no metrics and are left out."""
    from ..core.artifacts import artifact_path
    from ..eval.analysis import build_metrics_rows_datasets
    from ..eval.uq_plots import write_uq_plots
    from .common import Table, group_mean, main_columns, write_report

    rows = {
        seed: {cond: {ds: {m: v for m, v in models.items() if "skipped" not in v}
                      for ds, models in conds.items()}
               for cond, conds in by_cond.items()}
        for seed, by_cond in rows.items()
    }
    columns, dicts = build_metrics_rows_datasets(rows)
    for d in dicts:
        d["seed"] = int(d["seed"])
    table = Table.from_dicts(columns, dicts)
    keys = ["type", "dataset", "model"]
    write_report(
        {
            "main_grouped": group_mean(main_columns(table, ["seed", *keys]), keys),
            "all_results": table,
            "grouped_results": group_mean(table, keys),
        },
        excel_path,
    )
    plots = write_uq_plots(rows, artifact_path(Path(excel_path).parent / "uq_plots"))
    if plots:
        print(f"  wrote {len(plots)} UQ figures -> {Path(plots[0]).parent}", flush=True)
    else:
        print("  no UQ figures written (matplotlib is not installed, or no row has "
              "reliability data)", flush=True)
    return table


def parse_args(argv=None):
    from ..models.fusions import INTERMEDIATE_FUSIONS
    from .common import add_force_vmap_flag, add_mesh_args

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--seeds", type=int, nargs="*", default=None)
    parser.add_argument("--datasets", type=str, nargs="*", default=None)
    parser.add_argument("--conditions", type=str, nargs="*", default=["Normal", "Conflict"])
    parser.add_argument("--quick", action="store_true", help="2 epochs per fit")
    parser.add_argument("--probe-engine", choices=["step", "megakernel"], default="step",
                        help="'step' (the JAX package's 'xla'): every fit as the eager step "
                             "loop; 'megakernel': the probe fits through the whole-epoch "
                             "CUDA kernel (sequential engine only)")
    parser.add_argument("--vmap-seeds", action="store_true",
                        help="train all seeds of each (dataset, condition) cell at once, "
                             "each fit over the stacked seeds (same math per seed)")
    parser.add_argument("--one-program-cells", action="store_true",
                        help="run each (dataset, condition) cell, all seeds, as one call "
                             "with one fetch at its end; the fits of --vmap-seeds")
    parser.add_argument("--skip-report", action="store_true", help="skip the report write")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "PyTorch path)")
    parser.add_argument("--backbone", choices=["dmvae", "dssl"], default="dmvae",
                        help="disentangling backbone: DMVAE, or DisentangledSSL (two-view "
                             "datasets, sequential engine)")
    parser.add_argument("--no-fused-dmvae", action="store_true",
                        help="train the per-modality DMVAE instead of the fused one")
    parser.add_argument("--include-intermediate", action="store_true",
                        help="also sweep IntermediateFusion over concat (the reference's "
                             "baseline, baselines.py:153-252): 'intermediate_fusion' rows")
    parser.add_argument("--intermediate-fusion", type=str, nargs="*", default=None,
                        metavar="NAME",
                        help="sweep IntermediateFusion over these library fusions "
                             f"({', '.join(INTERMEDIATE_FUSIONS)}); a fusion refused for a "
                             "dataset's views is skipped with a skip row")
    parser.add_argument("--rows-file", default=None, metavar="PATH",
                        help="write the rows to PATH (JSON) after every (condition, dataset) "
                             "cell; a rerun skips the cells PATH holds and writes the report "
                             "once every requested cell exists")
    parser.add_argument("--profile", action="store_true",
                        help="record the sweep with torch.profiler (CPU and CUDA activity) "
                             "into logs/traces/uq_sweep/trace.json, a Chrome trace")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                        help="the products' compute type (parameters, optimizer state and "
                             "losses stay float32); bfloat16 runs the backbone's and the "
                             "heads' products in bf16")
    add_mesh_args(parser)
    add_force_vmap_flag(parser)
    args = parser.parse_args(argv)
    if args.probe_engine == "megakernel" and (args.vmap_seeds or args.one_program_cells):
        parser.error("--probe-engine megakernel runs the sequential engine only "
                     "(the epoch kernel has no seed-batched program)")
    if args.backbone == "dssl" and (args.vmap_seeds or args.one_program_cells):
        parser.error("--backbone dssl runs the sequential engine only (the SSL backbone has "
                     "no seed-batched trainer, as in the JAX package)")
    fusions = list(args.intermediate_fusion or [])
    unknown = [f for f in fusions if f not in INTERMEDIATE_FUSIONS]
    if unknown:
        parser.error(f"unknown --intermediate-fusion {unknown}; "
                     f"supported: {INTERMEDIATE_FUSIONS}")
    if args.include_intermediate and "concat" not in fusions:
        fusions.insert(0, "concat")
    args.intermediate_fusion = fusions
    if args.probe_engine == "megakernel" and (args.data_parallel > 1
                                              or args.model_parallel > 1):
        parser.error("--probe-engine megakernel is single-device (probe fits are KB-scale; mesh "
                     "parallelism applies to the backbone fit, which keeps the step loop)")
    return args


def main(argv=None):
    """Run the sweep; returns rows[seed][condition][dataset][model]."""
    from .common import build_runner_mesh, load_config, make_getter

    args = parse_args(argv)
    mesh, device = build_runner_mesh(args.data_parallel, args.model_parallel, args.device)
    C = make_getter(load_config())
    seeds = args.seeds if args.seeds is not None else C("experiment.seeds", [0, 1, 2, 3, 4])
    normal_ds = args.datasets or C("experiment.normal_datasets",
                                   ["CUB", "HandWritten", "PIE", "Scene"])
    conflict_ds = args.datasets or C("experiment.conflict_datasets",
                                     ["CUB", "HandWritten", "PIE", "Scene"])
    all_cells = [(cond_name, ds_name, is_conflict, is_noise)
                 for cond_name, is_conflict, is_noise in CONDITIONS
                 for ds_name in (normal_ds if cond_name == "Normal" else conflict_ds)]
    cells = [c for c in all_cells if c[0] in args.conditions]
    rows_file = RowsFile(args.rows_file, seeds, 6 + len(args.intermediate_fusion))
    rows = rows_file.load(all_cells)
    for seed in seeds:
        rows.setdefault(seed, {})
    t_start = time.time()
    # a sweep that raises still writes its trace
    with trace("uq_sweep", enabled=args.profile):
        if args.vmap_seeds or args.one_program_cells:
            _run_seed_batched(args, C, seeds, cells, device, rows, rows_file, mesh)
        else:
            for seed in seeds:
                for cond_name, ds_name, is_conflict, is_noise in cells:
                    by_ds = rows[seed].setdefault(cond_name, {})
                    if rows_file.complete(rows, cond_name, ds_name, [seed]):
                        print(f"  [{ds_name}/{cond_name}/seed{seed}] already complete "
                              f"(--rows-file), skipping", flush=True)
                        continue
                    by_ds[ds_name] = {}
                    run_condition(C=C, seed=seed, dataset_name=ds_name, conflict=is_conflict,
                                  noise=is_noise, quick=args.quick, device=device,
                                  rows_out=by_ds[ds_name], probe_engine=args.probe_engine,
                                  backbone=args.backbone, fused_dmvae=not args.no_fused_dmvae,
                                  intermediate_fusions=args.intermediate_fusion,
                                  dtype=args.dtype, mesh=mesh)
                    rows_file.save(rows)
    if not args.skip_report:
        report = Path(C("logging.datasets_excel_path", "logs/dataset_analysis.xlsx"))
        if args.backbone == "dssl":
            report = report.with_name(f"dssl_{report.name}")
        write_sweep_report(rows, str(report))
    print(f"sweep done in {time.time() - t_start:.1f}s")
    return rows


class RowsFile:
    """``--rows-file``: the sweep's rows as JSON at ``path`` (None: off),
    replaced whole through a ``.tmp`` file after every cell. A cell is
    complete when each of its seeds has ``n_models`` rows (skip rows
    count)."""

    def __init__(self, path, seeds, n_models: int):
        self.path = Path(path) if path else None
        self.seeds, self.n_models = list(seeds), n_models

    def complete(self, rows, cond_name, ds_name, seeds=None) -> bool:
        return self.path is not None and all(
            len(rows.get(s, {}).get(cond_name, {}).get(ds_name, {})) >= self.n_models
            for s in (self.seeds if seeds is None else seeds))

    def load(self, all_cells) -> dict:
        """The rows the file holds ({} without one), announcing how many
        cells of the configured datasets are complete."""
        if self.path is None or not self.path.exists():
            return {}
        rows = {int(s): conds for s, conds in json.loads(self.path.read_text()).items()}
        done = sum(self.complete(rows, cond, ds) for cond, ds, _, _ in all_cells)
        print(f"--rows-file: resuming; {done} completed cell(s) found", flush=True)
        return rows

    def save(self, rows) -> None:
        """Write the file (rank 0 alone under a process group; the others wait
        for it, so that every rank of a rerun finds the same cells)."""
        from ..parallel.distributed import barrier, is_writer

        if self.path is None:
            return
        if is_writer():
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(rows))
            tmp.replace(self.path)
        barrier()


def _run_seed_batched(args, C, seeds, cells, device, rows, rows_file, mesh=None):
    """The cells through ``--vmap-seeds`` or ``--one-program-cells``. A
    one-program cell's artifacts are written on a thread while the next
    cell runs; at most one such thread is outstanding, and it is joined
    before this returns or raises, so a finished cell's files are always
    complete. A cell's rows join ``rows``, and the rows file is written,
    only once its artifacts are."""
    pending = []

    def flush():
        while pending:
            thread, err = pending.pop()
            thread.join()
            if err:
                raise err[0]

    def record(cond_name, ds_name, rows_by_seed):
        for s in seeds:
            rows[s].setdefault(cond_name, {})[ds_name] = rows_by_seed[s]
        rows_file.save(rows)

    try:
        for cond_name, ds_name, is_conflict, is_noise in cells:
            if rows_file.complete(rows, cond_name, ds_name):
                print(f"  [{ds_name}/{cond_name}] already complete (--rows-file), skipping",
                      flush=True)
                continue
            rows_by_seed = {s: {} for s in seeds}
            kw = dict(C=C, seeds=seeds, dataset_name=ds_name, conflict=is_conflict,
                      noise=is_noise, quick=args.quick, device=device, rows_by_seed=rows_by_seed,
                      fused_dmvae=not args.no_fused_dmvae,
                      intermediate_fusions=args.intermediate_fusion, dtype=args.dtype,
                      mesh=mesh)
            if not args.one_program_cells:
                run_condition_vmapped(**kw)
                record(cond_name, ds_name, rows_by_seed)
                continue
            finish = run_condition_onejit(**kw, defer_artifacts=True)
            flush()  # the previous cell's artifacts
            err = []

            def work(finish=finish, err=err, cell=(cond_name, ds_name, rows_by_seed)):
                try:
                    finish()
                    record(*cell)
                except Exception as e:  # re-raised by flush
                    err.append(e)

            thread = threading.Thread(target=work, name="cell-artifacts")
            thread.start()
            pending.append((thread, err))
    finally:
        flush()


if __name__ == "__main__":
    main()

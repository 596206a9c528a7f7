"""Synthetic dependence sweep: seeds x dep in {0, 25, 50, 75, 100}.

Counterpart of ``disentagled_multimodal_fusion_tpu/runners/run_synthetic.py``
(reference: run_synthetic.py). For each (seed, dep), on the two-view
``SimpleTwoModalPlus`` data of the chosen preset with rho = shared class
fraction = dep / 100 (10 000 rows, 8000 train and 2000 validation; 1000
rows with ``--quick``):

1. the backbone: FusedDMVAE (embed 16, hidden 512, 100 epochs) or, with
   ``--backbone dssl``, DisentangledSSL (the same widths; its probes' shared
   input is the two shared codes side by side, 32 wide);
2. ``dmvae_cml``: the shared + private EvidentialProbe (cml, fused = 0, 50
   epochs) on the frozen embeddings;
3. ``cml`` and ``avg``: LateFusion on the raw views (fused = 0, 50 epochs);
4. evaluation on the validation rows (the probe in the with-shared layout,
   late fusion per view), CSV logs, checkpoints and the three-sheet report
   (main_grouped, all_results, grouped_results) at
   ``logs/synthetic_dataset.xlsx`` with CSV mirrors.

Every fit takes batches of 128 with ``drop_last``. The artifacts keep the
JAX package's names, whatever the backbone: ``{backbone}_seed{s}_dep{d}``,
``dmvae_fusion_seed{s}_dep{d}`` and ``late_fusion_seed{s}_dep{d}_agg{a}``
(checkpoints under ``checkpoints/``, logs under ``logs/``).

Engines:

* sequential (the default): one (seed, dep) at a time. ``--probe-engine
  step`` (the JAX package's ``xla``) fits everything with the eager step
  loop; ``megakernel`` fits the probe through the whole-epoch CUDA kernel.
* ``--vmap-seeds`` (DMVAE backbone only, as in the JAX package): all seeds
  of a dep at once, each fit one ``core.train.train_many`` over the stacked
  seeds, each validation one head-kernel launch at S x V heads. Rows,
  checkpoints and logs are written per seed under the sequential names.
  ``--probe-engine megakernel`` runs the sequential engine only, as in the
  JAX package (JAX ``:128-131``).

Randomness. The JAX package keys the sequential engine by
``split(PRNGKey(seed), 5)`` = (k_dmvae, k_probe, k_cml, k_avg, k_train),
the same key for every dep; here slot k seeds ``torch.Generator(seed * 16 +
k)``, so the slots depend on the seed alone: slot 0 draws the backbone's
weights, 1 the probe's, 2 and 3 the cml and avg late fusions'; slot 4 the
backbone fit's shuffles and noise (k_train), 5 the probe fit's
(``fold_in(k_train, 1)``), 6 and 7 the late-fusion fits'
(``fold_in(k_cml, 7)``, ``fold_in(k_avg, 7)``). ``--vmap-seeds`` uses fold
indices (JAX ``fold_in(PRNGKey(seed), i)``, ``:160-230``), index i seeding
``torch.Generator(runners.common.fold_seed(seed, i))``: 0 the backbone's
weights, 1 its fit, 10 + j head j's weights and 100 + j head j's fit, with
j = 0, 1, 2 for dmvae_cml, cml, avg. Fold seeds lie in [2**31, 2**32), so
their low 32 bits never meet a sequential slot.

``--no-fused-dmvae`` trains the per-modality DMVAE in both engines (same
checkpoint names). ``--dtype bfloat16`` (JAX lines 74-79) runs the DMVAE
backbone, the probe and late fusion with the bf16 compute type; the
DisentangledSSL backbone stays float32, as the JAX help text says (lines
47-51). Refused as not ported yet: the mesh flags. ``--force-vmap-seeds``
is accepted and changes nothing.

Examples:
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run_synthetic \
      --seeds 0 --deps 50 --probe-engine megakernel
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run_synthetic \
      --quick --seeds 0 --deps 50 --backbone dssl --device cpu
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run_synthetic \
      --quick --vmap-seeds --seeds 0 1 --deps 50 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.setup import resolve_device

BATCH_SIZE = 128  # reference: make_loaders_simple_plus default
# the med preset's values: the reference's effective code defaults
# (run_synthetic.py:26-41), the fallback of every preset key
PRESET_DEFAULTS = dict(
    n_samples=10000, d_signal=16, d_spurious=16, alpha_shared=0.7, beta_specific=0.6,
    class_sep_shared=1.1, class_sep_private=0.9, noise_std=0.7, hetero_noise=True,
    hetero_scale=0.4, nonlinear_shared=True, nonlinear_specific=False, conflict_frac=0.4,
    conflict_strength=0.7,
)


def preset_data_kwargs(C, preset: str, quick: bool) -> dict:
    """The generator's knobs of ``data.common_<preset>`` (1000 rows with
    ``quick``)."""
    kw = {k: C(f"data.common_{preset}.{k}", v) for k, v in PRESET_DEFAULTS.items()}
    if quick:
        kw["n_samples"] = 1000
    return kw


def make_cell(seed: int, dep: int, data_kw: dict):
    """The (seed, dep) cell's split as numpy: ((x1, x2), y) for train and
    for validation."""
    from ..data.synthetic import make_simple_plus_splits

    rho = dep / 100.0
    _, train, val = make_simple_plus_splits(batch_size=BATCH_SIZE, seed=seed, rho=rho,
                                            shared_class_frac=rho, **data_kw)
    return train, val


def checkpoint_name(model: str, seed: int, dep: int, backbone: str = "dmvae") -> str:
    """The JAX package's name (under ``checkpoints/`` and ``logs/``) of a
    model of the sweep: 'backbone', 'dmvae_cml', 'cml' or 'avg'."""
    if model == "backbone":
        return f"{backbone}_seed{seed}_dep{dep}"
    if model == "dmvae_cml":
        return f"dmvae_fusion_seed{seed}_dep{dep}"
    return f"late_fusion_seed{seed}_dep{dep}_agg{model}"


def cell_settings(C, quick: bool, dtype=None):
    """The sweep's settings as ``runners.run.CellSettings`` (the backbone
    fit reads them), with the compute type of ``--dtype``."""
    from .run import CellSettings

    return CellSettings(
        batch_size=BATCH_SIZE, lr=C("dmvae_fusion.lr", 3e-4),
        probe_hidden=tuple(C("dmvae_fusion.hidden_dim", (128,))),
        probe_dropout=C("dmvae_fusion.dropout", 0.1),
        annealing_start=C("dmvae_fusion.annealing_start", 10),
        probe_epochs=3 if quick else C("dmvae_fusion.num_epochs", 50),
        probe_input_dim=C("dmvae_fusion.input_dim", 16),
        dmvae_epochs=3 if quick else C("dmvae.num_epochs", 100),
        dmvae_hidden=C("dmvae.hidden_dim", 512), embed_dim=C("dmvae.embed_dim", 16),
        dmvae_a=C("dmvae.a", 1e-5), dmvae_dropout=0.0, dmvae_lr=C("dmvae.lr", 1e-3),
        dtype=dtype,
    )


def head_specs(C, st, view_dims, shared_dim: int, device, quick: bool):
    """[(label, builder(seed) -> task, kind, shared_layout, epochs)] in the
    JAX order, which fixes each head's slots and fold indices: the probe
    (kind 'probe', on the embeddings), then late fusion cml and avg (kind
    'raw', on the views)."""
    from ..core.tasks import build_late_fusion_task, build_probe_task

    late_epochs = 3 if quick else C("latefusion.num_epochs", 50)

    def probe(seed):
        return build_probe_task(
            seed=seed, num_modalities=2, num_classes=C("dmvae_fusion.num_classes", 3),
            input_dim=st.probe_input_dim, hidden_dim=st.probe_hidden, lr=st.lr,
            dropout=st.probe_dropout, annealing_start=st.annealing_start,
            aggregation=C("dmvae_fusion.aggregation", "cml"), fused=0.0,
            num_epochs=st.probe_epochs, shared_input_dim=shared_dim, dtype=st.dtype,
            device=device)

    def late(agg):
        return lambda seed: build_late_fusion_task(
            seed=seed, output_dims=view_dims, num_classes=C("latefusion.num_classes", 3),
            hidden_dim=tuple(C("latefusion.hidden_dim", (128,))),
            dropout=C("latefusion.dropout", 0.1), lr=C("latefusion.lr", 3e-4),
            annealing_start=C("latefusion.annealing_start", 10), aggregation=agg, fused=0.0,
            dtype=st.dtype, device=device)

    return [("dmvae_cml", probe, "probe", True, st.probe_epochs),
            ("cml", late("cml"), "raw", False, late_epochs),
            ("avg", late("avg"), "raw", False, late_epochs)]


def _upload(arrays, device):
    (x1, x2), y = arrays
    return (tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (x1, x2)),
            torch.from_numpy(y).to(device))


def run_cell(*, C, st, seed: int, dep: int, data_kw: dict, backbone: str, probe_engine: str,
             quick: bool, device, rows_out: dict, fused_dmvae: bool = True):
    """Train and evaluate the three models of one (seed, dep) cell into
    ``rows_out``; each row also carries its fit's wall time and the
    backbone's (and, over DSSL, the vMF sampler's host syncs per epoch)."""
    from ..core.checkpoint import save_checkpoint
    from ..core.logging import log_training_csv
    from ..core.sweep_cell import head_data
    from ..core.tasks import embed_dataset
    from ..core.train import Randomness, train
    from ..eval.analysis import evaluate_subjective_model, evaluate_subjective_model_with_shared
    from .run import fit_backbone

    t0 = time.time()
    train_np, val_np = make_cell(seed, dep, data_kw)
    xs_tr, y_tr = _upload(train_np, device)
    xs_va, y_va = _upload(val_np, device)
    n_train = xs_tr[0].shape[0]
    view_dims = [int(x.shape[1]) for x in xs_tr]  # d_signal + d_spurious of the preset

    def slot(k):
        return seed * 16 + k

    tag = f"[seed {seed} dep {dep}]"
    model, widths, bb_info = fit_backbone(C=C, st=st, backbone=backbone, dims=view_dims,
                                          xs_tr=xs_tr, n_train=n_train, seeds=(slot(0), slot(4)),
                                          device=device, tag=tag, drop_last=True,
                                          fused_dmvae=fused_dmvae)
    save_checkpoint(f"checkpoints/{checkpoint_name('backbone', seed, dep, backbone)}", model,
                    {"seed": seed, "dep": dep, "model": backbone})
    data = head_data(embed_dataset(model, xs_tr), embed_dataset(model, xs_va), xs_tr, xs_va,
                     y_tr, y_va)
    shared_dim = widths.get("shared_input_dim", st.embed_dim)
    for j, (label, builder, kind, shared_layout, epochs) in enumerate(
            head_specs(C, st, view_dims, shared_dim, device, quick)):
        task = builder(slot(1 + j))
        tr_data, va_data = data[kind]
        t_fit = time.perf_counter()
        res = train(model=task.model, loss_fn=task.loss_fn, data=tr_data, n_train=n_train,
                    optimizer=task.optimizer, epochs=epochs, batch_size=BATCH_SIZE,
                    randomness=Randomness(slot(5 + j), device), val_fn=task.val_fn,
                    val_data=va_data, drop_last=True,
                    megakernel=task.megakernel if probe_engine == "megakernel" else None)
        fit_s = time.perf_counter() - t_fit
        evaluate = (evaluate_subjective_model_with_shared if shared_layout
                    else evaluate_subjective_model)
        info = evaluate(task, va_data)
        name = checkpoint_name(label, seed, dep)
        log_training_csv(name, res)
        info["path"] = save_checkpoint(f"checkpoints/{name}", task.model,
                                       {"seed": seed, "dep": dep, "model": label})
        info.update(bb_info, fit_seconds=fit_s)
        rows_out[label] = info
        print(f"  {tag} {label}: fused_acc={info['fused']['accuracy']:.4f} "
              f"val_acc_last={float(res.val_acc[-1]):.4f} fit {fit_s:.2f} s, "
              f"{1e3 * fit_s / epochs:.3f} ms/epoch", flush=True)
    acc = rows_out["dmvae_cml"]["fused"]["accuracy"]
    print(f"[seed {seed} dep {dep}] dmvae_cml fused acc {acc:.3f}  ({time.time() - t0:.1f}s)",
          flush=True)


def run_dep_vmapped(*, C, st, seeds, dep: int, data_kw: dict, quick: bool, device, rows: dict,
                    fused_dmvae: bool = True):
    """All seeds of one dep at once (DMVAE backbone): each fit one
    ``train_many`` over the stacked seeds, its results fetched and written
    per seed under the sequential engine's names. Rows carry ``fit_seconds``
    (the seed-batched fit, evaluation and fetch) and
    ``backbone_fit_seconds``."""
    from ..core.checkpoint import save_checkpoint
    from ..core.logging import log_training_csv
    from ..core.sweep_cell import CellJob, fit_job, head_data, job_rows
    from ..core.tasks import dmvae_objective, embed_many
    from ..core.train import Randomness, TrainResult, load_params, stack_params, train_many
    from ..eval.analysis import fetch
    from .common import fold_seed
    from .run import build_backbone

    t0 = time.time()
    cells = [make_cell(s, dep, data_kw) for s in seeds]

    def stack(arrays):
        return torch.from_numpy(np.stack(arrays)).to(device)

    xs_tr = tuple(stack([c[0][0][v] for c in cells]) for v in range(2))
    xs_va = tuple(stack([c[1][0][v] for c in cells]) for v in range(2))
    y_tr, y_va = stack([c[0][1] for c in cells]), stack([c[1][1] for c in cells])
    n_train = xs_tr[0].shape[1]
    view_dims = [int(x.shape[2]) for x in xs_tr]

    backbones = [build_backbone(st, view_dims, fold_seed(s, 0), device, fused=fused_dmvae)
                 for s in seeds]
    loss_fn, opt = dmvae_objective(backbones[0], lr=st.dmvae_lr, num_epochs=st.dmvae_epochs)
    t_fit = time.perf_counter()
    res = train_many(model=backbones[0], params=stack_params(backbones), loss_fn=loss_fn,
                     data={"xs": xs_tr}, n_train=n_train, optimizer=opt,
                     epochs=st.dmvae_epochs, batch_size=BATCH_SIZE,
                     randomness=[Randomness(fold_seed(s, 1), device) for s in seeds],
                     drop_last=True)
    last = res.train_loss[:, -1].tolist()
    bb_s = time.perf_counter() - t_fit
    print(f"  [dep {dep}] dmvae fit x{len(seeds)} seeds: {bb_s:.2f} s, "
          f"{1e3 * bb_s / st.dmvae_epochs:.3f} ms/epoch, last train losses "
          f"{[round(x, 4) for x in last]}", flush=True)
    load_params(backbones, res.params)
    for backbone, s in zip(backbones, seeds):
        save_checkpoint(f"checkpoints/{checkpoint_name('backbone', s, dep)}", backbone,
                        {"seed": s, "dep": dep, "model": "dmvae"})
    data = head_data(embed_many(backbones[0], res.params, xs_tr),
                     embed_many(backbones[0], res.params, xs_va), xs_tr, xs_va, y_tr, y_va)
    for j, (label, builder, kind, shared_layout, epochs) in enumerate(
            head_specs(C, st, view_dims, st.embed_dim, device, quick)):
        job = CellJob(name=label, tasks=[builder(fold_seed(s, 10 + j)) for s in seeds],
                      randomness=[Randomness(fold_seed(s, 100 + j), device) for s in seeds],
                      kind=kind, epochs=epochs, shared_layout=shared_layout)
        t_fit = time.perf_counter()
        fetched = fetch(fit_job(job, data[kind], n_train, BATCH_SIZE, drop_last=True))
        fit_s = time.perf_counter() - t_fit
        per_seed = job_rows(job, fetched, seeds)
        load_params([t.model for t in job.tasks], fetched["params"])
        for i, s in enumerate(seeds):
            name = checkpoint_name(label, s, dep)
            log_training_csv(name, TrainResult(
                train_loss=fetched["train_loss"][i], val_loss=fetched["val_loss"][i],
                val_acc=fetched["val_acc"][i], final_lr=float(fetched["final_lr"][i])))
            info = per_seed[int(s)]
            info["path"] = save_checkpoint(f"checkpoints/{name}", job.tasks[i].model,
                                           {"seed": s, "dep": dep, "model": label})
            info.update(fit_seconds=fit_s, backbone_fit_seconds=bb_s)
            rows[s].setdefault(dep, {})[label] = info
        accs = [rows[s][dep][label]["fused"]["accuracy"] for s in seeds]
        print(f"  [dep {dep}] {label} x{len(seeds)}: fused_acc {np.mean(accs):.4f} +/- "
              f"{np.std(accs):.4f}, fit {fit_s:.2f} s, {1e3 * fit_s / epochs:.3f} ms/epoch",
              flush=True)
    accs = [rows[s][dep]["dmvae_cml"]["fused"]["accuracy"] for s in seeds]
    print(f"[dep {dep}] x{len(seeds)} seeds: dmvae_cml fused acc {np.mean(accs):.3f} +/- "
          f"{np.std(accs):.3f} ({time.time() - t0:.1f}s)", flush=True)


def write_synthetic_report(rows, excel_path: str):
    """Flatten rows[seed][dep][model] and write the three-sheet report
    (main_grouped, all_results, grouped_results), grouped by (dep, model)."""
    from ..eval.analysis import build_metrics_rows
    from .common import Table, group_mean, main_columns, write_report

    columns, dicts = build_metrics_rows(rows)
    for d in dicts:
        d["seed"], d["dep"] = int(d["seed"]), float(d["dep"])
    table = Table.from_dicts(columns, dicts)
    keys = ["dep", "model"]
    write_report(
        {
            "main_grouped": group_mean(main_columns(table, ["seed", *keys]), keys),
            "all_results": table,
            "grouped_results": group_mean(table, keys),
        },
        excel_path,
    )
    return table


def parse_args(argv=None):
    from .common import add_force_vmap_flag

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--seeds", type=int, nargs="*", default=None)
    parser.add_argument("--deps", type=int, nargs="*", default=None)
    parser.add_argument("--quick", action="store_true",
                        help="3 epochs per fit and 1000 rows, for smoke testing")
    parser.add_argument("--probe-engine", choices=["step", "megakernel"], default="step",
                        help="'step' (the JAX package's 'xla'): every fit as the eager step "
                             "loop; 'megakernel': the probe fit through the whole-epoch CUDA "
                             "kernel (sequential engine only)")
    parser.add_argument("--vmap-seeds", action="store_true",
                        help="train all seeds of each dep at once, each fit over the stacked "
                             "seeds (DMVAE backbone)")
    parser.add_argument("--preset", choices=["easy", "med", "hard"], default="med",
                        help="synthetic difficulty preset (data.common_<preset>)")
    parser.add_argument("--backbone", choices=["dmvae", "dssl"], default="dmvae",
                        help="disentangling backbone: DMVAE (the reference protocol) or "
                             "DisentangledSSL")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "PyTorch path)")
    parser.add_argument("--no-fused-dmvae", action="store_true",
                        help="train the per-modality DMVAE instead of the fused one")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                        help="the products' compute type for the DMVAE, probe and late-fusion "
                             "fits (parameters, optimizer state and losses stay float32; the "
                             "DisentangledSSL backbone always runs float32)")
    # options of the JAX runner that the port does not have yet (ROADMAP.md)
    parser.add_argument("--data-parallel", type=int, default=1)
    parser.add_argument("--model-parallel", type=int, default=1)
    add_force_vmap_flag(parser)
    args = parser.parse_args(argv)
    if args.probe_engine == "megakernel" and args.vmap_seeds:
        parser.error("--probe-engine megakernel runs the sequential path only (train_many has "
                     "no kernel program)")
    if args.backbone == "dssl" and args.vmap_seeds:
        parser.error("--vmap-seeds trains the DMVAE backbone only (the SSL backbone has no "
                     "seed-batched trainer, as in the JAX package)")
    if args.data_parallel > 1 or args.model_parallel > 1:
        parser.error("--data-parallel/--model-parallel: not ported yet (see ROADMAP.md)")
    return args


def main(argv=None):
    """Run the sweep; returns rows[seed][dep][model]."""
    from .common import load_config, make_getter

    args = parse_args(argv)
    device = resolve_device(args.device)
    C = make_getter(load_config("synthetic_config.yaml"))
    seeds = args.seeds if args.seeds is not None else C("experiment.seeds", [0, 1, 2, 3, 4])
    deps = args.deps if args.deps is not None else C("experiment.deps", [0, 25, 50, 75, 100])
    data_kw = preset_data_kwargs(C, args.preset, args.quick)
    st = cell_settings(C, args.quick, args.dtype)
    t_start = time.time()
    rows = {seed: {} for seed in seeds}
    if args.vmap_seeds:
        for dep in deps:
            run_dep_vmapped(C=C, st=st, seeds=seeds, dep=dep, data_kw=data_kw,
                            quick=args.quick, device=device, rows=rows,
                            fused_dmvae=not args.no_fused_dmvae)
    else:
        for seed in seeds:
            for dep in deps:
                run_cell(C=C, st=st, seed=seed, dep=dep, data_kw=data_kw,
                         backbone=args.backbone, probe_engine=args.probe_engine,
                         quick=args.quick, device=device, rows_out=rows[seed].setdefault(dep, {}),
                         fused_dmvae=not args.no_fused_dmvae)
    write_synthetic_report(rows, C("logging.excel_path", "logs/synthetic_dataset.xlsx"))
    print(f"sweep done in {time.time() - t_start:.1f}s")
    return rows


if __name__ == "__main__":
    main()

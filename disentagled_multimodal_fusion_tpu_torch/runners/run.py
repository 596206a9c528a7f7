"""UQ-datasets sweep: seeds x {Normal, Conflict, Noise} x datasets x 6 models.

Counterpart of ``disentagled_multimodal_fusion_tpu/runners/run.py``, its
sequential engine (``run_condition``, ``main``, ``write_sweep_report``).
Per (seed, condition, dataset):

1. the 80/20 split on the legacy ``np.random`` stream seeded with the seed;
   Conflict (Noise) injects cross-class view conflicts (Gaussian noise) into
   the test rows only;
2. the FusedDMVAE backbone fit (Adam + cosine, exact ragged tail);
3. frozen embeddings of both splits;
4. six head fits with val = test: ``dmvae_dis`` (private-only probe),
   ``dmvae_cml`` and ``dmvae_joint`` (shared + private probes), and
   ``dbf``/``cml``/``avg`` ``_fusion`` (late fusion on the raw views);
5. evaluation (``dmvae_dis`` in the per-view layout, every other model in
   the with-shared layout, which labels late fusion's view 0 "shared", a
   reference quirk kept for column parity), CSV logs, checkpoints, and the
   three-sheet report at ``logs/dataset_analysis.xlsx`` with CSV mirrors.

``--probe-engine``: ``step`` (the default; the JAX package's ``xla``) runs
every fit as the eager step loop of ``core/train.py``; ``megakernel`` (the
same name in the JAX package) runs the three probe fits through the
whole-epoch CUDA kernel (``core/megakernel.py``). The late-fusion fits are
Adam fits and keep the step loop either way, as in the JAX package.

Randomness: the cell's ``cell_seed`` s fixes 16 key slots, slot k seeding
``torch.Generator(s * 16 + k)``: slot 0 draws the backbone's weights, slot
1 its fit's shuffles and noise, slots 2-7 the six heads' weights and slots
8-13 their fits' shuffles and dropout masks (the JAX package's
``keys[0..13]`` of ``jax.random.split(PRNGKey(s), 16)``). Weights are drawn
on the CPU; a fit's draws come from a generator on its device.

Examples:
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run \
      --seeds 0 --datasets HandWritten --conditions Normal --probe-engine megakernel
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run \
      --quick --seeds 0 --datasets CUB --conditions Normal --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.setup import resolve_device

CONDITIONS = (("Normal", False, False), ("Conflict", True, False), ("Noise", False, True))


def run_condition(*, C, seed, dataset_name, conflict, quick, device, rows_out,
                  noise=False, probe_engine="step"):
    """Train and evaluate the six models of one cell into ``rows_out``."""
    from ..core.checkpoint import save_checkpoint
    from ..core.logging import log_training_csv
    from ..core.tasks import (
        build_disentangled_probe_task,
        build_dmvae_task,
        build_late_fusion_task,
        build_probe_task,
        dmvae_objective,
        embed_dataset,
    )
    from ..core.train import Randomness, train
    from ..data.multiview import DATASET_REGISTRY
    from ..eval.analysis import evaluate_subjective_model, evaluate_subjective_model_with_shared
    from .common import cell_seed

    t0 = time.time()
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

    def upload(rows):
        return (tuple(torch.from_numpy(np.ascontiguousarray(v[rows])).to(device) for v in views),
                torch.from_numpy(labels[rows]).to(device))

    xs_tr, y_tr = upload(train_idx)
    xs_te, y_te = upload(test_idx)
    num_classes = dataset.num_classes
    dims = [int(d[0]) for d in dataset.dims]
    n_train = len(train_idx)
    batch_size = C("dataloader.batch_size", 100)
    lr = C("optim.dataset_lr", {}).get(
        dataset_name,
        {"CalTech": 3e-4, "Scene": 0.01, "CUB": 3e-3, "HandWritten": 3e-3, "PIE": 3e-3}[
            dataset_name
        ],
    )
    probe_hidden = tuple(C("probes.model_hidden_dim", (128,)))
    probe_dropout = C("probes.dropout_p", 0.1)
    annealing_start = C("probes.annealing_start", 50)
    probe_epochs = 2 if quick else C("probes.model_epochs", 200)
    dmvae_epochs = 2 if quick else C("dmvae.num_epochs", 100)
    embed_dim = C("dmvae.embed_dim", 200)
    probe_input_dim = C("probes.input_dim", 200)
    base = cell_seed(seed, dataset_name, conflict)

    def slot(k):
        return base * 16 + k

    cond = "conflict" if conflict else ("noise" if noise else "normal")
    backbone = build_dmvae_task(
        seed=slot(0), output_dim=dims, hidden_dim=C("dmvae.hidden_dim", 512),
        embed_dim=embed_dim, a=C("dmvae.a", 1e-5), dropout=C("dmvae.dropout", 0.0),
        fused_modalities=True, device=device,
    )
    loss_fn, opt = dmvae_objective(backbone, lr=C("dmvae.lr", 1e-4), num_epochs=dmvae_epochs)
    t_fit = time.perf_counter()
    res = train(model=backbone, loss_fn=loss_fn, data={"xs": xs_tr}, n_train=n_train,
                optimizer=opt, epochs=dmvae_epochs, batch_size=batch_size,
                randomness=Randomness(slot(1), device))
    fit_s = time.perf_counter() - t_fit
    print(f"  [{dataset_name}/{cond}/seed{seed}] dmvae fit: {fit_s:.2f} s, "
          f"{1e3 * fit_s / dmvae_epochs:.3f} ms/epoch, last train loss "
          f"{float(res.train_loss[-1]):.4f}", flush=True)
    save_checkpoint(f"checkpoints/dmvae_dataset{dataset_name}_seed{seed}_a1e-05_{cond}",
                    backbone, {"dataset": dataset_name, "seed": seed, "cond": cond})
    zc_tr, zp_tr = embed_dataset(backbone, xs_tr)
    zc_te, zp_te = embed_dataset(backbone, xs_te)
    probe_train = {"zc": zc_tr, "zp": zp_tr, "y": y_tr}
    probe_test = {"zc": zc_te, "zp": zp_te, "y": y_te}
    lf_train = {"xs": xs_tr, "y": y_tr}
    lf_test = {"xs": xs_te, "y": y_te}
    num_modalities = len(dims)
    head = dict(num_classes=num_classes, hidden_dim=probe_hidden, lr=lr, dropout=probe_dropout,
                annealing_start=annealing_start, device=device)
    probe = dict(head, num_modalities=num_modalities, input_dim=probe_input_dim,
                 num_epochs=probe_epochs)

    # the six models, in the JAX package's order (its lines 167-199)
    jobs = [("dmvae_dis", build_disentangled_probe_task(seed=slot(2), **probe),
             probe_train, probe_test)]
    for k, agg in ((3, "cml"), (4, "joint")):
        jobs.append((f"dmvae_{agg}",
                     build_probe_task(seed=slot(k), aggregation=agg, fused=1.0, **probe),
                     probe_train, probe_test))
    for k, agg in ((5, "dbf"), (6, "cml"), (7, "avg")):
        jobs.append((f"{agg}_fusion",
                     build_late_fusion_task(seed=slot(k), output_dims=dims, aggregation=agg,
                                            fused=1.0, **head),
                     lf_train, lf_test))

    for i, (name, task, tr_data, te_data) in enumerate(jobs):
        t_fit = time.perf_counter()
        res_m = train(
            model=task.model, loss_fn=task.loss_fn, data=tr_data, n_train=n_train,
            optimizer=task.optimizer, epochs=probe_epochs, batch_size=batch_size,
            randomness=Randomness(slot(8 + i), device), val_fn=task.val_fn, val_data=te_data,
            megakernel=task.megakernel if probe_engine == "megakernel" else None,
        )
        fit_s = time.perf_counter() - t_fit
        if name == "dmvae_dis":
            info = evaluate_subjective_model(task, te_data)
        else:
            info = evaluate_subjective_model_with_shared(task, te_data)
        # the doubled suffix of late fusion (cml_fusion_fusion_ds...) is the
        # reference's own name template, kept so artifact names match
        model_name = (f"{name}_fusion_ds{dataset_name}_seed{seed}"
                      + ("_conflict" if conflict else "_noise" if noise else ""))
        log_training_csv(model_name, res_m)
        info["path"] = save_checkpoint(f"checkpoints/{model_name}", task.model,
                                       {"model": name, "dataset": dataset_name, "seed": seed})
        info["fit_seconds"] = fit_s
        rows_out[name] = info
        print(
            f"  [{dataset_name}/{cond}/seed{seed}] {name}: "
            f"fused_acc={info['fused']['accuracy']:.4f} "
            f"val_acc_last={float(res_m.val_acc[-1]):.4f} "
            f"fit {fit_s:.2f} s, {1e3 * fit_s / probe_epochs:.3f} ms/epoch",
            flush=True,
        )
    print(f"  {dataset_name}/{cond}/seed{seed} done in {time.time() - t0:.1f}s", flush=True)


def write_sweep_report(rows, excel_path):
    """Flatten nested rows[seed][condition][dataset][model] and write the
    three-sheet report (main_grouped, all_results, grouped_results)."""
    from ..eval.analysis import build_metrics_rows_datasets
    from .common import Table, group_mean, main_columns, write_report

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
    return table


NOT_PORTED = {
    "vmap_seeds": "--vmap-seeds", "one_program_cells": "--one-program-cells",
    "rows_file": "--rows-file", "profile": "--profile",
    "intermediate_fusion": "--intermediate-fusion",
}


def parse_args(argv=None):
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
                             "CUDA kernel")
    parser.add_argument("--skip-report", action="store_true", help="skip the report write")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "PyTorch path)")
    # options of the JAX runner that the port does not have yet (ROADMAP.md)
    parser.add_argument("--backbone", choices=["dmvae", "dssl"], default="dmvae")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    parser.add_argument("--data-parallel", type=int, default=1)
    parser.add_argument("--model-parallel", type=int, default=1)
    for dest, flag in NOT_PORTED.items():
        if dest in ("rows_file", "intermediate_fusion"):
            parser.add_argument(flag, nargs="*", default=None)
        else:
            parser.add_argument(flag, action="store_true")
    args = parser.parse_args(argv)
    used = [flag for dest, flag in NOT_PORTED.items() if getattr(args, dest)]
    if args.backbone != "dmvae":
        used.append("--backbone dssl")
    if args.dtype != "float32":
        used.append("--dtype bfloat16")
    if args.data_parallel > 1 or args.model_parallel > 1:
        used.append("--data-parallel/--model-parallel")
    if used:
        parser.error(f"{', '.join(used)}: not ported yet (see ROADMAP.md)")
    return args


def main(argv=None):
    """Run the sweep; returns rows[seed][condition][dataset][model]."""
    from .common import load_config, make_getter

    args = parse_args(argv)
    device = resolve_device(args.device)
    C = make_getter(load_config())
    seeds = args.seeds if args.seeds is not None else C("experiment.seeds", [0, 1, 2, 3, 4])
    normal_ds = args.datasets or C("experiment.normal_datasets",
                                   ["CUB", "HandWritten", "PIE", "Scene"])
    conflict_ds = args.datasets or C("experiment.conflict_datasets",
                                     ["CUB", "HandWritten", "PIE", "Scene"])
    t_start = time.time()
    rows = {}
    for seed in seeds:
        rows[seed] = {}
        for cond_name, is_conflict, is_noise in CONDITIONS:
            if cond_name not in args.conditions:
                continue
            rows[seed][cond_name] = {}
            for ds_name in (normal_ds if cond_name == "Normal" else conflict_ds):
                rows[seed][cond_name][ds_name] = {}
                run_condition(C=C, seed=seed, dataset_name=ds_name, conflict=is_conflict,
                              noise=is_noise, quick=args.quick, device=device,
                              rows_out=rows[seed][cond_name][ds_name],
                              probe_engine=args.probe_engine)
    if not args.skip_report:
        write_sweep_report(rows, C("logging.datasets_excel_path", "logs/dataset_analysis.xlsx"))
    print(f"sweep done in {time.time() - t_start:.1f}s")
    return rows


if __name__ == "__main__":
    main()

"""LUMA 3-modality protocol: DMVAE with real feature encoders + six
probe/baseline models.

Counterpart of ``disentagled_multimodal_fusion_tpu/runners/run_luma.py``, its
sequential engine (JAX lines 447-567). Per seed:

1. featurize the compiled corpus (``data/luma.py``; cached beside it);
2. fit FusedDMVAE (or with ``--no-fused-dmvae`` the per-modality DMVAE)
   over the Audio, Text and Image feature encoders (Adam + cosine, batch
   64, exact ragged tail), whose BatchNorm statistics train with it;
3. embed the train, test and (``--ood-eval``) OOD rows in eval mode;
4. fit the six models with val = test: ``dmvae_dis``, ``dmvae_cml`` and
   ``dmvae_joint`` (probes on the embeddings), ``dbf_fusion``,
   ``cml_fusion`` and ``avg_fusion`` (late fusion over their own Audio,
   Text and Image encoders, the stacked heads on the encoders' 200-wide
   outputs); with ``--include-intermediate`` / ``--intermediate-fusion
   NAME...`` one IntermediateFusion per library fusion over the encoders
   (a fusion refused for three 200-wide views becomes a skip row);
5. evaluate (``dmvae_dis`` and the intermediate fusions in the per-view
   layout, the others with the shared layout), and with ``--ood-eval`` the
   AUROC of OOD-vs-ID separation by each uncertainty (``eval/ood.py``) from
   the fused evidence of the test rows and of the held-out classes' rows;
6. write checkpoints (``dmvae_datasetLUMA_seed{s}_a1e-05_normal`` and
   ``{name}_fusion_dsLUMA_seed{s}``; a module's checkpoint holds its
   BatchNorm statistics), CSV logs, ``logs/luma_analysis.xlsx`` (three
   sheets, CSV mirrors) and ``logs/luma_ood.json`` (per model, the mean over
   seeds and each seed's AUROCs, derived from the rows).

``--rows-file PATH`` writes the rows after every seed; a rerun skips each
seed that has all its rows (skip rows count) and writes the reports from
the rows. Epochs default to the reference's debug values (DMVAE 3, heads 2;
``--dmvae-epochs``, ``--probe-epochs``). Images are the corpus's unless
``--replicate-image-bug``; ``--use-2d`` featurizes (n_mfcc, frames) MFCC maps
for the audio encoder's conv branch; ``--use-ood`` trains on every class
(and cannot be combined with ``--ood-eval``).

Randomness follows the JAX key layout of ``jax.random.split(PRNGKey(seed),
16)`` through stand-in generator seeds: slot k seeds ``torch.Generator(seed
* 16 + k)``. Slot 0 draws the DMVAE's weights, 1 its fit's shuffles, noise
and encoder masks, 2-7 the six models' weights, 8-13 their fits' draws and
15 concat's weights. The JAX package folds the other intermediate keys
(fusion m's weights from ``fold_in(keys[15], m)``, job i's fit from
``fold_in(keys[8], 1000 + i)``); their stand-ins are
``runners.common.intermediate_seed(seed, m)`` and ``intermediate_seed(seed,
8 + i)``, which never meet a slot.

The port runs on the CUDA card unless ``--device cpu``. Not ported yet
(``ROADMAP.md``): ``--vmap-seeds`` and ``--segment-epochs`` (seed-batched
LUMA), ``--dtype bfloat16`` and the mesh flags.

Example:
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run_luma \\
      --data-path data/luma_compiled --seeds 0 --ood-eval
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.setup import resolve_device

# options of the JAX runner that the port does not have yet (ROADMAP.md)
NOT_PORTED = ("--vmap-seeds", "--segment-epochs", "--dtype bfloat16",
              "--data-parallel/--model-parallel")
ENC_OUT = 200  # the Audio/Text/Image encoders' output width


def feature_configs(C, use_2d: bool = False):
    """(audio, text, image) featurization settings from the config."""
    audio = {
        "sample_rate": C("data.audio.sample_rate", 16000),
        "max_length": C("data.audio.max_length", 3.0),
        "n_mfcc": C("data.audio.n_mfcc", 40),
        "use_mfcc": C("data.audio.use_mfcc", True),
        "use_2d": use_2d or C("data.audio.use_2d", False),
    }
    text = {
        "max_length": C("data.text.max_length", 128),
        "model_name": C("data.text.model_name", "bert-base-uncased"),
        "use_pretrained": C("data.text.use_pretrained", True),
    }
    image = {"size": tuple(C("data.image.size", (32, 32))),
             "normalize": C("data.image.normalize", True)}
    return audio, text, image


def encoder_specs(audio_cfg, text_cfg):
    """The Audio, Text and Image encoders (reference run_luma.py:199-203)."""
    return (("AudioEncoder", dict(input_dim=audio_cfg["n_mfcc"], output_dim=ENC_OUT, dropout=0.1,
                                  use_2d=bool(audio_cfg["use_2d"]))),
            ("TextEncoder", dict(input_dim=text_cfg["max_length"], output_dim=ENC_OUT,
                                 dropout=0.1)),
            ("ImageEncoder", dict(output_dim=ENC_OUT, dropout=0.1)))


def head_builders(C, num_classes: int, probe_epochs: int, specs, device):
    """{name: (seed -> task)} of the six models, in the protocol's order."""
    from ..core.tasks import (
        build_disentangled_probe_task,
        build_late_fusion_task,
        build_probe_task,
    )

    head = dict(num_classes=num_classes, hidden_dim=tuple(C("probes.model_hidden_dim", (128,))),
                lr=C("optim.luma_lr", 3e-4), dropout=C("probes.dropout_p", 0.1),
                annealing_start=C("probes.annealing_start", 50), device=device)
    probe = dict(head, num_modalities=3, input_dim=C("probes.input_dim", 200),
                 num_epochs=probe_epochs)
    builders = {"dmvae_dis": lambda s: build_disentangled_probe_task(seed=s, **probe)}
    for agg in ("cml", "joint"):
        builders[f"dmvae_{agg}"] = (lambda agg: lambda s: build_probe_task(
            seed=s, aggregation=agg, fused=1.0, **probe))(agg)
    for agg in ("dbf", "cml", "avg"):
        builders[f"{agg}_fusion"] = (lambda agg: lambda s: build_late_fusion_task(
            seed=s, output_dims=[ENC_OUT] * 3, aggregation=agg, fused=1.0,
            feature_encoders=specs, **head))(agg)
    return builders


def intermediate_builder(C, num_classes: int, fusion: str, specs, device):
    from ..core.tasks import build_intermediate_fusion_task

    return lambda s: build_intermediate_fusion_task(
        seed=s, output_dims=[ENC_OUT] * 3, num_classes=num_classes,
        dropout=C("probes.dropout_p", 0.1), lr=C("optim.luma_lr", 3e-4),
        annealing_start=C("probes.annealing_start", 50), fusion=fusion,
        feature_encoders=specs, device=device)


def build_backbone(C, seed: int, specs, device, fused: bool = True):
    """The LUMA DMVAE over the encoders of ``specs``."""
    from ..core.tasks import build_dmvae_task

    return build_dmvae_task(seed=seed, output_dim=[ENC_OUT] * 3,
                            hidden_dim=C("dmvae.hidden_dim", 512),
                            embed_dim=C("dmvae.embed_dim", 200), a=C("dmvae.a", 1e-5),
                            dropout=C("dmvae.dropout", 0.0), fused_modalities=fused,
                            feature_encoders=specs, device=device)


def backbone_checkpoint(seed: int) -> str:
    return f"checkpoints/dmvae_datasetLUMA_seed{seed}_a1e-05_normal"


def head_checkpoint(name: str, seed: int) -> str:
    return f"checkpoints/{name}_fusion_dsLUMA_seed{seed}"


def to_device(arrays, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def ood_info(task, id_data, ood_data, num_classes: int):
    """OOD-vs-ID AUROCs from the fused evidence of each split."""
    from ..eval.analysis import task_evidences
    from ..eval.ood import evaluate_ood

    ev_id = task.aggregation(task_evidences(task, id_data))
    ev_ood = task.aggregation(task_evidences(task, ood_data))
    return evaluate_ood(ev_id, ev_ood, num_classes)


def run_seed(*, C, seed: int, data, specs, jobs, num_classes: int, dmvae_epochs: int,
             probe_epochs: int, device, fused_dmvae: bool, rows_out: dict):
    """Fit and evaluate one seed's models into ``rows_out``. ``data``:
    {'xs_tr', 'y_tr', 'xs_te', 'y_te', 'xs_ood' (or None)}; ``jobs``:
    [(name, seed -> task, fusion or None)] in the protocol's order."""
    from ..core.checkpoint import save_checkpoint
    from ..core.logging import log_training_csv
    from ..core.tasks import dmvae_objective, embed_dataset_chunked
    from ..core.train import Randomness, train
    from ..eval.analysis import evaluate_subjective_model, evaluate_subjective_model_with_shared
    from ..models.fusions import INTERMEDIATE_FUSIONS
    from .common import intermediate_seed

    def slot(k):
        return seed * 16 + k

    batch_size = C("dataloader.batch_size", 64)
    xs_tr, y_tr, xs_te, y_te, xs_ood = (data[k] for k in ("xs_tr", "y_tr", "xs_te", "y_te",
                                                          "xs_ood"))
    n_train = int(y_tr.shape[0])
    t0 = time.time()
    model = build_backbone(C, slot(0), specs, device, fused=fused_dmvae)
    loss_fn, opt = dmvae_objective(model, lr=C("dmvae.lr", 1e-4), num_epochs=dmvae_epochs)
    t_fit = time.perf_counter()
    res = train(model=model, loss_fn=loss_fn, data={"xs": xs_tr}, n_train=n_train, optimizer=opt,
                epochs=dmvae_epochs, batch_size=batch_size, randomness=Randomness(slot(1), device))
    fit_s = time.perf_counter() - t_fit
    save_checkpoint(backbone_checkpoint(seed), model, {"dataset": "LUMA", "seed": seed})
    print(f"[seed {seed}] DMVAE trained: {fit_s:.2f} s, {1e3 * fit_s / dmvae_epochs:.3f} ms/epoch, "
          f"last train loss {float(res.train_loss[-1]):.4f}", flush=True)

    zc_tr, zp_tr = embed_dataset_chunked(model, xs_tr)
    zc_te, zp_te = embed_dataset_chunked(model, xs_te)
    probe = ({"zc": zc_tr, "zp": zp_tr, "y": y_tr}, {"zc": zc_te, "zp": zp_te, "y": y_te})
    late = ({"xs": xs_tr, "y": y_tr}, {"xs": xs_te, "y": y_te})
    probe_ood = late_ood = None
    if xs_ood is not None:
        zc_o, zp_o = embed_dataset_chunked(model, xs_ood)
        # labels lie outside the ID heads' range; the evidence ignores them
        y_ood = torch.zeros(xs_ood[0].shape[0], dtype=y_tr.dtype, device=y_tr.device)
        probe_ood = {"zc": zc_o, "zp": zp_o, "y": y_ood}
        late_ood = {"xs": xs_ood, "y": y_ood}

    for i, (name, builder, fusion) in enumerate(jobs):
        if fusion is None:
            task = builder(slot(2 + i))
        elif fusion == "concat":
            task = builder(slot(15))
        else:
            task = builder(intermediate_seed(seed, INTERMEDIATE_FUSIONS.index(fusion)))
        fit_seed = slot(8 + i) if i < 6 else intermediate_seed(seed, 8 + i)
        on_views = name.endswith("_fusion") or fusion is not None
        tr_data, te_data = late if on_views else probe
        t_fit = time.perf_counter()
        res_m = train(model=task.model, loss_fn=task.loss_fn, data=tr_data, n_train=n_train,
                      optimizer=task.optimizer, epochs=probe_epochs, batch_size=batch_size,
                      randomness=Randomness(fit_seed, device), val_fn=task.val_fn,
                      val_data=te_data)
        fit_s = time.perf_counter() - t_fit
        if name == "dmvae_dis" or fusion is not None:
            info = evaluate_subjective_model(task, te_data)
        else:
            info = evaluate_subjective_model_with_shared(task, te_data)
        if xs_ood is not None:
            info["ood"] = ood_info(task, te_data, late_ood if on_views else probe_ood,
                                   num_classes)
        log_training_csv(f"{name}_fusion_dsLUMA_seed{seed}", res_m)
        info["path"] = save_checkpoint(head_checkpoint(name, seed), task.model,
                                       {"model": name, "dataset": "LUMA", "seed": seed})
        info["fit_seconds"] = fit_s
        rows_out[name] = info
        print(f"[seed {seed}] {name}: fused_acc={info['fused']['accuracy']:.4f} "
              f"fit {fit_s:.2f} s, {1e3 * fit_s / probe_epochs:.3f} ms/epoch", flush=True)
    print(f"[seed {seed}] done in {time.time() - t0:.1f}s", flush=True)


def write_reports(rows, seeds):
    """``logs/luma_analysis.xlsx`` (main_grouped, all_results,
    grouped_results; CSV mirrors) without skip rows, and, when any row has
    OOD AUROCs, ``logs/luma_ood.json``. Returns the OOD summary ({} without)."""
    from ..core.artifacts import artifact_path
    from ..eval.analysis import build_metrics_rows_datasets
    from .common import Table, group_mean, main_columns, write_report

    rows = {s: {cond: {ds: {m: v for m, v in models.items() if "skipped" not in v}
                       for ds, models in conds.items()}
                for cond, conds in by_cond.items()}
            for s, by_cond in rows.items()}
    columns, dicts = build_metrics_rows_datasets(rows)
    for d in dicts:
        d["seed"] = int(d["seed"])
    table = Table.from_dicts(columns, dicts)
    keys = ["type", "dataset", "model"]
    write_report({"main_grouped": group_mean(main_columns(table, ["seed", *keys]), keys),
                  "all_results": table, "grouped_results": group_mean(table, keys)},
                 "logs/luma_analysis.xlsx")
    ood_rows: dict = {}
    for s in seeds:
        for name, info in rows.get(s, {}).get("Normal", {}).get("LUMA", {}).items():
            if "ood" in info:
                ood_rows.setdefault(name, []).append(info["ood"])
    if not ood_rows:
        return {}
    summary = {name: {k: float(np.mean([r[k] for r in rs])) for k in rs[0]}
               for name, rs in ood_rows.items()}
    path = artifact_path("logs/luma_ood.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"mean": summary, "per_seed": ood_rows}, indent=1))
    for name, s in summary.items():
        print(f"OOD {name}: " + " ".join(f"{k}={v:.3f}" for k, v in s.items()), flush=True)
    print("OOD AUROC written to logs/luma_ood.json", flush=True)
    return summary


def parse_args(argv=None):
    from ..models.fusions import INTERMEDIATE_FUSIONS

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seeds", type=int, nargs="*", default=None)
    parser.add_argument("--data-path", type=str, default=None)
    parser.add_argument("--replicate-image-bug", action="store_true",
                        help="the reference's gray placeholder images")
    parser.add_argument("--use-ood", action="store_true",
                        help="train on every class, the OOD ones included")
    parser.add_argument("--ood-eval", action="store_true",
                        help="score the held-out OOD classes' test rows by each evidential "
                             "uncertainty and report OOD-vs-ID AUROCs (logs/luma_ood.json)")
    parser.add_argument("--use-2d", action="store_true",
                        help="(n_mfcc, frames) MFCC maps through the audio encoder's conv "
                             "branch")
    parser.add_argument("--dmvae-epochs", type=int, default=None)
    parser.add_argument("--probe-epochs", type=int, default=None)
    parser.add_argument("--no-fused-dmvae", action="store_true",
                        help="train the per-modality DMVAE instead of the fused one")
    parser.add_argument("--include-intermediate", action="store_true",
                        help="also fit IntermediateFusion over concat on the encoders")
    parser.add_argument("--intermediate-fusion", type=str, nargs="*", default=None,
                        metavar="NAME",
                        help="fit IntermediateFusion over these library fusions "
                             f"({', '.join(INTERMEDIATE_FUSIONS)}); one refused for three "
                             "200-wide views is a skip row")
    parser.add_argument("--rows-file", default=None, metavar="PATH",
                        help="write the rows to PATH (JSON) after every seed; a rerun skips "
                             "the seeds PATH completes")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "PyTorch path)")
    parser.add_argument("--vmap-seeds", action="store_true")
    parser.add_argument("--segment-epochs", type=int, default=None)
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    parser.add_argument("--data-parallel", type=int, default=1)
    parser.add_argument("--model-parallel", type=int, default=1)
    args = parser.parse_args(argv)
    used = [flag for flag, on in zip(NOT_PORTED, (
        args.vmap_seeds, args.segment_epochs is not None, args.dtype != "float32",
        args.data_parallel > 1 or args.model_parallel > 1)) if on]
    if used:
        parser.error(f"{', '.join(used)}: not ported yet (see ROADMAP.md)")
    if args.use_ood and args.ood_eval:
        parser.error("--use-ood trains on ALL classes, leaving no held-out set for --ood-eval; "
                     "pick one")
    fusions = list(args.intermediate_fusion or [])
    unknown = [f for f in fusions if f not in INTERMEDIATE_FUSIONS]
    if unknown:
        parser.error(f"unknown --intermediate-fusion {unknown}; supported: {INTERMEDIATE_FUSIONS}")
    if args.include_intermediate and "concat" not in fusions:
        fusions.insert(0, "concat")
    args.intermediate_fusion = fusions
    return args


def main(argv=None):
    """Run the protocol; returns rows[seed]['Normal']['LUMA'][model]."""
    from ..data.luma import get_luma_ood_arrays, get_luma_arrays
    from ..models.fusions import fusion_dim
    from .common import load_config, make_getter
    from .run import RowsFile, intermediate_job_name

    args = parse_args(argv)
    device = resolve_device(args.device)
    C = make_getter(load_config("luma_config.yaml"))
    seeds = args.seeds if args.seeds is not None else C("experiment.seeds", [0, 1, 2, 3, 4])
    data_path = args.data_path or C("data.luma_path", "data/luma_compiled")
    dmvae_epochs = args.dmvae_epochs if args.dmvae_epochs is not None else C("dmvae.num_epochs", 3)
    probe_epochs = (args.probe_epochs if args.probe_epochs is not None
                    else C("probes.model_epochs", 2))
    audio_cfg, text_cfg, image_cfg = feature_configs(C, args.use_2d)
    specs = encoder_specs(audio_cfg, text_cfg)

    t_feat = time.perf_counter()
    xs_tr, y_tr, xs_te, y_te, num_classes, _, dims = get_luma_arrays(
        data_path, audio_cfg, text_cfg, image_cfg, replicate_image_bug=args.replicate_image_bug,
        use_ood=args.use_ood)
    xs_ood = None
    if args.ood_eval:
        xs_ood_np, y_ood_np, _ = get_luma_ood_arrays(
            data_path, audio_cfg, text_cfg, image_cfg,
            replicate_image_bug=args.replicate_image_bug)
        if len(y_ood_np) == 0:
            print("--ood-eval: corpus declares no held-out OOD classes; skipping OOD scoring",
                  flush=True)
        else:
            xs_ood = to_device(xs_ood_np, device)
            print(f"OOD eval: {len(y_ood_np)} held-out rows from {len(np.unique(y_ood_np))} "
                  f"OOD classes", flush=True)
    print(f"LUMA: {len(y_tr)} train / {len(y_te)} test, {num_classes} classes, dims "
          f"{[int(d[0]) for d in dims]}; featurized in {time.perf_counter() - t_feat:.2f} s",
          flush=True)
    data = {"xs_tr": to_device(xs_tr, device), "y_tr": torch.from_numpy(y_tr).to(device),
            "xs_te": to_device(xs_te, device), "y_te": torch.from_numpy(y_te).to(device),
            "xs_ood": xs_ood}

    jobs = [(name, builder, None) for name, builder in
            head_builders(C, num_classes, probe_epochs, specs, device).items()]
    skipped = {}
    for fusion in args.intermediate_fusion:
        jname = intermediate_job_name(fusion)
        try:
            fusion_dim(fusion, [ENC_OUT] * 3)
        except ValueError as e:
            print(f"  [LUMA] skipping {jname}: {e}", flush=True)
            skipped[jname] = {"skipped": str(e)}
            continue
        jobs.append((jname, intermediate_builder(C, num_classes, fusion, specs, device), fusion))

    # a seed is complete with a row per job and per skipped fusion
    rows_file = RowsFile(args.rows_file, seeds, len(jobs) + len(skipped))
    rows: dict = {}

    def complete(s):
        return rows_file.complete(rows, "Normal", "LUMA", [s])

    if rows_file.path is not None and rows_file.path.exists():
        rows = {int(s): conds for s, conds in json.loads(rows_file.path.read_text()).items()}
        done = [s for s in seeds if complete(s)]
        print(f"--rows-file: resuming; {len(done)} completed seed(s) found {done}", flush=True)

    t_start = time.time()
    for seed in seeds:
        if complete(seed):
            print(f"[seed {seed}] already complete (--rows-file), skipping", flush=True)
            continue
        rows[seed] = {"Normal": {"LUMA": dict(skipped)}}
        run_seed(C=C, seed=seed, data=data, specs=specs, jobs=jobs, num_classes=num_classes,
                 dmvae_epochs=dmvae_epochs, probe_epochs=probe_epochs, device=device,
                 fused_dmvae=not args.no_fused_dmvae, rows_out=rows[seed]["Normal"]["LUMA"])
        rows_file.save(rows)
    write_reports(rows, seeds)
    print(f"LUMA protocol done in {time.time() - t_start:.1f}s", flush=True)
    return rows


if __name__ == "__main__":
    main()

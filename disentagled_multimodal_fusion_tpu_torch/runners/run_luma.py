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

``--vmap-seeds`` (with two seeds or more; JAX lines 286-441) trains all
seeds at once: one ``core.train.train_many`` for the DMVAE over the
encoders, on the shared corpus (``data_broadcast``), with each seed's
BatchNorm statistics stacked beside its parameters; then each seed's
embeddings from its own backbone (seed by seed, in row chunks); then one
``train_many`` per model, the probes on the stacked per-seed embeddings,
late and intermediate fusion on the shared views. Validation runs the heads
of all seeds through one head-kernel launch. Each seed is then evaluated,
scored (``--ood-eval``), checkpointed and logged under the sequential
engine's names. ``--segment-epochs N`` runs each ``train_many`` in exactly
resumed segments of N epochs. With ``--rows-file`` the whole block is
skipped only when every seed is complete; otherwise every seed is trained.
``--force-vmap-seeds`` is accepted and changes nothing.

Randomness follows the JAX key layout of ``jax.random.split(PRNGKey(seed),
16)`` through stand-in generator seeds: slot k seeds ``torch.Generator(seed
* 16 + k)``. Slot 0 draws the DMVAE's weights, 1 its fit's shuffles, noise
and encoder masks, 2-7 the six models' weights, 8-13 their fits' draws and
15 concat's weights. The JAX package folds the other intermediate keys
(fusion m's weights from ``fold_in(keys[15], m)``, job i's fit from
``fold_in(keys[8], 1000 + i)``); their stand-ins are
``runners.common.intermediate_seed(seed, m)`` and ``intermediate_seed(seed,
8 + i)``, which never meet a slot. ``--vmap-seeds`` gives the DMVAE and the
six models the same slots as the sequential engine, so each seed's base
rows are its sequential rows up to the rounding of batched products. Its
intermediate jobs follow the JAX package's vmapped layout instead (job j >=
6 from ``fold_in(keys[8], j)`` and its fit from ``fold_in(keys[9], j)``),
whose stand-ins are ``intermediate_seed(seed, 16 + j - 6)`` and
``intermediate_seed(seed, 24 + j - 6)``; the sequential engine's stand-ins
lie below 22, so the two layouts meet no slot of each other's within one
run.

``--dtype bfloat16`` (JAX lines 127-137) builds the DMVAE, the six models
and the intermediate fusions with the bf16 compute type (``core/tasks.py``):
the DMVAE's stacked MLPs and every evidential head compute in bf16 (the
heads' validation and evaluation through the head kernel's bf16 build);
the Audio, Text and Image encoders stay float32, as the JAX runner builds
them (its lines 222-229 give them no dtype); parameters, Adam's state, the
losses and the BatchNorm statistics stay float32, so the checkpoints keep
their format.

The port runs on the CUDA card unless ``--device cpu``. Not ported yet
(``ROADMAP.md``): the mesh flags.

Example:
  python -m disentagled_multimodal_fusion_tpu_torch.runners.run_luma \\
      --data-path data/luma_compiled --seeds 0 1 2 3 4 --vmap-seeds --ood-eval
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.setup import resolve_device

# options of the JAX runner that the port does not have yet (ROADMAP.md)
NOT_PORTED = ("--data-parallel/--model-parallel",)
ENC_OUT = 200  # the Audio/Text/Image encoders' output width
# the seed-batched engine's intermediate jobs: job j >= 6 takes its weights
# from intermediate_seed(seed, VMAP_INIT + j - 6) and its fit from
# intermediate_seed(seed, VMAP_FIT + j - 6)
VMAP_INIT, VMAP_FIT = 16, 24


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


def head_builders(C, num_classes: int, probe_epochs: int, specs, device, dtype=None):
    """{name: (seed -> task)} of the six models, in the protocol's order."""
    from ..core.tasks import (
        build_disentangled_probe_task,
        build_late_fusion_task,
        build_probe_task,
    )

    head = dict(num_classes=num_classes, hidden_dim=tuple(C("probes.model_hidden_dim", (128,))),
                lr=C("optim.luma_lr", 3e-4), dropout=C("probes.dropout_p", 0.1),
                annealing_start=C("probes.annealing_start", 50), dtype=dtype, device=device)
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


def intermediate_builder(C, num_classes: int, fusion: str, specs, device, dtype=None):
    from ..core.tasks import build_intermediate_fusion_task

    return lambda s: build_intermediate_fusion_task(
        seed=s, output_dims=[ENC_OUT] * 3, num_classes=num_classes,
        dropout=C("probes.dropout_p", 0.1), lr=C("optim.luma_lr", 3e-4),
        annealing_start=C("probes.annealing_start", 50), fusion=fusion,
        feature_encoders=specs, dtype=dtype, device=device)


def build_backbone(C, seed: int, specs, device, fused: bool = True, dtype=None):
    """The LUMA DMVAE over the encoders of ``specs``."""
    from ..core.tasks import build_dmvae_task

    return build_dmvae_task(seed=seed, output_dim=[ENC_OUT] * 3,
                            hidden_dim=C("dmvae.hidden_dim", 512),
                            embed_dim=C("dmvae.embed_dim", 200), a=C("dmvae.a", 1e-5),
                            dropout=C("dmvae.dropout", 0.0), fused_modalities=fused,
                            feature_encoders=specs, dtype=dtype, device=device)


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


def on_views(name: str, fusion) -> bool:
    """True for the models that train on the raw views (late and
    intermediate fusion), False for the probes on the embeddings."""
    return name.endswith("_fusion") or fusion is not None


def embed_splits(model, data):
    """The backbone's embeddings as probe data: (train, test, OOD or None)."""
    from ..core.tasks import embed_dataset_chunked

    out = []
    for xs, y in ((data["xs_tr"], data["y_tr"]), (data["xs_te"], data["y_te"])):
        zc, zp = embed_dataset_chunked(model, xs)
        out.append({"zc": zc, "zp": zp, "y": y})
    if data["xs_ood"] is None:
        return out[0], out[1], None
    zc, zp = embed_dataset_chunked(model, data["xs_ood"])
    return out[0], out[1], {"zc": zc, "zp": zp, "y": ood_labels(data)}


def ood_labels(data):
    """Labels of the OOD rows: outside the ID heads' range, so zeros (the
    evidence ignores them)."""
    y_tr = data["y_tr"]
    return torch.zeros(data["xs_ood"][0].shape[0], dtype=y_tr.dtype, device=y_tr.device)


def finish_job(*, name: str, fusion, task, result, seed: int, te_data, ood_data,
               num_classes: int, fit_s: float, probe_epochs: int) -> dict:
    """A fitted model's row: its evaluation (``dmvae_dis`` and the
    intermediate fusions in the per-view layout, the others with the shared
    layout), OOD AUROCs when ``ood_data`` is given, its training log and its
    checkpoint."""
    from ..core.checkpoint import save_checkpoint
    from ..core.logging import log_training_csv
    from ..eval.analysis import evaluate_subjective_model, evaluate_subjective_model_with_shared

    if name == "dmvae_dis" or fusion is not None:
        info = evaluate_subjective_model(task, te_data)
    else:
        info = evaluate_subjective_model_with_shared(task, te_data)
    if ood_data is not None:
        info["ood"] = ood_info(task, te_data, ood_data, num_classes)
    log_training_csv(f"{name}_fusion_dsLUMA_seed{seed}", result)
    info["path"] = save_checkpoint(head_checkpoint(name, seed), task.model,
                                   {"model": name, "dataset": "LUMA", "seed": seed})
    info["fit_seconds"] = fit_s
    print(f"[seed {seed}] {name}: fused_acc={info['fused']['accuracy']:.4f} "
          f"fit {fit_s:.2f} s, {1e3 * fit_s / probe_epochs:.3f} ms/epoch", flush=True)
    return info


def run_seed(*, C, seed: int, data, specs, jobs, num_classes: int, dmvae_epochs: int,
             probe_epochs: int, device, fused_dmvae: bool, rows_out: dict, dtype=None):
    """Fit and evaluate one seed's models into ``rows_out``. ``data``:
    {'xs_tr', 'y_tr', 'xs_te', 'y_te', 'xs_ood' (or None)}; ``jobs``:
    [(name, seed -> task, fusion or None)] in the protocol's order."""
    from ..core.checkpoint import save_checkpoint
    from ..core.tasks import dmvae_objective
    from ..core.train import Randomness, train
    from ..models.fusions import INTERMEDIATE_FUSIONS
    from .common import intermediate_seed

    def slot(k):
        return seed * 16 + k

    batch_size = C("dataloader.batch_size", 64)
    xs_tr, y_tr = data["xs_tr"], data["y_tr"]
    n_train = int(y_tr.shape[0])
    t0 = time.time()
    model = build_backbone(C, slot(0), specs, device, fused=fused_dmvae, dtype=dtype)
    loss_fn, opt = dmvae_objective(model, lr=C("dmvae.lr", 1e-4), num_epochs=dmvae_epochs)
    t_fit = time.perf_counter()
    res = train(model=model, loss_fn=loss_fn, data={"xs": xs_tr}, n_train=n_train, optimizer=opt,
                epochs=dmvae_epochs, batch_size=batch_size, randomness=Randomness(slot(1), device))
    fit_s = time.perf_counter() - t_fit
    save_checkpoint(backbone_checkpoint(seed), model, {"dataset": "LUMA", "seed": seed})
    print(f"[seed {seed}] DMVAE trained: {fit_s:.2f} s, {1e3 * fit_s / dmvae_epochs:.3f} ms/epoch, "
          f"last train loss {float(res.train_loss[-1]):.4f}", flush=True)

    probe_tr, probe_te, probe_ood = embed_splits(model, data)
    late = ({"xs": xs_tr, "y": y_tr}, {"xs": data["xs_te"], "y": data["y_te"]})
    late_ood = None if data["xs_ood"] is None else {"xs": data["xs_ood"], "y": ood_labels(data)}

    for i, (name, builder, fusion) in enumerate(jobs):
        if fusion is None:
            task = builder(slot(2 + i))
        elif fusion == "concat":
            task = builder(slot(15))
        else:
            task = builder(intermediate_seed(seed, INTERMEDIATE_FUSIONS.index(fusion)))
        fit_seed = slot(8 + i) if i < 6 else intermediate_seed(seed, 8 + i)
        views = on_views(name, fusion)
        tr_data, te_data = late if views else (probe_tr, probe_te)
        t_fit = time.perf_counter()
        res_m = train(model=task.model, loss_fn=task.loss_fn, data=tr_data, n_train=n_train,
                      optimizer=task.optimizer, epochs=probe_epochs, batch_size=batch_size,
                      randomness=Randomness(fit_seed, device), val_fn=task.val_fn,
                      val_data=te_data)
        rows_out[name] = finish_job(
            name=name, fusion=fusion, task=task, result=res_m, seed=seed, te_data=te_data,
            ood_data=late_ood if views else probe_ood, num_classes=num_classes,
            fit_s=time.perf_counter() - t_fit, probe_epochs=probe_epochs)
    print(f"[seed {seed}] done in {time.time() - t0:.1f}s", flush=True)


def run_seeds_batched(*, C, seeds, data, specs, jobs, num_classes: int, dmvae_epochs: int,
                      probe_epochs: int, device, fused_dmvae: bool, segment_epochs, rows: dict,
                      dtype=None):
    """Fit and evaluate every seed's models into ``rows[seed]['Normal']
    ['LUMA']``, each model of all seeds in one ``train_many`` (module
    docstring); ``rows[seed]`` already holds each seed's skip rows."""
    from ..core.checkpoint import save_checkpoint
    from ..core.tasks import dmvae_objective
    from ..core.train import (
        Randomness,
        TrainResult,
        load_params,
        stack_model_state,
        stack_params,
        train_many,
    )
    from .common import intermediate_seed

    def slot(seed, k):
        return seed * 16 + k

    def fit_all(models, loss_fn, optimizer, val_fn, tr_data, te_data, fit_seeds, epochs,
                broadcast):
        """One train_many of ``models`` (loaded back into them): their
        per-seed histories and the fit's wall seconds."""
        t_fit = time.perf_counter()
        res = train_many(model=models[0], params=stack_params(models),
                         model_state=stack_model_state(models), loss_fn=loss_fn, data=tr_data,
                         n_train=n_train, optimizer=optimizer, epochs=epochs,
                         batch_size=batch_size, randomness=[Randomness(f, device)
                                                            for f in fit_seeds],
                         val_fn=val_fn, val_data=te_data, data_broadcast=broadcast,
                         segment_epochs=segment_epochs)
        load_params(models, res.params, res.state.model_state)
        hist = torch.stack([res.train_loss, res.val_loss, res.val_acc]).cpu().numpy()
        lrs = res.final_lr.cpu().numpy()
        results = [TrainResult(*hist[:, i], final_lr=float(lrs[i])) for i in range(len(models))]
        return results, time.perf_counter() - t_fit

    batch_size = C("dataloader.batch_size", 64)
    n_train = int(data["y_tr"].shape[0])
    s_count = len(seeds)
    t0 = time.time()
    backbones = [build_backbone(C, slot(s, 0), specs, device, fused=fused_dmvae, dtype=dtype)
                 for s in seeds]
    loss_fn, opt = dmvae_objective(backbones[0], lr=C("dmvae.lr", 1e-4), num_epochs=dmvae_epochs)
    results, fit_s = fit_all(backbones, loss_fn, opt, None, {"xs": data["xs_tr"]}, None,
                             [slot(s, 1) for s in seeds], dmvae_epochs, True)
    for s, model in zip(seeds, backbones):
        save_checkpoint(backbone_checkpoint(s), model, {"dataset": "LUMA", "seed": s})
    print(f"DMVAE x{s_count} seeds trained: {fit_s:.2f} s, {1e3 * fit_s / dmvae_epochs:.3f} "
          f"ms/epoch, last train loss {[round(float(r.train_loss[-1]), 4) for r in results]}",
          flush=True)

    # each seed's embeddings from its own backbone and statistics, in row
    # chunks (the image CNN's activations of every seed at once would not fit)
    embedded = [embed_splits(model, data) for model in backbones]
    probe_tr, probe_te = ({k: torch.stack([e[i][k] for e in embedded]) for k in ("zc", "zp", "y")}
                          for i in (0, 1))
    late = ({"xs": data["xs_tr"], "y": data["y_tr"]}, {"xs": data["xs_te"], "y": data["y_te"]})
    late_ood = None if data["xs_ood"] is None else {"xs": data["xs_ood"], "y": ood_labels(data)}

    for j, (name, builder, fusion) in enumerate(jobs):
        if fusion is None:
            tasks = [builder(slot(s, 2 + j)) for s in seeds]
            fit_seeds = [slot(s, 8 + j) for s in seeds]
        else:
            tasks = [builder(intermediate_seed(s, VMAP_INIT + j - 6)) for s in seeds]
            fit_seeds = [intermediate_seed(s, VMAP_FIT + j - 6) for s in seeds]
        views = on_views(name, fusion)
        tr_data, te_data = late if views else (probe_tr, probe_te)
        results, fit_s = fit_all([t.model for t in tasks], tasks[0].loss_fn, tasks[0].optimizer,
                                 tasks[0].val_fn, tr_data, te_data, fit_seeds, probe_epochs,
                                 views)
        for i, (s, task) in enumerate(zip(seeds, tasks)):
            ood = late_ood if views else embedded[i][2]
            rows[s]["Normal"]["LUMA"][name] = finish_job(
                name=name, fusion=fusion, task=task, result=results[i], seed=s,
                te_data=te_data if views else embedded[i][1], ood_data=ood,
                num_classes=num_classes, fit_s=fit_s, probe_epochs=probe_epochs)
        accs = [rows[s]["Normal"]["LUMA"][name]["fused"]["accuracy"] for s in seeds]
        print(f"{name} x{s_count}: fused_acc {np.mean(accs):.4f} +/- {np.std(accs):.4f}, fit "
              f"{fit_s:.2f} s, {1e3 * fit_s / probe_epochs:.3f} ms/epoch", flush=True)
    print(f"seeds {list(seeds)} done in {time.time() - t0:.1f}s", flush=True)


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
    from .common import add_force_vmap_flag

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
    parser.add_argument("--vmap-seeds", action="store_true",
                        help="train all seeds at once, one seed-batched fit per model type "
                             "(the corpus is shared by all seeds)")
    parser.add_argument("--segment-epochs", type=int, default=None,
                        help="run each seed-batched fit in exactly resumed segments of this "
                             "many epochs")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                        help="the products' compute type (parameters, optimizer state, losses "
                             "and BatchNorm statistics stay float32); bfloat16 runs the DMVAE's "
                             "and the heads' products in bf16")
    parser.add_argument("--data-parallel", type=int, default=1)
    parser.add_argument("--model-parallel", type=int, default=1)
    add_force_vmap_flag(parser)
    args = parser.parse_args(argv)
    used = [flag for flag, on in zip(NOT_PORTED, (
        args.data_parallel > 1 or args.model_parallel > 1,)) if on]
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
            head_builders(C, num_classes, probe_epochs, specs, device, args.dtype).items()]
    skipped = {}
    for fusion in args.intermediate_fusion:
        jname = intermediate_job_name(fusion)
        try:
            fusion_dim(fusion, [ENC_OUT] * 3)
        except ValueError as e:
            print(f"  [LUMA] skipping {jname}: {e}", flush=True)
            skipped[jname] = {"skipped": str(e)}
            continue
        jobs.append((jname, intermediate_builder(C, num_classes, fusion, specs, device,
                                                 args.dtype), fusion))

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
    if args.vmap_seeds and len(seeds) > 1:
        if all(complete(s) for s in seeds):
            print("--rows-file: every seed complete, skipping training", flush=True)
        else:
            for s in seeds:
                rows[s] = {"Normal": {"LUMA": dict(skipped)}}
            run_seeds_batched(C=C, seeds=seeds, data=data, specs=specs, jobs=jobs,
                              num_classes=num_classes, dmvae_epochs=dmvae_epochs,
                              probe_epochs=probe_epochs, device=device,
                              fused_dmvae=not args.no_fused_dmvae,
                              segment_epochs=args.segment_epochs, rows=rows, dtype=args.dtype)
            rows_file.save(rows)
    sequential = [] if args.vmap_seeds and len(seeds) > 1 else seeds
    for seed in sequential:
        if complete(seed):
            print(f"[seed {seed}] already complete (--rows-file), skipping", flush=True)
            continue
        rows[seed] = {"Normal": {"LUMA": dict(skipped)}}
        run_seed(C=C, seed=seed, data=data, specs=specs, jobs=jobs, num_classes=num_classes,
                 dmvae_epochs=dmvae_epochs, probe_epochs=probe_epochs, device=device,
                 fused_dmvae=not args.no_fused_dmvae, rows_out=rows[seed]["Normal"]["LUMA"],
                 dtype=args.dtype)
        rows_file.save(rows)
    write_reports(rows, seeds)
    print(f"LUMA protocol done in {time.time() - t_start:.1f}s", flush=True)
    return rows


if __name__ == "__main__":
    main()

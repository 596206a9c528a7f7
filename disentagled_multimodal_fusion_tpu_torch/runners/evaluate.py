"""Evaluate a saved sweep checkpoint without retraining.

Counterpart of ``disentagled_multimodal_fusion_tpu/runners/evaluate.py``,
its ``.mat`` and synthetic branches (``_eval_mat``, ``_eval_synthetic`` and
``main``). It replays the seeded split (``runners/run.py``'s legacy
``np.random`` stream with the condition's perturbation of the test rows,
or ``runners/run_synthetic.py``'s generator at ``--dep``, ``--preset`` and
``--quick``), rebuilds the model, restores the checkpoints the sweep wrote
(``core/checkpoint.py``), and prints the subjective-model evaluation of the
test (validation) rows as JSON. It runs on the CUDA card unless ``--device
cpu``. The synthetic branch reads the DMVAE-backbone checkpoints, as the
JAX package's does; the LUMA branch waits for its backbone
(``ROADMAP.md``).

Checkpoint names carry the reference's own ``{name}_fusion_ds...`` pattern,
which doubles the suffix for late fusion (``cml_fusion_fusion_ds...``).

Examples:
  python -m disentagled_multimodal_fusion_tpu_torch.runners.evaluate \
      --model dmvae_cml --dataset HandWritten --seed 0
  python -m disentagled_multimodal_fusion_tpu_torch.runners.evaluate \
      --model cml_fusion --dataset CUB --seed 1 --condition conflict --device cpu
  python -m disentagled_multimodal_fusion_tpu_torch.runners.evaluate \
      --model dmvae_cml --dataset synthetic --seed 0 --dep 50
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.setup import resolve_device

MODELS = ["dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion"]
# the synthetic sweep trains only these three (run_synthetic.py:139-229)
SYNTH_MODELS = {"dmvae_cml", "cml_fusion", "avg_fusion"}


def eval_mat(args, C, device):
    """The evaluation dict of a ``.mat`` sweep checkpoint on its test rows."""
    from ..core.checkpoint import restore_checkpoint
    from ..core.tasks import (
        build_disentangled_probe_task,
        build_dmvae_task,
        build_late_fusion_task,
        build_probe_task,
        embed_dataset_chunked,
    )
    from ..eval.analysis import evaluate_subjective_model, evaluate_subjective_model_with_shared
    from .common import backbone_checkpoint, head_name
    from .run import split_cell

    seed, name, cond = args.seed, args.model, args.condition
    views, labels, _, test_idx, dims, num_classes = split_cell(
        C, seed, args.dataset, cond == "conflict", cond == "noise")
    xs_te = tuple(torch.from_numpy(np.ascontiguousarray(v[test_idx])).to(device) for v in views)
    y_te = torch.from_numpy(labels[test_idx]).to(device)
    probe_hidden = tuple(C("probes.model_hidden_dim", (128,)))

    if name.startswith("dmvae_"):
        backbone = build_dmvae_task(
            output_dim=dims, hidden_dim=C("dmvae.hidden_dim", 512),
            embed_dim=C("dmvae.embed_dim", 200), a=C("dmvae.a", 1e-5),
            fused_modalities=not args.no_fused_dmvae, device=device,
        )
        restore_checkpoint(args.dmvae_checkpoint or backbone_checkpoint(args.dataset, seed, cond),
                           backbone)
        zc, zp = embed_dataset_chunked(backbone, xs_te)
        data = {"zc": zc, "zp": zp, "y": y_te}
        kw = dict(num_modalities=len(dims), num_classes=num_classes,
                  input_dim=C("probes.input_dim", 200), hidden_dim=probe_hidden, device=device)
        if name == "dmvae_dis":
            task = build_disentangled_probe_task(**kw)
        else:
            task = build_probe_task(**kw, aggregation=name.split("_")[1])
    else:
        task = build_late_fusion_task(output_dims=dims, num_classes=num_classes,
                                      hidden_dim=probe_hidden, aggregation=name.split("_")[0],
                                      device=device)
        data = {"xs": xs_te, "y": y_te}
    head = args.checkpoint or f"checkpoints/{head_name(name, args.dataset, seed, cond)}"
    restore_checkpoint(head, task.model)
    if name == "dmvae_dis":
        return evaluate_subjective_model(task, data)
    return evaluate_subjective_model_with_shared(task, data)


def eval_synthetic(args, device):
    """The evaluation dict of a synthetic sweep checkpoint on the validation
    rows of its (seed, dep) cell."""
    from ..core.checkpoint import restore_checkpoint
    from ..core.tasks import embed_dataset
    from ..eval.analysis import evaluate_subjective_model, evaluate_subjective_model_with_shared
    from .common import load_config, make_getter
    from .run import build_backbone
    from .run_synthetic import (
        cell_settings,
        checkpoint_name,
        head_specs,
        make_cell,
        preset_data_kwargs,
    )

    C = make_getter(load_config("synthetic_config.yaml"))
    name, seed, dep = args.model, args.seed, args.dep
    if name not in SYNTH_MODELS:
        raise SystemExit(f"the synthetic sweep trains only {sorted(SYNTH_MODELS)} "
                         f"(run_synthetic.py protocol); got {name}")
    _, ((x1, x2), y) = make_cell(seed, dep, preset_data_kwargs(C, args.preset, args.quick))
    xs = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (x1, x2))
    y = torch.from_numpy(y).to(device)
    view_dims = [x.shape[1] for x in xs]
    st = cell_settings(C, args.quick)
    label = "dmvae_cml" if name == "dmvae_cml" else name.split("_")[0]
    specs = {spec_label: (builder, shared_layout) for spec_label, builder, _, shared_layout, _
             in head_specs(C, st, view_dims, st.embed_dim, device, args.quick)}
    builder, shared_layout = specs[label]
    if label == "dmvae_cml":
        backbone = restore_checkpoint(
            args.dmvae_checkpoint or f"checkpoints/{checkpoint_name('backbone', seed, dep)}",
            build_backbone(st, view_dims, 0, device, fused=not args.no_fused_dmvae))
        zc, zp = embed_dataset(backbone, xs)
        data = {"zc": zc, "zp": zp, "y": y}
    else:
        data = {"xs": xs, "y": y}
    task = builder(0)
    restore_checkpoint(args.checkpoint or f"checkpoints/{checkpoint_name(label, seed, dep)}",
                       task.model)
    if shared_layout:
        return evaluate_subjective_model_with_shared(task, data)
    return evaluate_subjective_model(task, data)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--model", choices=MODELS, required=True)
    parser.add_argument("--dataset", required=True, help=".mat registry name | synthetic")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--condition", choices=["normal", "conflict", "noise"],
                        default="normal")
    parser.add_argument("--conflict", action="store_true",
                        help="alias for --condition conflict")
    parser.add_argument("--dep", type=int, default=50,
                        help="synthetic dependence knob (synthetic only)")
    parser.add_argument("--preset", choices=["easy", "med", "hard"], default="med",
                        help="synthetic difficulty preset the checkpoint was trained under "
                             "(synthetic only)")
    parser.add_argument("--quick", action="store_true",
                        help="the checkpoint came from a --quick run (synthetic only: 1000 "
                             "rows)")
    parser.add_argument("--checkpoint", default=None,
                        help="override the sweep's head checkpoint path")
    parser.add_argument("--dmvae-checkpoint", default=None,
                        help="override the sweep's backbone checkpoint path")
    parser.add_argument("--no-fused-dmvae", action="store_true",
                        help="the checkpoint is of the unfused per-modality DMVAE")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "PyTorch path)")
    args = parser.parse_args(argv)
    if args.dataset == "LUMA":
        parser.error("--dataset LUMA: its backbone is not ported yet (see ROADMAP.md)")
    if args.conflict:
        args.condition = "conflict"
    return args


def main(argv=None):
    from .common import load_config, make_getter

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.dataset == "synthetic":
        info = eval_synthetic(args, device)
    else:
        info = eval_mat(args, make_getter(load_config()), device)
    print(json.dumps(info, indent=1, default=float))
    return info


if __name__ == "__main__":
    main()

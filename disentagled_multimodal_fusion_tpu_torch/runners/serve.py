"""Serving CLI: restore a sweep checkpoint, time its inference path per
batch bucket, optionally load-test the micro-batching daemon and serve it
over HTTP.

Counterpart of ``disentagled_multimodal_fusion_tpu/runners/serve.py``. The
frozen DMVAE backbone and the evidential head run on the CUDA card (the
head through the evidential head kernel), unless ``--device cpu``. The
model is restored from the checkpoints ``runners/run.py`` writes, at the
JAX package's default paths (``checkpoints/dmvae_dataset{ds}_seed{seed}_
a1e-05_normal`` and ``checkpoints/{model}_fusion_ds{ds}_seed{seed}``) or at
``--dmvae-checkpoint`` / ``--checkpoint``; ``--random-init`` skips the
restore (serving speed does not depend on the weights). ``--export-dir``
(JAX lines 250-261) writes one ``torch.export`` artifact per bucket,
``{model}_{dataset}_seed{seed}_b{b}.pt2`` (the JAX package's names, with
``.pt2`` for ``.stablehlo``), with the head kernel's operator file beside
them (``dmf_head_op.py``, a copy of ``ops/head_op.py``) and, for a CUDA
artifact, the kernel library it loads (``evidential_head.so``). They replay
without the package:

    import importlib.util, torch
    spec = importlib.util.spec_from_file_location("dmf_head_op", "out/dmf_head_op.py")
    op = importlib.util.module_from_spec(spec); spec.loader.exec_module(op)
    op.load("out/evidential_head.so")  # CUDA artifacts only
    outputs = torch.export.load("out/dmvae_cml_HandWritten_seed0_b8.pt2").module()(xs)

The report lists the artifacts under ``exported``.

Examples:
  python -m disentagled_multimodal_fusion_tpu_torch.runners.serve \
      --model dmvae_cml --dataset HandWritten --seed 0

  python -m disentagled_multimodal_fusion_tpu_torch.runners.serve \
      --model dmvae_cml --dataset HandWritten --random-init

  python -m disentagled_multimodal_fusion_tpu_torch.runners.serve \
      --model cml_fusion --dataset HandWritten --random-init --daemon --http-port 8000

  python -m disentagled_multimodal_fusion_tpu_torch.runners.serve \
      --model dmvae_cml --dataset HandWritten --random-init --export-dir exported
"""

from __future__ import annotations

import argparse
import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..core.setup import resolve_device

MODELS = ["dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion"]


def load(args, C, device):
    """(infer_fn, xs): the model named by ``args`` on ``device``, and the
    dataset's views tiled up to the largest bucket, as tensors there.

    The model is restored from its checkpoints (the sweep's names for
    ``--seed`` unless ``--checkpoint`` / ``--dmvae-checkpoint`` name
    others); with ``--random-init`` the backbone keeps the weights drawn
    from ``torch.Generator(seed)`` and the head those from ``seed + 1``.
    """
    from ..core.checkpoint import restore_checkpoint
    from ..core.serve import build_inference_fn
    from ..core.tasks import (
        build_disentangled_probe_task,
        build_dmvae_task,
        build_late_fusion_task,
        build_probe_task,
    )
    from ..data.multiview import DATASET_REGISTRY
    from .common import backbone_checkpoint, head_name

    seed, name = args.seed, args.model
    dataset = DATASET_REGISTRY[args.dataset]()
    views, _ = dataset.arrays()
    need = max(args.buckets)
    tile = -(-need // len(views[0]))
    xs = tuple(
        torch.from_numpy(np.concatenate([v] * tile, axis=0)[:need]).to(device) for v in views
    )
    dims = [int(d[0]) for d in dataset.dims]
    probe_hidden = tuple(C("probes.model_hidden_dim", (128,)))

    if name.startswith("dmvae_"):
        backbone = build_dmvae_task(
            seed=seed, output_dim=dims, hidden_dim=C("dmvae.hidden_dim", 512),
            embed_dim=C("dmvae.embed_dim", 200), fused_modalities=not args.no_fused_dmvae,
            device=device,
        )
        if not args.random_init:
            restore_checkpoint(args.dmvae_checkpoint
                               or backbone_checkpoint(args.dataset, seed, "normal"), backbone)
        kw = dict(
            seed=seed + 1, num_modalities=len(dims), num_classes=dataset.num_classes,
            input_dim=C("probes.input_dim", 200), hidden_dim=probe_hidden, device=device,
        )
        if name == "dmvae_dis":
            task = build_disentangled_probe_task(**kw)
        else:
            task = build_probe_task(**kw, aggregation=name.split("_")[1])
    else:
        backbone = None
        task = build_late_fusion_task(
            seed=seed + 1, output_dims=dims, num_classes=dataset.num_classes,
            hidden_dim=probe_hidden, aggregation=name.split("_")[0], device=device,
        )
    if not args.random_init:
        restore_checkpoint(args.checkpoint
                           or f"checkpoints/{head_name(name, args.dataset, seed, 'normal')}",
                           task.model)
    return build_inference_fn(task, backbone=backbone), xs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_bucket(infer, xs, b, reps, device):
    """Median wall-clock of the inference fn at batch size b, on inputs
    already on the device; each timed call ends in a device synchronise."""
    xsb = tuple(x[:b] for x in xs)
    out = infer(xsb)  # warm
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        infer(xsb)
        _sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    return {
        "bucket": b,
        "latency_ms": med * 1e3,
        "rows_per_s": b / med,
        "p10_ms": times[max(0, len(times) // 10)] * 1e3,
        "num_outputs": len(out),
    }


def make_engine(infer, xs, buckets):
    """A ServingEngine over ``infer`` with every bucket run once."""
    from ..core.serve import ServingEngine

    engine = ServingEngine(infer, buckets=sorted(buckets))
    engine.warmup([x.cpu().numpy() for x in xs])
    return engine


def bench_daemon(engine, xs, args):
    """Sustained load through the micro-batching daemon: --daemon-clients
    threads send back-to-back requests of random size in [1,
    --daemon-max-rows] for --daemon-seconds. Reports end-to-end latency
    percentiles and sustained rows/s."""
    from ..core.daemon import ServingDaemon

    xs = tuple(x.cpu().numpy() for x in xs)
    stop = time.perf_counter() + args.daemon_seconds
    done_rows = [0] * args.daemon_clients

    def client(cid):
        rng = np.random.RandomState(cid)
        while time.perf_counter() < stop:
            n = int(rng.randint(1, args.daemon_max_rows + 1))
            daemon.infer(tuple(x[:n] for x in xs))
            done_rows[cid] += n

    with ServingDaemon(engine, max_delay_ms=args.daemon_delay_ms) as daemon:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(args.daemon_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        st = daemon.stats()
    st.update(
        clients=args.daemon_clients,
        max_delay_ms=args.daemon_delay_ms,
        seconds=elapsed,
        sustained_rows_per_s=sum(done_rows) / elapsed,
        sustained_requests_per_s=st["requests"] / elapsed,
    )
    return st


def export_buckets(infer, xs, args, device):
    """One artifact per bucket under ``--export-dir``, and the head
    kernel's operator file (and, on the card, its library) beside them:
    the list of files written."""
    from ..core.serve import export_inference
    from ..ops import cuda_kernels, head_op

    outdir = Path(args.export_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    written = []
    for b in sorted(args.buckets):
        path = outdir / f"{args.model}_{args.dataset}_seed{args.seed}_b{b}.pt2"
        export_inference(infer, tuple(x[:b] for x in xs), path)
        written.append(str(path))
    written.append(shutil.copyfile(head_op.__file__, outdir / "dmf_head_op.py"))
    if device.type == "cuda":
        written.append(shutil.copyfile(cuda_kernels.library_path(),
                                       outdir / "evidential_head.so"))
    return [str(p) for p in written]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--model", choices=MODELS, required=True)
    parser.add_argument("--dataset", required=True, help=".mat registry name")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the "
                             "plain PyTorch path)")
    parser.add_argument("--checkpoint", default=None,
                        help="the head's checkpoint (default: the sweep's name for "
                             "--model, --dataset and --seed)")
    parser.add_argument("--dmvae-checkpoint", default=None,
                        help="the backbone's checkpoint (default: the sweep's name, "
                             "Normal condition)")
    parser.add_argument("--no-fused-dmvae", action="store_true",
                        help="the checkpoint is of the unfused per-modality DMVAE")
    parser.add_argument("--random-init", action="store_true",
                        help="skip the restore and serve weights drawn from --seed "
                             "(a program-speed profile)")
    parser.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 64, 256])
    parser.add_argument("--reps", type=int, default=30)
    parser.add_argument("--daemon", action="store_true",
                        help="also load-test the micro-batching daemon")
    parser.add_argument("--daemon-clients", type=int, default=8)
    parser.add_argument("--daemon-seconds", type=float, default=10.0)
    parser.add_argument("--daemon-max-rows", type=int, default=64,
                        help="each client request draws its row count "
                             "uniformly from [1, this]")
    parser.add_argument("--daemon-delay-ms", type=float, default=2.0,
                        help="daemon flush deadline")
    parser.add_argument("--http-port", type=int, default=None,
                        help="after the bench, serve over HTTP until interrupted "
                             "(POST /v1/infer, GET /v1/stats, /healthz)")
    parser.add_argument("--http-host", default="127.0.0.1")
    parser.add_argument("--export-dir", default=None,
                        help="write one torch.export artifact per bucket here "
                             "({model}_{dataset}_seed{seed}_b{b}.pt2), with the head "
                             "kernel's operator file (and on the card its library)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    from .common import load_config, make_getter

    try:
        infer, xs = load(args, make_getter(load_config()), device)
    except FileNotFoundError as e:
        raise SystemExit(f"serve: {e}; train the model with runners/run.py, name its "
                         f"checkpoint, or pass --random-init") from e
    rows = [bench_bucket(infer, xs, b, args.reps, device) for b in sorted(args.buckets)]
    engine = (make_engine(infer, xs, args.buckets)
              if (args.daemon or args.http_port is not None) else None)
    daemon_stats = bench_daemon(engine, xs, args) if args.daemon else None
    exported = export_buckets(infer, xs, args, device) if args.export_dir else []

    report = {
        "model": args.model,
        "dataset": args.dataset,
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "random_init": args.random_init,
        "buckets": rows,
        "daemon": daemon_stats,
        "exported": exported,
    }
    print(json.dumps(report, indent=1))

    if args.http_port is not None:
        from ..core.daemon import ServingDaemon
        from ..core.http_front import serve_forever

        with ServingDaemon(engine, max_delay_ms=args.daemon_delay_ms) as daemon:
            serve_forever(daemon, host=args.http_host, port=args.http_port)
    return report


if __name__ == "__main__":
    main()

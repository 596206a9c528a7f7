"""Per-model training-metrics CSV logs and the profiler trace.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/logging.py``:
``log_training_csv`` with the ``csv`` module instead of pandas (per-epoch
train/val histories at ``logs/<model_name>/metrics.csv``), and ``trace``
with ``torch.profiler`` instead of ``jax.profiler``: CPU activity, and CUDA
activity (every kernel launched, by name) where there is a card, written as
a Chrome trace (chrome://tracing, Perfetto) at
``logs/traces/<name>/trace.json``.
"""

from __future__ import annotations

import contextlib
import csv

import numpy as np

from .artifacts import artifact_path


def log_training_csv(model_name: str, result, save_dir: str = "logs") -> str:
    out = artifact_path(save_dir) / model_name
    out.mkdir(parents=True, exist_ok=True)
    path = out / "metrics.csv"
    columns = [np.asarray(result.train_loss), np.asarray(result.val_loss),
               np.asarray(result.val_acc)]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["epoch", "train_loss", "val_loss", "val_acc"])
        for epoch, (tl, vl, va) in enumerate(zip(*columns)):
            writer.writerow([epoch, float(tl), float(vl), float(va)])
    return str(path)


@contextlib.contextmanager
def trace(name: str = "trace", log_dir: str = "logs/traces", enabled: bool = True):
    """Profile the block; the trace is written, and its directory printed,
    when the block ends, also when it raises. Yields the trace's path (None
    when not ``enabled``)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = artifact_path(log_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    path = out / "trace.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield path
    finally:
        prof.export_chrome_trace(str(path))
        print(f"profiler trace written to {log_dir}/{name}", flush=True)

"""Per-model training-metrics CSV logs.

Counterpart of ``log_training_csv`` in
``disentagled_multimodal_fusion_tpu/core/logging.py``, with the ``csv``
module instead of pandas: per-epoch train/val histories at
``logs/<model_name>/metrics.csv``. The profiler ``trace`` is not ported.
"""

from __future__ import annotations

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

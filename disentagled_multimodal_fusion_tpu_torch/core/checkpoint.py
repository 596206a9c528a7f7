"""Checkpoints of trained parameters plus their hyperparameters.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/checkpoint.py``
(Orbax there): ``torch.save`` of the module's state dict, moved to the CPU,
to ``<path>.pt``, with ``<path>.hparams.json`` beside it. Saves are
synchronous, so the JAX package's ``wait_for_checkpoints`` has no
counterpart.
"""

from __future__ import annotations

import json
from typing import Optional

import torch

from .artifacts import artifact_path


def save_checkpoint(path: str, module: torch.nn.Module, hparams: Optional[dict] = None) -> str:
    """Save ``module``'s parameters under ``path``; returns the file's path."""
    p = artifact_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    target = p.with_name(p.name + ".pt")
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, target)
    if hparams is not None:
        p.with_name(p.name + ".hparams.json").write_text(json.dumps(hparams, default=str, indent=1))
    return str(target)


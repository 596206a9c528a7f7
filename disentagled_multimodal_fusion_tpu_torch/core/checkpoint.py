"""Checkpoints of trained parameters plus their hyperparameters.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/checkpoint.py``
(Orbax there): ``torch.save`` of the module's state dict, moved to the CPU,
to ``<path>.pt``, with ``<path>.hparams.json`` beside it, and
:func:`restore_checkpoint`, which loads it back strictly. Saves are
synchronous, so the JAX package's ``wait_for_checkpoints`` has no
counterpart. The JAX package's Orbax checkpoints are not read here: carry
their parameter trees over with ``convert.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from .artifacts import artifact_path


def checkpoint_file(path: str) -> Path:
    """The ``.pt`` file of the checkpoint named ``path`` (an artifact path)."""
    p = artifact_path(path)
    return p.with_name(p.name + ".pt")


def save_checkpoint(path: str, module: torch.nn.Module, hparams: Optional[dict] = None) -> str:
    """Save ``module``'s parameters under ``path``; returns the file's path."""
    target = checkpoint_file(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, target)
    if hparams is not None:
        target.with_name(target.name[:-len(".pt")] + ".hparams.json").write_text(
            json.dumps(hparams, default=str, indent=1))
    return str(target)


def restore_checkpoint(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Load the checkpoint :func:`save_checkpoint` wrote under ``path`` into
    ``module``, on the module's device; returns ``module``.

    Raises ``FileNotFoundError`` (naming the file) when there is none, and
    ``RuntimeError`` on any missing, unexpected or mis-shaped key: a partial
    load is never silent.
    """
    source = checkpoint_file(path)
    if not source.is_file():
        raise FileNotFoundError(f"no checkpoint at {source}")
    device = next(module.parameters()).device
    state = torch.load(source, map_location=device, weights_only=True)
    module.load_state_dict(state, strict=True)
    return module

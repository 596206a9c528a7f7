"""Artifact-path resolution for checkpoints, logs and reports.

Counterpart of ``disentagled_multimodal_fusion_tpu/core/artifacts.py``:
relative artifact paths (``checkpoints/``, ``logs/``) are rooted at
``$DMF_ARTIFACT_ROOT`` when it is set, else at the working directory;
absolute paths are honoured as they are.
"""

from __future__ import annotations

import os
from pathlib import Path

_ENV = "DMF_ARTIFACT_ROOT"


def artifact_path(path) -> Path:
    p = Path(path)
    if p.is_absolute():
        return p
    root = os.environ.get(_ENV)
    return (Path(root) / p).resolve() if root else p.resolve()

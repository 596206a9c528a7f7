"""Shared runner plumbing: config access.

Counterpart of the config half of
``disentagled_multimodal_fusion_tpu/runners/common.py``: the ``C()``
dot-path getter, where a missing key falls back to the code-level default.
"""

from __future__ import annotations

import copy

from ..configs.config import CONFIG


def load_config() -> dict:
    """A private copy of the port's config (``configs/config.py``)."""
    return copy.deepcopy(CONFIG)


def make_getter(cfg: dict):
    """Dot-path getter with default: C('probes.dropout_p', 0.1)."""

    def C(path: str, default=None):
        cur = cfg
        for p in path.split("."):
            if not isinstance(cur, dict) or p not in cur:
                return default
            cur = cur[p]
        return cur

    return C

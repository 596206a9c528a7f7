"""Dirichlet uncertainty decomposition.

Counterpart of ``dirichlet_uncertainties`` in
``disentagled_multimodal_fusion_tpu/ops/dirichlet.py``. The EDL losses come
with the training slice.
"""

from __future__ import annotations

import torch


def dirichlet_uncertainties(evidence: torch.Tensor, num_classes: int):
    """Epistemic / aleatoric decomposition of (B, C) evidence.

    With ``alpha = evidence + 1`` and ``S = sum(alpha)``: epistemic ``K / S``
    and aleatoric ``-sum_c p_c (digamma(alpha_c + 1) - digamma(S + 1))``,
    each (B,).
    """
    alphas = evidence.float() + 1.0
    s = torch.sum(alphas, dim=-1, keepdim=True)
    probs = alphas / s
    epistemic = (num_classes / s)[..., 0]
    aleatoric = -torch.sum(
        probs * (torch.special.digamma(alphas + 1.0) - torch.special.digamma(s + 1.0)),
        dim=-1,
    )
    return epistemic, aleatoric

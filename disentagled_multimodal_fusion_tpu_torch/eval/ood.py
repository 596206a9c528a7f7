"""OOD scoring from evidential uncertainties.

Counterpart of ``disentagled_multimodal_fusion_tpu/eval/ood.py``: each row of
fused evidence (B, C) is scored by an uncertainty measure (higher = more
out-of-distribution), and the AUROC of OOD-vs-ID separation is reported per
measure. The uncertainties are ``ops/dirichlet.py``'s; the AUROC is the
rank statistic with tie correction, in numpy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.dirichlet import dirichlet_uncertainties


def auroc(scores_pos: np.ndarray, scores_neg: np.ndarray) -> float:
    """P(score_pos > score_neg), ties counted half (average ranks); NaN when
    either side is empty."""
    if len(scores_pos) == 0 or len(scores_neg) == 0:
        return float("nan")
    scores = np.concatenate([scores_pos, scores_neg])
    order = scores.argsort(kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    n_pos, n_neg = len(scores_pos), len(scores_neg)
    r_pos = ranks[:n_pos].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


@torch.no_grad()
def ood_scores(evidence, num_classes: int) -> Dict[str, np.ndarray]:
    """Per-row OOD scores of fused evidence (B, C): epistemic, aleatoric and
    the negated total evidence."""
    ev = torch.as_tensor(evidence)
    epi, ale = dirichlet_uncertainties(ev, num_classes)
    out = torch.stack([epi, ale, -torch.sum(ev.float(), dim=-1)]).cpu().numpy()
    return {"epistemic": out[0], "aleatoric": out[1], "neg_evidence": out[2]}


def evaluate_ood(evidence_id, evidence_ood, num_classes: int) -> Dict[str, float]:
    """AUROC per uncertainty measure, OOD the positive class."""
    s_id = ood_scores(evidence_id, num_classes)
    s_ood = ood_scores(evidence_ood, num_classes)
    return {f"auroc_{k}": auroc(s_ood[k], s_id[k]) for k in s_id}

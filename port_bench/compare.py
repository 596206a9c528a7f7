"""The comparison that decides ``correct``: the port's six outputs against the plain reference's.

For the requests a run samples from its window, each number is the widest
gap over every row, view and class:

* ``evidence_log_gap``: |log e - log e_ref| of the per-view evidence (the
  evidence is at least exp(-10) times a constant, so the log is finite; a
  gap in it is the gap in the head's logits below the clip);
* ``fused_log_gap``: the same of the fused evidence, and how far the served
  class ``pred`` lies below the reference's best class in it (0 where they
  agree);
* ``probs_gap``: |p - p_ref| of the Dirichlet means;
* ``uncertainty_gap``: |u - u_ref| / u_ref of the epistemic uncertainty,
  and |a - a_ref| of the aleatoric.

The served class and the aleatoric uncertainty are held inside the numbers
of their neighbours, in the same units, and not alone: the aleatoric is a
difference of digammas near log S, whose float32 rounding (about 1e-6) is
as large as what TF32 products change in it, and the served class departs
from the reference's best only at near ties, by less than the fused
evidence's own gap, in float32 and in TF32 alike (PERF.md gives the
readings). A shape that differs, a NaN or an infinity reads as
an infinite gap. Each number has its limit in the cell's file
(``limits``); a run is correct when every number is at most its limit.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

NAMES = ("evidence_log_gap", "fused_log_gap", "probs_gap", "uncertainty_gap")


def _widest(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    worst = float(x.max())  # a NaN anywhere makes the max NaN
    return worst if math.isfinite(worst) else math.inf


def gaps(got: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Each number of :data:`NAMES` for one request (tensors on one device)."""
    keys = ("evidence", "fused_evidence", "probs", "epistemic", "aleatoric", "pred")
    if any(k not in got or tuple(got[k].shape) != tuple(ref[k].shape) for k in keys):
        return {name: math.inf for name in NAMES}
    log_ref = torch.log(ref["fused_evidence"])
    pred = got["pred"].long()
    classes = log_ref.shape[-1]
    if bool(((pred < 0) | (pred >= classes)).any()):
        pred_gap = math.inf
    else:
        pred_gap = _widest(log_ref.max(dim=-1).values
                           - log_ref.gather(-1, pred[:, None])[:, 0])
    return {
        "evidence_log_gap": _widest((torch.log(got["evidence"])
                                     - torch.log(ref["evidence"])).abs()),
        "fused_log_gap": max(_widest((torch.log(got["fused_evidence"]) - log_ref).abs()),
                             pred_gap),
        "probs_gap": _widest((got["probs"] - ref["probs"]).abs()),
        "uncertainty_gap": max(_widest((got["epistemic"] - ref["epistemic"]).abs()
                                       / ref["epistemic"]),
                               _widest((got["aleatoric"] - ref["aleatoric"]).abs())),
    }


def widest(a: Mapping[str, float], b: Mapping[str, float]) -> Dict[str, float]:
    """Each number's larger reading of two."""
    return {k: max(a[k], b[k]) for k in a}


def judge(values: Mapping[str, float], limits: Mapping[str, float]):
    """(correct, {name: {"value", "limit"}}): every number within its limit."""
    checks = {k: {"value": values.get(k, math.inf), "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks

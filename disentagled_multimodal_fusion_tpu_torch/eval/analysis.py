"""Subjective-model evaluation and results flattening.

Counterpart of ``disentagled_multimodal_fusion_tpu/eval/analysis.py``
(lines 25-291 and 293-395). The whole test set is evaluated on the device
(accuracy, ECE, evidence/epistemic/aleatoric means, incorrect-only means,
per-class evidence tables, reliability bins, risk-coverage) and the scalars
come back in one copy. The output dict and the flattened column names are
the JAX package's. The flatteners return lists of row dicts, not
DataFrames.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.dirichlet import dirichlet_uncertainties

RC_COVERAGE_GRID = tuple(round(0.05 * i, 2) for i in range(1, 21))  # 0.05..1.0


def _bin_edges(n_bins: int, device) -> torch.Tensor:
    """The bin edges of ``jnp.linspace(0, 1, n_bins + 1)`` in float32, bit for bit."""
    i = np.arange(n_bins + 1, dtype=np.float32)
    return torch.from_numpy(i * (np.float32(1.0) / np.float32(n_bins))).to(device)


def reliability_bins(probs: torch.Tensor, target: torch.Tensor, n_bins: int = 15):
    """Per-bin (count, accuracy, mean confidence) of the top-label
    confidence in equal-width, right-closed bins."""
    conf = torch.max(probs, dim=-1).values
    correct = (torch.argmax(probs, dim=-1) == target).float()
    edges = _bin_edges(n_bins, probs.device)
    idx = torch.clamp(torch.searchsorted(edges, conf, side="left") - 1, 0, n_bins - 1)
    onehot = F.one_hot(idx, n_bins).float()
    counts = torch.sum(onehot, dim=0)
    denom = torch.clamp(counts, min=1.0)
    return {
        "count": counts,
        "accuracy": torch.sum(onehot * correct[:, None], dim=0) / denom,
        "confidence": torch.sum(onehot * conf[:, None], dim=0) / denom,
    }


def expected_calibration_error(probs, target, n_bins: int = 15) -> torch.Tensor:
    """Top-label ECE with equal-width confidence bins."""
    b = reliability_bins(probs, target, n_bins)
    return torch.sum(b["count"] / probs.shape[0] * torch.abs(b["accuracy"] - b["confidence"]))


def risk_coverage(probs: torch.Tensor, target: torch.Tensor):
    """Selective risk at each coverage of :data:`RC_COVERAGE_GRID`, the area
    under the n-point risk-coverage curve and the risks at 50/80/90 %.
    Rows rank by confidence with a stable sort; the covering row indices
    are computed in float64 (a float32 c*n can land past an integer)."""
    n = probs.shape[0]
    conf = torch.max(probs, dim=-1).values
    correct = (torch.argmax(probs, dim=-1) == target).float()
    order = torch.argsort(-conf, stable=True)
    err_sorted = 1.0 - correct[order]
    cum_err = torch.cumsum(err_sorted, dim=0) / torch.arange(
        1, n + 1, dtype=torch.float32, device=probs.device)
    idx = np.clip(np.ceil(np.asarray(RC_COVERAGE_GRID) * n).astype(np.int64) - 1, 0, n - 1)

    def at(c):
        return cum_err[int(np.clip(np.ceil(c * n) - 1, 0, n - 1))]

    return {
        "risk": cum_err[torch.from_numpy(idx).to(probs.device)],
        "aurc": torch.mean(cum_err),
        "risk_at_50": at(0.5),
        "risk_at_80": at(0.8),
        "risk_at_90": at(0.9),
    }


def _block_metrics(ev: torch.Tensor, target: torch.Tensor, num_classes: int):
    """Metrics of one evidence block (B, C), ECE included."""
    ev_scalar = torch.sum(ev, dim=-1)
    epi, ale = dirichlet_uncertainties(ev, num_classes)
    correct = (torch.argmax(ev, dim=-1) == target).float()
    incorrect = 1.0 - correct
    inc_n = torch.sum(incorrect)
    safe_inc = torch.clamp(inc_n, min=1.0)
    alphas = ev.float() + 1.0
    probs = alphas / torch.sum(alphas, dim=-1, keepdim=True)
    zero = torch.zeros((), device=ev.device)

    def inc_mean(x):  # the reference's 0.0 when every row is correct
        return torch.where(inc_n > 0, torch.sum(x * incorrect) / safe_inc, zero)

    return {
        "accuracy": torch.mean(correct),
        "ece": expected_calibration_error(probs, target),
        "evidence_mean": torch.mean(ev_scalar),
        "epistemic_mean": torch.mean(epi),
        "aleatoric_mean": torch.mean(ale),
        "incorrect_only": {
            "evidence_mean": inc_mean(ev_scalar),
            "epistemic_mean": inc_mean(epi),
            "aleatoric_mean": inc_mean(ale),
        },
    }


def _per_class_evidence(ev: torch.Tensor, target: torch.Tensor, num_classes: int):
    """Unconditional and true-class per-class evidence means."""
    uncond = torch.sum(ev, dim=0) / max(ev.shape[0], 1)
    onehot = F.one_hot(target.long(), num_classes).float()
    class_counts = torch.sum(onehot, dim=0)
    true_ev = torch.gather(ev, 1, target.long()[:, None])[:, 0]
    true_sum = torch.sum(onehot * true_ev[:, None], dim=0)
    return uncond, true_sum / torch.clamp(class_counts, min=1e-12)


def _stack_trees(trees):
    """A list of equal-structure dicts of tensors -> one dict of stacked tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _eval_all(evidences: torch.Tensor, fused: torch.Tensor, target: torch.Tensor,
              num_classes: int):
    """Every evaluation metric: the fused block, the V view blocks (stacked
    over V), the per-class tables and the fused head's reliability bins and
    risk-coverage summary, as tensors on the device."""
    f_alphas = fused.float() + 1.0
    f_probs = f_alphas / torch.sum(f_alphas, dim=-1, keepdim=True)
    views = range(evidences.shape[1])
    pcs = [_per_class_evidence(evidences[:, i], target, num_classes) for i in views]
    return {
        "fused_block": _block_metrics(fused, target, num_classes),
        "blocks": _stack_trees([_block_metrics(evidences[:, i], target, num_classes)
                                for i in views]),
        "pc": (torch.stack([p[0] for p in pcs]), torch.stack([p[1] for p in pcs])),
        "f_pc": _per_class_evidence(fused, target, num_classes),
        "f_rel": reliability_bins(f_probs, target),
        "f_rc": risk_coverage(f_probs, target),
    }


def fetch(tree):
    """The tensors of ``tree`` as numpy arrays, in one device-to-host copy."""
    leaves = []

    def collect(t):
        if isinstance(t, dict):
            return {k: collect(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(collect(v) for v in t)
        leaves.append(t)
        return len(leaves) - 1

    layout = collect(tree)
    flat = torch.cat([t.float().reshape(-1) for t in leaves]).cpu().numpy()
    arrays, at = [], 0
    for t in leaves:
        arrays.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(build(v) for v in node)
        return arrays[node]

    return build(layout)


def _to_py(tree):
    if isinstance(tree, dict):
        return {k: _to_py(v) for k, v in tree.items()}
    return float(tree) if np.ndim(tree) == 0 else np.asarray(tree).tolist()


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return float(tree[i])


def format_eval_result(dev, v: int, has_shared: bool) -> Dict[str, Any]:
    """A fetched :func:`_eval_all` result as the reference's nested metrics
    dict."""
    fused_block = _to_py(dev["fused_block"])
    if "f_rel" in dev:
        fused_block["reliability"] = _to_py(dev["f_rel"])
    if "f_rc" in dev:
        rc = _to_py(dev["f_rc"])
        rc["coverage"] = list(RC_COVERAGE_GRID)
        fused_block["risk_coverage"] = rc
    blocks = [_index(dev["blocks"], i) for i in range(v)]
    uncond, truecls = dev["pc"]
    f_unc, f_tc = dev["f_pc"]
    if has_shared:  # evidences[:, 0] is the shared head
        return {
            "shared": blocks[0],
            "per_view": blocks[1:],
            "fused": fused_block,
            "per_class_evidence": {
                "unconditional": {
                    "shared": uncond[0].tolist(),
                    "per_view": [u.tolist() for u in uncond[1:]],
                    "fused": f_unc.tolist(),
                },
                "true_class": {
                    "shared": truecls[0].tolist(),
                    "per_view": [t.tolist() for t in truecls[1:]],
                    "fused": f_tc.tolist(),
                },
            },
        }
    return {
        "per_view": blocks,
        "fused": fused_block,
        "per_class_evidence": {
            "unconditional": {
                "per_view": [u.tolist() for u in uncond],
                "fused": f_unc.tolist(),
            },
            "true_class": {
                "per_view": [t.tolist() for t in truecls],
                "fused": f_tc.tolist(),
            },
        },
    }


def evaluate_evidences(evidences, fused, target, num_classes: int,
                       has_shared: bool) -> Dict[str, Any]:
    """Full evaluation of stacked evidences (N, V, C) and fused (N, C)."""
    dev = fetch(_eval_all(evidences, fused, target, num_classes))
    return format_eval_result(dev, evidences.shape[1], has_shared)


@torch.no_grad()
def evaluate_subjective_model(task, data) -> Dict[str, Any]:
    """Per-view layout evaluator."""
    evidences = task.evidences_fn(data)
    return evaluate_evidences(evidences, task.aggregation(evidences), data["y"],
                              task.num_classes, False)


@torch.no_grad()
def evaluate_subjective_model_with_shared(task, data) -> Dict[str, Any]:
    """[shared, views...] layout evaluator."""
    evidences = task.evidences_fn(data)
    if evidences.shape[1] < 2:
        raise ValueError("Expected at least one shared and one specific view (V >= 2).")
    return evaluate_evidences(evidences, task.aggregation(evidences), data["y"],
                              task.num_classes, True)


# -------------------------------------------------------------- flattening
def _add_block(row: dict, prefix: str, block) -> None:
    if not isinstance(block, dict):
        return
    for k in ["accuracy", "ece", "evidence_mean", "epistemic_mean", "aleatoric_mean"]:
        if k in block:
            row[f"{prefix}{k}"] = float(block[k])
    inc = block.get("incorrect_only", {})
    for k in ["evidence_mean", "epistemic_mean", "aleatoric_mean"]:
        if k in inc:
            row[f"{prefix}incorrect_only_{k}"] = float(inc[k])
    rc = block.get("risk_coverage")
    if isinstance(rc, dict):
        for k in ["aurc", "risk_at_50", "risk_at_80", "risk_at_90"]:
            row[f"{prefix}{k}"] = float(rc[k])
    rel = block.get("reliability")
    if isinstance(rel, dict):
        for k, (cnt, acc, conf) in enumerate(
            zip(rel["count"], rel["accuracy"], rel["confidence"])
        ):
            row[f"{prefix}rel_bin{k:02d}_count"] = float(cnt)
            row[f"{prefix}rel_bin{k:02d}_acc"] = float(acc)
            row[f"{prefix}rel_bin{k:02d}_conf"] = float(conf)


def _flatten_common(row: dict, sample_info: Dict[str, Any]) -> dict:
    _add_block(row, "fused_", sample_info.get("fused", {}))
    _add_block(row, "shared_", sample_info.get("shared", {}))
    for i, v in enumerate(sample_info.get("per_view", [])):
        _add_block(row, f"view_{i}_", v)
    pce = sample_info.get("per_class_evidence", {})
    uncond = pce.get("unconditional", {})
    truec = pce.get("true_class", {})
    for key in ("fused", "shared"):
        arr = uncond.get(key)
        if isinstance(arr, (list, tuple)):
            for k, val in enumerate(arr):
                row[f"{key}_per_class_evidence_class_{k}"] = float(val)
        arr = truec.get(key)
        if isinstance(arr, (list, tuple)):
            for k, val in enumerate(arr):
                row[f"{key}_per_class_evidence_true_class_{k}"] = float(val)
    for i, arr in enumerate(uncond.get("per_view", [])):
        if isinstance(arr, (list, tuple)):
            for k, val in enumerate(arr):
                row[f"view_{i}_per_class_evidence_class_{k}"] = float(val)
    for i, arr in enumerate(truec.get("per_view", [])):
        if isinstance(arr, (list, tuple)):
            for k, val in enumerate(arr):
                row[f"view_{i}_per_class_evidence_true_class_{k}"] = float(val)
    return row


def flatten_sample_info_datasets(sample_info: Dict[str, Any], *, seed: Union[int, str],
                                 typ: str, ds: str, model: str) -> Dict[str, Any]:
    """One tidy row per (seed, type, dataset, model)."""
    return _flatten_common({"seed": seed, "type": typ, "dataset": ds, "model": model},
                           sample_info)


def build_metrics_rows_datasets(nested) -> tuple:
    """nested[seed][type][ds][model] = sample_info -> (columns, rows): the
    id columns then the metric columns sorted, one dict per row (a metric a
    row lacks is absent from its dict)."""
    rows: List[dict] = []
    for seed, d_typ in nested.items():
        for typ, d_ds in d_typ.items():
            for ds, d_model in d_ds.items():
                for model, info in d_model.items():
                    rows.append(flatten_sample_info_datasets(info, seed=seed, typ=typ, ds=ds,
                                                             model=model))
    id_cols = ["seed", "type", "dataset", "model"]
    other = sorted({c for r in rows for c in r} - set(id_cols))
    return id_cols + other, rows

"""Reliability-diagram + risk-coverage SVG figures for the sweep report.

Counterpart of ``disentagled_multimodal_fusion_tpu/eval/uq_plots.py``,
copied: one figure per (condition, dataset) cell with two panels, the
fused head's reliability diagram (per-bin accuracy against confidence, the
15-bin data behind the ECE column) and the selective-prediction
risk-coverage curves, per model, averaged over seeds. The data are the
``reliability`` / ``risk_coverage`` entries that ``eval.analysis`` attaches
to each fused block; a model without them is skipped.

matplotlib is imported only when a figure is drawn, and is optional:
without it :func:`write_uq_plots` writes nothing and returns ``[]``.

Chart conventions: one fixed, CVD-validated categorical palette assigned
by MODEL (never by plot-local rank), 2px lines, recessive grid, text in
ink tokens rather than series colors, legend always present.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

__all__ = ["write_uq_plots", "MODEL_COLORS"]

# Fixed categorical palette (validated light-mode order: worst adjacent
# CVD dE 9.1, normal-vision dE 19.6 — passes the six checks). Slot order
# follows the canonical sweep model order; a model outside this table
# (rare: custom intermediate-fusion sweeps) folds into the last slot.
_PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
            "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_MODEL_ORDER = [
    "dmvae_dis", "dmvae_cml", "dmvae_joint",
    "dbf_fusion", "cml_fusion", "avg_fusion",
    "intermediate_fusion", "dssl_dis",
]
MODEL_COLORS: Dict[str, str] = {
    m: _PALETTE[i] for i, m in enumerate(_MODEL_ORDER)
}
_INK, _INK2, _GRID = "#0b0b0b", "#52514e", "#e4e3df"


def _color(model: str) -> str:
    return MODEL_COLORS.get(model, _PALETTE[-1])


def _mean_over_seeds(entries: List[dict], path: List[str]) -> np.ndarray:
    vals = []
    for e in entries:
        cur = e
        for k in path:
            cur = cur.get(k) if isinstance(cur, dict) else None
            if cur is None:
                return None
        vals.append(np.asarray(cur, dtype=np.float64))
    return np.mean(vals, axis=0) if vals else None


def _style_axes(ax):
    ax.set_facecolor("#fcfcfb")
    ax.grid(True, color=_GRID, linewidth=0.8)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(_INK2)
    ax.tick_params(colors=_INK2, labelsize=8)


def write_uq_plots(rows, outdir, fmt: str = "svg") -> List[str]:
    """rows[seed][cond][ds][model] = sample_info (write_sweep_report's
    nested layout). Writes ``{cond}_{ds}_uq.svg`` per cell; returns the
    written paths. Silently returns [] when matplotlib is unavailable or
    no row carries the round-5 UQ-depth entries, and on every rank but the
    writing one under a process group."""
    from ..parallel.distributed import is_writer

    if not is_writer():
        return []
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # matplotlib is optional
        return []

    # regroup: cell[(cond, ds)][model] = [fused_block per seed]
    cells: Dict[tuple, Dict[str, List[dict]]] = {}
    for by_cond in rows.values():
        for cond, by_ds in by_cond.items():
            for ds, by_model in by_ds.items():
                for model, info in by_model.items():
                    fused = info.get("fused") if isinstance(info, dict) else None
                    if isinstance(fused, dict) and "reliability" in fused:
                        cells.setdefault((cond, ds), {}) \
                            .setdefault(model, []).append(fused)

    written = []
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    for (cond, ds), models in sorted(cells.items()):
        fig, (ax_rel, ax_rc) = plt.subplots(
            1, 2, figsize=(9.2, 3.6), facecolor="#fcfcfb"
        )
        _style_axes(ax_rel)
        _style_axes(ax_rc)
        ax_rel.plot([0, 1], [0, 1], color=_INK2, linewidth=1.0,
                    linestyle=(0, (4, 3)), zorder=1)
        order = [m for m in _MODEL_ORDER if m in models] + sorted(
            m for m in models if m not in _MODEL_ORDER
        )
        for model in order:
            seeds = models[model]
            c = _color(model)
            # Count-weighted seed averaging: an empty bin reports acc=0 /
            # conf=0, so a plain mean across seeds drags occupied bins
            # toward zero wherever any seed left the bin empty (renders as
            # zig-zags). Weighting by per-seed bin count uses exactly the
            # rows that landed in the bin.
            withrel = [s for s in seeds if "reliability" in s]
            cnts = [np.asarray(s["reliability"]["count"], dtype=np.float64)
                    for s in withrel]
            if cnts:
                cnt = np.sum(cnts, axis=0)
                w_acc = np.sum([c_ * np.asarray(s["reliability"]["accuracy"])
                                for c_, s in zip(cnts, withrel)], axis=0)
                w_conf = np.sum([c_ * np.asarray(s["reliability"]["confidence"])
                                 for c_, s in zip(cnts, withrel)], axis=0)
                mask = cnt > 0  # empty bins carry no calibration signal
                safe = np.maximum(cnt, 1.0)
                ax_rel.plot((w_conf / safe)[mask], (w_acc / safe)[mask],
                            color=c, linewidth=2.0, marker="o",
                            markersize=4.5, label=model, zorder=3)
            cov = _mean_over_seeds(seeds, ["risk_coverage", "coverage"])
            risk = _mean_over_seeds(seeds, ["risk_coverage", "risk"])
            if cov is not None:
                ax_rc.plot(cov, risk, color=c, linewidth=2.0, label=model,
                           zorder=3)
        ax_rel.set_xlabel("mean confidence (bin)", color=_INK2, fontsize=9)
        ax_rel.set_ylabel("accuracy (bin)", color=_INK2, fontsize=9)
        ax_rel.set_title("Reliability (fused head)", color=_INK,
                         fontsize=10, loc="left")
        ax_rel.set_xlim(0, 1)
        ax_rel.set_ylim(0, 1)
        ax_rc.set_xlabel("coverage", color=_INK2, fontsize=9)
        ax_rc.set_ylabel("selective risk", color=_INK2, fontsize=9)
        ax_rc.set_title("Risk-coverage", color=_INK, fontsize=10, loc="left")
        ax_rc.set_xlim(0, 1)
        ax_rc.set_ylim(bottom=0)
        ax_rc.legend(loc="upper left", fontsize=7.5, frameon=False,
                     labelcolor=_INK2)
        fig.suptitle(f"{ds} / {cond} — seed-averaged UQ", color=_INK,
                     fontsize=11, x=0.01, ha="left")
        fig.tight_layout(rect=(0, 0, 1, 0.93))
        path = outdir / f"{cond}_{ds}_uq.{fmt}"
        fig.savefig(path, format=fmt, dpi=150)
        plt.close(fig)
        written.append(str(path))
    return written

"""The one corpus generator of the scoring loop: rows on the device, and a request's rows.

A cell's workload file (``workloads/<cell>.json``) gives ``corpus_rows`` and
``rows_per_request``; its configuration (``configs/<config>.json``) gives
how a row is made, under ``corpus``:

* ``"kind": "mat_rows"``: rows of a ``.mat`` file in the checkout (``file``,
  its views under ``views_key`` as the reference's loader reads them),
  each view min-max scaled per feature to [0, 1] as that loader does, in
  an order drawn from the seed (a permutation, as a seeded split shuffles
  them), the first ``corpus_rows`` of it;
* ``"kind": "features"``: one entry per view under ``views``, each
  ``{"width": w, "law": "normal"}`` (standard normal) or ``{"width": w,
  "law": "token_ids", "vocab": n}`` (ids uniform over the vocabulary,
  divided by its size, the form the LUMA loader gives token ids).

Request k is rows ``[k R mod N, k R mod N + R)`` of the corpus (consecutive
rows, cycling). Every seed gives the same sizes; only the values differ.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = x.min(axis=0), x.max(axis=0)
    span = hi - lo
    span[span == 0.0] = 1.0
    return ((x - lo) / span).astype(np.float32)


def make_corpus(corpus: dict, rows: int, generator: torch.Generator,
                root: Path) -> Tuple[torch.Tensor, ...]:
    """The views of a ``rows``-row corpus, float32 on the generator's device."""
    device = generator.device
    if corpus["kind"] == "mat_rows":
        import scipy.io

        data = scipy.io.loadmat(str(root / corpus["file"]))[corpus["views_key"]][0]
        views = [torch.from_numpy(_minmax(np.asarray(v, dtype=np.float64))).to(device)
                 for v in data]
        if rows > views[0].shape[0]:
            raise ValueError(f"{corpus['file']} has {views[0].shape[0]} rows, not {rows}")
        order = torch.randperm(views[0].shape[0], generator=generator, device=device)[:rows]
        return tuple(v[order] for v in views)
    if corpus["kind"] == "features":
        out = []
        for view in corpus["views"]:
            shape = (rows, view["width"])
            if view["law"] == "normal":
                out.append(torch.randn(shape, generator=generator, device=device))
            elif view["law"] == "token_ids":
                ids = torch.randint(0, view["vocab"], shape, generator=generator, device=device)
                out.append(ids.float() / view["vocab"])
            else:
                raise ValueError(f"unknown feature law {view['law']!r}")
        return tuple(out)
    raise ValueError(f"unknown corpus kind {corpus['kind']!r}")


def request(corpus: Sequence[torch.Tensor], rows_per_request: int, k: int):
    """The views of request ``k`` (views of the corpus, no copy)."""
    lo = (k * rows_per_request) % corpus[0].shape[0]
    return tuple(v[lo:lo + rows_per_request] for v in corpus)

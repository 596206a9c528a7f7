"""The closed scoring loop of a configuration whose text view goes through a language-model tower.

As ``loops/closed.py`` (one client, consecutive requests of a corpus,
the same window, readings and check, reused from it), with what a tower
of 15.5 B bf16 parameters changes in the set-up:

* the weights: the rest of the model is drawn as ``closed.py`` draws it,
  the tower's per tensor in bf16 on the card, one layer at a time, by
  ``models/<config>.py``'s ``build``, which hands the same tensors to the
  port (loaded by assignment, no copy) and adds them to the weights the
  plain reference reads;
* the corpus: the configuration's ``corpus.views`` are ``{"width": w,
  "law": "normal"}`` (standard normal, float32) or ``{"width": w, "law":
  "ids", "vocab": n}`` (token ids uniform over the vocabulary, int64: the
  tower's input, which ``traffic.py``'s ``token_ids`` law would divide
  into floats);
* the constants add ``expert_bound_s``, the expert kernel's least time a
  request (``models/<config>.py``'s ``expert_bound_s``).

With ``system="control"`` (``calibrate.py --control-seeds``) the plain
reference stands in the port's place with the tower's weights read in
e4m3, the precision below the tower's bf16 (``closed.py``'s TF32 control
is finer than bf16): the same draws, each product's weight and the
embedding rounded to e4m3 at a per-tensor power-of-two scale as the
reference reads them (the norm scales and the rest of the model as
drawn), so the card holds one tower. ``check`` holds it, as it holds the
port, to the reference on the weights as drawn; PERF.md gives its
readings, each above a limit.
"""

from __future__ import annotations

import random
from collections.abc import Mapping
from pathlib import Path

import torch

from port_bench import bounds, registry, weights

closed = registry.module("loops", "closed", Path(__file__).resolve().parents[1])


def make_corpus(corpus: dict, rows: int, generator: torch.Generator):
    """The views of a ``rows``-row corpus on the generator's device."""
    out = []
    for view in corpus["views"]:
        shape = (rows, view["width"])
        if view["law"] == "normal":
            out.append(torch.randn(shape, generator=generator, device=generator.device))
        elif view["law"] == "ids":
            out.append(torch.randint(0, view["vocab"], shape, generator=generator,
                                     device=generator.device))
        else:
            raise ValueError(f"unknown view law {view['law']!r}")
    return tuple(out)


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, rounded to e4m3 at the power-of-two scale that
    brings its largest magnitude to at most 448, e4m3's largest."""
    t = t.float()
    scale = 2.0 ** torch.ceil(torch.log2(t.abs().amax().clamp(min=1e-30) / 448.0))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _ReadInE4M3:
    """A weight the reference reads with ``float()``, rounded to e4m3 then."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def float(self) -> torch.Tensor:
        return e4m3(self.t)


class E4M3Tower(Mapping):
    """The weights, with every tower tensor under ``prefix`` but the norm
    scales read in e4m3: rounded as the reference reads it (a layer at a
    time), never stored."""

    def __init__(self, w: dict, prefix: str):
        self.w, self.prefix = w, prefix

    def _rounded(self, key: str) -> bool:
        return key.startswith(self.prefix) and not key.endswith("norm.weight")

    def __getitem__(self, key):
        v = self.w[key]
        return e4m3(v) if self._rounded(key) else v

    def __iter__(self):
        return iter(self.w)

    def __len__(self):
        return len(self.w)

    def items(self):
        for key, v in self.w.items():
            yield key, (_ReadInE4M3(v) if self._rounded(key) else v)


class ClosedTower(closed.Closed):
    def __init__(self, cell: registry.Cell):
        from disentagled_multimodal_fusion_tpu_torch.core.serve import to_host

        cfg, wl = cell.config, cell.workload
        if wl["corpus_rows"] % wl["rows_per_request"]:
            raise ValueError("corpus_rows must be a multiple of rows_per_request")
        self.cell, self.to_host = cell, to_host
        self.models = registry.module("models", cell.entry["config"], cell.here)
        self.reference = registry.module("reference", cell.entry["config"], cell.here)
        self.model, self.rows = wl["model"], wl["rows_per_request"]
        generator = torch.Generator(device=cell.device)
        generator.manual_seed(cell.seed)
        self.w = weights.draw(self.models.params(cfg, self.model), generator)
        self.corpus = make_corpus(cfg["corpus"], wl["corpus_rows"], generator)
        cell.phase("weights and corpus")
        if cell.system == "port":
            self.infer = self.models.build(cfg, self.model, self.w, cell.device, generator)
        elif cell.system == "control":
            for layer in self.models.tower_weights(cfg, generator):
                self.w.update(layer)
            rounded = E4M3Tower(self.w, self.models.tower_prefix(cfg))
            self.infer = lambda xs: self.reference.forward(cfg, self.model, rounded, xs)
        else:
            raise ValueError(f"system {cell.system!r}")
        cell.phase("tower weights and build")
        for k in range(closed.WARMUP_REQUESTS):
            self.warm(k)
        self.sample, self.k = closed._Sample(wl["compare_requests"], random.Random(cell.seed)), 0
        self.constants = dict(
            rows_per_request=self.rows, flops_per_row=self.models.flops_per_row(cfg, self.model),
            head_bound_s=bounds.head_bound_s(self.models.head_views(cfg, self.model), self.rows,
                                             cfg["probes"]["hidden_dim"],
                                             cfg["num_classes"])[0],
            expert_bound_s=self.models.expert_bound_s(cfg, self.rows)[0])


def set_up(cell: registry.Cell) -> ClosedTower:
    return ClosedTower(cell)

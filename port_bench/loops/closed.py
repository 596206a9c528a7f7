"""The closed scoring loop: one client scores consecutive requests of a corpus on the card.

A cell with ``"loop": "closed"`` gives in ``workloads/<cell>.json`` the
served ``model``, ``corpus_rows``, ``rows_per_request``,
``compare_requests`` and the ``limits`` of the numbers compared; its
configuration gives the widths and how the corpus is made (``traffic.py``).

``set_up`` draws the weights and the corpus from the seed on the card,
builds the port's inference function (``models/<config>.py``:
``core.serve.build_inference_fn``, the port's ``InferenceModule``) and warms
up the cell's one request shape. A window then serves requests for its
seconds, as an evaluation loop calls: request k is rows ``[k R mod N, k R
mod N + R)`` of the corpus, and it runs from the call into the inference
function until its six outputs are numpy arrays on the host (the port's
``core.serve.to_host``); request k + 1 follows. A uniform sample of the
requests, drawn from the seed, keeps its outputs. ``check`` frees the port
and recomputes the sample with the plain reference
(``reference/<config>.py``) from the same weights and rows; ``compare.py``
measures the gaps. With ``system="control"`` the reference in TF32 stands
in the port's place (``calibrate.py`` reads it; the benchmark never).

A window's readings: ``attempted``, ``failed``, ``requests`` and ``rows``
completed, ``window_s``, and per request ``latency_s`` (call to numpy
outputs) and ``issue_s`` (call to the inference function's return). The
run's constants: ``rows_per_request``, ``flops_per_row`` (model FLOPs from
the published widths) and ``head_bound_s`` (the head kernel's bound a
request).
"""

from __future__ import annotations

import gc
import math
import random
import time

import numpy as np
import torch

from port_bench import bounds, compare, registry, traffic, weights

WARMUP_REQUESTS = 3


class _Sample:
    """A uniform sample of ``size`` requests of a stream (reservoir)."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.kept, self.seen = size, rng, [], 0

    def offer(self, k: int, outputs) -> None:
        if len(self.kept) < self.size:
            self.kept.append((k, outputs))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = (k, outputs)
        self.seen += 1


class Closed:
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
        self.corpus = traffic.make_corpus(cfg["corpus"], wl["corpus_rows"], generator, cell.root)
        cell.phase("weights and corpus")
        if cell.system == "port":
            self.infer = self.models.build(cfg, self.model, self.w, cell.device)
        elif cell.system == "control":
            self.infer = lambda xs: self.reference.forward(cfg, self.model, self.w, xs, tf32=True)
        else:
            raise ValueError(f"system {cell.system!r}")
        cell.phase("build")
        for k in range(WARMUP_REQUESTS):
            self.warm(k)
        self.sample, self.k = _Sample(wl["compare_requests"], random.Random(cell.seed)), 0
        self.constants = dict(
            rows_per_request=self.rows, flops_per_row=self.models.flops_per_row(cfg, self.model),
            head_bound_s=bounds.head_bound_s(self.models.head_views(cfg, self.model), self.rows,
                                             cfg["probes"]["hidden_dim"],
                                             cfg["num_classes"])[0])

    def warm(self, k: int = 0) -> None:
        self.to_host(self.infer(traffic.request(self.corpus, self.rows, k)))

    def window(self, seconds: float) -> dict:
        latency, issue, failed, first_error, k0 = [], [], 0, None, self.k
        t0 = time.perf_counter()
        end, last = t0 + seconds, t0
        while last < end:
            xs = traffic.request(self.corpus, self.rows, self.k)
            a = time.perf_counter()
            try:
                out = self.infer(xs)
                b = time.perf_counter()
                host = self.to_host(out)
            except Exception as err:  # a failed request counts; the loop goes on
                failed += 1
                first_error = first_error or repr(err)
                last = time.perf_counter()
                self.k += 1
                continue
            last = time.perf_counter()
            latency.append(last - a)
            issue.append(b - a)
            self.sample.offer(self.k, host)
            self.k += 1
        window_s = last - t0
        ms = np.percentile(latency, [50, 90, 95, 99, 100]) * 1e3 if latency else []
        self.cell.log(f"{len(latency)} requests of {self.rows} rows in {window_s:.3f} s; "
                      "latency ms " + " ".join(f"p{q} {v:.4f}"
                                               for q, v in zip((50, 90, 95, 99, 100), ms)))
        if first_error:
            self.cell.log(f"{failed} requests failed; the first: {first_error}")
        return dict(attempted=self.k - k0, failed=failed, requests=len(latency),
                    rows=len(latency) * self.rows, window_s=window_s, latency_s=latency,
                    issue_s=issue)

    def check(self) -> dict:
        cell, cfg = self.cell, self.cell.config
        del self.infer
        gc.collect()
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        if not self.sample.kept:
            return {n: math.inf for n in compare.NAMES}
        values, t0 = None, time.perf_counter()
        for k, host in self.sample.kept:
            ref = self.reference.forward(cfg, self.model, self.w,
                                         traffic.request(self.corpus, self.rows, k))
            got = {key: torch.as_tensor(np.asarray(v)).to(cell.device) for key, v in host.items()}
            g = compare.gaps(got, ref)
            values = g if values is None else compare.widest(values, g)
        cell.log(f"the reference checked {len(self.sample.kept)} requests in "
                 f"{time.perf_counter() - t0:.3f} s")
        return values


def set_up(cell: registry.Cell) -> Closed:
    return Closed(cell)

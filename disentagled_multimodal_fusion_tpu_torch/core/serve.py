"""Inference path: raw views in, predictions and Dirichlet uncertainty out.

Counterpart of ``build_inference_fn`` and ``ServingEngine`` of
``disentagled_multimodal_fusion_tpu/core/serve.py``, with the same six
output keys. The frozen backbone's ``get_embedding`` and the evidential
head run back to back on the task's device; the head's forward is the
evidential head kernel (``ops/cuda_kernels.py``) on the card.

The engine pads each request up to a static batch bucket with copies of
row 0 and slices the padding off after the call, in numpy. Every served
model is row-independent in eval mode, so padding never changes a real row.
The mesh-sharded branch and exported artifacts of the JAX package are not
ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.dirichlet import dirichlet_uncertainties

__all__ = ["build_inference_fn", "ServingEngine", "DEFAULT_BUCKETS", "to_host"]

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def to_host(out: dict) -> dict:
    """The output dict with every tensor copied to a numpy array."""
    return {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in out.items()
    }


def build_inference_fn(task, *, backbone=None):
    """``fn(xs) -> dict`` from raw views to predictions and uncertainties.

    task
        A :class:`~.tasks.EvidentialTask`; its model's device is where the
        function runs.
    backbone
        When given, the frozen backbone's ``get_embedding`` turns the views
        into (zc, zp) for a probe; otherwise the task takes the views
        themselves (late fusion).

    ``xs`` are per-view (B, S_i) arrays or tensors. The outputs are tensors
    on the task's device: ``pred`` (B,), ``probs`` (B, C) the Dirichlet mean
    alpha/S, ``evidence`` (B, V, C) per view, ``fused_evidence`` (B, C),
    ``epistemic`` (B,) = K/S and ``aleatoric`` (B,).
    """
    device = next(task.model.parameters()).device

    def as_tensor(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=device, dtype=torch.float32)

    @torch.inference_mode()
    def infer(xs: Sequence):
        xs = tuple(as_tensor(x) for x in xs)
        if backbone is not None:
            zc, zp_list = backbone.get_embedding(xs)
            data = {"zc": zc, "zp": torch.stack(zp_list, dim=1)}
        else:
            data = {"xs": xs}
        ev = task.evidences_fn(data)
        fused = task.aggregation(ev)
        alpha = fused.float() + 1.0
        epistemic, aleatoric = dirichlet_uncertainties(fused, task.num_classes)
        return {
            "pred": torch.argmax(fused, dim=-1),
            "probs": alpha / torch.sum(alpha, dim=-1, keepdim=True),
            "evidence": ev,
            "fused_evidence": fused,
            "epistemic": epistemic,
            "aleatoric": aleatoric,
        }

    return infer


class ServingEngine:
    """Static-shape batch buckets around an inference fn.

    Each request is rounded up to the next bucket (padding with copies of
    row 0), run, and sliced back; requests larger than the top bucket run
    at the next multiple of it. Returns numpy arrays.
    """

    def __init__(self, infer_fn, buckets: Sequence[int] = DEFAULT_BUCKETS):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive: {buckets}")
        self.infer_fn = infer_fn
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return ((n + top - 1) // top) * top

    def warmup(self, xs_sample: Sequence) -> None:
        """Run every bucket once, from one row."""
        row = tuple(np.asarray(x)[:1] for x in xs_sample)
        for b in self.buckets:
            to_host(self.infer_fn(tuple(np.broadcast_to(x, (b, *x.shape[1:])) for x in row)))

    def __call__(self, xs: Sequence):
        xs = tuple(np.asarray(x) for x in xs)
        n = xs[0].shape[0]
        if n == 0:
            raise ValueError("empty batch")
        b = self.bucket_for(n)
        if b != n:
            xs = tuple(
                np.concatenate([x, np.broadcast_to(x[:1], (b - n, *x.shape[1:]))], axis=0)
                for x in xs
            )
        out = to_host(self.infer_fn(xs))
        if b != n:
            out = {k: v[:n] for k, v in out.items()}
        return out

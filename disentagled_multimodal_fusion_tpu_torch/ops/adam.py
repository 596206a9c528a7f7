"""Adam/AdamW with optax's arithmetic, shared by the step loop and the plain
version of the probe-epoch kernel (the CUDA kernel repeats it in device code).

As ``_make_tx`` of ``disentagled_multimodal_fusion_tpu/core/train.py``:
``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
root, bias corrections 1 - b^count of the step's count), then the decoupled
weight decay added, then times -lr. ``torch.optim`` is not used, so that
the step loop and the kernel share one arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def bias_corrections(count: int):
    """(1 - b1^count, 1 - b2^count) in float32, as optax computes them."""
    f32 = np.float32
    c = f32(count)
    return float(f32(1.0) - f32(B1) ** c), float(f32(1.0) - f32(B2) ** c)


@torch.no_grad()
def adam_update(params, moments, grads, bc1, bc2, lr, weight_decay: float) -> None:
    """One step in place; ``moments`` holds an (m, v) pair per parameter."""
    for p, (m, v), g in zip(params, moments, grads):
        m.mul_(B1).add_((1.0 - B1) * g)
        v.mul_(B2).add_((1.0 - B2) * (g * g))
        upd = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        if weight_decay > 0.0:
            upd = upd + weight_decay * p
        p.sub_(lr * upd)

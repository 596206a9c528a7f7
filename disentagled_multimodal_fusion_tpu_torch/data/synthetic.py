"""Seeded synthetic multi-view generators.

The port's own copy of ``disentagled_multimodal_fusion_tpu/data/synthetic.py``
(numpy only), so a seed gives the JAX package's arrays bit for bit
(``tests/test_torch_synthetic.py``).

* :class:`SimpleTwoModalPlus` — 2 modalities with a dependence knob rho
  (``G_i = sqrt(rho) S0 + sqrt(1-rho) E_i``), shared/private class means with
  a class-signal allocation knob, per-class random-orthogonal conflict
  rotation of the shared means in modality 2, spurious dims, and
  heteroscedastic noise (reference: datasets/dataset.py:331-455).
* :func:`generate_data_simple` — the v1 generator: linear maps from latents
  with a single shared_frac mixing knob and a frozen-MLP median-threshold
  label (reference: datasets/dataset.py:71-160).

Everything is generated eagerly with a seeded numpy Generator (the reference
uses a seeded torch.Generator — distributional semantics are identical, the
bitstreams differ).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


def _rand_orthogonal(d: int, rng: np.random.Generator) -> np.ndarray:
    """Haar-ish random orthogonal via QR with sign fix (dataset.py:324-328)."""
    m = rng.standard_normal((d, d))
    q, r = np.linalg.qr(m)
    return q @ np.diag(np.sign(np.diag(r)))


class SimpleTwoModalPlus:
    """Simple 2-modality dataset with tunable dependence + difficulty knobs."""

    def __init__(
        self,
        n_samples: int = 1000,
        n_classes: int = 3,
        d_signal: int = 16,
        d_spurious: int = 16,
        rho: float = 0.5,
        shared_class_frac: float = 1.0,
        class_sep_shared: float = 1.0,
        class_sep_private: float = 1.0,
        alpha_shared: float = 0.7,
        beta_specific: float = 0.6,
        noise_std: float = 0.8,
        hetero_noise: bool = True,
        hetero_scale: float = 0.5,
        nonlinear_shared: bool = True,
        nonlinear_specific: bool = False,
        conflict_frac: float = 0.5,
        conflict_strength: float = 0.8,
        seed: int = 0,
        **_ignored,
    ):
        assert 0.0 <= rho <= 1.0 and 0.0 <= shared_class_frac <= 1.0
        rng = np.random.default_rng(seed)
        f32 = np.float32

        y = rng.integers(0, n_classes, n_samples)
        d = d_signal
        s0 = rng.standard_normal((n_samples, d))
        a = math.sqrt(rho)
        e1 = rng.standard_normal((n_samples, d))
        e2 = rng.standard_normal((n_samples, d))
        g1 = a * s0 + math.sqrt(1 - a * a) * e1
        g2 = a * s0 + math.sqrt(1 - a * a) * e2

        mu_sh = rng.standard_normal((n_classes, d)) * class_sep_shared
        mu_p1 = rng.standard_normal((n_classes, d)) * class_sep_private
        mu_p2 = rng.standard_normal((n_classes, d)) * class_sep_private
        mu_sh_y = mu_sh[y]

        # Per-class conflict rotation of shared means, modality 2 only.
        conflict_mask = rng.random(n_classes) < conflict_frac
        rotations = np.stack(
            [
                (1.0 - conflict_strength) * np.eye(d)
                + conflict_strength * _rand_orthogonal(d, rng)
                if conflict_mask[c]
                else np.eye(d)
                for c in range(n_classes)
            ]
        )
        mu_sh_y_mod2 = np.einsum("nd,ndk->nk", mu_sh_y, rotations[y])

        u1 = rng.standard_normal((n_samples, d))
        u2 = rng.standard_normal((n_samples, d))

        sfrac = shared_class_frac
        x1_shared = g1 + sfrac * mu_sh_y
        x2_shared = g2 + sfrac * mu_sh_y_mod2
        if nonlinear_shared:
            x1_shared = np.tanh(x1_shared)
            x2_shared = np.tanh(x2_shared)
        x1_shared = alpha_shared * x1_shared
        x2_shared = alpha_shared * x2_shared

        pfrac = 1.0 - sfrac
        x1_spec = u1 + pfrac * mu_p1[y]
        x2_spec = u2 + pfrac * mu_p2[y]
        if nonlinear_specific:
            x1_spec = np.tanh(x1_spec)
            x2_spec = np.tanh(x2_spec)
        x1_spec = beta_specific * x1_spec
        x2_spec = beta_specific * x2_spec

        x1 = x1_shared + x1_spec
        x2 = x2_shared + x2_spec
        if d_spurious > 0:
            x1 = np.concatenate([x1, rng.standard_normal((n_samples, d_spurious))], 1)
            x2 = np.concatenate([x2, rng.standard_normal((n_samples, d_spurious))], 1)

        if hetero_noise:
            m1 = 1.0 + hetero_scale * (2 * rng.random((n_samples, 1)) - 1.0)
            m2 = 1.0 + hetero_scale * (2 * rng.random((n_samples, 1)) - 1.0)
            n1 = rng.standard_normal(x1.shape) * noise_std * m1
            n2 = rng.standard_normal(x2.shape) * noise_std * m2
        else:
            n1 = rng.standard_normal(x1.shape) * noise_std
            n2 = rng.standard_normal(x2.shape) * noise_std

        self.X1 = (x1 + n1).astype(f32)
        self.X2 = (x2 + n2).astype(f32)
        self.y = y.astype(np.int64)
        self.extras = {"G1": g1, "G2": g2, "mu_sh_y": mu_sh_y}

    def __len__(self):
        return self.X1.shape[0]


def make_simple_plus_splits(
    batch_size: int = 128, val_split: float = 0.2, seed: int = 0, **kwargs
):
    """Seeded random train/val split (reference: dataset.py:460-471).

    Returns (dataset, train_arrays, val_arrays) where each arrays tuple is
    ((X1, X2), y).
    """
    kwargs.pop("val_split", None)
    ds = SimpleTwoModalPlus(seed=seed, **kwargs)
    n = len(ds)
    n_val = int(val_split * n)
    rng = np.random.default_rng(seed + 997)
    perm = rng.permutation(n)
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    train = ((ds.X1[train_idx], ds.X2[train_idx]), ds.y[train_idx])
    val = ((ds.X1[val_idx], ds.X2[val_idx]), ds.y[val_idx])
    return ds, train, val


# ----------------------------------------------------------- v1 generator
def _normalize(c: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    c = c - c.mean(axis=0, keepdims=True)
    s = c.std(axis=0, keepdims=True)
    return c / np.where(s < eps, eps, s)


def _mix(a, b, frac_shared, normalize=True):
    if normalize:
        a, b = _normalize(a), _normalize(b)
    return (1.0 - frac_shared) * a + frac_shared * b


def _frozen_mlp(rng: np.random.Generator, in_dim: int, hidden: int, layers: int = 2):
    """Frozen 2-layer ReLU MLP with torch-default (kaiming-uniform a=sqrt(5))
    init semantics (dataset.py:47-56)."""
    ws, bs, d = [], [], in_dim
    for out in [hidden] * layers + [1]:
        bound_w = math.sqrt(6.0 / ((1 + 5) * d))  # kaiming_uniform(a=sqrt5) on fan_in
        ws.append(rng.uniform(-bound_w, bound_w, size=(d, out)))
        bound_b = 1.0 / math.sqrt(d)
        bs.append(rng.uniform(-bound_b, bound_b, size=(out,)))
        d = out

    def apply(x):
        h = x
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = h @ w + b
            if i < len(ws) - 1:
                h = np.maximum(h, 0.0)
        return h[:, 0]

    return apply


def generate_data_simple(
    n_samples: int,
    dim_info: Dict[str, int],
    shared_frac: float = 0.5,
    noise_std: float = 0.10,
    seed: int = 0,
    normalize_components: bool = True,
    return_latents: bool = True,
    hidden_dim: int = 100,
):
    """v1 generator (dataset.py:71-160): latents -> linear views mixed by
    shared_frac; binary label from a frozen MLP on weighted latents,
    median-thresholded."""
    if not (0.0 <= shared_frac <= 1.0):
        raise ValueError("shared_frac must be in [0,1].")
    rng = np.random.default_rng(seed)
    ds, d1, d2 = dim_info["Zs"], dim_info["Z1"], dim_info["Z2"]
    dx, dy = dim_info["X"], dim_info["Y"]

    zs = rng.normal(0, np.sqrt(0.5), (n_samples, ds)).astype(np.float32)
    z1 = rng.normal(0, np.sqrt(0.5), (n_samples, d1)).astype(np.float32)
    z2 = rng.normal(0, np.sqrt(0.5), (n_samples, d2)).astype(np.float32)

    t1p = rng.uniform(-1, 1, (d1, dx)).astype(np.float32)
    t1s = rng.uniform(-1, 1, (ds, dx)).astype(np.float32)
    t2p = rng.uniform(-1, 1, (d2, dy)).astype(np.float32)
    t2s = rng.uniform(-1, 1, (ds, dy)).astype(np.float32)

    x = _mix(z1 @ t1p, zs @ t1s, shared_frac, normalize_components)
    y_view = _mix(z2 @ t2p, zs @ t2s, shared_frac, normalize_components)
    if noise_std and noise_std > 0:
        x = x + rng.normal(0, noise_std, x.shape).astype(np.float32)
        y_view = y_view + rng.normal(0, noise_std, y_view.shape).astype(np.float32)

    w_sh = shared_frac
    w_p = (1.0 - shared_frac) * 0.5
    parts = []
    if d1 > 0 and w_p > 0:
        parts.append(_normalize(z1) * w_p)
    if ds > 0 and w_sh > 0:
        parts.append(_normalize(zs) * w_sh)
    if d2 > 0 and w_p > 0:
        parts.append(_normalize(z2) * w_p)
    label_in = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]

    mlp = _frozen_mlp(rng, label_in.shape[1], hidden_dim, layers=2)
    logits = 4.0 * mlp(label_in)
    probs = 1.0 / (1.0 + np.exp(-logits))
    labels = (probs >= np.median(probs)).astype(np.float32)

    if dx == dy:
        total = np.stack([x.astype(np.float32), y_view.astype(np.float32)], axis=0)
    else:
        total = [x.astype(np.float32), y_view.astype(np.float32)]

    extras = None
    if return_latents:
        extras = dict(Zs=zs, Z1=z1, Z2=z2, X=x, Y=y_view,
                      shared_frac=shared_frac, noise_std=noise_std)
    return total, labels, extras

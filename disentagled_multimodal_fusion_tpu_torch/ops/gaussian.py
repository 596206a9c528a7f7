"""Gaussian latent-variable ops: reparameterisation, KL, product-of-experts.

Counterpart of ``disentagled_multimodal_fusion_tpu/ops/gaussian.py``, over
a stacked ``(K, B, D)`` expert axis.
"""

from __future__ import annotations

import torch


def reparameterize(eps: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """``mu + eps * exp(0.5 logvar)``; the caller draws ``eps ~ N(0, I)``,
    so that a test can feed both frameworks the same noise. The noise is
    taken in mu's type, as the JAX package draws it (bf16 under a bf16
    compute type)."""
    return mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar)


def gaussian_kl_standard(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL( N(mu, sigma^2) || N(0, I) ) summed over the feature dim, per row (B,)."""
    return -0.5 * torch.sum(1.0 + logvar - mu**2 - torch.exp(logvar), dim=1)


def product_of_experts(
    mus: torch.Tensor,
    logvars: torch.Tensor,
    temperature: float = 1.0,
    include_prior: bool = True,
):
    """Tempered Gaussian PoE with an optional N(0, I) prior expert.

    mus/logvars: (K, B, D). Each precision is divided by ``temperature``.
    Returns (mu, logvar), each (B, D).
    """
    if include_prior:
        mus = torch.cat([mus, torch.zeros_like(mus[:1])], dim=0)
        logvars = torch.cat([logvars, torch.zeros_like(logvars[:1])], dim=0)
    precisions = torch.exp(-logvars) / max(temperature, 1e-8)
    var = 1.0 / (torch.sum(precisions, dim=0) + 1e-8)
    mu = var * torch.sum(precisions * mus, dim=0)
    return mu, torch.log(var)

"""N-modal DMVAE with per-modality MLPs, inference half.

Counterpart of ``disentagled_multimodal_fusion_tpu/models/dmvae.py``
(``get_embedding``, its lines 110-122), used for ``--no-fused-dmvae``. Each
encoder emits [mu_s, logvar_s, mu_p, logvar_p]; the shared embedding is the
tempered PoE of the mu_s experts with a N(0, I) prior expert. Its ELBO
forward is not ported yet; training uses the fused model.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.gaussian import product_of_experts
from .layers import MLP


def _masked_mean_rows(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over batch rows of a (B,) vector, restricted to mask == 1."""
    if mask is None:
        return torch.mean(x)
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


class DMVAE(nn.Module):
    """N-modal DMVAE (N >= 2)."""

    def __init__(self, x_dims: Sequence[int], generator: torch.Generator,
                 hidden_dim: int = 512, embed_dim: int = 100,
                 poe_temperature: float = 1.5):
        super().__init__()
        if len(x_dims) < 2:
            raise ValueError("DMVAE needs at least two modalities")
        self.x_dims = tuple(x_dims)
        self.embed_dim = embed_dim
        self.poe_temperature = poe_temperature
        self.encoders = nn.ModuleList(
            MLP((d, hidden_dim, hidden_dim), 4 * embed_dim, generator)
            for d in self.x_dims
        )
        self.decoders = nn.ModuleList(
            MLP((2 * embed_dim, hidden_dim, hidden_dim), d, generator)
            for d in self.x_dims
        )

    def get_embedding(self, xs, return_poe: bool = True):
        """(shared embedding, [private embedding per modality])."""
        stats = [torch.split(enc(x), self.embed_dim, dim=1) for enc, x in zip(self.encoders, xs)]
        mu_p_all = [s[2] for s in stats]
        if return_poe:
            mu_poe, _ = product_of_experts(
                torch.stack([s[0] for s in stats]), torch.stack([s[1] for s in stats]),
                temperature=self.poe_temperature, include_prior=True,
            )
            return mu_poe, mu_p_all
        return torch.cat([s[0] for s in stats], dim=1), mu_p_all

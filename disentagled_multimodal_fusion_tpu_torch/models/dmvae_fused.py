"""FusedDMVAE: the modality-stacked DMVAE, inference half.

Counterpart of ``disentagled_multimodal_fusion_tpu/models/dmvae_fused.py``.
Views are zero-padded to the widest view and stacked (B, N, Dmax); the N
per-modality MLPs are stacked weight tensors (N, Dmax, H) / (N, H, H) /
(N, H, 4E), one batched product per layer. Each slice is initialised with
its own modality's fan sizes and the padding stays zero, so padded input
columns contribute nothing. The ELBO forward comes with the training slice.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gaussian import product_of_experts
from .layers import torch_bias_init, xavier_uniform


class StackedMLP(nn.Module):
    """N parallel (in -> hidden* -> out) MLPs as one batched product per layer.

    Inputs (..., N, max(in_dims)); outputs (..., N, max(out_dims)), of which each
    modality's first ``out_dims[i]`` columns are valid. ``hidden`` is an int
    (two hidden layers of that width) or a sequence of hidden widths.
    Parameters ``w1, b1, w2, b2, ...`` have the JAX layout: w (N, in, out),
    b (N, out).
    """

    def __init__(self, in_dims: Sequence[int], hidden: Union[int, Sequence[int]],
                 out_dims: Sequence[int], generator: torch.Generator):
        super().__init__()
        n = len(in_dims)
        hiddens = [hidden, hidden] if isinstance(hidden, int) else list(hidden)
        widths = [*hiddens, max(out_dims)]
        fans, d_in = list(in_dims), max(in_dims)
        for li, width in enumerate(widths):
            w = torch.zeros((n, d_in, width))
            b = torch.zeros((n, width))
            for i, fan in enumerate(fans):
                w[i, :fan] = xavier_uniform((fan, width), generator)
                b[i] = torch_bias_init((width,), fan, generator)
            self.register_parameter(f"w{li + 1}", nn.Parameter(w))
            self.register_parameter(f"b{li + 1}", nn.Parameter(b))
            fans, d_in = [width] * n, width
        self.num_layers = len(widths)

    def layer(self, i: int):
        """(w, b) of layer ``i`` (0-based)."""
        return getattr(self, f"w{i + 1}"), getattr(self, f"b{i + 1}")

    def forward(self, x):
        y = x
        for i in range(self.num_layers):
            w, b = self.layer(i)
            y = torch.einsum("...nd,ndh->...nh", y, w) + b
            if i < self.num_layers - 1:
                y = torch.relu(y)
        return y


def pad_stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Zero-pad (B, d_i) views to the widest and stack them into (B, N, Dmax)."""
    width = max(x.shape[-1] for x in xs)
    return torch.stack([F.pad(x.float(), (0, width - x.shape[-1])) for x in xs], dim=1)


class FusedDMVAE(nn.Module):
    """Modality-stacked DMVAE; same ``get_embedding`` contract as
    :class:`~.dmvae.DMVAE`."""

    def __init__(self, x_dims: Sequence[int], generator: torch.Generator,
                 hidden_dim: int = 512, embed_dim: int = 100,
                 poe_temperature: float = 1.5):
        super().__init__()
        if len(x_dims) < 2:
            raise ValueError("DMVAE needs at least two modalities")
        n = len(x_dims)
        self.x_dims = tuple(x_dims)
        self.embed_dim = embed_dim
        self.poe_temperature = poe_temperature
        self.encoder = StackedMLP(
            self.x_dims, hidden_dim, (4 * embed_dim,) * n, generator
        )
        self.decoder = StackedMLP(
            (2 * embed_dim,) * n, hidden_dim, self.x_dims, generator
        )

    def encode_stats(self, xs):
        """(mu_s, logv_s, mu_p, logv_p), each (B, N, E)."""
        four = self.encoder(pad_stack(xs))
        return torch.split(four, self.embed_dim, dim=-1)

    def get_embedding(self, xs, return_poe: bool = True):
        """(shared embedding, [private embedding per modality])."""
        mu_s, logv_s, mu_p, _ = self.encode_stats(xs)
        mu_p_all = list(mu_p.unbind(dim=1))
        if return_poe:
            mu_poe, _ = product_of_experts(
                mu_s.movedim(1, 0), logv_s.movedim(1, 0),
                temperature=self.poe_temperature, include_prior=True,
            )
            return mu_poe, mu_p_all
        return mu_s.reshape(mu_s.shape[0], -1), mu_p_all

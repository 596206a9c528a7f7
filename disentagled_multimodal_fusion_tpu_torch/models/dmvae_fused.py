"""FusedDMVAE: the modality-stacked DMVAE.

Counterpart of ``disentagled_multimodal_fusion_tpu/models/dmvae_fused.py``.
Views are zero-padded to the widest view and stacked (B, N, Dmax); the N
per-modality MLPs are stacked weight tensors (N, Dmax, H) / (N, H, H) /
(N, H, 4E), one batched product per layer. Each slice is initialised with
its own modality's fan sizes and the padding stays zero, so padded input
columns contribute nothing.

``FusedDMVAE.forward`` is the training ELBO (JAX lines 200-292), each
modality's reconstruction weighted by ``lambda_per_modality``. Its three
reparameterisation draws, and with ``dropout`` its keep-masks
(``drop_shapes``), are inputs, so a test can feed the JAX draws. The
training forward keeps the reference's PoE temperature 1.5 whatever
``poe_temperature`` is (that one is ``get_embedding``'s).

``feature_encoders`` (specs for ``layers.build_encoders``, e.g. LUMA's Audio,
Text and Image encoders) encode the views before they are zero-padded and
stacked (JAX lines 166-177); ``x_dims`` are then the encoders' output
widths. The reconstruction target is the encoder features themselves, with
gradients through both sides (JAX line 251): the decoder chases a target
its own encoders move. The encoders train with their keep-masks
(``enc_drop_shapes``) and evaluate, with BatchNorm's running statistics,
in ``get_embedding``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gaussian import gaussian_kl_standard, product_of_experts, reparameterize
from .dmvae import _masked_mean_rows
from .layers import (Encoded, build_encoders, dense_cut, dropout, encode_views, local_mask,
                     norm_dtype, torch_bias_init, whole, xavier_uniform)


class StackedMLP(nn.Module):
    """N parallel (in -> hidden* -> out) MLPs as one batched product per layer.

    Inputs (..., N, max(in_dims)); outputs (..., N, max(out_dims)), of which each
    modality's first ``out_dims[i]`` columns are valid. ``hidden`` is an int
    (two hidden layers of that width) or a sequence of hidden widths.
    Parameters ``w1, b1, w2, b2, ...`` have the JAX layout: w (N, in, out),
    b (N, out). ``drop_masks`` (train mode) holds one boolean keep-mask
    (..., N, hidden) per hidden layer, applied after its ReLU as flax's
    ``Dropout`` does: ``where(mask, h / keep, 0)``.

    ``dtype`` (JAX lines 86-125) is the compute type: the input, each
    weight and each bias are rounded to it, each product is rounded to it
    and the bias added in it, ReLU and dropout run in it, and the output
    returns to float32 so that the VAE statistics, KL and MSE stay float32.
    The parameters stay float32.

    Each layer runs as ``layers.dense_cut``. Inside a ``model_split`` (the
    mesh's model axis) it holds this rank's blocks: with the DMVAE's
    two hidden layers of width h, w1 (N, in, h) is column-parallel, w2
    (N, h, h) column-parallel too (the rule tests the last axis first), so
    its input, w1's block, is gathered first, and the last layer (N, h,
    out) row-parallel; the dropout masks are cut to the block's columns.
    """

    takes_model_blocks = True

    def __init__(self, in_dims: Sequence[int], hidden: Union[int, Sequence[int]],
                 out_dims: Sequence[int], generator: torch.Generator, dtype=None):
        super().__init__()
        self.dtype = norm_dtype(dtype)
        n = len(in_dims)
        hiddens = [hidden, hidden] if isinstance(hidden, int) else list(hidden)
        widths = [*hiddens, max(out_dims)]
        fans, d_in = list(in_dims), max(in_dims)
        self.widths = []  # each layer's whole (in, out)
        for li, width in enumerate(widths):
            w = torch.zeros((n, d_in, width))
            b = torch.zeros((n, width))
            for i, fan in enumerate(fans):
                w[i, :fan] = xavier_uniform((fan, width), generator)
                b[i] = torch_bias_init((width,), fan, generator)
            self.register_parameter(f"w{li + 1}", nn.Parameter(w))
            self.register_parameter(f"b{li + 1}", nn.Parameter(b))
            self.widths.append((d_in, width))
            fans, d_in = [width] * n, width
        self.num_layers = len(widths)

    def layer(self, i: int):
        """(w, b) of layer ``i`` (0-based)."""
        return getattr(self, f"w{i + 1}"), getattr(self, f"b{i + 1}")

    def forward(self, x, drop_masks=None, keep: float = 1.0):
        y = x if self.dtype is None else x.to(self.dtype)
        for i in range(self.num_layers):
            w, b = self.layer(i)
            y = dense_cut(y, w, b, *self.widths[i], _stacked_product, self.dtype)
            if i < self.num_layers - 1:
                y = torch.relu(y)
                if drop_masks is not None:
                    y = dropout(y, local_mask(drop_masks[i], y), keep)
        return whole(y, self.widths[-1][1]).float()


def _stacked_product(x, w, b=None):
    y = torch.einsum("...nd,ndh->...nh", x, w)
    return y if b is None else y + b


def pad_stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Zero-pad (B, d_i) views to the widest and stack them into (B, N, Dmax)."""
    width = max(x.shape[-1] for x in xs)
    return torch.stack([F.pad(x.float(), (0, width - x.shape[-1])) for x in xs], dim=1)


class FusedDMVAE(Encoded):
    """Modality-stacked DMVAE; same ``get_embedding`` contract as
    :class:`~.dmvae.DMVAE`."""

    def __init__(self, x_dims: Sequence[int], generator: torch.Generator,
                 hidden_dim: int = 512, embed_dim: int = 100,
                 poe_temperature: float = 1.5, a: float = 1.0, cross_weight: float = 1.0,
                 dropout: float = 0.0, lambda_per_modality: Optional[Sequence[float]] = None,
                 feature_encoders=None, dtype=None):
        super().__init__()
        if len(x_dims) < 2:
            raise ValueError("DMVAE needs at least two modalities")
        n = len(x_dims)
        self.feat_encs = build_encoders(feature_encoders, generator)
        self.x_dims = tuple(x_dims)
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.keep = 1.0 - dropout
        self.poe_temperature = poe_temperature
        self.a = a
        self.cross_weight = cross_weight
        self.encoder = StackedMLP(
            self.x_dims, hidden_dim, (4 * embed_dim,) * n, generator, dtype
        )
        self.decoder = StackedMLP(
            (2 * embed_dim,) * n, hidden_dim, self.x_dims, generator, dtype
        )
        # each modality's true width, and its valid columns of the padded width
        dims = torch.tensor(self.x_dims, dtype=torch.float32)
        self.register_buffer("dims", dims, persistent=False)
        self.register_buffer("lam", torch.tensor(list(lambda_per_modality or [1.0] * n),
                                                 dtype=torch.float32), persistent=False)
        self.register_buffer("dim_mask", (torch.arange(max(x_dims))[None] < dims[:, None]).float(),
                             persistent=False)

    def encode_stats(self, xs):
        """(mu_s, logv_s, mu_p, logv_p), each (B, N, E), in eval mode."""
        four = self.encoder(pad_stack(encode_views(self.feat_encs, xs)))
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

    def noise_shapes(self, rows: int):
        """Shapes of the three standard-normal draws of :meth:`forward`."""
        n, e = len(self.x_dims), self.embed_dim
        return (rows, n, e), (rows, n, e), (rows, e)

    def drop_shapes(self, rows: int):
        """Shapes of the keep-masks of :meth:`forward`, none without
        dropout: the encoder's two hidden layers (rows, N, H), then the
        decoder's (N, rows, N, H), which decodes all N joint and cross rows."""
        if self.keep >= 1.0:
            return []
        n, h = len(self.x_dims), self.hidden_dim
        return [(rows, n, h)] * 2 + [(n, rows, n, h)] * 2

    def drop_rows(self, masks, lo: int, hi: int):
        """The keep-masks of :meth:`drop_shapes` at the batch's rows [lo, hi)."""
        return [m[lo:hi] for m in masks[:2]] + [m[:, lo:hi] for m in masks[2:]]

    def forward(self, xs, noise, mask=None, drop_masks=None, enc_masks=None):
        """Training ELBO of N views (B, S_i) -> (loss, logs).

        ``noise`` is (eps_p (B, N, E), eps_u (B, N, E), eps_s (B, E)), the
        draws of the private, unimodal-shared and PoE-shared latents;
        ``drop_masks`` the masks of :meth:`drop_shapes` (None without
        dropout); ``enc_masks`` the feature encoders' (one list per encoder,
        required with encoders); ``mask`` (B,) {0, 1} restricts every mean to
        the rows it keeps.
        """
        n, e = len(self.x_dims), self.embed_dim
        if self.feat_encs is not None and enc_masks is None:
            raise ValueError("the training forward needs the feature encoders' keep-masks")
        mlp_masks, dec_masks = (None, None) if not drop_masks else (drop_masks[:2],
                                                                    drop_masks[2:])
        x = pad_stack(encode_views(self.feat_encs, xs, enc_masks))  # (B, N, Dmax)
        b = x.shape[0]
        mu_s, logv_s, mu_p, logv_p = torch.split(self.encoder(x, mlp_masks, self.keep), e, dim=-1)
        eps_p, eps_u, eps_s = noise
        z_p = reparameterize(eps_p, mu_p, logv_p)                   # (B, N, E)
        z_s_uni = reparameterize(eps_u, mu_s, logv_s)               # (B, N, E)
        mu_poe, logv_poe = product_of_experts(
            mu_s.movedim(1, 0), logv_s.movedim(1, 0), temperature=1.5, include_prior=True,
        )
        z_s = reparameterize(eps_s, mu_poe, logv_poe)               # (B, E)

        # decode rows per modality i: row 0 joint (z_s), rows 1.. cross with
        # the other modalities' unimodal z_s in order j != i
        others = torch.stack(
            [torch.stack([z_s_uni[:, j] for j in range(n) if j != i]) for i in range(n)], dim=1
        )                                                           # (N-1, N, B, E)
        zs_rows = torch.cat([z_s[None, None].expand(1, n, b, e), others])  # (N, N, B, E)
        zp_rows = z_p.movedim(1, 0)[None].expand(n, n, b, e)
        dec_in = torch.cat([zp_rows, zs_rows], dim=-1).movedim(2, 1)  # (rows, B, N, 2E)
        recon = self.decoder(dec_in, dec_masks, self.keep)         # (rows, B, N, Dmax)

        # masked MSE per (row, modality) over the modality's true width
        row_mask = torch.ones(b, device=x.device) if mask is None else mask.float()
        se = (recon - x[None]) ** 2 * self.dim_mask[None, None] * row_mask[None, :, None, None]
        denom = torch.clamp(torch.sum(row_mask), min=1.0)
        per_pair = torch.sum(se, dim=(1, 3)) / (denom * self.dims[None, :])  # (rows, N)
        loss_recon_joint = torch.sum(self.lam * per_pair[0])
        loss_recon_cross = (torch.sum(self.lam * per_pair[1:]) / (n * (n - 1))
                            * self.cross_weight)

        def kl_rows(mu, logv):
            return torch.sum(-0.5 * torch.sum(1 + logv - mu ** 2 - torch.exp(logv), dim=-1), dim=1)

        kl_p = _masked_mean_rows(kl_rows(mu_p, logv_p), mask)
        kl_poe = _masked_mean_rows(gaussian_kl_standard(mu_poe, logv_poe), mask)
        kl_uni = _masked_mean_rows(kl_rows(mu_s, logv_s), mask)
        loss = (loss_recon_joint + self.a * (kl_p + n * kl_poe)
                + loss_recon_cross + self.a * kl_uni)
        logs = {
            "loss": loss,
            "loss_joint_recon": loss_recon_joint,
            "loss_cross_recon": loss_recon_cross,
            "kl_private": kl_p,
            "kl_shared_poe": kl_poe,
            "kl_shared_uni_sum": kl_uni,
        }
        return loss, logs

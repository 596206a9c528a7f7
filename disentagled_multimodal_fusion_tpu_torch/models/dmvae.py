"""N-modal DMVAE with per-modality MLPs.

Counterpart of ``disentagled_multimodal_fusion_tpu/models/dmvae.py``, used
for ``--no-fused-dmvae``. Each encoder emits [mu_s, logvar_s, mu_p,
logvar_p]; the shared embedding (``get_embedding``) is the tempered PoE of
the mu_s experts with a N(0, I) prior expert at the configured
``poe_temperature``. ``forward`` is the training ELBO (JAX lines 124-192):

    joint recon (PoE z_s) + cross recon (z_s from each other modality)
    + a * (KL_private_sum + N * KL_poe) + a * KL_shared_unimodal_sum

each reconstruction weighted by ``lambda_per_modality``. As in the
reference, the training forward's PoE temperature is 1.5 whatever
``poe_temperature`` is (JAX docstring, lines 11-14). Its draws are inputs,
so a test can feed the JAX ones: the reparameterisation noise
(``noise_shapes``) and, with ``dropout``, one boolean keep-mask per hidden
layer of every encoder and decoder (``drop_shapes``). ``feature_encoders``
encode the views first, as in ``dmvae_fused.FusedDMVAE``, whose
reconstruction target they are too.

With a compute ``dtype`` (bf16) every MLP runs in it and returns it, so,
as in the JAX package, the statistics, the reparameterised draws (the
noise rounded to the statistics' type, as JAX draws it in that type), the
PoE and the KL terms are bf16 too; each MSE against the float32 views is
float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.gaussian import gaussian_kl_standard, product_of_experts, reparameterize
from .layers import MLP, Encoded, build_encoders, encode_views


def _masked_mean_rows(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over batch rows of a (B,) vector, restricted to mask == 1."""
    if mask is None:
        return torch.mean(x)
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def _masked_mse(pred: torch.Tensor, target: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``F.mse_loss`` (the mean over every element), over the rows where
    ``mask`` is 1."""
    se = (pred - target) ** 2
    if mask is None:
        return torch.mean(se)
    m = mask.to(se.dtype).reshape(-1, *([1] * (se.dim() - 1)))
    denom = torch.clamp(torch.sum(mask), min=1.0) * (se.numel() / se.shape[0])
    return torch.sum(se * m) / denom


class DMVAE(Encoded):
    """N-modal DMVAE (N >= 2)."""

    def __init__(self, x_dims: Sequence[int], generator: torch.Generator,
                 hidden_dim: int = 512, embed_dim: int = 100,
                 poe_temperature: float = 1.5, a: float = 1.0,
                 dropout: float = 0.0, lambda_per_modality: Optional[Sequence[float]] = None,
                 feature_encoders=None, dtype=None):
        super().__init__()
        if len(x_dims) < 2:
            raise ValueError("DMVAE needs at least two modalities")
        self.feat_encs = build_encoders(feature_encoders, generator)
        self.x_dims = tuple(x_dims)
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.poe_temperature = poe_temperature
        self.a = a
        self.keep = 1.0 - dropout
        self.lam = tuple(lambda_per_modality or [1.0] * len(self.x_dims))
        self.encoders = nn.ModuleList(
            MLP((d, hidden_dim, hidden_dim), 4 * embed_dim, generator, dropout, dtype)
            for d in self.x_dims
        )
        self.decoders = nn.ModuleList(
            MLP((2 * embed_dim, hidden_dim, hidden_dim), d, generator, dropout, dtype)
            for d in self.x_dims
        )

    def noise_shapes(self, rows: int):
        """Shapes of the three standard-normal draws of :meth:`forward`:
        the private, unimodal-shared and PoE-shared latents'."""
        n, e = len(self.x_dims), self.embed_dim
        return (rows, n, e), (rows, n, e), (rows, e)

    def drop_shapes(self, rows: int):
        """Shapes of the keep-masks of :meth:`forward`, none without
        dropout: two per encoder (rows, H), in modality order, then two per
        decoder (N * rows, H), which decodes its joint and cross rows as
        one stack."""
        if self.keep >= 1.0:
            return []
        n, h = len(self.x_dims), self.hidden_dim
        return [(rows, h)] * (2 * n) + [(n * rows, h)] * (2 * n)

    def get_embedding(self, xs, return_poe: bool = True):
        """(shared embedding, [private embedding per modality]), in eval mode."""
        views = encode_views(self.feat_encs, [x.float() for x in xs])
        stats = [torch.split(enc(x), self.embed_dim, dim=1)
                 for enc, x in zip(self.encoders, views)]
        mu_p_all = [s[2] for s in stats]
        if return_poe:
            mu_poe, _ = product_of_experts(
                torch.stack([s[0] for s in stats]), torch.stack([s[1] for s in stats]),
                temperature=self.poe_temperature, include_prior=True,
            )
            return mu_poe, mu_p_all
        return torch.cat([s[0] for s in stats], dim=1), mu_p_all

    def forward(self, xs, noise, mask=None, drop_masks=None, enc_masks=None):
        """Training ELBO of N views (B, S_i) -> (loss, logs).

        ``noise`` is (eps_p (B, N, E), eps_u (B, N, E), eps_s (B, E));
        ``drop_masks`` the masks of :meth:`drop_shapes` (None without
        dropout); ``enc_masks`` the feature encoders' (one list per encoder,
        required with encoders); ``mask`` (B,) {0, 1} restricts every mean
        to its rows."""
        n = len(self.x_dims)
        if self.feat_encs is not None and enc_masks is None:
            raise ValueError("the training forward needs the feature encoders' keep-masks")
        masks = list(drop_masks) if drop_masks else [None] * (4 * n)
        pairs_of = lambda k: None if masks[k] is None else masks[k:k + 2]  # noqa: E731
        feats = encode_views(self.feat_encs, [x.float() for x in xs], enc_masks)
        stats = [torch.split(enc(x, pairs_of(2 * i)), self.embed_dim, dim=1)
                 for i, (enc, x) in enumerate(zip(self.encoders, feats))]
        mu_s, logv_s, mu_p, logv_p = ([s[k] for s in stats] for k in range(4))
        eps_p, eps_u, eps_s = noise
        z_p = [reparameterize(eps_p[:, i], mu_p[i], logv_p[i]) for i in range(n)]
        z_s_uni = [reparameterize(eps_u[:, i], mu_s[i], logv_s[i]) for i in range(n)]
        mu_poe, logv_poe = product_of_experts(torch.stack(mu_s), torch.stack(logv_s),
                                              temperature=1.5, include_prior=True)
        z_s = reparameterize(eps_s, mu_poe, logv_poe)

        # decoder i decodes its joint row (z_s) and its cross rows (the
        # other modalities' unimodal z_s, j != i) as one stack
        b = feats[0].shape[0]
        recon_joint, recon_cross, pairs = 0.0, 0.0, 0
        for i, dec in enumerate(self.decoders):
            zs_rows = [z_s] + [z_s_uni[j] for j in range(n) if j != i]
            dec_in = torch.cat([torch.cat([z_p[i]] * len(zs_rows), dim=0),
                                torch.cat(zs_rows, dim=0)], dim=1)
            out = dec(dec_in, pairs_of(2 * n + 2 * i))
            recon_joint = recon_joint + self.lam[i] * _masked_mse(out[:b], feats[i], mask)
            for k in range(1, len(zs_rows)):
                recon_cross = recon_cross + self.lam[i] * _masked_mse(
                    out[k * b:(k + 1) * b], feats[i], mask)
                pairs += 1
        recon_cross = recon_cross / pairs

        kl_p = _masked_mean_rows(sum(gaussian_kl_standard(mu_p[i], logv_p[i])
                                     for i in range(n)), mask)
        kl_poe = _masked_mean_rows(gaussian_kl_standard(mu_poe, logv_poe), mask)
        kl_uni = _masked_mean_rows(sum(gaussian_kl_standard(mu_s[i], logv_s[i])
                                       for i in range(n)), mask)
        loss = recon_joint + self.a * (kl_p + n * kl_poe) + recon_cross + self.a * kl_uni
        logs = {
            "loss": loss,
            "loss_joint_recon": recon_joint,
            "loss_cross_recon": recon_cross,
            "kl_private": kl_p,
            "kl_shared_poe": kl_poe,
            "kl_shared_uni_sum": kl_uni,
        }
        return loss, logs

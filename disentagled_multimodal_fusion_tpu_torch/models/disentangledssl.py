"""DisentangledSSL: the two-modal contrastive disentangler.

Counterpart of ``disentagled_multimodal_fusion_tpu/models/disentangledssl.py``
(reference: models/disentangledssl.py:17-194). Shared encoders feed
probabilistic heads (vMF with Householder-rotated rejection samples, or a
unit-sigma normal); SupCon couples the two modalities' shared codes and,
per modality, the clean and augmented private codes; an orthogonality
penalty decorrelates private from shared; lambda follows an exponential
schedule over the global step.

Every random draw is an input: :meth:`DisentangledSSL.draw` makes one
epoch's draws from a fit's randomness (the augmentations of both views,
then the four heads' vMF marginals w and tangent noise v, or the normal
head's noise), and :meth:`DisentangledSSL.loss` computes the loss from them.
So the rejection sampler runs once per epoch outside autograd, and a test
can replay the JAX package's draws. The views' feature encoders are the
identity (the JAX package's LUMA encoders are not ported).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.augment import augment_data, draw_augment
from ..ops.contrastive import _l2_normalize, ortho_loss, supcon_loss
from ..ops.schedulers import exponential_schedule
from ..ops.vmf import vmf_rotate
from .layers import MLP

HEADS = 4  # zs1, zs2 and their augmented twins


class DisentangledSSL(nn.Module):
    def __init__(self, output_dim: Sequence[int], generator: torch.Generator,
                 hidden_dim: int = 512, embed_dim: int = 100, a: float = 1.0,
                 distribution: str = "vmf", vmfkappa: float = 1.0,
                 lmd_start_value: float = 0.0, lmd_end_value: float = 0.0,
                 lmd_n_iterations: int = 8000, lmd_start_iteration: int = 0,
                 condzs: bool = True, usezsx: bool = False):
        super().__init__()
        if distribution not in ("vmf", "normal"):
            raise ValueError(distribution)
        self.output_dim = tuple(output_dim)
        self.embed_dim, self.a = embed_dim, a
        self.distribution, self.vmfkappa = distribution, vmfkappa
        self.lmd = (lmd_start_value, lmd_end_value, lmd_n_iterations, lmd_start_iteration)
        self.condzs, self.usezsx = condzs, usezsx
        x1_dim, x2_dim = self.output_dim
        extra = embed_dim if condzs else 0

        def mk(in_dim):
            return MLP((in_dim, hidden_dim, hidden_dim), embed_dim, generator)

        self.encoder_x1s = mk(x1_dim)
        self.encoder_x2s = mk(x2_dim)
        self.encoder_x1 = mk(x1_dim + extra)
        self.encoder_x2 = mk(x2_dim + extra)

    # ---- draws (outside autograd) ----
    def draw(self, randomness, sizes: Sequence[int]) -> list:
        """Every step's draws of an epoch whose steps take ``sizes`` rows, in
        one call per kind over all the epoch's rows: each view's augmentation
        draws (``ops.augment.draw_augment``), then the heads' noise: for vMF
        the marginals w (rows, 4) from ``randomness.vmf_w`` and the tangent
        noise v (rows, 4, m - 1), for the normal head eps (rows, 4, m). Head
        i of a step is zs1, zs2, zsv1, zsv2 in that order. Each step's
        draws are one flat tuple of tensors."""
        total, m = sum(sizes), self.embed_dim
        parts = [t for d in self.output_dim for t in draw_augment(randomness, total, d)]
        if self.distribution == "vmf":
            parts.append(randomness.vmf_w(self.vmfkappa, m, total * HEADS).reshape(total, HEADS))
            parts.append(randomness.normal((total, HEADS, m - 1)))
        else:
            parts.append(randomness.normal((total, HEADS, m)))
        cut = [list(torch.split(t, list(sizes))) for t in parts]
        return [tuple(c[i] for c in cut) for i in range(len(sizes))]

    def _phead(self, params: torch.Tensor, head_draws, i: int) -> torch.Tensor:
        """Head i's sample on ``params`` (classifiers.py:444-466)."""
        if self.distribution == "normal":
            (eps,) = head_draws
            return params + eps[:, i]
        w, v = head_draws
        loc = params / torch.linalg.vector_norm(params, dim=-1, keepdim=True)
        return vmf_rotate(w[:, i], v[:, i], loc)

    def lmd_at(self, iteration: int) -> float:
        start, end, n_it, start_it = self.lmd
        if end > 0:
            return exponential_schedule(iteration, start, end, n_it, start_it)
        return float(start)

    def get_embedding(self, xs):
        """(concat(zsx1, zsx2), [z1x1, z2x2]) (disentangledssl.py:67-80)."""
        x1, x2 = xs[0].float(), xs[1].float()
        zsx1, zsx2 = self.encoder_x1s(x1), self.encoder_x2s(x2)
        if self.condzs:
            z1x1 = self.encoder_x1(torch.cat([x1, zsx1], dim=1))
            z2x2 = self.encoder_x2(torch.cat([x2, zsx2], dim=1))
        else:
            z1x1, z2x2 = self.encoder_x1(x1), self.encoder_x2(x2)
        return torch.cat([zsx1, zsx2], dim=1), [z1x1, z2x2]

    def forward(self, x1, x2, v1, v2, head_draws, iteration: int):
        """Loss forward on clean (x) and augmented (v) views
        (disentangledssl.py:82-160): (loss, logs)."""
        x1, x2, v1, v2 = x1.float(), x2.float(), v1.float(), v2.float()
        e1, e2 = self.encoder_x1s(x1), self.encoder_x2s(x2)
        e1_v, e2_v = self.encoder_x1s(v1), self.encoder_x2s(v2)
        zs1, zs2, zsv1, zsv2 = (self._phead(e, head_draws, i)
                                for i, e in enumerate((e1, e2, e1_v, e2_v)))

        joint_loss, loss_x, loss_y = supcon_loss(torch.stack([zs1, zs2], dim=1))
        joint_loss_v, loss_x_v, loss_y_v = supcon_loss(torch.stack([zsv1, zsv2], dim=1))
        loss_shared = 0.5 * (joint_loss + joint_loss_v)
        loss_x = 0.5 * (loss_x + loss_x_v)
        loss_y = 0.5 * (loss_y + loss_y_v)

        if self.condzs:
            z1x1 = self.encoder_x1(torch.cat([x1, e1], dim=1))
            z1xv1 = self.encoder_x1(torch.cat([v1, e1_v], dim=1))
            z2x2 = self.encoder_x2(torch.cat([x2, e2], dim=1))
            z2xv2 = self.encoder_x2(torch.cat([v2, e2_v], dim=1))
        else:
            z1x1, z1xv1 = self.encoder_x1(x1), self.encoder_x1(v1)
            z2x2, z2xv2 = self.encoder_x2(x2), self.encoder_x2(v2)

        if self.usezsx:
            pair1 = torch.stack([_l2_normalize(torch.cat([z1x1, e1], dim=1)),
                                 _l2_normalize(torch.cat([z1xv1, e1_v], dim=1))], dim=1)
            pair2 = torch.stack([_l2_normalize(torch.cat([z2x2, e2], dim=1)),
                                 _l2_normalize(torch.cat([z2xv2, e2_v], dim=1))], dim=1)
        else:
            pair1 = torch.stack([_l2_normalize(z1x1), _l2_normalize(z1xv1)], dim=1)
            pair2 = torch.stack([_l2_normalize(z2x2), _l2_normalize(z2xv2)], dim=1)
        loss_specific = supcon_loss(pair1)[0] + supcon_loss(pair2)[0]

        lmd = self.lmd_at(iteration)
        loss_ortho = 0.5 * (ortho_loss(z1x1, e1) + ortho_loss(z2x2, e2)) + 0.5 * (
            ortho_loss(z1xv1, e1_v) + ortho_loss(z2xv2, e2_v))
        loss = (2.0 * loss_shared / (1.0 + self.a) + self.a * loss_specific / (1.0 + self.a)
                + lmd * loss_ortho)
        logs = {"loss": loss, "shared": loss_shared, "clip": loss_shared, "loss_x": loss_x,
                "loss_y": loss_y, "specific": loss_specific, "ortho": loss_ortho, "lmd": lmd}
        return loss, logs

    def loss(self, xs, draws, iteration: int):
        """shared_step + forward (disentangledssl.py:162-181): augment both
        views with their draws, then the loss forward. ``draws`` is one
        step's tuple from :meth:`draw`."""
        x1, x2 = xs[0].float(), xs[1].float()
        v1 = augment_data(x1, draws[0:3])
        v2 = augment_data(x2, draws[3:6])
        return self(x1, x2, v1, v2, draws[6:], iteration)

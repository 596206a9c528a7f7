"""Plain PyTorch building blocks of the references: float32, TF32 off, no kernel of the port.

Written from the published model (the reference repository's DMVAE,
evidential probes and late fusion): each view through its own MLP, the
Gaussian product of experts with a N(0, I) prior at temperature 1.5, the
evidential heads Dense -> ReLU -> Dense -> saturated exponential, the
cumulative (cml) fusion of the heads' evidence, and the Dirichlet mean and
uncertainties. It imports torch alone. Weights are the benchmark's, read by
their names in the port's state-dict layout: a stacked layer ``w`` (N, max
in, out) is read per view as ``w[i, :in_i]``, its published width.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

LOG_SATURATION = math.log(1e13)
LOGIT_CLIP = 10.0


@contextmanager
def precision(tf32: bool):
    """Float32 products in full float32 (``tf32=False``, the reference) or
    in TF32 (the control), restored afterwards."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def evidence(z):
    """exp(z) 1e13 / (exp(z) + 1e13) of the logits clipped to +-10."""
    z = torch.clamp(z, -LOGIT_CLIP, LOGIT_CLIP)
    return torch.exp(z - F.softplus(z - LOG_SATURATION))


def view_mlp(x, w, prefix: str, i: int, layers: int):
    """View i through the stacked MLP ``prefix`` (ReLU between layers)."""
    for li in range(1, layers + 1):
        kernel = w[f"{prefix}w{li}"][i]
        x = x @ kernel[:x.shape[-1]] + w[f"{prefix}b{li}"][i]
        if li < layers:
            x = torch.relu(x)
    return x


def dmvae_embedding(w, prefix: str, feats, embed_dim: int, temperature: float):
    """(z_c, [z_p per view]): the PoE mean of the shared statistics with a
    standard-normal prior expert, and each view's private mean."""
    stats = [view_mlp(x, w, prefix, i, 3) for i, x in enumerate(feats)]
    mu_s = [s[:, :embed_dim] for s in stats]
    logvar_s = [s[:, embed_dim:2 * embed_dim] for s in stats]
    mu_p = [s[:, 2 * embed_dim:3 * embed_dim] for s in stats]
    precisions = [torch.exp(-lv) / temperature for lv in logvar_s]
    prior = torch.full_like(precisions[0], 1.0 / temperature)
    variance = 1.0 / (sum(precisions) + prior + 1e-8)
    z_c = variance * sum(p * m for p, m in zip(precisions, mu_s))
    return z_c, mu_p


def heads(w, prefix: str, inputs):
    """(B, V, C) evidence of head v on inputs[v]."""
    return torch.stack([evidence(view_mlp(x, w, prefix, v, 2)) for v, x in enumerate(inputs)],
                       dim=1)


def outputs(ev, num_classes: int):
    """The six outputs of (B, V, C) evidence fused by summing the views."""
    fused = ev.sum(dim=1)
    alpha = fused + 1.0
    strength = alpha.sum(dim=-1, keepdim=True)
    probs = alpha / strength
    aleatoric = -(probs * (torch.special.digamma(alpha + 1.0)
                           - torch.special.digamma(strength + 1.0))).sum(dim=-1)
    return {"pred": fused.argmax(dim=-1), "probs": probs, "evidence": ev,
            "fused_evidence": fused, "epistemic": num_classes / strength[:, 0],
            "aleatoric": aleatoric}

"""Supervised-contrastive (SupCon/SimCLR) and orthogonality losses.

Counterpart of ``disentagled_multimodal_fusion_tpu/ops/contrastive.py``
(reference: models/losses.py:7-110). The SupCon variant keeps the
reference's cross-modality mask surgery as the JAX package has it: the
corner blocks are zeroed at ``batch_size`` (not at V·B), so within-view
pairs of the first and of the other views leave both the positives and the
normalising denominator; the stop-gradient is on the row max; 1e-12 is
added inside the log; and a detached within-view diagnostic (loss_x,
loss_y) is returned for the 2-view case.

Both losses couple the rows of a batch. Inside a data-parallel step
(``parallel.distributed.row_split``) ``features`` (or z1, zs) hold this
rank's rows and each loss takes its global form: SupCon contrasts this
rank's anchors with the global batch's features, gathered with their
gradient, and averages over this rank's anchors (``core.train`` weighs the
ranks' means by their rows); the orthogonality penalty sums its product
over the global batch. Both sum over the split's data group: the ranks of
one model group hold the same rows. loss_x and loss_y, which no loss term
reads, are then this rank's anchors' means.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.distributed import all_reduce, current_row_split, gather_rows


def supcon_loss(
    features: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    temperature: float = 0.07,
    base_temperature: float = 0.07,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SupCon loss over ``features`` of shape (B, V, D), every view an
    anchor (the JAX ``contrast_mode="all"``): (loss, loss_x, loss_y), the
    last two detached. Without ``labels`` it is the SimCLR loss with
    identity positives. The JAX function's explicit ``mask`` and
    ``contrast_mode="one"`` have no caller and are left out."""
    if features.dim() < 3:
        raise ValueError("`features` must be (B, V, ...)")
    if features.dim() > 3:
        features = features.reshape(features.shape[0], features.shape[1], -1)
    split = current_row_split()
    if split is not None:
        return _supcon_rows(features, labels, temperature, base_temperature, split)
    batch_size, contrast_count = features.shape[0], features.shape[1]
    device = features.device
    if labels is None:
        mask = torch.eye(batch_size, dtype=torch.float32, device=device)
    else:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).float()

    # (V*B, D): the views unbound along axis 1, then concatenated; every
    # view's rows are anchors
    contrast_feature = torch.cat(features.unbind(dim=1), dim=0)
    anchor_feature, anchor_count = contrast_feature, contrast_count

    logits = (anchor_feature @ contrast_feature.T) / temperature
    logits = logits - torch.amax(logits, dim=1, keepdim=True).detach()

    n = anchor_count * batch_size
    mask = mask.repeat(anchor_count, contrast_count)
    # cross-modality surgery: zero the within-view corner blocks (losses.py:73-76)
    logits_mask = torch.ones((n, contrast_count * batch_size), dtype=torch.float32, device=device)
    logits_mask[:batch_size, :batch_size] = 0.0
    logits_mask[batch_size:, batch_size:] = 0.0
    mask = mask * logits_mask

    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(torch.sum(exp_logits, dim=1, keepdim=True) + 1e-12)
    mean_log_prob_pos = torch.sum(mask * log_prob, dim=1) / torch.sum(mask, dim=1)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    loss = torch.mean(loss.reshape(anchor_count, batch_size))

    # detached within-view diagnostics (losses.py:89-99), defined for V == 2
    with torch.no_grad():
        logits_mask_x = torch.ones_like(mask)
        logits_mask_x[:batch_size, batch_size:] = 0.0
        logits_mask_x[batch_size:, :batch_size] = 0.0
        exp_logits_x = torch.exp(logits) * logits_mask_x
        log_prob_x = logits - torch.log(torch.sum(exp_logits_x, dim=1, keepdim=True))
        mask_x = torch.eye(n, dtype=torch.float32, device=device)
        mean_log_prob_pos_x = torch.sum(mask_x * log_prob_x, dim=1) / torch.sum(mask_x, dim=1)
        loss_xy = -(temperature / base_temperature) * mean_log_prob_pos_x
        loss_xy = torch.mean(loss_xy.reshape(anchor_count, batch_size), dim=1)
    return loss, loss_xy[0], loss_xy[-1]


def _supcon_rows(features, labels, temperature: float, base_temperature: float, split):
    """:func:`supcon_loss` of this rank's rows [lo, hi) of a global batch of
    B rows: the anchors are this rank's rows of every view, the contrasts all
    V * B global features, and the cross-modality surgery and positives use
    the global indices (anchor v * B + r, contrast u * B + q)."""
    b_local, views = features.shape[0], features.shape[1]
    batch_size, lo = split.total, split.lo
    device = features.device
    gathered = gather_rows(features, batch_size, lo, differentiable=True,
                           group=split.group)                               # (B, V, D)
    contrast_feature = torch.cat(gathered.unbind(dim=1), dim=0)             # (V*B, D)
    anchor_feature = torch.cat(features.unbind(dim=1), dim=0)               # (V*b, D)
    rows = lo + torch.arange(b_local, device=device)
    anchor_index = (torch.arange(views, device=device)[:, None] * batch_size
                    + rows[None]).reshape(-1)                               # (V*b,)
    contrast_index = torch.arange(views * batch_size, device=device)
    if labels is None:
        same = rows[:, None] == (contrast_index % batch_size)[None]
    else:
        labels = labels.reshape(-1)
        all_labels = gather_rows(labels.float(), batch_size, lo, group=split.group)
        same = labels.float()[:, None] == all_labels[contrast_index % batch_size][None]
    mask = same.float().repeat(views, 1)                                    # (V*b, V*B)

    logits = (anchor_feature @ contrast_feature.T) / temperature
    logits = logits - torch.amax(logits, dim=1, keepdim=True).detach()
    # the surgery zeroes columns [0, B) for anchors of view 0 and [B, V*B)
    # for the others (losses.py:73-76)
    first_view = anchor_index[:, None] < batch_size
    logits_mask = (first_view != (contrast_index[None] < batch_size)).float()
    mask = mask * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(torch.sum(exp_logits, dim=1, keepdim=True) + 1e-12)
    mean_log_prob_pos = torch.sum(mask * log_prob, dim=1) / torch.sum(mask, dim=1)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    loss = torch.sum(loss) / max(views * b_local, 1)

    with torch.no_grad():
        logits_mask_x = (first_view == (contrast_index[None] < batch_size)).float()
        exp_logits_x = torch.exp(logits) * logits_mask_x
        log_prob_x = logits - torch.log(torch.sum(exp_logits_x, dim=1, keepdim=True))
        own = torch.gather(log_prob_x, 1, anchor_index[:, None])[:, 0]
        loss_xy = -(temperature / base_temperature) * own
        loss_xy = torch.sum(loss_xy.reshape(views, b_local), dim=1) / max(b_local, 1)
    return loss, loss_xy[0], loss_xy[-1]


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), as ``torch.nn.functional.normalize``."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def ortho_loss(z1: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of normalized(z1)^T @ normalized(zs) (losses.py:104-110),
    the product summed over the global batch inside a data-parallel step."""
    product = _l2_normalize(z1).T @ _l2_normalize(zs)
    split = current_row_split()
    if split is not None:
        product = all_reduce(product, differentiable=True, group=split.group)
    return torch.linalg.matrix_norm(product)

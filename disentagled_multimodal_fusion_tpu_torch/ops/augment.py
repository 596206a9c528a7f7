"""Per-row data augmentations for DisentangledSSL, with explicit draws.

Counterpart of ``disentagled_multimodal_fusion_tpu/ops/augment.py``
(reference: utils.py:118-151): each row independently receives one of
{gaussian noise, random feature drop, identity}. The draws are inputs
(:func:`draw_augment` makes them from a fit's randomness, in a fixed order:
the choice, the noise, the drop scores), so a test can hand in the JAX
package's draws and get its augmented rows bit for bit. The JAX module's
``swap`` and ``identity_fn`` have no caller and are left out.
"""

from __future__ import annotations

import torch


def noise(x: torch.Tensor, eps: torch.Tensor, scale: float = 0.01) -> torch.Tensor:
    """x + eps * scale, eps standard normal of x's shape (reference: utils.py:118-120)."""
    return x + eps * scale


def random_drop(x: torch.Tensor, scores: torch.Tensor, drop_scale: int = 10) -> torch.Tensor:
    """Zero exactly ``D // drop_scale`` features per row of x (B, D): those
    whose iid uniform ``scores`` rank lowest in the row (reference:
    utils.py:126-131)."""
    drop_num = x.shape[-1] // drop_scale
    ranks = torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1, stable=True)
    return x * (ranks >= drop_num).to(x.dtype)


def draw_augment(randomness, rows: int, dim: int):
    """(choice (rows,) in {0, 1, 2}, eps (rows, dim) normal, scores (rows,
    dim) uniform): the draws of :func:`augment_data`, in that order."""
    return (randomness.integers(3, (rows,)), randomness.normal((rows, dim)),
            randomness.uniform((rows, dim)))


def augment_data(x: torch.Tensor, draws, noise_scale: float = 0.01,
                 drop_scale: int = 10) -> torch.Tensor:
    """Per-row pick among {noise (choice 0), drop (1), identity (2)}
    (reference: utils.py:136-151); ``draws`` as :func:`draw_augment` makes them."""
    choice, eps, scores = draws
    c = choice.reshape(-1, *([1] * (x.dim() - 1)))
    noised = noise(x, eps, scale=noise_scale)
    dropped = random_drop(x, scores, drop_scale=drop_scale)
    return torch.where(c == 0, noised, torch.where(c == 1, dropped, x))

"""Building-block layers: MLP stacks and evidential heads.

Counterpart of ``disentagled_multimodal_fusion_tpu/models/layers.py:25-149``
with its init laws as the configs use them: xavier-uniform kernels and the
torch ``nn.Linear`` default bias ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``.
Initialisation draws from an explicit ``torch.Generator`` on the CPU, so a
seed gives the same weights on any device. Kernel tensors are drawn in the
JAX layout ``(in, out)``. Dropout follows each hidden ReLU; its keep-masks
are inputs (one boolean mask per hidden layer), applied as flax's
``Dropout`` does: ``where(mask, h / keep, 0)``. The other kernel inits of
the JAX package and the LUMA encoders come with later slices.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.evidence import evidence_activation


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=generator)


def torch_bias_init(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)


def xavier_uniform(shape: Tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """A Dense kernel of shape (in, out) drawn from U(+-sqrt(6 / (in + out)))."""
    fan_in, fan_out = shape
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), generator)


class TorchLinear(nn.Module):
    """Dense layer, ``weight`` (out, in) as in ``nn.Linear``, with a
    xavier-uniform kernel and the torch-default bias."""

    def __init__(self, in_features: int, out_features: int, generator: torch.Generator):
        super().__init__()
        kernel = xavier_uniform((in_features, out_features), generator)
        self.weight = nn.Parameter(kernel.t().contiguous())
        self.bias = nn.Parameter(torch_bias_init((out_features,), in_features, generator))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class IdentityEncoder(nn.Module):
    """Pass-through feature encoder."""

    def forward(self, x):
        return x


class MLP(nn.Module):
    """(Dense + ReLU + Dropout)* + output Dense. ``layers`` lists the input
    and hidden sizes, e.g. (in, h1, h2); the last Dense maps to
    ``output_dims``."""

    def __init__(self, layers: Sequence[int], output_dims: int, generator: torch.Generator,
                 dropout: float = 0.0):
        super().__init__()
        widths = [*layers, output_dims]
        self.keep = 1.0 - dropout
        self.hidden = tuple(layers[1:])
        self.layers = nn.ModuleList(
            TorchLinear(a, b, generator) for a, b in zip(widths[:-1], widths[1:])
        )

    def forward(self, x, drop_masks=None):
        """``drop_masks``: in training, one boolean keep-mask (rows, h) per
        hidden layer; None in eval mode."""
        x = x.to(self.layers[0].weight.dtype)  # float32 data, whatever it came as
        for i, layer in enumerate(self.layers[:-1]):
            x = torch.relu(layer(x))
            if drop_masks is not None:
                x = torch.where(drop_masks[i], x / self.keep, torch.zeros_like(x))
        return self.layers[-1](x)


class EvidentialNN(nn.Module):
    """MLP head with the saturated-exp evidence activation."""

    def __init__(self, layers: Sequence[int], output_dims: int, generator: torch.Generator,
                 dropout: float = 0.0):
        super().__init__()
        self.mlp = MLP(layers, output_dims, generator, dropout)

    def forward(self, x, drop_masks=None):
        return evidence_activation(self.mlp(x, drop_masks))

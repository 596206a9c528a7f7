"""Weights drawn from the seed on the device, in one call.

Every parameter is a slice of one ``torch.rand`` draw of U(-1, 1) from a
``torch.Generator`` on the card, scaled to its initialisation law: the
xavier-uniform kernels and torch-default biases the configurations' models
use, and BatchNorm scales, biases and running statistics drawn around their
initial values so that the check covers them. The benchmark makes these
tensors and hands the same ones to the port (loaded into its modules) and
to the plain reference; the names and layouts are those of the port's
state dicts, which the reference reads by name.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Sequence

import torch


class Param(NamedTuple):
    """A parameter: its name, shape, and the map from U(-1, 1) draws of
    that shape to its values."""

    name: str
    shape: tuple
    law: Callable[[torch.Tensor], torch.Tensor]


def _scaled(bound):
    """U(-1, 1) draws times ``bound``, a number or a tensor that broadcasts."""
    if isinstance(bound, torch.Tensor):
        return lambda u: u * bound.to(u.device)
    return lambda u: u * bound


def _around(center: float, half: float):
    return lambda u: u * half + center


def stacked_mlp(prefix: str, in_dims: Sequence[int], widths: Sequence[int]) -> List[Param]:
    """A modality-stacked MLP (the port's ``StackedMLP``): layer l is ``w{l}``
    (N, max in, out) and ``b{l}`` (N, out). Each modality's slice is
    xavier-uniform at its own fan in, U(+-sqrt(6 / (fan + out))), with the
    rows past its fan zero; its bias U(+-1 / sqrt(fan))."""
    n, fans, d_in, out = len(in_dims), list(in_dims), max(in_dims), []
    for li, width in enumerate(widths, start=1):
        fan = torch.tensor(fans, dtype=torch.float32)
        rows = (torch.arange(d_in)[None, :] < fan[:, None]).float()       # (N, d_in)
        w_bound = (torch.sqrt(6.0 / (fan + width))[:, None] * rows)[..., None]
        b_bound = (1.0 / torch.sqrt(fan))[:, None]
        out += [Param(f"{prefix}w{li}", (n, d_in, width), _scaled(w_bound)),
                Param(f"{prefix}b{li}", (n, width), _scaled(b_bound))]
        fans, d_in = [width] * n, width
    return out


def linear(prefix: str, fan_in: int, fan_out: int) -> List[Param]:
    """torch's default ``nn.Linear``: weight (out, in) and bias, both
    U(+-1 / sqrt(in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return [Param(f"{prefix}weight", (fan_out, fan_in), _scaled(bound)),
            Param(f"{prefix}bias", (fan_out,), _scaled(bound))]


def conv3x3(prefix: str, cin: int, cout: int) -> List[Param]:
    """torch's default 3 x 3 ``Conv2d``: weight (out, in, 3, 3) and bias,
    both U(+-1 / sqrt(9 in))."""
    bound = 1.0 / math.sqrt(9 * cin)
    return [Param(f"{prefix}weight", (cout, cin, 3, 3), _scaled(bound)),
            Param(f"{prefix}bias", (cout,), _scaled(bound))]


def batch_norm(prefix: str, channels: int) -> List[Param]:
    """A BatchNorm's scale U(0.8, 1.2), bias U(-0.1, 0.1), running mean
    U(-0.2, 0.2) and running variance U(0.5, 1.5)."""
    c = (channels,)
    return [Param(f"{prefix}weight", c, _around(1.0, 0.2)),
            Param(f"{prefix}bias", c, _around(0.0, 0.1)),
            Param(f"{prefix}mean", c, _around(0.0, 0.2)),
            Param(f"{prefix}var", c, _around(1.0, 0.5))]


def draw(params: Sequence[Param], generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """{name: tensor} on the generator's device, float32, from one draw."""
    total = sum(math.prod(p.shape) for p in params)
    u = torch.rand(total, generator=generator, device=generator.device).mul_(2.0).sub_(1.0)
    out, offset = {}, 0
    for p in params:
        n = math.prod(p.shape)
        out[p.name] = p.law(u[offset:offset + n].view(p.shape)).contiguous()
        offset += n
    return out

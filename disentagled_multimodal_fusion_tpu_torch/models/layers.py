"""Building-block layers: MLP stacks, evidential heads, the LUMA feature
encoders and flax's BatchNorm.

Counterpart of ``disentagled_multimodal_fusion_tpu/models/layers.py`` with
its init laws as the configs use them: xavier-uniform kernels and the torch
``nn.Linear`` default bias ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``; the LUMA
encoders keep torch's default kernels too (``U(+-1/sqrt(fan_in))``, fan_in =
kh * kw * in for a convolution). Initialisation draws from an explicit
``torch.Generator`` on the CPU, so a seed gives the same weights on any
device. Kernel tensors are drawn in the JAX layout (``(in, out)``, a
convolution's ``(kh, kw, in, out)``). Dropout follows each hidden ReLU; its
keep-masks are inputs (one boolean mask per hidden layer), applied as flax's
``Dropout`` does: ``where(mask, h / keep, 0)``.

The encoders (``ImageEncoder``, ``AudioEncoder``, ``TextEncoder``; JAX lines
152-264; and ``TowerTextEncoder``, the port's own, a DeepSeek-V2 decoder
over token ids, ``models/text_tower.py``) run in NCHW; ``ImageEncoder``
permutes its (B, 128, 4, 4) map to NHWC before flattening, so its 2048 ->
512 kernel has the JAX row order. An encoder trains when it is given its
keep-masks (``drop_shapes``; an empty list without dropout) and evaluates
without them. Channel dropout draws one mask per (row, channel), (B, C, 1,
1), broadcast over H and W.

``batch_norm`` is flax's ``BatchNorm`` (flax 0.12.3 defaults) as a function
of (input, statistics) -> (output, new statistics): in training it
normalises by the batch's mean and fast variance E[x^2] - E[x]^2 (clipped
at 0) and returns running statistics 0.99 * old + 0.01 * batch, the
variance biased; in evaluation it normalises by the running ones. The
``BatchNorm`` module keeps them as buffers (``mean``, ``var``), so a state
dict, and a checkpoint, carries them; its training forward writes the new
ones in place.

``dtype`` (``norm_dtype``: None for float32, or ``"bfloat16"``) is the
compute type of the JAX modules' ``dtype=`` (the ``--dtype bfloat16``
mode), as flax's ``Dense(dtype=bf16)`` and ``Conv(dtype=bf16)`` compute:
input, kernel and bias rounded to bf16, the product summed in f32 and
rounded to bf16, then the bias added in bf16 (a second rounding); ReLU,
max-pool and dropout's ``h / keep`` in bf16; the output stays bf16.
Parameters stay float32. flax's ``BatchNorm(dtype=bf16)`` (with its
default ``force_float32_reductions``) computes the statistics and the
normalisation in f32 from the bf16 input and rounds its output to bf16
once; the running statistics stay f32.

**The mesh's model axis** (``parallel.mesh``; inside ``model_split``, the
Megatron cut of the hidden width ``h``). ``TorchLinear`` (and so ``MLP``,
``EvidentialNN`` and the encoders' dense layers) holds this rank's block
of its parameters and runs :func:`dense_cut`: a column layer (``out ==
h``) computes its block of the hidden columns, from its input summed back
over the group in the backward (``to_model``), or gathered first when the
input is itself a column layer's block; ReLU and dropout run on the
block, the keep-mask cut to its columns (:func:`local_mask`); a row layer
(``in == h``) takes its block of the input's columns, sums the partial
products over the group (``from_model``) and adds the bias, whole on every
rank, once. Under bf16 the cut's products run in float32 on bf16 operands,
so the partial products and a column layer's input gradients are summed in
float32 and rounded once, as the whole product is. A layer's output that is still a block is gathered (:func:`whole`)
before anything else reads it. Every other parameter the rule cuts (a
``Conv`` kernel and bias of ``h`` channels, a ``BatchNorm`` scale and
bias) is gathered whole before the forward and used whole
(gather-on-use): what reads it runs the same on every rank of the group,
so each rank's gradient of it is whole, and the gather's backward hands
this rank its block. BatchNorm's moments sum over the data group.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.logging import span
from ..ops.evidence import evidence_activation
from ..parallel.distributed import (all_reduce, current_row_split, from_model, gather_from_model,
                                    scatter_to_model, to_model)
from ..parallel.mesh import current_model_split
from .text_tower import DEEPSEEK_V2_LITE, Tower, draw_tower


def norm_dtype(dtype) -> Optional[torch.dtype]:
    """A model's compute type (JAX ``core/tasks.py:97-102``): None for
    float32 (None, ``"float32"``, ``torch.float32``), ``torch.bfloat16`` for
    ``"bfloat16"``; the losses stay float32 whatever it is."""
    if dtype is None or dtype in ("float32", torch.float32):
        return None
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unsupported compute dtype {dtype!r}: float32 or bfloat16")


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=generator)


def torch_bias_init(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    return _uniform(shape, 1.0 / math.sqrt(fan_in), generator)


def xavier_uniform(shape: Tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """A Dense kernel of shape (in, out) drawn from U(+-sqrt(6 / (in + out)))."""
    fan_in, fan_out = shape
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def torch_default_kernel(shape, generator: torch.Generator) -> torch.Tensor:
    """torch's default Linear/Conv kernel, U(+-1/sqrt(fan_in)), drawn in the
    JAX layout: fan_in is the product of every axis but the last."""
    return _uniform(shape, 1.0 / math.sqrt(math.prod(shape[:-1])), generator)


KERNEL_INITS = {"xavier": xavier_uniform, "torch_default": torch_default_kernel}


# ------------------------------------------------------------ the model axis
def dense_cut(x, w, b, width_in: int, width_out: int, product, dtype=None):
    """One Dense layer (whole widths ``width_in`` -> ``width_out``) on this
    rank's blocks ``w`` and ``b`` of the active ``model_split``, or on the
    whole ``w`` and ``b`` outside one; ``product(x, w, b=None)`` is the
    layer's product (plus ``b`` when given). ``x`` is whole or, after a
    column layer, this rank's block of its columns. Returns the output,
    this rank's block of the columns for a column layer. In ``dtype`` (a
    compute type) the product is rounded once and then the bias added, as
    flax's ``Dense(dtype=...)``; under the cut the product runs in float32
    on the operands rounded to ``dtype``, so that the sums over the group
    (a row layer's partial products, a column layer's input gradients) are
    float32 too and each result is rounded once, as the whole product's."""
    split = current_model_split()
    kind = None if split is None else split.kind(width_in, width_out)
    if kind is None:
        if dtype is None:
            return product(x, w, b)
        return product(x.to(dtype), w.to(dtype)) + b.to(dtype)
    if dtype is not None:
        x, w = x.to(dtype).float(), w.to(dtype).float()
    if kind == "row":
        if x.shape[-1] == width_in:
            x = scatter_to_model(x, split)
        y = from_model(product(x, w), split)
    else:
        x = (to_model(x, split) if x.shape[-1] == width_in
             else gather_from_model(x, split, partial=True))
        y = product(x, w)
    return y + b if dtype is None else y.to(dtype) + b.to(dtype)


def local_mask(mask, x):
    """A keep-mask of a whole hidden layer, cut to the columns of ``x``
    when ``x`` is this rank's block of them."""
    if mask.shape[-1] == x.shape[-1]:
        return mask
    return mask[..., current_model_split().block(mask.shape[-1])]


def whole(y, width: int):
    """``y`` whole: gathered when it is this rank's block of ``width``
    columns (whatever reads it runs the same on every rank of the group)."""
    if y.shape[-1] == width:
        return y
    return gather_from_model(y, current_model_split())


class TorchLinear(nn.Module):
    """Dense layer, ``weight`` (out, in) as in ``nn.Linear``, with a
    xavier-uniform (or ``torch_default``) kernel and the torch-default bias.
    It runs :func:`dense_cut`, on its blocks inside a ``model_split``:
    :meth:`cut` leaves a column layer's output a block, ``forward`` returns
    it whole."""

    takes_model_blocks = True

    def __init__(self, in_features: int, out_features: int, generator: torch.Generator,
                 init: str = "xavier", dtype=None):
        super().__init__()
        kernel = KERNEL_INITS[init]((in_features, out_features), generator)
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(kernel.t().contiguous())
        self.bias = nn.Parameter(torch_bias_init((out_features,), in_features, generator))
        self.dtype = norm_dtype(dtype)

    def cut(self, x):
        return dense_cut(x, self.weight, self.bias, self.in_features, self.out_features,
                         F.linear, self.dtype)

    def forward(self, x):
        return whole(self.cut(x), self.out_features)


def dense_stack(x, layers, masks, keep: float, start: int = 0):
    """``layers`` (TorchLinear) with ReLU and, when ``masks`` are given,
    dropout after every layer but the last (masks[start:] are the hidden
    layers'): inside a ``model_split`` the hidden activations stay blocks
    and only the output is gathered."""
    for i, layer in enumerate(layers[:-1]):
        x = torch.relu(layer.cut(x))
        if masks:
            x = dropout(x, local_mask(masks[start + i], x), keep)
    return whole(layers[-1].cut(x), layers[-1].out_features)


class IdentityEncoder(nn.Module):
    """Pass-through feature encoder."""

    def forward(self, x):
        return x


class MLP(nn.Module):
    """(Dense + ReLU + Dropout)* + output Dense. ``layers`` lists the input
    and hidden sizes, e.g. (in, h1, h2); the last Dense maps to
    ``output_dims``."""

    def __init__(self, layers: Sequence[int], output_dims: int, generator: torch.Generator,
                 dropout: float = 0.0, dtype=None):
        super().__init__()
        widths = [*layers, output_dims]
        self.keep = 1.0 - dropout
        self.hidden = tuple(layers[1:])
        self.dtype = norm_dtype(dtype)
        self.layers = nn.ModuleList(
            TorchLinear(a, b, generator, dtype=dtype) for a, b in zip(widths[:-1], widths[1:])
        )

    def forward(self, x, drop_masks=None):
        """``drop_masks``: in training, one boolean keep-mask (rows, h) per
        hidden layer; None in eval mode. The output is in the compute type."""
        # the data in the parameters' type (float32), then in the compute type
        x = x.to(self.dtype or self.layers[0].weight.dtype)
        return dense_stack(x, self.layers, drop_masks, self.keep)


class EvidentialNN(nn.Module):
    """MLP head with the saturated-exp evidence activation, computed in
    float32 whatever the MLP's compute type (JAX lines 149-150)."""

    def __init__(self, layers: Sequence[int], output_dims: int, generator: torch.Generator,
                 dropout: float = 0.0, dtype=None):
        super().__init__()
        self.mlp = MLP(layers, output_dims, generator, dropout, dtype)

    def forward(self, x, drop_masks=None):
        return evidence_activation(self.mlp(x, drop_masks).float())


# ------------------------------------------------------------ LUMA encoders
def dropout(x, mask, keep: float):
    """flax's ``Dropout`` with its keep-mask: ``where(mask, x / keep, 0)``.
    JAX takes the Python ``keep`` in x's type (a weak type), so a bf16 x is
    divided by bf16(keep) (0.69921875 for 0.7), not by keep."""
    if x.dtype == torch.bfloat16:
        keep = torch.tensor(keep, dtype=x.dtype).item()
    return torch.where(mask, x / keep, torch.zeros_like(x))


def batch_norm(x, weight, bias, mean, var, train: bool, momentum: float = 0.99,
               eps: float = 1e-5):
    """flax ``BatchNorm`` over every axis of x but axis 1 (NCHW channels):
    (y, (new_mean, new_var)). In training the batch statistics normalise and
    the running ones move to ``momentum * old + (1 - momentum) * batch``
    (biased variance); in evaluation the running ones normalise and are
    returned unchanged. A bf16 x is normalised in f32 (the statistics too)
    and the output rounded back to bf16 once, as flax does.

    Inside a data-parallel step (``parallel.distributed.row_split``) x holds
    this rank's rows and the batch statistics are the global batch's, as
    GSPMD computes the mean over a sharded axis: the sums of x and x^2 and
    the count are summed over the data group (with their gradients), and the
    variance keeps flax's form E[x^2] - E[x]^2."""
    out_dtype, x = x.dtype, x.float()
    axes = [a for a in range(x.dim()) if a != 1]
    shape = [1, -1] + [1] * (x.dim() - 2)
    if train:
        split = current_row_split()
        if split is None:
            mu, ex2 = torch.mean(x, dim=axes), torch.mean(x * x, dim=axes)
        else:
            c = x.shape[1]
            count = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
            sums = all_reduce(torch.cat([torch.sum(x, dim=axes), torch.sum(x * x, dim=axes),
                                         count]), differentiable=True, group=split.group)
            mu, ex2 = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var_b = torch.clamp(ex2 - mu * mu, min=0.0)
        new = (momentum * mean + (1.0 - momentum) * mu.detach(),
               momentum * var + (1.0 - momentum) * var_b.detach())
    else:
        mu, var_b, new = mean, var, (mean, var)
    mul = torch.rsqrt(var_b + eps) * weight
    y = (x - mu.reshape(shape)) * mul.reshape(shape) + bias.reshape(shape)
    return y.to(out_dtype), new


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` (momentum 0.99, epsilon 1e-5, fast variance) over
    NCHW channels: scale 1 and bias 0 (``weight``, ``bias``), running
    ``mean`` 0 and ``var`` 1 as buffers, updated in place by a training
    forward."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        y, (mean, var) = batch_norm(x, self.weight, self.bias, self.mean, self.var, train)
        if train:
            with torch.no_grad():
                self.mean.copy_(mean)
                self.var.copy_(var)
        return y


class Conv(nn.Module):
    """3 x 3 'SAME' convolution with torch Conv2d's default init; ``weight``
    (out, in, 3, 3), drawn as flax's (3, 3, in, out) kernel."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator, dtype=None):
        super().__init__()
        kernel = torch_default_kernel((3, 3, in_ch, out_ch), generator)
        self.weight = nn.Parameter(kernel.permute(3, 2, 0, 1).contiguous())
        self.bias = nn.Parameter(torch_bias_init((out_ch,), 9 * in_ch, generator))
        self.dtype = norm_dtype(dtype)

    def forward(self, x):
        if self.dtype is None:
            return F.conv2d(x, self.weight, self.bias, padding=1)
        # flax Conv(dtype=...): the convolution rounded, then the bias added
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None, padding=1)
        return y + self.bias.to(self.dtype)[:, None, None]


class _ConvBlocks(nn.Module):
    """conv -> BatchNorm -> ReLU [-> 2 x 2 max-pool -> channel dropout] per
    block; ``pooled`` blocks pool and drop."""

    def __init__(self, widths: Sequence[int], pooled: int, generator: torch.Generator,
                 dtype=None):
        super().__init__()
        self.conv = nn.ModuleList(Conv(a, b, generator, dtype)
                                  for a, b in zip(widths[:-1], widths[1:]))
        self.bn = nn.ModuleList(BatchNorm(b) for b in widths[1:])
        self.channels = tuple(widths[1:])
        self.pooled = pooled

    def drop_shapes(self, rows: int):
        return [(rows, c, 1, 1) for c in self.channels[:self.pooled]]

    def forward(self, x, masks, keep: float):
        train = masks is not None
        for i, (conv, bn) in enumerate(zip(self.conv, self.bn)):
            x = torch.relu(bn(conv(x), train))
            if i < self.pooled:
                x = F.max_pool2d(x, 2, 2)
                if masks:
                    x = dropout(x, masks[i], keep)
        return x


class _Encoder(nn.Module):
    """A feature encoder: ``forward(x, drop_masks=None)`` trains when given
    the keep-masks of ``drop_shapes(rows)`` (an empty list without dropout)."""

    keep: float

    def drop_shapes(self, rows: int):
        return [] if self.keep >= 1.0 else self._drop_shapes(rows)


class ImageEncoder(_Encoder):
    """(B, 3072) CHW-flattened 32 x 32 images -> (B, output_dim): three conv
    blocks (32/64/128 channels) with BatchNorm, ReLU, max-pool and channel
    dropout, then 2048 -> 512 -> output_dim (JAX lines 152-187)."""

    def __init__(self, generator: torch.Generator, output_dim: int = 200, dropout: float = 0.1,
                 dtype=None):
        super().__init__()
        self.keep = 1.0 - dropout
        self.blocks = _ConvBlocks((3, 32, 64, 128), 3, generator, dtype)
        self.layers = nn.ModuleList([TorchLinear(2048, 512, generator, "torch_default", dtype),
                                     TorchLinear(512, output_dim, generator, "torch_default",
                                                 dtype)])

    def _drop_shapes(self, rows: int):
        return self.blocks.drop_shapes(rows) + [(rows, 512)]

    def forward(self, x, drop_masks=None):
        b = x.shape[0]
        x = x.reshape(b, 3, 32, 32).to(self.layers[0].weight.dtype)
        x = self.blocks(x, drop_masks, self.keep)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's NHWC flatten
        return dense_stack(x, self.layers, drop_masks, self.keep, 3)


class AudioEncoder(_Encoder):
    """MFCC features -> (B, output_dim) (JAX lines 190-250): the MLP
    input_dim -> 128 -> 256 -> output_dim, or with ``use_2d`` three conv
    blocks (1 -> 32 -> 64 -> 128 channels, the first two pooled with channel
    dropout), a global average pool and 128 -> output_dim over an (n_mfcc,
    frames) map, (B, H, W), (B, 1, H, W) or (B, H, W, 1)."""

    def __init__(self, generator: torch.Generator, input_dim: int = 40, output_dim: int = 200,
                 dropout: float = 0.1, use_2d: bool = False, dtype=None):
        super().__init__()
        self.keep = 1.0 - dropout
        self.use_2d = use_2d
        if use_2d:
            self.blocks = _ConvBlocks((1, 32, 64, 128), 2, generator, dtype)
            widths = (128, output_dim)
        else:
            widths = (input_dim, 128, 256, output_dim)
        self.layers = nn.ModuleList(TorchLinear(a, b, generator, "torch_default", dtype)
                                    for a, b in zip(widths[:-1], widths[1:]))

    def _drop_shapes(self, rows: int):
        if self.use_2d:
            return self.blocks.drop_shapes(rows)
        return [(rows, 128), (rows, 256)]

    def forward(self, x, drop_masks=None):
        x = x.to(self.layers[0].weight.dtype)
        if not self.use_2d:
            return dense_stack(x, self.layers, drop_masks, self.keep)
        if x.dim() == 3:
            x = x[:, None]
        elif x.shape[1] != 1:  # NHWC (B, H, W, 1)
            x = x.permute(0, 3, 1, 2)
        x = self.blocks(x, drop_masks, self.keep)
        return self.layers[0](torch.mean(x, dim=(2, 3)))


class TextEncoder(_Encoder):
    """Token-id features input_dim -> 256 -> 256 -> output_dim (JAX lines
    253-270)."""

    def __init__(self, generator: torch.Generator, input_dim: int = 128, output_dim: int = 200,
                 dropout: float = 0.1, dtype=None):
        super().__init__()
        self.keep = 1.0 - dropout
        widths = (input_dim, 256, 256, output_dim)
        self.layers = nn.ModuleList(TorchLinear(a, b, generator, "torch_default", dtype)
                                    for a, b in zip(widths[:-1], widths[1:]))

    def _drop_shapes(self, rows: int):
        return [(rows, 256), (rows, 256)]

    def forward(self, x, drop_masks=None):
        return dense_stack(x.to(self.layers[0].weight.dtype), self.layers, drop_masks,
                           self.keep)


class TowerTextEncoder(_Encoder):
    """Token ids (B, S), integer -> (B, output_dim): the DeepSeek-V2 decoder
    ``config`` (the published ``config.json`` keys; DeepSeek-V2-Lite's by
    default) mean-pooled, then hidden -> 256 -> 256 -> output_dim as
    ``TextEncoder`` (``models/text_tower.py``). The tower is made and drawn
    on ``device`` in ``dtype`` and frozen; the head is drawn from
    ``generator`` in float32 and moves with the model."""

    # core.tasks hands it the model's device, so the tower is made there
    builds_on_device = True
    # core.serve.export_inference refuses a module that holds one
    exportable = False

    def __init__(self, generator: torch.Generator, config: Optional[dict] = None,
                 output_dim: int = 200, dropout: float = 0.1, dtype="bfloat16", device=None):
        super().__init__()
        cfg = dict(config or DEEPSEEK_V2_LITE)
        self.keep = 1.0 - dropout
        self.tower = Tower(cfg, norm_dtype(dtype) or torch.float32, torch.device(device or "cpu"))
        draw_tower(self.tower, generator, cfg.get("initializer_range", 0.02))
        widths = (cfg["hidden_size"], 256, 256, output_dim)
        self.layers = nn.ModuleList(TorchLinear(a, b, generator, "torch_default")
                                    for a, b in zip(widths[:-1], widths[1:]))

    def _drop_shapes(self, rows: int):
        return [(rows, 256), (rows, 256)]

    def forward(self, x, drop_masks=None):
        if x.is_floating_point():
            raise TypeError(f"TowerTextEncoder takes integer token ids, not {x.dtype}")
        with span("serve.text_tower"):
            pooled = self.tower(x)
        return dense_stack(pooled, self.layers, drop_masks, self.keep)


ENCODER_REGISTRY = {"ImageEncoder": ImageEncoder, "AudioEncoder": AudioEncoder,
                    "TextEncoder": TextEncoder, "TowerTextEncoder": TowerTextEncoder}


def placed(specs, device):
    """``specs`` with ``device`` given to each encoder that is made on its
    device (``builds_on_device``) and names none."""
    if not specs:
        return specs
    return tuple((name, dict(kw, device=kw.get("device") or device)
                  if getattr(ENCODER_REGISTRY[name], "builds_on_device", False) else kw)
                 for name, kw in specs)


def build_encoders(specs, generator: torch.Generator) -> Optional[nn.ModuleList]:
    """Feature encoders from ``specs``, a sequence of (registry name, keyword
    arguments), drawn in order from ``generator``; None without specs."""
    if not specs:
        return None
    return nn.ModuleList(ENCODER_REGISTRY[name](generator, **dict(kw)) for name, kw in specs)


class Encoded(nn.Module):
    """A model whose views may pass through feature encoders first: its
    ``feat_encs`` (``build_encoders``; None without them)."""

    def enc_drop_shapes(self, rows: int):
        """Each feature encoder's keep-mask shapes (a list per encoder; []
        without encoders)."""
        return [] if self.feat_encs is None else [enc.drop_shapes(rows) for enc in self.feat_encs]


def encode_views(encoders: Optional[nn.ModuleList], xs, drop_masks=None):
    """The views through their encoders, as given without them: training
    with ``drop_masks`` (one list per encoder), evaluation without."""
    if encoders is None:
        return list(xs)
    masks = drop_masks if drop_masks is not None else [None] * len(encoders)
    return [enc(x, m) for enc, x, m in zip(encoders, xs, masks)]

"""Carry a JAX/flax parameter tree into the port's modules.

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of a
flax ``params`` collection), so this module needs neither JAX nor flax.
The port names its submodules after the flax ones:

=============================================  ==============================
flax path                                      port state-dict key
=============================================  ==============================
``encoder/w1`` (FusedDMVAE StackedMLP)         ``encoder.w1``
``encoders_0/TorchLinear_1/Dense_0/kernel``    ``encoders.0.layers.1.weight``
``x_specs_2/MLP_0/TorchLinear_0/Dense_0/bias`` ``x_specs.2.mlp.layers.0.bias``
``StackedMLP_0/w2`` (fused probe, late fusion) ``stack.w2``
``encoder_x1s/TorchLinear_2/Dense_0/kernel``   ``encoder_x1s.layers.2.weight``
=============================================  ==============================

The last row is DisentangledSSL's: its four encoders (``encoder_x1s``,
``encoder_x2s``, ``encoder_x1``, ``encoder_x2``) keep their flax names.

The fusion library (``models/fusions.py``) and ``IntermediateFusion``:

==================================================================  =========================================
flax path                                                           port state-dict key
==================================================================  =========================================
``fusion/Dense_0/kernel`` (ConcatWithLinear, NLgate, transformers)  ``fusion.dense.0.weight``
``fusion/factor_1``, ``fusion/W`` (LRTF, MI; leaves keep names)     ``fusion.factor_1``, ``fusion.W``
``fusion/MultiplicativeInteractions2Modal_1/U`` (mi3)               ``fusion.mi.1.U``
``.../LateFusionTransformer_0/_TransformerEncoderLayer_2/...``      ``...transformer.layers.2...``
``.../MultiHeadDotProductAttention_0/query/kernel``                 ``...attn.query.weight``
``.../LayerNorm_1/scale``                                           ``...norm.1.weight``
``head/MLP_0/TorchLinear_0/Dense_0/kernel``                         ``head.mlp.layers.0.weight``
==================================================================  =========================================

The LUMA feature encoders (a model's ``feature_encoders_i``) and their
BatchNorm statistics, the ``batch_stats`` collection (the JAX package's
``..._state`` checkpoint beside the parameters):

==============================================================  ==================================
flax path                                                       port state-dict key
==============================================================  ==================================
``feature_encoders_2/Conv_1/kernel`` (kh, kw, in, out)          ``feat_encs.2.blocks.conv.1.weight``
``feature_encoders_2/BatchNorm_0/scale``                        ``feat_encs.2.blocks.bn.0.weight``
``feature_encoders_2/BatchNorm_0/mean`` (``batch_stats``)       ``feat_encs.2.blocks.bn.0.mean``
``feature_encoders_0/TorchLinear_1/Dense_0/kernel``             ``feat_encs.0.layers.1.weight``
==============================================================  ==================================

A convolution kernel (kh, kw, in, out) becomes ``weight`` (out, in, kh,
kw). ``ImageEncoder`` flattens its last map in flax's NHWC order itself,
so its 2048 -> 512 kernel carries over as any Dense kernel does.

A Dense ``kernel`` (in, out) becomes ``weight`` (out, in). An attention
kernel is flattened first: query/key/value (d, heads, head_dim) to
(d, heads * head_dim), out (heads, head_dim, d) to (heads * head_dim, d);
their biases (heads, head_dim) to one axis. A LayerNorm ``scale`` becomes
``weight``. Stacked weights keep the JAX layout (N, in, out). Each of
these layouts is a :class:`Layout`, which maps a tensor (or a block of
one) both ways: :func:`flax_to_state_dict` applies its ``to_port``, and
:func:`param_layouts` gives each parameter's of a port module, by which
``parallel.mesh`` reads the JAX sharding rule on the flax shape.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

_SEGMENTS = (
    (re.compile(r"^(encoders|decoders|x_specs|spec_heads|heads|TorchLinear)_(\d+)$"),
     lambda m: ("layers" if m.group(1) == "TorchLinear" else m.group(1), m.group(2))),
    (re.compile(r"^MLP_0$"), lambda m: ("mlp",)),
    (re.compile(r"^StackedMLP_0$"), lambda m: ("stack",)),
    (re.compile(r"^(Dense|LayerNorm|MultiplicativeInteractions2Modal|_TransformerEncoderLayer)"
                r"_(\d+)$"),
     lambda m: ({"Dense": "dense", "LayerNorm": "norm", "MultiplicativeInteractions2Modal": "mi",
                 "_TransformerEncoderLayer": "layers"}[m.group(1)], m.group(2))),
    (re.compile(r"^MultiHeadDotProductAttention_0$"), lambda m: ("attn",)),
    (re.compile(r"^feature_encoders_(\d+)$"), lambda m: ("feat_encs", m.group(1))),
    (re.compile(r"^(Conv|BatchNorm)_(\d+)$"),
     lambda m: ("blocks", {"Conv": "conv", "BatchNorm": "bn"}[m.group(1)], m.group(2))),
    (re.compile(r"^LateFusionTransformer_0$"), lambda m: ("transformer",)),
    (re.compile(r"^(kernel|scale)$"), lambda m: ("weight",)),
)
_ATTENTION = ("query", "key", "value", "out")


class Layout(NamedTuple):
    """A parameter's flax layout: ``to_jax`` and ``to_port`` map a tensor,
    or a block of one, between the port's layout and flax's."""

    to_jax: Callable
    to_port: Callable


def _same(t):
    return t


IDENTITY = Layout(_same, _same)
DENSE = Layout(lambda t: t.t(), lambda t: t.t())  # weight (out, in) <-> kernel (in, out)
CONV = Layout(lambda t: t.permute(2, 3, 1, 0),    # (out, in, kh, kw) <-> (kh, kw, in, out)
              lambda t: t.permute(3, 2, 0, 1))


def attention_layout(part: str, leaf: str, heads: int) -> Layout:
    """The layout of flax attention's ``part`` (query, key, value or out)
    ``leaf`` (its kernel, the port's weight, or its bias) with ``heads``
    heads: the (d, heads, head_dim) query/key/value kernels, the (heads,
    head_dim, d) output kernel and the (heads, head_dim) biases flattened
    (the output bias, (d,), as it is)."""
    if leaf == "bias":
        if part == "out":
            return IDENTITY
        return Layout(lambda t: t.reshape(heads, -1), lambda t: t.reshape(-1))
    if part == "out":
        return Layout(lambda t: t.t().reshape(heads, -1, t.shape[0]),
                      lambda t: t.reshape(-1, t.shape[-1]).t())
    return Layout(lambda t: t.t().reshape(t.shape[1], heads, -1),
                  lambda t: t.reshape(t.shape[0], -1).t())


def _flax_layout(path, t: torch.Tensor) -> Layout:
    """The layout of the flax leaf at ``path`` holding ``t``."""
    if len(path) > 1 and path[-2] in _ATTENTION and t.dim() > 1:
        heads = t.shape[1] if path[-1] == "kernel" and path[-2] != "out" else t.shape[0]
        return attention_layout(path[-2], path[-1], heads)
    if path[-1] == "kernel":
        return CONV if t.dim() == 4 else DENSE
    return IDENTITY


def param_layouts(model: nn.Module) -> Dict[str, Layout]:
    """The flax layout of each of ``model``'s parameters, by name: a 2-D
    ``weight`` is a Dense kernel, a 4-D one a convolution's, an attention
    module's (one with ``num_heads``) kernels and biases are flattened;
    every other tensor has flax's layout."""
    layouts, attention = {}, {}
    for prefix, module in model.named_modules():
        at = f"{prefix}." if prefix else ""
        for name, p in module.named_parameters(recurse=False):
            if name == "weight" and p.dim() in (2, 4):
                layouts[at + name] = DENSE if p.dim() == 2 else CONV
            else:
                layouts[at + name] = IDENTITY
        if hasattr(module, "num_heads") and hasattr(module, "query"):
            attention.update({f"{at}{part}.{leaf}": attention_layout(part, leaf, module.num_heads)
                              for part in _ATTENTION for leaf in ("weight", "bias")})
    return {**layouts, **attention}


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _port_key(path) -> str:
    parts = []
    for i, seg in enumerate(path):
        if seg == "Dense_0" and i and path[i - 1].startswith("TorchLinear_"):
            continue  # TorchLinear wraps one Dense: its parameters are the layer's
        for pattern, repl in _SEGMENTS:
            m = pattern.match(seg)
            if m:
                parts.extend(repl(m))
                break
        else:
            parts.append(seg)
    return ".".join(parts)


def flax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """The port's state dict for a flax ``params`` tree and, for a model
    with BatchNorm, its ``batch_stats`` tree."""
    state = {}
    for path, value in _flatten(batch_stats or {}):
        state[_port_key(path)] = torch.from_numpy(np.array(value, dtype=np.float32))
    for path, value in _flatten(params):
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        state[_port_key(path)] = _flax_layout(path, t).to_port(t).contiguous()
    return state


_HEAD = re.compile(r"^(x_shared|x_specs\.(\d+)|spec_heads\.(\d+)|heads\.(\d+))"
                   r"\.mlp\.layers\.(\d+)\.(weight|bias)$")


def stack_heads(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The state dict of a stacked-head model (``FusedEvidentialProbe``,
    ``FusedDisentangledEvidentialProbe``, ``FusedLateFusion``) holding the
    heads of its unfused twin's ``state`` (``EvidentialProbe``,
    ``DisentangledEvidentialProbe``, ``LateFusion``): head v's Dense layer
    i becomes slice v of ``stack.w{i+1}`` (V, in, out) and ``stack.b{i+1}``
    (V, out), its kernel zero-padded to the widest input as ``StackedMLP``
    pads it; the shared head (``x_shared``) is head 0, before ``x_specs``.
    Every other entry (feature encoders, BatchNorm statistics) is kept."""
    heads, out = {}, {}
    for key, t in state.items():
        m = _HEAD.match(key)
        if m is None:
            out[key] = t
            continue
        v = 0 if m.group(1) == "x_shared" else int(next(g for g in m.group(2, 3, 4) if g))
        v += 1 if m.group(2) is not None else 0
        heads.setdefault(int(m.group(5)), {}).setdefault(v, {})[m.group(6)] = t
    for i, layer in sorted(heads.items()):
        views = [layer[v] for v in sorted(layer)]
        width = max(h["weight"].shape[1] for h in views)
        w = views[0]["weight"].new_zeros((len(views), width, views[0]["weight"].shape[0]))
        for v, h in enumerate(views):
            w[v, :h["weight"].shape[1]] = h["weight"].t()
        out[f"stack.w{i + 1}"] = w
        out[f"stack.b{i + 1}"] = torch.stack([h["bias"] for h in views])
    return out


def load_flax_params(module: nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Load a flax ``params`` tree (and its ``batch_stats``) into ``module``
    in place; every parameter and buffer must be matched (``strict``).
    Returns ``module``."""
    module.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)
    return module

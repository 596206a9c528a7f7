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

A Dense ``kernel`` (in, out) becomes ``weight`` (out, in). An attention
kernel is flattened first: query/key/value (d, heads, head_dim) to
(d, heads * head_dim), out (heads, head_dim, d) to (heads * head_dim, d);
their biases (heads, head_dim) to one axis. A LayerNorm ``scale`` becomes
``weight``. Stacked weights keep the JAX layout (N, in, out).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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
    (re.compile(r"^LateFusionTransformer_0$"), lambda m: ("transformer",)),
    (re.compile(r"^(kernel|scale)$"), lambda m: ("weight",)),
)
_ATTENTION = ("query", "key", "value", "out")


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


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict for a flax ``params`` tree."""
    state = {}
    for path, value in _flatten(params):
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if len(path) > 1 and path[-2] in _ATTENTION and t.dim() > 1:
            if path[-1] == "bias":      # (heads, head_dim)
                t = t.reshape(-1)
            elif path[-2] == "out":     # (heads, head_dim, d)
                t = t.reshape(-1, t.shape[-1])
            else:                       # (d, heads, head_dim)
                t = t.reshape(t.shape[0], -1)
        if path[-1] == "kernel":
            t = t.t().contiguous()
        state[_port_key(path)] = t
    return state


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax ``params`` tree into ``module`` in place; every parameter
    must be matched (``strict``). Returns ``module``."""
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module

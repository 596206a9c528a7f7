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

A Dense ``kernel`` (in, out) becomes ``weight`` (out, in). Stacked weights
keep the JAX layout (N, in, out).
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
    (re.compile(r"^Dense_0$"), lambda m: ()),
    (re.compile(r"^kernel$"), lambda m: ("weight",)),
)


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _port_key(path) -> str:
    parts = []
    for seg in path:
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
        if path[-1] == "kernel":
            t = t.t().contiguous()
        state[_port_key(path)] = t
    return state


def load_flax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax ``params`` tree into ``module`` in place; every parameter
    must be matched (``strict``). Returns ``module``."""
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module

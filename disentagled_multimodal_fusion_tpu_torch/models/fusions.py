"""Generic fusion-op library.

Counterpart of ``disentagled_multimodal_fusion_tpu/models/fusions.py``
(reference: models/common_fusions.py:11-473). The stateless fusions are
plain functions; the parameterised ones are modules whose parameters are
drawn from an explicit ``torch.Generator`` with the JAX modules' laws, which
are not torch's defaults:

* a flax ``nn.Dense`` kernel is ``lecun_normal`` (a normal truncated at two
  standard deviations, variance 1 / fan_in) and its bias is zero; the
  module keeps ``weight`` as (out, in), as ``nn.Linear`` does;
* ``xavier_normal`` is the same truncated normal with variance
  2 / (fan_in + fan_out), the fans taken as flax takes them: the last axis
  is fan_out, the one before it fan_in, and any leading axes multiply both
  (so matrix3D's ``W`` (d0, d1, p*q) has fan_in d0*d1 and fan_out d0*p*q);
* ``normal(stddev=1.0)`` where the JAX module uses it, and a zero
  ``fusion_bias``;
* LayerNorm: scale one, bias zero, epsilon 1e-6 and flax's variance
  ``E[x^2] - E[x]^2``;
* multi-head attention: flax ``MultiHeadDotProductAttention``'s per-head
  query/key/value projections (d -> heads x head_dim) and output
  projection, scores scaled by 1/sqrt(head_dim), softmax in the
  parameters' precision (float32), no dropout. It is written as explicit
  products: the JAX package has no attention kernel to port.

On bf16 views (from bf16 feature encoders) every op computes in the type
JAX's promotion gives it: the parameter-free fusions and a product of two
views (matrix3D's outer product) stay bf16, and a view that meets a float32
parameter is taken to float32 first (``_promoted``), so the result is
float32, as the JAX modules' is.

Parameters keep the flax names where they are leaves (``W``, ``U``, ``V``,
``b``, ``factor_i``, ``fusion_weights``, ``fusion_bias``); ``convert.py``
maps the flax submodule paths onto the port's (``Dense_i`` -> ``dense.i``,
``LayerNorm_i`` -> ``norm.i``, ...).

On the mesh's model axis (``parallel.mesh``) every parameter here that the
rule cuts (a Dense kernel, a factor or an attention kernel whose flax axis
has the hidden width) is gathered whole before the forward and used whole
on every rank of the model group (gather-on-use); the layers here have no
Megatron form of their own.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated normal is cut at +-2 standard deviations of the unit
# normal; this divides the stddev so the cut normal keeps the variance
_TRUNC_STD = 0.87962566103423978


def truncated_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """A normal truncated to [-2, 2], scaled so that its std is ``std``
    (``jax.nn.initializers.variance_scaling(..., 'truncated_normal')``)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32).uniform_(lo, hi, generator=generator)
    z = torch.clamp(torch.erfinv(u) * math.sqrt(2.0), -2.0, 2.0)
    return z * (std / _TRUNC_STD)


def _fans(shape):
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def xavier_normal(shape, generator: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    return truncated_normal(shape, math.sqrt(2.0 / (fan_in + fan_out)), generator)


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    return truncated_normal(shape, math.sqrt(1.0 / _fans(shape)[0]), generator)


def normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` (out, in) drawn lecun-normal, zero bias."""

    def __init__(self, in_features: int, out_features: int, generator: torch.Generator,
                 bias: bool = True):
        super().__init__()
        kernel = lecun_normal((in_features, out_features), generator)
        self.weight = nn.Parameter(kernel.t().contiguous())
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def _promoted(modalities, module):
    """The views in the type that JAX's promotion gives them against the
    module's parameters: a bf16 view meets float32 parameters in float32, as
    the JAX ops compute it (a parameter-free fusion keeps its input's
    type)."""
    dtype = next(module.parameters()).dtype
    return [m.to(torch.promote_types(m.dtype, dtype)) for m in modalities]


def _ones_column(m: torch.Tensor) -> torch.Tensor:
    """``m`` with a column of ones in front of its last axis."""
    return F.pad(m, (1, 0), value=1.0)


# --------------------------------------------------------------- stateless
def concat(modalities) -> torch.Tensor:
    """Flatten each modality past dim 0 and concat on dim 1
    (common_fusions.py:11-27)."""
    return torch.cat([m.flatten(1) for m in modalities], dim=1)


def concat_early(modalities) -> torch.Tensor:
    """Concat on dim 2 (common_fusions.py:31-44)."""
    return torch.cat(list(modalities), dim=2)


def stack(modalities) -> torch.Tensor:
    """Flatten then stack on a new trailing dim (common_fusions.py:48-64)."""
    return torch.stack([m.flatten(1) for m in modalities], dim=2)


def tensor_fusion(modalities) -> torch.Tensor:
    """TensorFusion: outer product of 1-augmented modalities
    (common_fusions.py:246-276); one modality is returned as it is."""
    if len(modalities) == 1:
        return modalities[0]
    nonfeature = modalities[0].shape[:-1]
    m = _ones_column(modalities[0])
    for mod in modalities[1:]:
        fused = torch.einsum("...i,...j->...ij", m, _ones_column(mod))
        m = fused.flatten(-2)
    return m


# --------------------------------------------------------------- modules
class Concat(nn.Module):
    """Module wrapper over :func:`concat`."""

    def forward(self, modalities):
        return concat(modalities)


class TensorFusion(nn.Module):
    """Module wrapper over :func:`tensor_fusion`."""

    def forward(self, modalities):
        return tensor_fusion(modalities)


class ConcatWithLinear(nn.Module):
    """Concat on ``concat_dim``, then Dense (common_fusions.py:67-87)."""

    def __init__(self, input_dim: int, output_dim: int, generator: torch.Generator,
                 concat_dim: int = 1):
        super().__init__()
        self.concat_dim = concat_dim
        self.dense = nn.ModuleList([Dense(input_dim, output_dim, generator)])

    def forward(self, modalities):
        return self.dense[0](torch.cat(_promoted(modalities, self), dim=self.concat_dim))


class MultiplicativeInteractions2Modal(nn.Module):
    """2-way multiplicative interactions (common_fusions.py:118-243);
    ``output`` in {'matrix3D', 'matrix', 'vector', 'scalar'}.

    matrix3D contracts its W-term as (B, d0*d1) @ (d0*d1, p*q): the
    per-sample weight tensor (B, d1, p, q) is never formed (JAX
    ``models/fusions.py:123-135``)."""

    def __init__(self, input_dims: Sequence[int], output_dim, generator: torch.Generator,
                 output: str = "matrix", flatten: bool = False, clip=None, flip: bool = False):
        super().__init__()
        d0, d1 = (int(d) for d in input_dims)
        self.input_dims, self.output_dim, self.output = (d0, d1), output_dim, output
        self.flatten, self.clip, self.flip = flatten, clip, flip
        xn, nrm = xavier_normal, normal
        if output == "matrix3D":
            p, q = output_dim
            shapes = {"W": (xn, (d0, d1, p * q)), "U": (xn, (d0, p * q)),
                      "V": (xn, (d1, p * q)), "b": (xn, (p, q))}
        elif output == "matrix":
            d = output_dim
            shapes = {"W": (xn, (d0, d1 * d)), "U": (xn, (d0, d)), "V": (xn, (d1, d)),
                      "b": (nrm, (d,))}
        elif output == "vector":
            shapes = {"W": (xn, (d0, d1)), "U": (xn, (d0, d1)), "V": (nrm, (d1,)),
                      "b": (nrm, (d1,))}
        elif output == "scalar":
            shapes = {"W": (nrm, (d0,)), "U": (nrm, (d0,)), "V": (nrm, (1,)), "b": (nrm, (1,))}
        else:
            raise ValueError(output)
        for name, (law, shape) in shapes.items():
            self.register_parameter(name, nn.Parameter(law(shape, generator)))

    def forward(self, modalities):
        if len(modalities) == 1:
            return modalities[0]
        if len(modalities) != 2:
            raise ValueError(f"expected 2 modalities, got {len(modalities)}")
        m1, m2 = modalities
        if self.flip:
            m1, m2 = m2, m1
        if self.flatten:
            m1, m2 = m1.flatten(1), m2.flatten(1)
        if self.clip is not None:
            m1, m2 = (torch.clamp(m, self.clip[0], self.clip[1]) for m in (m1, m2))
        d0, d1 = self.input_dims
        W, U, V, b = self.W, self.U, self.V, self.b
        # matrix3D's outer product of the views stays in their type (bf16 as
        # in the JAX op); every product with a parameter is in the promoted one
        outer = (torch.einsum("bn,bm->bnm", m1, m2).reshape(-1, d0 * d1)
                 if self.output == "matrix3D" else None)
        m1, m2 = _promoted([m1, m2], self)
        if self.output == "matrix3D":
            p, q = self.output_dim
            core = outer.to(m1.dtype) @ W.reshape(d0 * d1, p * q)
            bp = torch.einsum("bn,nd->bd", m1, U).reshape(-1, p, q) + b
            return (core + m2 @ V).reshape(-1, p, q) + bp
        if self.output == "matrix":
            d = self.output_dim
            Wp = torch.einsum("bn,nmd->bmd", m1, W.reshape(d0, d1, d)) + V
            bp = m1 @ U + b
            return torch.einsum("bm,bmd->bd", m2, Wp) + bp
        if self.output == "vector":
            return (m1 @ W + V) * m2 + (m1 @ U + b)
        return (m1 @ W[:, None] + V) * m2 + (m1 @ U[:, None] + b)


class MultiplicativeInteractions3Modal(nn.Module):
    """3-way multiplicative interactions (common_fusions.py:90-115): a
    matrix3D interaction of views 0 and 1 with tail (d2, out), contracted
    with view 2, plus a matrix interaction of views 0 and 1."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, generator: torch.Generator):
        super().__init__()
        dims = tuple(int(d) for d in input_dims)
        self.mi = nn.ModuleList([
            MultiplicativeInteractions2Modal(dims[:2], (dims[2], output_dim), generator,
                                             output="matrix3D"),
            MultiplicativeInteractions2Modal(dims[:2], output_dim, generator, output="matrix"),
        ])

    def forward(self, modalities):
        a = self.mi[0](modalities[:2])
        b = self.mi[1](modalities[:2])
        (m3,) = _promoted(modalities[2:3], self)
        return torch.einsum("bm,bmp->bp", m3, a) + b


class LowRankTensorFusion(nn.Module):
    """Low-rank tensor fusion (common_fusions.py:279-344)."""

    def __init__(self, input_dims: Sequence[int], output_dim: int, rank: int,
                 generator: torch.Generator, flatten: bool = True):
        super().__init__()
        self.input_dims, self.output_dim, self.rank = tuple(input_dims), output_dim, rank
        self.flatten = flatten
        for i, d in enumerate(self.input_dims):
            self.register_parameter(f"factor_{i}", nn.Parameter(
                xavier_normal((rank, (d + 1) * output_dim), generator)))
        self.fusion_weights = nn.Parameter(xavier_normal((1, rank), generator))
        self.fusion_bias = nn.Parameter(torch.zeros(1, output_dim))

    def forward(self, modalities):
        modalities = _promoted(modalities, self)
        batch = modalities[0].shape[0]
        fused = 1.0
        for i, (modality, d) in enumerate(zip(modalities, self.input_dims)):
            factor = getattr(self, f"factor_{i}").reshape(self.rank, d + 1, self.output_dim)
            m = modality.flatten(1) if self.flatten else modality
            fused = fused * torch.einsum("bi,rio->rbo", _ones_column(m), factor)
        out = torch.einsum("or,rbd->bd", self.fusion_weights, fused) + self.fusion_bias
        return out.reshape(-1, self.output_dim)


class NLgate(nn.Module):
    """Non-local gate fusion (common_fusions.py:347-406). ``q_linear`` etc.
    are (in, out) pairs of optional Dense projections, which are
    ``dense.0, dense.1, ...`` in the order q, k, v of those present."""

    def __init__(self, thw_dim: int, c_dim: int, tf_dim: int, generator: torch.Generator,
                 q_linear=None, k_linear=None, v_linear=None):
        super().__init__()
        self.thw_dim, self.c_dim, self.tf_dim = thw_dim, c_dim, tf_dim
        specs = [q_linear, k_linear, v_linear]
        self.dense = nn.ModuleList(Dense(s[0], s[1], generator) for s in specs if s)
        slots, at = [], 0
        for s in specs:
            slots.append(at if s else None)
            at += 1 if s else 0
        self.slots = slots

    def _proj(self, which: int, x):
        slot = self.slots[which]
        return x if slot is None else self.dense[slot](x)

    def forward(self, x):
        q, k = x[0], x[1]
        qin = self._proj(0, q).reshape(-1, self.thw_dim, self.c_dim)
        kin = self._proj(1, k).reshape(-1, self.c_dim, self.tf_dim)
        vin = self._proj(2, k).reshape(-1, self.tf_dim, self.c_dim)
        attn = torch.softmax(qin @ kin, dim=2)
        out = qin + attn @ vin
        return out.flatten(1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6, the variance
    as E[x^2] - E[x]^2 (clamped at 0), ``weight`` is flax's ``scale``."""

    EPS = 1e-6

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.clamp(torch.mean(x * x, dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * torch.rsqrt(var + self.EPS) * self.weight + self.bias


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no dropout):
    ``query``/``key``/``value`` project d -> heads * head_dim (flax kernels
    (d, heads, head_dim)), ``out`` projects back (flax (heads, head_dim, d)),
    every kernel lecun-normal over its flattened input width."""

    def __init__(self, d_model: int, num_heads: int, generator: torch.Generator):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of {num_heads} heads")
        self.num_heads, self.head_dim = num_heads, d_model // num_heads
        self.query, self.key, self.value, self.out = (
            Dense(d_model, d_model, generator) for _ in range(4))

    def forward(self, x):
        b, t, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        q = self.query(x).reshape(b, t, h, hd) / math.sqrt(hd)
        k = self.key(x).reshape(b, t, h, hd)
        v = self.value(x).reshape(b, t, h, hd)
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        heads = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(heads.reshape(b, t, h * hd))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (torch ``nn.TransformerEncoderLayer``
    defaults: feed-forward 2048, relu, post-LN), with flax's inits."""

    def __init__(self, d_model: int, nhead: int, generator: torch.Generator,
                 dim_feedforward: int = 2048):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, nhead, generator)
        self.norm = nn.ModuleList([LayerNorm(d_model), LayerNorm(d_model)])
        self.dense = nn.ModuleList([Dense(d_model, dim_feedforward, generator),
                                    Dense(dim_feedforward, d_model, generator)])

    def forward(self, x):
        x = self.norm[0](x + self.attn(x))
        ff = self.dense[1](torch.relu(self.dense[0](x)))
        return self.norm[1](x + ff)


class EarlyFusionTransformer(nn.Module):
    """Early-fusion transformer (common_fusions.py:409-441): a per-step
    projection without bias (the reference's 1x1 conv), three encoder
    layers, Dense(1) on the last step."""

    def __init__(self, n_features: int, generator: torch.Generator, embed_dim: int = 9):
        super().__init__()
        self.dense = nn.ModuleList([Dense(n_features, embed_dim, generator, bias=False)])
        self.layers = nn.ModuleList(TransformerEncoderLayer(embed_dim, 3, generator)
                                    for _ in range(3))
        self.dense.append(Dense(embed_dim, 1, generator))

    def forward(self, x):
        h = self.dense[0](x)
        for layer in self.layers:
            h = layer(h)
        return self.dense[1](h[:, -1])


class LateFusionTransformer(nn.Module):
    """Late-fusion transformer (common_fusions.py:444-473): one scalar token
    per feature of a flat vector, three encoder layers, the last token."""

    def __init__(self, generator: torch.Generator, embed_dim: int = 9):
        super().__init__()
        self.embed_dim = embed_dim
        self.dense = nn.ModuleList([Dense(1, embed_dim, generator, bias=False)])
        self.layers = nn.ModuleList(TransformerEncoderLayer(embed_dim, 3, generator)
                                    for _ in range(3))

    def forward(self, x):
        h = self.dense[0](x.flatten(1)[..., None])
        for layer in self.layers:
            h = layer(h)
        return h[:, -1]


class ConcatTransformerFusion(nn.Module):
    """Concat the flat views, then :class:`LateFusionTransformer` over the
    concatenated feature axis: the reference's LateFusionTransformer as an
    N-view fusion op."""

    def __init__(self, generator: torch.Generator, embed_dim: int = 9):
        super().__init__()
        self.embed_dim = embed_dim
        self.transformer = LateFusionTransformer(generator, embed_dim)

    def forward(self, modalities):
        return self.transformer(concat(_promoted(modalities, self)))


# --------------------------------------------------------------- registry
#: Fusions usable as IntermediateFusion's fusion op over flat (B, S_i)
#: views. NLgate (video feature-map reshapes) and EarlyFusionTransformer
#: (a scalar output) are left out, as in the JAX package.
INTERMEDIATE_FUSIONS = (
    "concat",         # sum(dims)                 (the reference's executed choice)
    "concat_linear",  # ConcatWithLinear -> output_dim
    "mi_matrix",      # MultiplicativeInteractions2Modal 'matrix' (2 views)
    "mi_vector",      # MultiplicativeInteractions2Modal 'vector' (2 views)
    "mi3",            # MultiplicativeInteractions3Modal (3 views)
    "tensor",         # outer product of 1-augmented views -> prod(dims+1)
    "lrtf",           # LowRankTensorFusion -> output_dim
    "lft",            # concat -> LateFusionTransformer -> embed_dim (9)
)

#: Cap on TensorFusion's output width (prod(dims + 1) explodes: HandWritten's
#: six views would give ~2e11 features).
TENSOR_FUSION_MAX_DIM = 1_500_000

#: Cap on the multiplicative-interaction fusions' parameter count, the JAX
#: package's: PIE's mi3 (484, 256, 279) would need 2.2e9 parameters.
MI_FUSION_MAX_PARAMS = 1_100_000_000

_LFT_EMBED = 9


def fusion_dim(name: str, input_dims, *, output_dim: int = 64) -> int:
    """The fused width of fusion ``name`` over flat views ``input_dims``,
    or ``ValueError`` (the JAX package's texts) where :func:`build_fusion`
    refuses; draws nothing."""
    dims = tuple(int(d) for d in input_dims)
    n = len(dims)
    if name == "concat":
        return sum(dims)
    if name in ("concat_linear", "lrtf"):
        return output_dim
    if name == "mi_matrix":
        if n != 2:
            raise ValueError(f"mi_matrix fuses exactly 2 views, got {n}")
        n_params = (dims[0] * dims[1] + dims[0] + dims[1] + 1) * output_dim
        if n_params > MI_FUSION_MAX_PARAMS:
            raise ValueError(
                f"mi_matrix needs {n_params:.2e} params for views {dims} "
                f"(cap {MI_FUSION_MAX_PARAMS:.1e}: params + Adam state must "
                f"fit single-chip HBM); use lrtf instead"
            )
        return output_dim
    if name == "mi_vector":
        if n != 2:
            raise ValueError(f"mi_vector fuses exactly 2 views, got {n}")
        return dims[1]
    if name == "mi3":
        if n != 3:
            raise ValueError(f"mi3 fuses exactly 3 views, got {n}")
        pair = dims[0] * dims[1] + dims[0] + dims[1] + 1
        n_params = pair * (dims[2] * output_dim) + pair * output_dim
        if n_params > MI_FUSION_MAX_PARAMS:
            raise ValueError(
                f"mi3 needs {n_params:.2e} params for views {dims} "
                f"(cap {MI_FUSION_MAX_PARAMS:.1e}: params + Adam state must "
                f"fit single-chip HBM — e.g. PIE (484,256,279) would be "
                f"~35 GiB with optimizer state); use lrtf instead"
            )
        return output_dim
    if name == "tensor":
        fused = math.prod(d + 1 for d in dims)
        if fused > TENSOR_FUSION_MAX_DIM:
            raise ValueError(
                f"tensor fusion output dim prod(dims+1)={fused} exceeds "
                f"{TENSOR_FUSION_MAX_DIM} for views {dims}; use lrtf instead"
            )
        return fused
    if name == "lft":
        return _LFT_EMBED
    raise ValueError(f"unknown fusion {name!r}; supported: {INTERMEDIATE_FUSIONS}")


def build_fusion(name: str, input_dims, *, output_dim: int = 64, rank: int = 8,
                 generator: Optional[torch.Generator] = None):
    """(module, fused_dim) of library fusion ``name`` over flat ``(B, S_i)``
    views: ``module(list_of_views) -> (B, fused_dim)``. Parameters are
    drawn from ``generator`` (a fresh one seeded 0 by default). Refuses what
    :func:`fusion_dim` refuses."""
    fused = fusion_dim(name, input_dims, output_dim=output_dim)
    dims = tuple(int(d) for d in input_dims)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    if name == "concat":
        return Concat(), fused
    if name == "concat_linear":
        return ConcatWithLinear(sum(dims), output_dim, g), fused
    if name == "mi_matrix":
        return MultiplicativeInteractions2Modal(dims, output_dim, g, output="matrix"), fused
    if name == "mi_vector":
        return MultiplicativeInteractions2Modal(dims, dims[1], g, output="vector"), fused
    if name == "mi3":
        return MultiplicativeInteractions3Modal(dims, output_dim, g), fused
    if name == "tensor":
        return TensorFusion(), fused
    if name == "lrtf":
        return LowRankTensorFusion(dims, output_dim, rank, g), fused
    return ConcatTransformerFusion(g, _LFT_EMBED), fused

"""DeepSeek-V2's decoder as a frozen text tower of LUMA: token ids in, a pooled state through an MLP out.

``layers.TowerTextEncoder`` (``layers.ENCODER_REGISTRY``) holds a
``Tower`` and a head: a feature encoder, so
``core.tasks.build_dmvae_task(feature_encoders=...)`` builds it beside the
Audio and Image encoders and the scoring path (``core/serve.py``) serves
it. The JAX package has no counterpart: this is the port's own module.

The tower follows the published config (``DEEPSEEK_V2_LITE``, the keys of
DeepSeek-V2-Lite's ``config.json``; other configs of the family with the
same mechanisms load too) and DeepSeek-V2's modelling code, with weight
names as in its checkpoints. For layer l:
h <- h + Attn(RMSNorm(h)), then h <- h + FFN_l(RMSNorm(h)).

- RMSNorm: x rsqrt(mean(x^2) + eps) w, in float32, cast back.
- Attention, multi-head latent (MLA) without a query LoRA: q = W_q x,
  split per head into q_nope and q_pe; c = W_kva x, split into c_kv
  (``kv_lora_rank``) and one k_pe shared by the heads; [k_nope | v] =
  W_kvb RMSNorm(c_kv). q_pe and k_pe are de-interleaved, then rotated
  (``rotate_half``) by YaRN's frequencies (:func:`yarn_inv_freq`; cos and
  sin scaled by mscale(mscale) / mscale(mscale_all_dim)). Scores q.k times
  (q head dim)^-0.5 mscale(mscale_all_dim)^2 (:func:`softmax_scale`), a
  causal mask over each row's positions 0..S-1, softmax in float32, P v,
  then W_o. The two batched products are ``torch.matmul``.
- FFN: the first ``first_k_dense_replace`` layers are SiLU-gated MLPs of
  width ``intermediate_size``; the others mixtures of experts: a float32
  softmax gate over ``n_routed_experts``, each token's greedy top-k
  (weights not renormalised, times ``routed_scaling_factor``), the routed
  experts through ``ops/moe_experts.py`` (the expert kernel on the card),
  their weighted sum in float32, plus the shared experts (one SiLU-gated
  MLP of width ``n_shared_experts * moe_intermediate_size``), cast back.
- Then the final RMSNorm, the mean over the positions in float32, and
  the head MLP hidden -> 256 -> 256 -> ``output_dim`` with ReLU, as
  ``TextEncoder``'s (float32, trained like it).

The tower computes in ``dtype`` (bfloat16, the published dtype, or float32
for the CPU tests): its weights and activations, products summed in
float32 by the libraries and the kernel; norms, softmaxes and the gate in
float32. It is frozen (``requires_grad`` False) and has no dropout.

It is built where it runs: its parameters are made on ``device`` and drawn
there (N(0, ``initializer_range``) weights, unit norm scales) from a
generator on that device seeded by one number of the host's generator,
or on the host's generator itself on the CPU; on the meta device nothing
is drawn. Nothing of its weights passes through the host: a checkpoint's
are loaded by assignment (``load_state_dict(assign=True)``). Export
(``core.serve.export_inference``) refuses it: ``exportable`` is False.

Spans (``core/logging.py``): ``serve.text_tower`` (the tower's forward,
inside ``serve.backbone`` when served), ``tower.attention`` and
``tower.moe`` (each layer's); they open where the module runs eagerly or
is captured, not at a graph's replay. The counter ``tower.tokens`` adds
the tokens of each forward (held into a graph, so it counts at each
replay), and ``kernels.moe_experts`` the expert kernel's launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.logging import count, span
from ..ops.moe_experts import moe_experts, route

# DeepSeek-V2-Lite's config.json (https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite)
DEEPSEEK_V2_LITE = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax", "seq_aux": True,
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy", "v_head_dim": 128,
    "vocab_size": 102400,
}

# what this module computes; another value of these keys raises
_SUPPORTED = {"q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy",
              "norm_topk_prob": False, "n_group": 1, "topk_group": 1, "attention_bias": False,
              "hidden_act": "silu", "moe_layer_freq": 1}


def check_config(cfg: dict) -> None:
    """Raise ValueError where ``cfg`` asks for a mechanism this tower lacks."""
    for key, value in _SUPPORTED.items():
        if cfg.get(key, value) != value:
            raise ValueError(f"text tower: {key}={cfg[key]!r} is not supported ({value!r} is)")
    scaling = cfg.get("rope_scaling")
    if scaling is not None and scaling.get("type") != "yarn":
        raise ValueError(f"text tower: rope_scaling type {scaling.get('type')!r}; yarn or none")


def yarn_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(cfg: dict) -> torch.Tensor:
    """The rotary frequencies (rope dim / 2,) in float32: YaRN's blend
    f_inter (1 - m) + f_extra m of f_extra = theta^(-2i/d) and f_inter =
    f_extra / factor, m = 1 - the ramp from floor(low) to ceil(high) of the
    dims at which ``beta_fast`` and ``beta_slow`` rotations fit the
    original context; f_extra alone without rope scaling."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    f_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    scaling = cfg.get("rope_scaling")
    if scaling is None:
        return f_extra
    factor, original = scaling["factor"], scaling["original_max_position_embeddings"]

    def correction_dim(rotations):
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(scaling["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(scaling["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    m = 1.0 - ramp
    return f_extra / factor * (1.0 - m) + f_extra * m


def rope_mscale(cfg: dict) -> float:
    """The factor of YaRN's cos and sin: mscale(mscale) / mscale(mscale_all_dim)."""
    s = cfg.get("rope_scaling")
    if s is None:
        return 1.0
    return yarn_mscale(s["factor"], s.get("mscale", 1)) / yarn_mscale(
        s["factor"], s.get("mscale_all_dim", 0))


def softmax_scale(cfg: dict) -> float:
    """(qk_nope + qk_rope)^-0.5, times mscale(factor, mscale_all_dim)^2
    under YaRN with ``mscale_all_dim`` set."""
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    s = cfg.get("rope_scaling")
    if s is not None and s.get("mscale_all_dim"):
        scale *= yarn_mscale(s["factor"], s["mscale_all_dim"]) ** 2
    return scale


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Linear(nn.Module):
    """A bias-free product x W^T, ``weight`` (out, in)."""

    def __init__(self, fan_in: int, fan_out: int, dtype, device):
        super().__init__()
        self.weight = _param((fan_out, fan_in), dtype, device)

    def forward(self, x):
        return F.linear(x, self.weight)


class Embedding(nn.Module):
    """Rows of ``weight`` (vocab, hidden) by token id."""

    def __init__(self, vocab: int, hidden: int, dtype, device):
        super().__init__()
        self.weight = _param((vocab, hidden), dtype, device)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.weight = _param((dim,), dtype, device)
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, heads, S, d) de-interleaved ((x0, x1), (x2, x3), ... -> x0, x2,
    ..., x1, x3, ...), then x cos + rotate_half(x) sin, in float32."""
    b, h, s, d = x.shape
    x = x.float().view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


class Attention(nn.Module):
    """Multi-head latent attention without a query LoRA (see the module)."""

    def __init__(self, cfg: dict, dtype, device):
        super().__init__()
        hidden, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        self.heads, self.rank = heads, cfg["kv_lora_rank"]
        self.nope, self.rope, self.v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                                        cfg["v_head_dim"])
        self.q_proj = Linear(hidden, heads * (self.nope + self.rope), dtype, device)
        self.kv_a_proj_with_mqa = Linear(hidden, self.rank + self.rope, dtype, device)
        self.kv_a_layernorm = RMSNorm(self.rank, cfg["rms_norm_eps"], dtype, device)
        self.kv_b_proj = Linear(self.rank, heads * (self.nope + self.v), dtype, device)
        self.o_proj = Linear(heads * self.v, hidden, dtype, device)
        self.scale = softmax_scale(cfg)

    def forward(self, x, cos, sin, causal):
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, self.heads, -1).transpose(1, 2)
        q_nope, q_pe = torch.split(q, [self.nope, self.rope], dim=-1)
        c, k_pe = torch.split(self.kv_a_proj_with_mqa(x), [self.rank, self.rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(b, s, self.heads, -1).transpose(1, 2)
        k_nope, v = torch.split(kv, [self.nope, self.v], dim=-1)
        q_pe = rotate(q_pe, cos, sin).to(x.dtype)
        k_pe = rotate(k_pe.view(b, s, 1, self.rope).transpose(1, 2), cos, sin).to(x.dtype)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, self.heads, s, self.rope)], dim=-1)
        scores = torch.matmul(q, k.transpose(2, 3)).float() * self.scale
        p = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1).to(v.dtype)
        out = torch.matmul(p, v).transpose(1, 2).reshape(b, s, self.heads * self.v)
        return self.o_proj(out)


class MLP(nn.Module):
    """W_down (silu(W_gate x) * W_up x)."""

    def __init__(self, hidden: int, width: int, dtype, device):
        super().__init__()
        self.gate_proj = Linear(hidden, width, dtype, device)
        self.up_proj = Linear(hidden, width, dtype, device)
        self.down_proj = Linear(width, hidden, dtype, device)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Experts(nn.Module):
    """The routed experts' weights stacked: ``gate_proj`` and ``up_proj``
    (E, width, hidden), ``down_proj`` (E, hidden, width)."""

    def __init__(self, n: int, hidden: int, width: int, dtype, device):
        super().__init__()
        self.gate_proj = _param((n, width, hidden), dtype, device)
        self.up_proj = _param((n, width, hidden), dtype, device)
        self.down_proj = _param((n, hidden, width), dtype, device)


class MoE(nn.Module):
    """The gate, the routed experts and the shared experts (see the module)."""

    def __init__(self, cfg: dict, dtype, device):
        super().__init__()
        hidden, width = cfg["hidden_size"], cfg["moe_intermediate_size"]
        self.top_k, self.scaling = cfg["num_experts_per_tok"], cfg["routed_scaling_factor"]
        self.gate = Linear(hidden, cfg["n_routed_experts"], dtype, device)
        self.experts = Experts(cfg["n_routed_experts"], hidden, width, dtype, device)
        self.shared_experts = MLP(hidden, width * cfg["n_shared_experts"], dtype, device)

    def forward(self, x):
        with span("tower.moe"):
            flat = x.reshape(-1, x.shape[-1])
            weights, experts = route(flat, self.gate.weight, self.top_k, self.scaling)
            e = self.experts
            routed = moe_experts(flat, weights, experts, e.gate_proj, e.up_proj, e.down_proj)
            out = routed + self.shared_experts(flat).float()
            return out.to(x.dtype).view(x.shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: dict, index: int, dtype, device):
        super().__init__()
        eps, hidden = cfg["rms_norm_eps"], cfg["hidden_size"]
        self.input_layernorm = RMSNorm(hidden, eps, dtype, device)
        self.self_attn = Attention(cfg, dtype, device)
        self.post_attention_layernorm = RMSNorm(hidden, eps, dtype, device)
        if index < cfg["first_k_dense_replace"]:
            self.mlp = MLP(hidden, cfg["intermediate_size"], dtype, device)
        else:
            self.mlp = MoE(cfg, dtype, device)

    def forward(self, h, cos, sin, causal):
        with span("tower.attention"):
            h = h + self.self_attn(self.input_layernorm(h), cos, sin, causal)
        return h + self.mlp(self.post_attention_layernorm(h))


class Tower(nn.Module):
    """Token ids (B, S) -> the mean over positions of the final norm's
    states, (B, hidden) float32."""

    def __init__(self, cfg: dict, dtype, device):
        super().__init__()
        check_config(cfg)
        self.cfg = dict(cfg)
        self.embed_tokens = Embedding(cfg["vocab_size"], cfg["hidden_size"], dtype, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, dtype, device)
                                    for i in range(cfg["num_hidden_layers"]))
        self.norm = RMSNorm(cfg["hidden_size"], cfg["rms_norm_eps"], dtype, device)
        self.register_buffer("inv_freq", yarn_inv_freq(cfg).to(device), persistent=False)
        self.rope_mscale = rope_mscale(cfg)

    def forward(self, ids):
        s = ids.shape[1]
        if s > self.cfg["max_position_embeddings"]:
            raise ValueError(f"{s} positions; the tower takes at most "
                             f"{self.cfg['max_position_embeddings']}")
        positions = torch.arange(s, dtype=torch.float32, device=ids.device)
        freqs = torch.outer(positions, self.inv_freq)
        emb = torch.cat([freqs, freqs], dim=-1)
        cos, sin = emb.cos() * self.rope_mscale, emb.sin() * self.rope_mscale
        causal = torch.ones((s, s), dtype=torch.bool, device=ids.device).triu(1)
        h = self.embed_tokens(ids)
        for layer in self.layers:
            h = layer(h, cos, sin, causal)
        count("tower.tokens", ids.numel())
        return self.norm(h).float().mean(dim=1)


def draw_tower(tower: Tower, generator: torch.Generator, std: float) -> None:
    """The tower's own initial law, drawn where its parameters lie: norm
    scales 1, every other weight N(0, std); from ``generator`` on the CPU,
    from a generator on the parameters' device seeded by one draw of
    ``generator`` elsewhere; nothing on the meta device."""
    device = tower.embed_tokens.weight.device
    if device.type == "meta":
        return
    if device.type != "cpu":
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        generator = torch.Generator(device=device).manual_seed(seed)
    for name, p in tower.named_parameters():
        if name.endswith("norm.weight"):
            p.data.fill_(1.0)
        else:
            p.data.normal_(0.0, std, generator=generator)

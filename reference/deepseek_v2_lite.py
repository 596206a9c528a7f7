"""A plain reference of DeepSeek-V2's decoder as a text tower: token ids -> mean-pooled final states.

Written from DeepSeek-V2's published config and modelling code, in float32
(on a card the caller turns TF32 off), with no kernel, cache or batching
of the port's and nothing of the port or of JAX imported: torch and math
alone. Weights are read by their checkpoint names under ``prefix``
(``embed_tokens.weight``, ``layers.<l>.self_attn.q_proj.weight``, ...;
the routed experts stacked as ``layers.<l>.mlp.experts.gate_proj`` and
``up_proj`` (E, width, hidden) and ``down_proj`` (E, hidden, width)),
whatever their dtype, and upcast to float32 one layer at a time, so that
bf16 weights of the published size fit beside it. ``cfg`` holds the
published ``config.json`` keys.

Departures from the published model: none in the layers; the tower ends
with the final RMSNorm and the mean over the positions (an encoder's
pooling) instead of the LM head. The YaRN numbers are computed here in
Python's float64 and rounded to float32 once. The routed experts run as a
loop over the experts, each on the tokens a boolean mask selects, and the
causal mask is an explicit -inf above the diagonal.
"""

import math

import torch
import torch.nn.functional as F


def yarn_get_mscale(scale, mscale):
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def rope_inv_freq(cfg):
    """YaRN's rotary frequencies, float64 arithmetic, as a float32 tensor."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    extra = [base ** (-(2 * i) / dim) for i in range(dim // 2)]
    s = cfg.get("rope_scaling")
    if s is None:
        return torch.tensor(extra, dtype=torch.float32)
    original = s["original_max_position_embeddings"]

    def dim_of(rotations):
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim_of(s["beta_fast"])), 0)
    high = min(math.ceil(dim_of(s["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    out = []
    for i, f in enumerate(extra):
        extrapolated = 1.0 - min(max((i - low) / (high - low), 0.0), 1.0)
        out.append(f / s["factor"] * (1.0 - extrapolated) + f * extrapolated)
    return torch.tensor(out, dtype=torch.float32)


def attention_scale(cfg):
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    s = cfg.get("rope_scaling")
    if s is not None and s.get("mscale_all_dim"):
        scale = scale * yarn_get_mscale(s["factor"], s["mscale_all_dim"]) ** 2
    return scale


def rope_cos_sin(cfg, positions, device):
    s = cfg.get("rope_scaling")
    mscale = 1.0 if s is None else (yarn_get_mscale(s["factor"], s.get("mscale", 1))
                                    / yarn_get_mscale(s["factor"], s.get("mscale_all_dim", 0)))
    t = torch.arange(positions, dtype=torch.float32, device=device)
    freqs = t[:, None] * rope_inv_freq(cfg).to(device)[None, :]
    angles = torch.cat([freqs, freqs], dim=-1)
    return angles.cos() * mscale, angles.sin() * mscale


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * weight


def apply_rope(x, cos, sin):
    """Pairs (x0, x1), (x2, x3), ... of the last axis de-interleaved into
    (x0, x2, ..., x1, x3, ...), then rotated by half."""
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def gated_mlp(x, gate, up, down):
    return (F.silu(x @ gate.T) * (x @ up.T)) @ down.T


def attention(p, x, cfg, cos, sin):
    b, s, _ = x.shape
    heads, nope, rope, v_dim = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                                cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    q = (x @ p["self_attn.q_proj.weight"].T).view(b, s, heads, nope + rope).transpose(1, 2)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    compressed = x @ p["self_attn.kv_a_proj_with_mqa.weight"].T
    c_kv, k_pe = compressed[..., :rank], compressed[..., rank:]
    c_kv = rms_norm(c_kv, p["self_attn.kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = (c_kv @ p["self_attn.kv_b_proj.weight"].T).view(b, s, heads, nope + v_dim)
    kv = kv.transpose(1, 2)
    k_nope, value = kv[..., :nope], kv[..., nope:]
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, None], cos, sin).expand(b, heads, s, rope)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe], dim=-1)
    scores = query @ key.transpose(2, 3) * attention_scale(cfg)
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    weights = torch.softmax(scores + mask, dim=-1)
    out = (weights @ value).transpose(1, 2).reshape(b, s, heads * v_dim)
    return out @ p["self_attn.o_proj.weight"].T


def moe(p, x, cfg):
    shape = x.shape
    t = x.reshape(-1, shape[-1])
    scores = torch.softmax(t @ p["mlp.gate.weight"].T, dim=-1)
    weight, expert = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    weight = weight * cfg["routed_scaling_factor"]
    out = torch.zeros_like(t)
    for e in range(cfg["n_routed_experts"]):
        hit = expert == e
        tokens = hit.any(dim=-1)
        if not bool(tokens.any()):
            continue
        y = gated_mlp(t[tokens], p["mlp.experts.gate_proj"][e], p["mlp.experts.up_proj"][e],
                      p["mlp.experts.down_proj"][e])
        out[tokens] += (weight * hit).sum(dim=-1)[tokens, None] * y
    out = out + gated_mlp(t, p["mlp.shared_experts.gate_proj.weight"],
                          p["mlp.shared_experts.up_proj.weight"],
                          p["mlp.shared_experts.down_proj.weight"])
    return out.view(shape)


def layer_weights(w, prefix):
    """The weights under ``prefix``, names without it, in float32."""
    return {k[len(prefix):]: v.float() for k, v in w.items() if k.startswith(prefix)}


def tower(cfg, w, prefix, ids):
    """(B, S) token ids -> (B, hidden) float32: the decoder, the final
    RMSNorm and the mean over the S positions."""
    eps = cfg["rms_norm_eps"]
    h = w[f"{prefix}embed_tokens.weight"][ids].float()
    cos, sin = rope_cos_sin(cfg, ids.shape[1], ids.device)
    for layer in range(cfg["num_hidden_layers"]):
        p = layer_weights(w, f"{prefix}layers.{layer}.")
        h = h + attention(p, rms_norm(h, p["input_layernorm.weight"], eps), cfg, cos, sin)
        x = rms_norm(h, p["post_attention_layernorm.weight"], eps)
        if layer < cfg["first_k_dense_replace"]:
            h = h + gated_mlp(x, p["mlp.gate_proj.weight"], p["mlp.up_proj.weight"],
                              p["mlp.down_proj.weight"])
        else:
            h = h + moe(p, x, cfg)
        del p
    return rms_norm(h, w[f"{prefix}norm.weight"].float(), eps).mean(dim=1)

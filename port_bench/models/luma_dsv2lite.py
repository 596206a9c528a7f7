"""LUMA with DeepSeek-V2-Lite as its text tower: the port's ``dmvae_cml`` over the Audio
encoder, ``TowerTextEncoder`` and the Image encoder, its FLOPs from the published
widths, and the expert kernel's least time a request.

The tower's keys are the configuration's top-level keys (the published
``config.json``'s, ``torch_dtype`` bfloat16). Its weights are drawn here
per tensor, in bf16 on the card from the run's generator, one layer at a
time (never as one float32 buffer: 15.5 B parameters are 62 GB in float32):
N(0, 0.02) for every product's weight and the embedding but the gate's,
N(0, 0.06) for the gate's (its logits at about 2.7 standard deviations, so
that a token's top-6 weights sum to about 0.82 and the routed experts
carry about 35 % of a MoE layer's output by norm, as a trained router
concentrates its weight on the experts it picks; at N(0, 0.02) they sum to
0.33 and the routed part is 10.5 %: PERF.md), U(0.8, 1.2) for the norm
scales so that the check covers them. The rest of the model
(``port.params``: the audio and image encoders, the tower's MLP head, the
DMVAE and the heads) is drawn as the LUMA cell draws it.

``build`` makes the port's model with ``core.tasks.build_dmvae_task`` (the
tower made on the card), loads the rest with ``load_state_dict(strict)``,
then hands it the tower's tensors layer by layer with
``load_state_dict(assign=True)``: the port holds the drawn tensors
themselves, no copy, and each of its own initial tensors goes as its
replacement comes, so the card holds one tower and a layer.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

from port_bench import port
from port_bench.bounds import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, conv3x3_flops, dense_flops

TOWER = "TowerTextEncoder"
params = port.params
WEIGHT_STD = 0.02            # the family's initializer_range
GATE_STD = 0.06              # the MoE gates' (see the module)
NORM_SCALES = (0.8, 1.2)


def tower_index(cfg) -> int:
    return [e["name"] for e in cfg["encoders"]].index(TOWER)


def tower_prefix(cfg) -> str:
    return f"{port.BACKBONE}feat_encs.{tower_index(cfg)}.tower."


def positions(cfg) -> int:
    """Tokens a row: the text view's width."""
    return cfg["views"][tower_index(cfg)]


def tower_shapes(cfg) -> List[Tuple[str, tuple]]:
    """(name under the tower, shape) of every tower parameter, by layer."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                           cfg["kv_lora_rank"])
    e, width = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    shared = width * cfg["n_shared_experts"]
    out = [("embed_tokens.weight", (cfg["vocab_size"], h))]
    for layer in range(cfg["num_hidden_layers"]):
        p = f"layers.{layer}."
        out += [(p + "input_layernorm.weight", (h,)),
                (p + "self_attn.q_proj.weight", (heads * (nope + rope), h)),
                (p + "self_attn.kv_a_proj_with_mqa.weight", (rank + rope, h)),
                (p + "self_attn.kv_a_layernorm.weight", (rank,)),
                (p + "self_attn.kv_b_proj.weight", (heads * (nope + v), rank)),
                (p + "self_attn.o_proj.weight", (h, heads * v)),
                (p + "post_attention_layernorm.weight", (h,))]
        if layer < cfg["first_k_dense_replace"]:
            mlp = [("mlp.", cfg["intermediate_size"])]
        else:
            out += [(p + "mlp.gate.weight", (e, h)),
                    (p + "mlp.experts.gate_proj", (e, width, h)),
                    (p + "mlp.experts.up_proj", (e, width, h)),
                    (p + "mlp.experts.down_proj", (e, h, width))]
            mlp = [("mlp.shared_experts.", shared)]
        for sub, w in mlp:
            out += [(p + sub + "gate_proj.weight", (w, h)), (p + sub + "up_proj.weight", (w, h)),
                    (p + sub + "down_proj.weight", (h, w))]
    return out + [("norm.weight", (h,))]


def tower_weights(cfg, generator: torch.Generator) -> Iterator[Dict[str, torch.Tensor]]:
    """The tower's weights, one dict a layer (the embedding first on its
    own, the final norm with the last layer), each tensor drawn in the
    configuration's ``torch_dtype`` on the generator's device."""
    dtype = getattr(torch, cfg["torch_dtype"])
    prefix, batch, current = tower_prefix(cfg), {}, None
    for name, shape in tower_shapes(cfg):
        layer = name.split(".")[1] if name.startswith("layers.") else current
        if batch and layer != current:
            yield batch
            batch = {}
        current = layer
        t = torch.empty(shape, dtype=dtype, device=generator.device)
        if name.endswith("norm.weight"):
            t.uniform_(*NORM_SCALES, generator=generator)
        else:
            std = GATE_STD if name.endswith("mlp.gate.weight") else WEIGHT_STD
            t.normal_(0.0, std, generator=generator)
        batch[prefix + name] = t
    yield batch


def _encoder_specs(cfg):
    specs = []
    for enc in cfg["encoders"]:
        kw = dict(output_dim=enc["widths"][-1], dropout=enc["dropout"])
        if enc["name"] == TOWER:
            kw.update(config=cfg, dtype=cfg["torch_dtype"])
        elif enc["name"] == "AudioEncoder":
            kw.update(input_dim=enc["widths"][0], use_2d=False)
        specs.append((enc["name"], kw))
    return tuple(specs)


def build(cfg, model: str, weights, device, generator: torch.Generator):
    """The port's inference function for ``model``, holding ``weights`` (the
    rest of the model) and the tower's tensors from ``generator``, which are
    added to ``weights`` for the reference."""
    from disentagled_multimodal_fusion_tpu_torch.core import tasks
    from disentagled_multimodal_fusion_tpu_torch.core.serve import build_inference_fn
    from disentagled_multimodal_fusion_tpu_torch.models import layers

    if model != "dmvae_cml":
        raise ValueError(f"model {model!r}: this configuration serves dmvae_cml")
    if TOWER not in layers.ENCODER_REGISTRY:
        raise RuntimeError(f"this port has no {TOWER}: it cannot serve this configuration")
    d = cfg["dmvae"]
    backbone = tasks.build_dmvae_task(
        output_dim=port.embed_dims(cfg), hidden_dim=d["hidden_dim"], embed_dim=d["embed_dim"],
        poe_temperature=d["poe_temperature"], fused_modalities=True,
        feature_encoders=_encoder_specs(cfg), device=device)
    prefix = tower_prefix(cfg)[len(port.BACKBONE):]
    rest = {k[len(port.BACKBONE):]: v for k, v in weights.items()
            if k.startswith(port.BACKBONE)}
    missing, unexpected = backbone.load_state_dict(rest, strict=False)
    if unexpected or any(not k.startswith(prefix) for k in missing):
        raise KeyError(f"weights and the port's backbone differ: missing "
                       f"{[k for k in missing if not k.startswith(prefix)]}, "
                       f"unexpected {unexpected}")
    assigned = set()
    for layer in tower_weights(cfg, generator):
        weights.update(layer)
        own = {k[len(port.BACKBONE):]: v for k, v in layer.items()}
        backbone.load_state_dict(own, strict=False, assign=True)
        assigned |= set(own)
    if assigned != set(missing):
        raise KeyError(f"the tower's weights and the port's differ: "
                       f"{sorted(assigned ^ set(missing))[:5]}")
    hid = (cfg["probes"]["hidden_dim"],)
    task = tasks.build_probe_task(num_modalities=len(cfg["encoders"]),
                                  num_classes=cfg["num_classes"], input_dim=d["embed_dim"],
                                  hidden_dim=hid, aggregation="cml", device=device)
    port._load(task.model, weights, port.HEADS)
    return build_inference_fn(task, backbone=backbone)


def head_views(cfg, model):
    """The head kernel's input width of each head."""
    return [cfg["dmvae"]["embed_dim"]] * (len(cfg["encoders"]) + 1)


def tower_flops_per_token(cfg) -> int:
    """The tower's products a token at ``positions`` tokens a row: the
    projections, attention's two products over all positions (the causal
    half included, as the unfused products compute it), the dense layer,
    each MoE layer's gate, its k routed experts and its shared experts."""
    h, heads, s = cfg["hidden_size"], cfg["num_attention_heads"], positions(cfg)
    nope, rope, v, rank = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                           cfg["kv_lora_rank"])
    proj = 2 * (h * heads * (nope + rope) + h * (rank + rope) + rank * heads * (nope + v)
                + heads * v * h)
    attn = 2 * heads * s * (nope + rope + v)
    dense = 2 * 3 * h * cfg["intermediate_size"]
    width = cfg["moe_intermediate_size"]
    moe = (2 * h * cfg["n_routed_experts"]
           + 2 * 3 * h * width * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]))
    n_dense = cfg["first_k_dense_replace"]
    return (cfg["num_hidden_layers"] * (proj + attn) + n_dense * dense
            + (cfg["num_hidden_layers"] - n_dense) * moe)


def encoder_flops(cfg, enc) -> int:
    if enc["name"] == TOWER:
        return tower_flops_per_token(cfg) * positions(cfg) + dense_flops(enc["widths"])
    flops = dense_flops(enc["widths"])
    if "channels" in enc:
        ch, side = enc["channels"], enc["image_side"]
        for a, b in zip(ch[:-1], ch[1:]):
            flops += conv3x3_flops(a, b, side, side)
            side //= 2
    return flops


def flops_per_row(cfg, model):
    hid, c = cfg["probes"]["hidden_dim"], cfg["num_classes"]
    h, e = cfg["dmvae"]["hidden_dim"], cfg["dmvae"]["embed_dim"]
    return (sum(encoder_flops(cfg, enc) for enc in cfg["encoders"])
            + sum(dense_flops([enc["widths"][-1], h, h, 4 * e]) for enc in cfg["encoders"])
            + sum(dense_flops([d, hid, c]) for d in head_views(cfg, model)))


def expert_work(cfg, rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the expert kernel's two launches in every MoE
    layer for ``rows`` rows: T = rows x positions tokens, M = T k routed
    rows; the gate, up and down products of the routed rows (the shared
    experts are not the kernel's), and in bf16 each expert's three weights,
    the T token rows, the M gated rows once, the M float32 routing weights
    and the M float32 weighted rows written once."""
    h, width, e, k = (cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"],
                      cfg["num_experts_per_tok"])
    t = rows * positions(cfg)
    m = t * k
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    flops = 2.0 * m * 3 * h * width
    nbytes = 2.0 * 3 * e * h * width + 2.0 * t * h + 2.0 * m * width + 4.0 * m + 4.0 * m * h
    return layers * flops, layers * nbytes


def expert_bound_s(cfg, rows: int) -> Tuple[float, str]:
    """(seconds, 'operations' | 'bytes'): the larger of the expert kernel's
    FLOPs over 989 TFLOP/s (bf16) and its bytes over 3.35 TB/s."""
    flops, nbytes = expert_work(cfg, rows)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


"""The system under test: the port's inference function, built from the benchmark's weights.

``models/<config>.py`` files build through these helpers. The port's task
builders make the modules (they draw their own initial weights on the
host, from a fixed seed, which the benchmark then replaces), and
``load_state_dict(strict=True)`` loads the benchmark's weights into them,
so a parameter the benchmark does not draw, or one of another shape, stops
the run. The function served is ``core.serve.build_inference_fn(task,
backbone=...)``, whose ``module`` is the port's ``InferenceModule``.

The weight names are the port's state-dict names under ``backbone.`` (the
FusedDMVAE with its feature encoders) and ``heads.`` (the stacked heads).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from . import weights as W

BACKBONE, HEADS = "backbone.", "heads."


def encoder_params(encoders: Optional[Sequence[dict]]) -> List[W.Param]:
    """The feature encoders' parameters, from their published widths: an
    MLP encoder's ``widths`` (in, hidden..., out); the image encoder's conv
    ``channels`` (each block conv 3 x 3, BatchNorm, ReLU, 2 x 2 max-pool)
    and then its dense ``widths``."""
    out = []
    for i, enc in enumerate(encoders or ()):
        prefix = f"{BACKBONE}feat_encs.{i}."
        if "channels" in enc:
            ch = enc["channels"]
            for j, (a, b) in enumerate(zip(ch[:-1], ch[1:])):
                out += W.conv3x3(f"{prefix}blocks.conv.{j}.", a, b)
            for j, b in enumerate(ch[1:]):
                out += W.batch_norm(f"{prefix}blocks.bn.{j}.", b)
        widths = enc["widths"]
        for j, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            out += W.linear(f"{prefix}layers.{j}.", a, b)
    return out


def embed_dims(cfg) -> List[int]:
    """The widths the DMVAE reads: the encoders' outputs, else the views."""
    encoders = cfg.get("encoders")
    return [e["widths"][-1] for e in encoders] if encoders else list(cfg["views"])


def params(cfg, model: str) -> List[W.Param]:
    """Every parameter of ``model`` (``dmvae_cml``: FusedDMVAE and 1 + N
    stacked probe heads; ``cml_fusion``: N stacked heads on the views)."""
    hid, c = cfg["probes"]["hidden_dim"], cfg["num_classes"]
    if model == "cml_fusion" and not cfg.get("encoders"):
        return W.stacked_mlp(f"{HEADS}stack.", cfg["views"], [hid, c])
    if model != "dmvae_cml":
        raise ValueError(f"model {model!r}: this harness builds dmvae_cml, and cml_fusion "
                         f"without encoders")
    dims, d = embed_dims(cfg), cfg["dmvae"]
    h, e = d["hidden_dim"], d["embed_dim"]
    return (encoder_params(cfg.get("encoders"))
            + W.stacked_mlp(f"{BACKBONE}encoder.", dims, [h, h, 4 * e])
            + W.stacked_mlp(f"{BACKBONE}decoder.", [2 * e] * len(dims), [h, h, max(dims)])
            + W.stacked_mlp(f"{HEADS}stack.", [e] * (len(dims) + 1), [hid, c]))


def _load(module, weights, prefix: str) -> None:
    module.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                            if k.startswith(prefix)}, strict=True)


def _encoder_specs(encoders):
    """The port's encoder specs (registry name, keyword arguments)."""
    if not encoders:
        return None
    specs = []
    for enc in encoders:
        kw = dict(output_dim=enc["widths"][-1], dropout=enc["dropout"])
        if enc["name"] != "ImageEncoder":
            kw["input_dim"] = enc["widths"][0]
        if enc["name"] == "AudioEncoder":
            kw["use_2d"] = False
        specs.append((enc["name"], kw))
    return tuple(specs)


def build(cfg, model: str, weights, device):
    """The port's inference function for ``model`` on ``device``, holding
    ``weights``."""
    from disentagled_multimodal_fusion_tpu_torch.core import tasks
    from disentagled_multimodal_fusion_tpu_torch.core.serve import build_inference_fn

    hid, c = (cfg["probes"]["hidden_dim"],), cfg["num_classes"]
    if model == "cml_fusion":
        task = tasks.build_late_fusion_task(output_dims=cfg["views"], num_classes=c,
                                            hidden_dim=hid, aggregation="cml", device=device)
        _load(task.model, weights, HEADS)
        return build_inference_fn(task)
    dims, d = embed_dims(cfg), cfg["dmvae"]
    backbone = tasks.build_dmvae_task(
        output_dim=dims, hidden_dim=d["hidden_dim"], embed_dim=d["embed_dim"],
        poe_temperature=d["poe_temperature"], fused_modalities=True,
        feature_encoders=_encoder_specs(cfg.get("encoders")), device=device)
    _load(backbone, weights, BACKBONE)
    task = tasks.build_probe_task(num_modalities=len(dims), num_classes=c,
                                  input_dim=d["embed_dim"], hidden_dim=hid, aggregation="cml",
                                  device=device)
    _load(task.model, weights, HEADS)
    return build_inference_fn(task, backbone=backbone)

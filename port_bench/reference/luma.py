"""The plain reference of the LUMA cell: the Audio and Text MLP encoders, the
Image encoder (three blocks of 3 x 3 convolution, BatchNorm on its running
statistics, ReLU and 2 x 2 max-pool, the (128, 4, 4) map flattened in
height, width, channel order, then 2048 -> 512 -> 200), the DMVAE's PoE and
private means over the three encodings, and 1 + 3 heads fused by summing
their evidence."""

import torch
import torch.nn.functional as F

from port_bench.reference import plain

BN_EPS = 1e-5


def _dense(x, w, prefix, layers):
    for j in range(layers):
        x = F.linear(x, w[f"{prefix}layers.{j}.weight"], w[f"{prefix}layers.{j}.bias"])
        if j < layers - 1:
            x = torch.relu(x)
    return x


def encode(enc, w, prefix, x):
    if "channels" in enc:
        side = enc["image_side"]
        x = x.reshape(x.shape[0], enc["channels"][0], side, side)
        for j in range(len(enc["channels"]) - 1):
            x = F.conv2d(x, w[f"{prefix}blocks.conv.{j}.weight"],
                         w[f"{prefix}blocks.conv.{j}.bias"], padding=1)
            bn = f"{prefix}blocks.bn.{j}."
            scale = w[f"{bn}weight"] / torch.sqrt(w[f"{bn}var"] + BN_EPS)
            x = (x - w[f"{bn}mean"][:, None, None]) * scale[:, None, None] \
                + w[f"{bn}bias"][:, None, None]
            x = F.max_pool2d(torch.relu(x), 2)
        x = x.permute(0, 2, 3, 1).flatten(1)
    return _dense(x, w, prefix, len(enc["widths"]) - 1)


@torch.inference_mode()
def forward(cfg, model, w, xs, tf32=False):
    with plain.precision(tf32):
        feats = [encode(enc, w, f"backbone.feat_encs.{i}.", x)
                 for i, (enc, x) in enumerate(zip(cfg["encoders"], xs))]
        d = cfg["dmvae"]
        z_c, z_p = plain.dmvae_embedding(w, "backbone.encoder.", feats, d["embed_dim"],
                                         d["poe_temperature"])
        return plain.outputs(plain.heads(w, "heads.stack.", [z_c, *z_p]), cfg["num_classes"])

"""LUMA: the port's ``dmvae_cml`` over the FusedDMVAE and its Audio, Text and Image
encoders, and its FLOPs counted from the published widths.

A row: the audio MLP 40 -> 128 -> 256 -> 200, the text MLP 128 -> 256 ->
256 -> 200, the image encoder's three 3 x 3 convolutions (3 -> 32 at 32 x
32, 32 -> 64 at 16 x 16, 64 -> 128 at 8 x 8, each map halved by its
max-pool) and its dense 2048 -> 512 -> 200, the DMVAE encoder (per view 200
-> 512 -> 512 -> 800) and 1 + 3 heads 200 -> 128 -> 42. Only products and
convolutions count: BatchNorm, ReLU, pooling, the PoE, the evidence and the
uncertainties are elementwise passes.
"""

from port_bench import port
from port_bench.bounds import conv3x3_flops, dense_flops

params = port.params
build = port.build


def head_views(cfg, model):
    """The head kernel's input width of each head."""
    return [cfg["dmvae"]["embed_dim"]] * (len(cfg["encoders"]) + 1)


def encoder_flops(enc):
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
    return (sum(encoder_flops(enc) for enc in cfg["encoders"])
            + sum(dense_flops([enc["widths"][-1], h, h, 4 * e]) for enc in cfg["encoders"])
            + sum(dense_flops([d, hid, c]) for d in head_views(cfg, model)))

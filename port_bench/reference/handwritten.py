"""The plain reference of the HandWritten cells: ``dmvae_cml`` (the DMVAE's
PoE and private means, then 1 + 6 heads) and ``cml_fusion`` (six heads on
the raw views), both fused by summing the heads' evidence."""

import torch

from port_bench.reference import plain


@torch.inference_mode()
def forward(cfg, model, w, xs, tf32=False):
    with plain.precision(tf32):
        if model == "cml_fusion":
            ev = plain.heads(w, "heads.stack.", xs)
        else:
            d = cfg["dmvae"]
            z_c, z_p = plain.dmvae_embedding(w, "backbone.encoder.", xs, d["embed_dim"],
                                             d["poe_temperature"])
            ev = plain.heads(w, "heads.stack.", [z_c, *z_p])
        return plain.outputs(ev, cfg["num_classes"])

"""HandWritten (BASELINE config #1): the port's ``dmvae_cml`` over the FusedDMVAE, or
``cml_fusion`` on the raw views, and their FLOPs counted from the published widths.

A row of ``dmvae_cml`` is the DMVAE encoder (per view: d -> 512 -> 512 ->
800, the four 200-wide statistics) and 1 + 6 heads 200 -> 128 -> 10; the
decoder does not run when scoring. A row of ``cml_fusion`` is six heads d
-> 128 -> 10 on the views. Only the products count: the PoE, the evidence
and the uncertainties are a few elementwise passes.
"""

from port_bench import port
from port_bench.bounds import dense_flops

params = port.params
build = port.build


def head_views(cfg, model):
    """The head kernel's input width of each head, as published (unpadded)."""
    if model == "cml_fusion":
        return list(cfg["views"])
    return [cfg["dmvae"]["embed_dim"]] * (len(cfg["views"]) + 1)


def flops_per_row(cfg, model):
    hid, c = cfg["probes"]["hidden_dim"], cfg["num_classes"]
    heads = sum(dense_flops([d, hid, c]) for d in head_views(cfg, model))
    if model == "cml_fusion":
        return heads
    h, e = cfg["dmvae"]["hidden_dim"], cfg["dmvae"]["embed_dim"]
    return heads + sum(dense_flops([d, h, h, 4 * e]) for d in cfg["views"])

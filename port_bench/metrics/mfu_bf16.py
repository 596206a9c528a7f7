"""The whole request's share of the card's bf16 peak: the model FLOPs of the
rows scored in the untraced half of a traced run's window (from the
published widths, forward only) over that half's seconds times 989 TFLOP/s,
the tensor cores' dense bf16 rate. For a cell whose work is a bf16 tower
(``luma_dsv2lite``): its float32 parts, the audio and image encoders, the
tower's MLP head, the DMVAE and the heads, are under 0.1 % of the FLOPs,
counted here against the same peak. Nothing where the loop gave no
``flops_per_row``."""

from port_bench.bounds import PEAK_BF16_FLOPS


def read(r):
    if r.rows == 0 or r.window_s <= 0 or not getattr(r, "flops_per_row", 0):
        return None
    return 100.0 * r.flops_per_row * r.rows / r.window_s / PEAK_BF16_FLOPS

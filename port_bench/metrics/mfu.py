"""The whole request's share of the card's float32 peak: the model FLOPs of
the rows scored in the untraced half of a traced run's window (from the
published widths, forward only) over that half's seconds times 67
TFLOP/s, the peak outside the tensor cores (the port keeps TF32 off)."""

from port_bench.bounds import PEAK_F32_FLOPS


def read(r):
    if r.rows == 0 or r.window_s <= 0:
        return None
    return 100.0 * r.flops_per_row * r.rows / r.window_s / PEAK_F32_FLOPS

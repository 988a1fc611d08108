"""The whole solve's share of the card's float32 peak: the least work of
the solves the traced window ran, at the published 67 TFLOP/s, over the
window's wall time."""

from benchmark.roofline import PEAK_F32_FLOPS, solve_flops


def read(trace):
    if not trace.units or trace.window_s <= 0:
        return None
    return 100.0 * solve_flops(trace.info["cfg"]) * trace.units / PEAK_F32_FLOPS / trace.window_s

"""The PDIPM kernels' share of their roofline: the least work of a solve at
the published float32 peak, over their device time a solve. Bound by
operations: a solve's ~32 MB at 3.35 TB/s takes a fortieth of its least
work's time at 67 TFLOP/s."""

from benchmark.layers import device_ms, is_pdipm
from benchmark.roofline import PEAK_F32_FLOPS, solve_flops


def read(trace):
    ms = device_ms(trace, is_pdipm)
    if ms is None:
        return None
    return 100.0 * solve_flops(trace.info["cfg"]) / PEAK_F32_FLOPS / (ms * 1e-3)

"""The hybrid's condensed kernel's share of its roofline: the least work of a
solve of every env (`roofline.solve_flops`) at the published float32 peak,
over K2's device time a solve (`hybrid_condensed_ms.solve`). Bound by
operations, as `pdipm_roofline_pct.solve` is."""

from benchmark.phases import kernel_ms
from benchmark.roofline import PEAK_F32_FLOPS, solve_flops


def read(trace):
    ms = kernel_ms(trace, "hybrid_condensed")
    if ms is None:
        return None
    return 100.0 * solve_flops(trace.info["cfg"]) / PEAK_F32_FLOPS / (ms * 1e-3)

"""The hybrid's re-solve kernel's share of its roofline: the least work of a
solve of the budget's envs (`roofline_hybrid.resolve_flops`) at the
published float32 peak, over K1's device time in the re-solve a solve
(`hybrid_resolve_ms.solve`). None where the phase is not marked or the
loop states no budget."""

from benchmark.phases import kernel_ms
from benchmark.roofline import PEAK_F32_FLOPS
from benchmark.roofline_hybrid import resolve_flops


def read(trace):
    ms = kernel_ms(trace, "hybrid_resolve")
    if ms is None or "budget" not in trace.info:
        return None
    return (100.0 * resolve_flops(trace.info["cfg"], trace.info["budget"]) / PEAK_F32_FLOPS
            / (ms * 1e-3))

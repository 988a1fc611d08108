"""Device ms a solve of the hybrid's condensed pass: the PDIPM kernel (K2,
every env) between the `hybrid_condensed` mark and the next. None where the
program marks no such phase."""

from benchmark.phases import kernel_ms


def read(trace):
    return kernel_ms(trace, "hybrid_condensed")

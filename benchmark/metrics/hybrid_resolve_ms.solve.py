"""Device ms a solve of the hybrid's re-solve: the PDIPM kernel (K1, the
budget's envs) between the `hybrid_resolve` mark and the next. None where
the program marks no such phase."""

from benchmark.phases import kernel_ms


def read(trace):
    return kernel_ms(trace, "hybrid_resolve")

"""Device operations a closed-loop cycle outside the PDIPM kernel."""

from benchmark.layers import count, is_pdipm


def read(trace):
    return count(trace, lambda n: not is_pdipm(n))

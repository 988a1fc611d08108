"""Mean ms of the period's run_mpc between CUDA events around the call."""

from benchmark.layers import mean_span_ms


def read(trace):
    return mean_span_ms(trace, "run_mpc")

"""Mean ms of a tick without a solve (update_state, run_lowlevel, get_action)
between CUDA events before the first call and after the last."""

from benchmark.layers import mean_span_ms


def read(trace):
    return mean_span_ms(trace, "tick")

"""Share of the whole traced window in which no device operation ran."""

from benchmark.layers import idle_pct


def read(trace):
    return idle_pct(trace)

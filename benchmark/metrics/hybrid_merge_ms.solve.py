"""Device ms a solve of the hybrid's merge, every operation between the
`hybrid_merge` mark and the next: each result field's merge and the
counters. None where the program marks no such phase."""

from benchmark.phases import phase_ms


def read(trace):
    return phase_ms(trace, "hybrid_merge")

"""Device ms a solve of the hybrid's rank pass, every operation between the
`hybrid_rank` mark and the next: the criterion, the finiteness test, the
sort and the gather of the worst envs' QPs. None where the program marks no
such phase."""

from benchmark.phases import phase_ms


def read(trace):
    return phase_ms(trace, "hybrid_rank")

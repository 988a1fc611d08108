"""Device ms a closed-loop cycle from an `assembly` mark to the next mark, the
PDIPM kernels left out (`pdipm_ms.rollout` has them): `run_mpc`'s QP
assembly and postprocess, once a cycle. The program marks where each phase
starts with an empty kernel `trace_mark_<phase>` (`utils/tracing.mark`,
captured into the cycle's graph); an operation belongs to the phase of the
last mark before it, and the marks themselves are not counted. None where
the program marks no such phase."""

import re

MARK = re.compile(r"trace_mark_([a-z]+)")
PHASES = ("assembly",)


def read(trace):
    phase, total, seen = None, 0.0, False
    for name, s, e in sorted(trace.device, key=lambda t: t[1]):
        m = MARK.search(name)
        if m:
            phase = m.group(1)
            seen = seen or phase in PHASES
        elif phase in PHASES and "pdipm_kernel" not in name:
            total += e - s
    return total * 1e-3 / trace.units if seen and trace.units else None

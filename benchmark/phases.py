"""What the readers of the program's phase marks share: each device
operation of a trace assigned to the phase of the last mark before it.

The program marks where a phase starts with an empty kernel
`trace_mark_<phase>` (`utils/tracing.mark`, captured into its graphs); an
operation belongs to the phase of the last mark before it in time, and the
marks themselves are not counted."""

from __future__ import annotations

import re

from benchmark.layers import is_pdipm

MARK = re.compile(r"trace_mark_([a-z_]+)")


def marked_ops(trace):
    """[(phase or None, name, start_us, end_us)] of the trace's device
    operations other than the marks, in time order, and the set of phases
    marked."""
    phase, ops, seen = None, [], set()
    for name, s, e in sorted(trace.device, key=lambda t: t[1]):
        m = MARK.search(name)
        if m:
            phase = m.group(1)
            seen.add(phase)
        else:
            ops.append((phase, name, s, e))
    return ops, seen


def phase_ms(trace, phase: str, pred=None) -> float | None:
    """Device ms a unit of the operations in `phase` (those whose names
    satisfy `pred`, where given), or None where no such phase is marked or
    nothing in it satisfies `pred`."""
    ops, seen = marked_ops(trace)
    if phase not in seen or not trace.units:
        return None
    durs = [e - s for p, name, s, e in ops if p == phase and (pred is None or pred(name))]
    if pred is not None and not durs:
        return None
    return sum(durs) * 1e-3 / trace.units


def kernel_ms(trace, phase: str) -> float | None:
    """Device ms a unit of the PDIPM kernels in `phase`, or None."""
    return phase_ms(trace, phase, is_pdipm)

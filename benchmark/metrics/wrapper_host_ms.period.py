"""Host ms a period inside the wrapper's calls: the union of the program's
`wrapper.*` spans (`utils/tracing.span`: one top-level span a public call of
`MPCController`, its `copy_in` / `copy_out` children inside it), a period
running from one `wrapper.set_command` span to the next; the median over the
window's periods, since the first launch of each call's graph under the
profiler stalls the host once. None where the program records no such
span."""

import bisect
import statistics


def read(trace):
    starts = sorted(s for name, s, _ in trace.host if name == "wrapper.set_command")
    if not starts:
        return None
    per, reach = [0.0] * len(starts), starts[0]
    for s, e in sorted((s, e) for name, s, e in trace.host if name.startswith("wrapper.")):
        s = max(s, reach)
        if e > s:
            per[bisect.bisect_right(starts, s) - 1] += e - s
            reach = e
    return statistics.median(per) * 1e-3

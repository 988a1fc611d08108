"""Device idle ms a closed-loop cycle inside the cycle's replay: from the
cycle's first phase mark (the first `trace_mark_<phase>` kernel after a
`carry` mark, or the window's first mark; `utils/tracing.mark`) to the last
device operation before the next cycle's first mark, less the time some
operation ran. The idle between one replay's end and the next one's start
is left out. The median over the window's cycles: the profiler stalls the
first replay's launch once (5-21 ms, CUPTI taking up the graph), and that
stall lands before the first cycle or inside it. None where the program
marks no phase."""

import re
import statistics

MARK = re.compile(r"trace_mark_([a-z]+)")


def read(trace):
    ops = sorted(trace.device, key=lambda t: t[1])
    starts, last = [], "carry"
    for i, (name, _, _) in enumerate(ops):
        m = MARK.search(name)
        if m:
            if last == "carry":
                starts.append(i)
            last = m.group(1)
    if not starts:
        return None
    idle = []
    for a, b in zip(starts, starts[1:] + [len(ops)]):
        busy, first, reach = 0.0, ops[a][1], ops[a][1]
        for _, s, e in ops[a:b]:
            s = max(s, reach)
            if e > s:
                busy += e - s
                reach = e
        idle.append(reach - first - busy)
    return statistics.median(idle) * 1e-3

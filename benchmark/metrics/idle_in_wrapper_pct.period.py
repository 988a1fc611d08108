"""Share of a period's device-idle time in gaps whose midpoint lies inside
one of the program's `wrapper.*` spans (a public call of `MPCController`);
the rest falls in the caller's code between the calls. A period runs from
one `wrapper.set_command` span to the next; the median over the window's
periods, since the first launch of each call's graph under the profiler
stalls the host once. None where the program records no such span."""

import bisect
import statistics


def read(trace):
    starts = sorted(s for name, s, _ in trace.host if name == "wrapper.set_command")
    if not starts:
        return None
    union = []  # disjoint [start, end] of the calls, in order
    for s, e in sorted((s, e) for name, s, e in trace.host if name.startswith("wrapper.")):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], e)
        else:
            union.append([s, e])
    first = [s for s, _ in union]
    idle, inside = [0.0] * len(starts), [0.0] * len(starts)
    for s, e in trace.gaps():
        mid = (s + e) / 2
        if mid < starts[0]:
            continue
        p = bisect.bisect_right(starts, mid) - 1
        idle[p] += e - s
        i = bisect.bisect_right(first, mid) - 1
        if i >= 0 and mid <= union[i][1]:
            inside[p] += e - s
    return statistics.median(100.0 * a / b if b > 0 else 0.0 for a, b in zip(inside, idle))

"""Host ms a period inside the program's `graph.replay` spans
(`utils/cuda_graph.LoopStep`: the host's side of launching a captured call's
CUDA graph), a period running from one `wrapper.set_command` span to the
next; the median over the window's periods, since the first launch of each
graph under the profiler stalls the host once. None where the program
records no such span."""

import bisect
import statistics


def read(trace):
    starts = sorted(s for name, s, _ in trace.host if name == "wrapper.set_command")
    if not starts:
        return None
    per = [0.0] * len(starts)
    for name, s, e in trace.host:
        if name == "graph.replay" and s >= starts[0]:
            per[bisect.bisect_right(starts, s) - 1] += e - s
    return statistics.median(per) * 1e-3

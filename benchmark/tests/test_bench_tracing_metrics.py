"""The readers of the program's own spans and phase marks on synthetic traces
with known host spans and device marks: the phase attribution (K1 left out
of the assembly), idle inside a replay against idle between replays, gaps
inside and outside the wrapper's calls, the median over periods and
cycles, and None where the program records neither (as a program without
the spans and marks would)."""

import pytest

from benchmark.common import Trace
from benchmark.run import read_metric

K1 = "void pdipm_kernel<RicAugLean<float>, WarpGroup<2> >(...)"
PHASE_METRICS = ("obs_ingest_ms.rollout", "qp_assembly_ms.rollout", "lowlevel_ms.rollout",
                 "plant_ms.rollout")
PERIOD_METRICS = ("wrapper_host_ms.period", "replay_host_ms.period",
                  "idle_in_wrapper_pct.period")


def _cycle(t0, inner_gap=0.0):
    """One cycle's device operations from t0 (us): two ticks, the first with
    the solve. Each mark takes 1 us; returns (ops, end, {phase: busy us})."""
    ops, t = [], t0
    busy = {"obs": 0.0, "ingest": 0.0, "assembly": 0.0, "k1": 0.0, "lowlevel": 0.0,
            "plant": 0.0, "carry": 0.0, "marks": 0.0}

    def mark(phase):
        nonlocal t
        ops.append((f"trace_mark_{phase}", t, t + 1.0))
        busy["marks"] += 1.0
        t += 1.0

    def op(name, dur, phase, gap=0.0):
        nonlocal t
        t += gap
        ops.append((name, t, t + dur))
        busy[phase] += dur
        t += dur

    for tick in range(2):
        mark("obs")
        op("elementwise_kernel", 3.0, "obs")
        op("CatArrayBatchedCopy", 2.0, "obs")
        mark("ingest")
        op("gemv", 4.0, "ingest")
        if tick == 0:
            mark("assembly")
            op("gemm", 6.0, "assembly")
            op(K1, 50.0, "k1", gap=inner_gap)
            op("Memcpy DtoD", 2.0, "assembly")
        mark("lowlevel")
        op("elementwise_kernel", 5.0, "lowlevel")
        mark("plant")
        op("elementwise_kernel", 7.0, "plant")
    mark("carry")
    op("index_copy", 1.5, "carry")
    op("Memcpy DtoD", 0.5, "carry")
    return ops, t, busy


def _rollout(cycles=2, inner_gap=0.0, between=100.0):
    ops, t, total = [("Memcpy DtoD", 0.0, 2.0)], 10.0, {}  # the episode's restart
    for _ in range(cycles):
        c, t, busy = _cycle(t, inner_gap)
        ops += c
        total = {k: total.get(k, 0.0) + v for k, v in busy.items()}
        t += between
    return Trace(device=ops, host=[], start=0.0, end=t, units=cycles), total


def test_each_phase_gets_the_operations_after_its_mark():
    tr, busy = _rollout()
    ms = lambda us: us * 1e-3 / 2
    assert read_metric("obs_ingest_ms.rollout", tr) == pytest.approx(
        ms(busy["obs"] + busy["ingest"]))
    assert read_metric("qp_assembly_ms.rollout", tr) == pytest.approx(ms(busy["assembly"]))
    assert read_metric("lowlevel_ms.rollout", tr) == pytest.approx(ms(busy["lowlevel"]))
    assert read_metric("plant_ms.rollout", tr) == pytest.approx(ms(busy["plant"]))
    # K1 lies in the assembly phase and is left out of it; pdipm_ms has it.
    assert read_metric("pdipm_ms.rollout", tr) == pytest.approx(ms(busy["k1"]))


def test_phases_carry_and_marks_sum_to_the_tick():
    tr, busy = _rollout()
    phases = sum(read_metric(m, tr) for m in PHASE_METRICS)
    rest = (busy["carry"] + busy["marks"] + 2.0) * 1e-3 / 2  # the restart's copy is no phase's
    assert phases + rest == pytest.approx(read_metric("tick_device_ms.rollout", tr))


def test_replay_idle_counts_gaps_inside_a_cycle_only():
    tight, _ = _rollout(inner_gap=0.0, between=100.0)
    assert read_metric("replay_idle_ms.rollout", tight) == pytest.approx(0.0)
    gappy, _ = _rollout(inner_gap=5.0, between=100.0)
    # 5 us inside each of 2 cycles, a cycle at a time; the 100 us between
    # the replays and the window's ends are not counted.
    assert read_metric("replay_idle_ms.rollout", gappy) == pytest.approx(5.0e-3)
    wide, _ = _rollout(inner_gap=5.0, between=1000.0)
    assert read_metric("replay_idle_ms.rollout", wide) == pytest.approx(5.0e-3)
    assert wide.idle_pct() > gappy.idle_pct()


def test_replay_idle_is_the_median_cycles():
    """A stall inside one cycle's replay (the profiler's first launch) is
    left out; idle inside most cycles is not."""
    tr, _ = _rollout(cycles=3, inner_gap=5.0)
    first = [i for i, op in enumerate(tr.device) if op[0] == K1][0]
    tr.device[first + 1:] = [(n, s + 500.0, e + 500.0) for n, s, e in tr.device[first + 1:]]
    tr.device[first] = (K1, tr.device[first][1] + 500.0, tr.device[first][2] + 500.0)
    assert read_metric("replay_idle_ms.rollout", tr) == pytest.approx(5.0e-3)


def _period(stall=True, periods=3):
    """Periods of 100 us, each three calls with their children and device
    work idle 10-20 (the caller's), 45-55 (inside `wrapper.update_state`)
    and 80-100 (the caller's, to the next period). With `stall` the first
    period's `update_state` replay runs to 88 and the call to 90, as the
    profiler's first launch of a graph does."""
    host, device = [("benchmark.window", 0.0, 100.0 * periods)], []
    for p in range(periods):
        t = 100.0 * p
        end = 90.0 if stall and p == 0 else 60.0
        host += [("wrapper.set_command", t, t + 5), ("wrapper.copy_in", t + 1, t + 2),
                 ("graph.replay", t + 2, t + 4),
                 ("wrapper.update_state", t + 30, t + end), ("wrapper.copy_in", t + 31, t + 35),
                 ("graph.replay", t + 36, t + end - 2), ("cudaGraphLaunch", t + 37, t + end - 3),
                 ("wrapper.get_action", t + 62, t + 75), ("graph.replay", t + 63, t + 70),
                 ("wrapper.copy_out", t + 71, t + 74)]
        device += [("k", t, t + 10), ("k", t + 20, t + 45), ("k", t + 55, t + 80)]
    return Trace(device=device, host=host, start=0.0, end=100.0 * periods, units=periods)


def test_host_time_inside_the_calls_and_the_replays():
    """The union of the calls' spans (the children lie inside their calls)
    and of the replays' a period, the median over the periods: the first
    period's stalled launch is left out."""
    tr = _period()
    assert read_metric("wrapper_host_ms.period", tr) == pytest.approx((5.0 + 30.0 + 13.0) * 1e-3)
    assert read_metric("replay_host_ms.period", tr) == pytest.approx((2.0 + 22.0 + 7.0) * 1e-3)
    one = _period(periods=1)  # the stalled period alone; get_action lies inside update_state
    assert read_metric("wrapper_host_ms.period", one) == pytest.approx((5.0 + 60.0) * 1e-3)
    assert read_metric("replay_host_ms.period", one) == pytest.approx((2.0 + 52.0 + 7.0) * 1e-3)


def test_idle_is_split_by_the_gaps_midpoints():
    # A period's idle: 10-20 (caller), 45-55 (midpoint 50, inside
    # update_state), 80-100 (caller): 10 of 40 us inside a call.
    assert _period(stall=False, periods=1).gaps() == [(10.0, 20.0), (45.0, 55.0), (80.0, 100.0)]
    assert read_metric("idle_in_wrapper_pct.period", _period()) == pytest.approx(25.0)
    # The stalled period alone: 80-100's midpoint lies inside update_state.
    assert read_metric("idle_in_wrapper_pct.period", _period(periods=1)) == pytest.approx(75.0)
    # A gap that starts inside a call but whose midpoint lies after it is
    # the caller's.
    tr = _period(stall=False, periods=1)
    late = Trace(device=[("k", 0.0, 10.0), ("k", 20.0, 58.0), ("k", 64.0, 100.0)], host=tr.host,
                 start=0.0, end=100.0, units=1)
    assert read_metric("idle_in_wrapper_pct.period", late) == pytest.approx(0.0)


def test_none_without_the_programs_spans_and_marks():
    """A trace of a program without them: the same device work, K1 and the
    benchmark's own window only."""
    tr, _ = _rollout()
    bare = Trace(device=[op for op in tr.device if not op[0].startswith("trace_mark_")],
                 host=[("benchmark.window", tr.start, tr.end), ("cudaGraphLaunch", 1.0, 2.0)],
                 start=tr.start, end=tr.end, units=tr.units)
    for name in PHASE_METRICS + ("replay_idle_ms.rollout",) + PERIOD_METRICS:
        assert read_metric(name, bare) is None, name
    assert read_metric("tick_device_ms.rollout", bare) is not None

"""The benchmark's arithmetic on known inputs: the least-work count of the
roofline, the idle share and gaps of a trace (its ends included), the
tail and the rates over the whole window."""

import statistics
import time

import numpy as np
import pytest
import torch

from benchmark.common import Reservoir, Trace, percentile, rate_window
from benchmark.roofline import newton_step_flops, solve_flops


def test_least_work_of_a_newton_step():
    assert newton_step_flops(10, 1) == 313_100
    cfg = {"horizon_length": 10, "solver_refine_steps": 1, "newton_iterations": 20,
           "num_envs": 4096}
    assert solve_flops(cfg) == pytest.approx(2.565e10, rel=1e-3)


def _trace(device, start=0.0, end=100.0, host=()):
    return Trace(device=list(device), host=list(host), start=start, end=end, units=1)


def test_idle_share_counts_the_gaps_at_both_ends():
    # Busy 10-30 and 25-50 (overlapping), 70-90: 60 of 100 us busy; the
    # idle gaps are 0-10 (the start), 50-70 and 90-100 (the end).
    tr = _trace([("k", 10, 30), ("k", 25, 50), ("c", 70, 90)])
    assert tr.busy_us() == 60
    assert tr.idle_pct() == pytest.approx(40.0)
    assert tr.gaps() == [(0.0, 10), (50, 70), (90, 100.0)]


def test_idle_share_clips_operations_to_the_window():
    tr = _trace([("k", -20, 10), ("k", 95, 130)])
    assert tr.busy_us() == 15
    assert tr.gaps() == [(10, 95)]


def test_breakdown_names_gaps_by_the_innermost_host_operation():
    host = [("benchmark.window", 0, 100), ("cudaGraphLaunch", 55, 65)]
    tr = _trace([("pdipm_kernel<A>", 10, 50), ("copy", 70, 100)], host=host)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "pdipm_kernel<A>"
    assert bd["device_ops"][0][1] == pytest.approx(40e-6)
    names = [g[0] for g in bd["idle_gaps"]]
    assert names == ["cudaGraphLaunch", "benchmark.window"]  # 50-70, then 0-10


def test_percentile_is_taken_over_every_value():
    rng = np.random.default_rng(1)
    values = list(rng.exponential(size=997))
    assert percentile(values, 95.0) == pytest.approx(float(np.percentile(values, 95.0)))
    # Not a median of chunks: a tail confined to one chunk still shows.
    values = [1.0] * 900 + [10.0] * 100
    assert percentile(values, 95.0) == 10.0
    assert statistics.median([percentile(values[i:i + 100], 95.0)
                              for i in range(0, 1000, 100)]) == 1.0


def test_rate_window_counts_all_work_over_all_the_time():
    done = []

    def issue(i):
        time.sleep(0.01 if i % 10 else 0.05)  # one slow unit in ten
        done.append(i)

    n, secs = rate_window(issue, 0.5, 4, torch.device("cpu"))
    assert n == len(done) and done == list(range(n))
    assert secs >= 0.5
    # The rate is every unit over the whole window, slow ones included.
    assert n / secs < 1 / 0.01


def test_reservoir_is_drawn_from_the_seed_and_uniform():
    def kept(seed, n=200, k=2):
        r, slots = Reservoir(k, seed), [None] * k
        for i in range(n):
            j = r.take(i)
            if j is not None:
                slots[j] = i
        return slots

    assert kept(5) == kept(5)
    hits = np.zeros(200)
    for seed in range(400):
        for i in kept(seed):
            hits[i] += 1
    assert hits[:100].sum() == pytest.approx(hits[100:].sum(), rel=0.2)

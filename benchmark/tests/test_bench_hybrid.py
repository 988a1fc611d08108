"""The hybrid cell (`hector_hybrid.solve`) on the CPU at 32 envs: a sound run
comes out correct; the bfloat16 control and the timed path broken
underneath (half the batch given the other half's mean, every answer a
quarter too large) come out not correct, and so does a solve that merges no
env, whether its counters are off the mode's rule or its mask is empty. A
merge that keeps the condensed answers (the re-solve discarded) raises the
merged envs' gap; at 32 envs, where the budget covers the batch, the plain
condensed route's answers stay under the limit set on the card (PERF.md
§2), so the test marked `cuda` holds the limit to that fault at the cell's
own size. Then the seven readers of the hybrid's phase marks and counters
on a synthetic trace, and None where a program marks no hybrid phase."""

import dataclasses
import math

import pytest
import torch

import benchmark.run as bench_run
from benchmark import control
from benchmark.common import Trace, load_json
from benchmark.roofline import PEAK_F32_FLOPS, newton_step_flops, solve_flops
from benchmark.roofline_hybrid import resolve_flops
from benchmark.run import read_metric

from test_bench_faults import _altered_answer, _half_batch

CELL = "hector_hybrid.solve"
SEED = 2 ** 33 + 7  # wider than 32 bits: a run's seed may be


@pytest.fixture
def small(monkeypatch):
    """The cell at 32 envs: its budget of max(64, B // 32) covers the batch."""
    torch.set_num_threads(1)  # a batched CPU LU under several threads can stall
    spec = bench_run.cell_spec

    def small_spec(name):
        cell, cfg, mix, limits, layers = spec(name)
        return cell, dict(cfg, num_envs=32), mix, limits, layers

    monkeypatch.setattr(bench_run, "cell_spec", small_spec)


def run():
    return bench_run.run(CELL, SEED, 0.3, False, device=torch.device("cpu"))


def test_a_sound_run_is_correct(small):
    out = run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["dropped_nonfinite_envs"]["value"] == 0
    assert list(out["metrics"]) == ["qp_units_per_s", "setup_s"]


def _resolve_discarded(monkeypatch):
    """The re-solve runs the condensed route again, so every merged env keeps
    the condensed answer."""
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    hybrid = pdipm_cuda.solve_hybrid
    monkeypatch.setattr(pdipm_cuda, "solve_hybrid",
                        lambda qp, opts, **kw: hybrid(qp, opts, aug_opts=opts, **kw))


def _need_all_false(monkeypatch):
    """No ranked env takes the re-solve's answer: the condensed result comes
    back with no env resolved and an empty mask, beside honest flagged
    counts."""
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    hybrid = pdipm_cuda.solve_hybrid

    def unmerged(qp, opts, **kw):
        _, stats = hybrid(qp, opts, **kw)
        return pdipm_cuda.solve(qp, opts), dataclasses.replace(
            stats, resolved=torch.zeros_like(stats.resolved), merged=torch.zeros_like(stats.merged))

    monkeypatch.setattr(pdipm_cuda, "solve_hybrid", unmerged)


def _nothing_flagged(monkeypatch):
    """A tolerance no finite criterion passes: nothing is flagged, resolved or
    merged, and the counters keep the mode's rule among themselves."""
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    hybrid = pdipm_cuda.solve_hybrid
    monkeypatch.setattr(pdipm_cuda, "solve_hybrid",
                        lambda qp, opts, **kw: hybrid(qp, opts, **dict(kw, flag_tol=math.inf)))


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer], ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(small, fault, monkeypatch):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_need_all_false, _nothing_flagged], ids=lambda f: f.__name__)
def test_a_solve_that_merges_nothing_is_not_correct(small, fault, monkeypatch):
    """Every env of this traffic is flagged, so a sound solve merges its whole
    budget. Reporting no env resolved beside flagged ones is off the rule;
    merging none at all leaves the merged gap nothing to read, which fails."""
    sound = run()["checks"]
    assert sound["off_rule_solves"]["value"] == 0
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]
    checks = out["checks"]
    assert checks["wrench_gap_merged_p75_N"]["value"] == math.inf
    assert (checks["off_rule_solves"]["value"] > 0) == (fault is _need_all_false)


def test_the_resolve_discarded_raises_the_merged_gap(small, monkeypatch):
    """At 32 envs the merged envs are the whole batch, so the discarded
    re-solve reads the condensed route's gap there (0.20-1.0 N over six
    draws on the CPU) against the augmented route's (0.014-0.030 N)."""
    sound = run()["checks"]["wrench_gap_merged_p75_N"]["value"]
    _resolve_discarded(monkeypatch)
    discarded = run()["checks"]["wrench_gap_merged_p75_N"]["value"]
    assert discarded > 5 * sound


def test_the_bfloat16_control_is_not_correct(small):
    limits = load_json(f"benchmark/limits/{CELL}.json")
    rows = list(control.readings(CELL, [], [SEED], 0.3, "bfloat16", torch.device("cpu")))
    failed = [k for k, v in rows[0]["checks"].items() if v > limits.get(k, 0.0)]
    assert failed, rows[0]


K2 = "void pdipm_kernel<RicLean<float>, WarpGroup<1> >(...)"
K1 = "void pdipm_kernel<RicAugLean<float>, WarpGroup<2> >(...)"
CFG = {"horizon_length": 10, "solver_refine_steps": 1, "newton_iterations": 20, "num_envs": 4096}
INFO = {"cfg": CFG, "batch": 4096, "budget": 128,
        "hybrid": {"flagged": 3891.5, "nonfinite": 0.0, "resolved": 128.0,
                   "dropped_nonfinite": 0.0}}
# Device us of one solve by phase: the assembly's operations before the
# hybrid's first mark, then each hybrid phase's operations, then the
# postprocess after `hybrid_done`.
SOLVE = [("assembly", "gemm", 90.0), ("assembly", "elementwise_kernel", 400.0),
         ("hybrid_condensed", K2, 8700.0),
         ("hybrid_rank", "reduce_kernel", 40.0), ("hybrid_rank", "radixSortKVInPlace", 150.0),
         ("hybrid_rank", "index_elementwise_kernel", 60.0),
         ("hybrid_resolve", K1, 2800.0),
         ("hybrid_merge", "index_copy_kernel", 120.0), ("hybrid_merge", "where_kernel", 80.0),
         ("hybrid_done", "elementwise_kernel", 30.0)]


def _trace(solves=2, marks=True, info=INFO):
    ops, t = [], 0.0
    for _ in range(solves):
        phase = None
        for p, name, dur in SOLVE:
            if marks and p != phase:
                ops.append((f"trace_mark_{p}", t, t + 1.0))
                t += 1.0
            phase = p
            ops.append((name, t, t + dur))
            t += dur + 2.0
        t += 50.0
    return Trace(device=ops, host=[], start=0.0, end=t, units=solves, info=dict(info))


def _ms(phase):
    return sum(d for p, _, d in SOLVE if p == phase) * 1e-3


def test_the_readers_take_each_phase_after_its_mark():
    tr = _trace()
    assert read_metric("hybrid_condensed_ms.solve", tr) == pytest.approx(8.7)
    assert read_metric("hybrid_rank_ms.solve", tr) == pytest.approx(_ms("hybrid_rank"))
    assert read_metric("hybrid_resolve_ms.solve", tr) == pytest.approx(2.8)
    assert read_metric("hybrid_merge_ms.solve", tr) == pytest.approx(_ms("hybrid_merge"))
    assert read_metric("hybrid_flagged_pct.solve", tr) == pytest.approx(100 * 3891.5 / 4096)
    # The whole solve's PDIPM time is both kernels, as `pdipm_ms.solve` reads it.
    assert read_metric("pdipm_ms.solve", tr) == pytest.approx(8.7 + 2.8)


def test_the_rooflines_are_the_least_work_over_each_kernel():
    tr = _trace()
    k2 = read_metric("hybrid_condensed_roofline_pct.solve", tr)
    assert k2 == pytest.approx(100 * solve_flops(CFG) / PEAK_F32_FLOPS / 8.7e-3)
    assert k2 == pytest.approx(4.40, abs=0.01)  # 2.565e10 flops at 67 TFLOP/s in 8.7 ms
    k1 = read_metric("hybrid_resolve_roofline_pct.solve", tr)
    assert resolve_flops(CFG, 128) == newton_step_flops(10, 1) * 20 * 128
    assert k1 == pytest.approx(100 * resolve_flops(CFG, 128) / PEAK_F32_FLOPS / 2.8e-3)
    assert k1 == pytest.approx(k2 * 8.7 / 2.8 / 32)


@pytest.mark.parametrize("name", ["hybrid_condensed_ms.solve", "hybrid_condensed_roofline_pct.solve",
                                  "hybrid_rank_ms.solve", "hybrid_resolve_ms.solve",
                                  "hybrid_resolve_roofline_pct.solve", "hybrid_merge_ms.solve",
                                  "hybrid_flagged_pct.solve"])
def test_a_program_without_the_marks_or_counters_reads_nothing(name):
    """No hybrid mark (a program before them, or the K1 cells) and no
    counters in the trace's info: every reader returns None."""
    info = {"cfg": CFG, "batch": 4096, "per_unit": "solve"}
    assert read_metric(name, _trace(marks=False, info=info)) is None
    empty = Trace(device=[], host=[], start=0.0, end=1.0, units=1, info=info)
    assert read_metric(name, empty) is None


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_the_resolve_discarded_is_not_correct_on_the_card(monkeypatch):
    """At the cell's own size the merged envs are the 128 of 4096 with the
    condensed route's largest residuals, whose condensed answers fail the
    merged gap's limit (2.09-2.74 N against 1.0)."""
    _card()
    _resolve_discarded(monkeypatch)
    out = bench_run.run(CELL, SEED, 1.0, False)
    assert not out["correct"], out["checks"]
    checks = out["checks"]
    assert checks["wrench_gap_merged_p75_N"]["value"] > checks["wrench_gap_merged_p75_N"]["limit"]


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    """The cell at its own size on the card, a one-second window, with no
    non-finite env left."""
    _card()
    out = bench_run.run(CELL, SEED, 1.0, False)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["checks"]["dropped_nonfinite_envs"]["value"] == 0

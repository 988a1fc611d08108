"""The hybrid speed mode as the benchmark deploys it (`hector_hybrid`): the
port's `pdipm_cuda.solve_hybrid` held to the plain statement of its
selection and merge (`benchmark/reference/hybrid.py`), its merged wrench to
the float64 dense-LU reference, its phase marks in a captured `run_mpc`,
and the wrapper's counters read without a sync. CPU, float64, 32 envs of
the benchmark's walking draw; this file imports no jax."""

import dataclasses

import pytest
import torch

from benchmark import port
from benchmark.common import env_gap, load_json
from benchmark.reference import hybrid as ref_hybrid
from benchmark.reference.control import Reference
from biped_pympc_tpu_torch import wrapper
from biped_pympc_tpu_torch.control import controller
from biped_pympc_tpu_torch.ops import pdipm_cuda
from biped_pympc_tpu_torch.ops import qp as qps
from biped_pympc_tpu_torch.utils import cuda_graph

from graph_fakes import _fake_cuda, _kernel

torch.set_num_threads(1)
F64 = torch.float64
B = 32
CFG = load_json("benchmark/configs/hector_hybrid.json")
HYBRID_MARKS = ["hybrid_condensed", "hybrid_rank", "hybrid_resolve", "hybrid_merge", "hybrid_done"]


def _controller(budget=4, newton_iterations=20, seed=0, **mpc):
    """The `hector_hybrid` configuration at B envs in float64 on the CPU,
    its QPs drawn as the benchmark's solve traffic draws them."""
    mix = load_json("benchmark/traffic/hybrid_solve.json")
    gen = torch.Generator().manual_seed(seed)
    obs = port.draw_observations(CFG, mix, gen, 1, B, "cpu")[0].to(F64)
    twist = port.uniform(gen, (B, 3), -mix["twist"], mix["twist"], "cpu").to(F64)
    phase = port.uniform(gen, (B,), 0.0, 1.0, "cpu").to(F64)
    ccfg, mcfg, gait_id, _ = port.confs(CFG)
    mcfg = dataclasses.replace(mcfg, hybrid_budget=budget, hybrid_flag_tol=CFG["hybrid_flag_tol"],
                               hybrid_flag=CFG["hybrid_flag"], newton_iterations=newton_iterations,
                               **mpc)
    ctrl = wrapper.MPCController(ccfg, mcfg, B, gait_id=gait_id, dtype=F64, device="cpu")
    height = torch.full((B,), mix["height"], dtype=F64)
    ctrl.set_command(twist, height)
    ctrl.update_state(obs)
    ctrl.state.gait_phase.copy_(phase)
    return ctrl, (obs, twist, height, phase)


def _fields(res):
    return {k: getattr(res, k) for k in ref_hybrid.FIELDS}


# (budget, flag_tol, envs whose fast answer is poisoned with NaN)
CASES = {"every_ranked_env_flagged": (4, -1.0, ()),
         "some_ranked_envs_under_the_tolerance": (4, None, ()),
         "nonfinite_envs_rescued": (4, 1.0, (5, 17, 30)),
         "budget_under_the_nonfinite_count": (2, 1.0, (5, 17, 30))}


@pytest.mark.parametrize("case", list(CASES))
def test_port_merge_is_the_plain_statement_bit_for_bit(case, monkeypatch):
    """Given the same two route results, the port's merge, counters and merged
    mask are the reference's, and it re-solves the reference's ranked envs
    in rank order. A NaN planted in x of three envs ranks them first;
    with a budget of 2 one is left, `dropped_nonfinite` 1."""
    budget, flag_tol, poisoned = CASES[case]
    ctrl, _ = _controller(newton_iterations=3)
    _, _, qp = ctrl.core.assemble_mpc(ctrl.state)
    opts = dataclasses.replace(ctrl.core.opts, iterations=3)
    if flag_tol is None:  # between the second and third largest criterion
        crit = sorted(pdipm_cuda.solve(qp, opts).residuals.amax(1).tolist(), reverse=True)
        flag_tol = 0.5 * (crit[1] + crit[2])
    calls, solve = [], pdipm_cuda.solve

    def recorded(q, o, state=None):
        res = solve(q, o, state)
        if not calls:
            for env in poisoned:
                res.x[env, 3] = float("nan")
        calls.append((q, o, res))
        return res

    monkeypatch.setattr(pdipm_cuda, "solve", recorded)
    merged, stats = pdipm_cuda.solve_hybrid(qp, opts, budget=budget, flag_tol=flag_tol,
                                            with_stats=True)
    (_, fast_opts, fast), (taken, aug_opts, robust) = calls
    assert (fast_opts.backend, aug_opts.backend, aug_opts.aug_pivot) == ("ric", "ric_aug", True)
    want, counts, mask = ref_hybrid.hybrid(_fields(fast), _fields(robust), budget, flag_tol)
    crit = ref_hybrid.criterion(_fields(fast))
    ranked = ref_hybrid.rank(crit, budget)
    assert torch.equal(taken.f, qps.take(qp, torch.tensor(ranked)).f)
    for k in ref_hybrid.FIELDS:
        torch.testing.assert_close(getattr(merged, k), want[k], rtol=0, atol=0, equal_nan=True)
    assert {k: int(getattr(stats, k)) for k in ref_hybrid.COUNTERS} == counts
    assert torch.equal(stats.merged, mask)
    assert counts["resolved"] == int(mask.sum()) == ref_hybrid.resolved_of(counts["flagged"], B,
                                                                             budget)
    if case == "some_ranked_envs_under_the_tolerance":
        assert 0 < counts["resolved"] < budget
    if poisoned:
        assert counts["nonfinite"] == len(poisoned)
        assert counts["dropped_nonfinite"] == max(0, len(poisoned) - budget)
        assert ranked[:min(budget, len(poisoned))] == list(poisoned[:budget])


def test_merged_wrench_is_the_float64_dense_lu_solve():
    """The hybrid's wrench in float64, 20 Newton steps, a budget of 4, against
    the reference's dense-LU Mehrotra solve of the same QPs, on every env:
    both routes follow the reference's iterate, so only roundoff parts them
    (at most 7.2e-7 N over four draws; the condensed route amplifies f64
    roundoff through W^-1); 1e-5 N allows for that and no more. The envs
    the merge took from the re-solve are 4 of the 32."""
    ctrl, (obs, twist, height, phase) = _controller()
    ctrl.run_mpc()
    ref = Reference(CFG)
    st = ref.init_state(B)
    ref.set_command(st, twist, height)
    st["gait_phase"] = phase.clone()
    ref.ingest(st, obs)
    w_ref, _, _ = ref.run_mpc(st)
    gap = env_gap(ctrl.state.leg_cmd.wrench_ff, w_ref)
    assert float(gap.max()) < 1e-5
    assert int(ctrl.hybrid_merged.sum()) == ctrl.hybrid_stats["resolved"] == 4


@pytest.fixture
def captured(monkeypatch):
    """The wrapper's calls captured through the CUDA graph stand-ins, and each
    phase mark recorded as device work: at once outside a capture, at each
    replay inside one."""
    seen = []

    def mark(phase, like):
        _kernel(lambda: seen.append(phase))

    with _fake_cuda(monkeypatch):
        monkeypatch.setattr(wrapper, "LoopStep", lambda step, carry, graph=None: cuda_graph.LoopStep(
            step, carry, True if graph is None else graph))
        monkeypatch.setattr(controller, "mark", mark)
        monkeypatch.setattr(pdipm_cuda, "mark", mark)
        yield seen


@pytest.mark.parametrize("solver", ["pallas_hybrid", "pallas_ric_aug"])
def test_captured_run_mpc_marks_the_hybrid_phases_in_order(solver, captured):
    """A replayed hybrid `run_mpc` marks `assembly`, then the five hybrid
    phases once each, in order; a K1 `run_mpc` marks `assembly` alone."""
    ctrl, _ = _controller(newton_iterations=1, solver=solver)
    ctrl.run_mpc()  # the capture
    captured.clear()
    ctrl.run_mpc()
    ctrl.run_mpc()
    one = ["assembly"] + (HYBRID_MARKS if solver == "pallas_hybrid" else [])
    assert captured == one * 2
    assert isinstance(ctrl.graphs["run_mpc"].graph, torch.cuda.CUDAGraph)


def test_counters_are_read_without_a_sync(monkeypatch):
    """`hybrid_counts` and `hybrid_merged` hand out copies of the last
    solve's device tensors without reading them on the host; None under K1
    and before the first solve."""
    ctrl, _ = _controller(newton_iterations=1)
    assert ctrl.hybrid_counts is None and ctrl.hybrid_merged is None
    ctrl.run_mpc()

    def no_sync(*a, **k):
        raise AssertionError("read on the host")

    with monkeypatch.context() as m:
        for name in ("tolist", "item", "cpu", "numpy", "__bool__", "__int__", "__float__"):
            m.setattr(torch.Tensor, name, no_sync)
        m.setattr(torch.cuda, "synchronize", no_sync)
        counts, merged = ctrl.hybrid_counts, ctrl.hybrid_merged
    assert counts.dtype == torch.int32 and counts.shape == (4,)
    assert merged.dtype == torch.bool and merged.shape == (B,)
    assert counts is not ctrl.hybrid_counts and counts.data_ptr() != ctrl._last_mpc.hybrid_counts.data_ptr()
    stats = ctrl.hybrid_stats
    assert counts.tolist() == [stats[k] for k in ref_hybrid.COUNTERS]
    assert int(merged.sum()) == stats["resolved"]
    k1, _ = _controller(newton_iterations=1, solver="pallas_ric_aug")
    k1.run_mpc()
    assert k1.hybrid_counts is None and k1.hybrid_merged is None and k1.hybrid_stats == {}

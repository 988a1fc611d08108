"""The port's `MPCController` as the counterpart of the JAX wrapper's jitted
calls: on the card each call is one captured CUDA graph, replayed; on the
CPU the same plumbing runs eagerly (input buffers, a working copy of the
state, the replaced leaves copied back). These tests hold, on the CPU, what
the replay depends on: the state's tensors keep their addresses, a result
the caller holds is the caller's own, inputs are copied in, the wrapper
still matches the JAX wrapper (float64), nothing in a captured call waits
for the device, and a captured step's launches count as they ran
(`utils/cuda_graph.LoopStep`, driven here through stand-ins for the CUDA
graph calls)."""

import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import biped_pympc_tpu as jpkg
import biped_pympc_tpu_torch as tpkg
from biped_pympc_tpu_torch.config import SOLVERS
from biped_pympc_tpu_torch.control import mpc
from biped_pympc_tpu_torch.ops import pdipm_cuda
from biped_pympc_tpu_torch.utils import cuda_graph
from biped_pympc_tpu_torch.utils.tree import leaves
from biped_pympc_tpu_torch.wrapper import eager_run_mpc

from graph_fakes import _FakeGraph, _fake_cuda, _kernel
from test_torch_controller import _obs, _t1_obs

torch.set_num_threads(1)
B = 4
DECIM = 10
# The tolerance of tests/test_torch_controller.py for tau and the wrench.
ATOL = 1e-6


def _port(solver="ric_aug", dtype=torch.float64, num_envs=B, robot="HECTOR"):
    """HECTOR with the default configuration (the JAX wrapper's below), the
    T1 with its `recommended_conf`."""
    cconf, kw = tpkg.recommended_conf(robot) if robot != "HECTOR" else (tpkg.ControllerConf(), {})
    c = tpkg.MPCController(cconf, tpkg.MPCConf(**{**kw, "solver": solver, "verbose": False}),
                           num_envs=num_envs, gait_id=2, dtype=dtype, device="cpu")
    c.set_command(np.tile([0.2, 0.0, 0.1], (num_envs, 1)), np.full(num_envs, 0.55))
    return c


def _period(c, obs, start=0):
    for step in range(start, start + DECIM):
        c.update_state(obs)
        if step % DECIM == 0:
            c.run_mpc()
        c.run_lowlevel()
        c.get_action()


def _residuals(seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.05, 0.05, (B, 12, 12)), rng.uniform(-0.02, 0.02, (B, 12, 12))


def _addresses(c):
    return {path: t.untyped_storage().data_ptr() for path, t in leaves(c.state)}


# --- addresses ------------------------------------------------------------


def test_state_keeps_its_addresses_across_every_call(tmp_path):
    """Every leaf keeps its memory across set_command, ticks, run_mpc,
    reset, every DRL setter and load_state: a graph captured at the first
    call reads and writes the same tensors at every replay."""
    c = _port()
    obs = _obs(B, np.random.default_rng(0))
    want = _addresses(c)
    before = {p: t.clone() for p, t in leaves(c.state)}
    c.set_command(np.tile([0.3, 0.0, 0.0], (B, 1)), np.full(B, 0.5))
    for step in range(3):
        c.update_state(obs)
        if step == 0:
            c.run_mpc()
        c.run_lowlevel()
        c.get_action()
    c.run_mpc()
    c.reset([1, 3])
    c.reset(np.array([True, False, False, False]))
    c.update_mpc_sampling_time(0.03)
    c.set_swing_parameters(0.13, 0.3, 0.7)
    c.set_srbd_accel(np.full((B, 3), 0.1), np.full((B, 3), -0.1))
    c.set_contact_parameters(mu=0.7, f_max=400.0, lt=0.08, lh=0.04)
    path = tmp_path / "ctrl.npz"
    c.save_state(str(path))
    c.load_state(str(path))
    assert _addresses(c) == want
    changed = {p for p, t in leaves(c.state) if not torch.equal(t, before[p])}
    assert {".gait_phase", ".dt_mpc", ".foot_height", ".mu", ".x_ref",
            ".leg_cmd.wrench_ff"} <= changed
    assert c.state.dt_mpc.tolist() == [0.03] * B and c.state.f_max.tolist() == [400.0] * B


def test_residual_toggle_is_the_one_structure_change():
    """set_srbd_residual between None and a tensor adds or removes two leaves
    and drops every graph; the other leaves keep their memory, and a tensor
    over a tensor is copied in and keeps the graphs."""
    c = _port()
    obs = _obs(B, np.random.default_rng(1))
    _period(c, obs)
    want = _addresses(c)
    assert set(c.graphs) == {"set_command", "update_state", "run_mpc", "run_lowlevel",
                             "get_action"}
    a_res, b_res = _residuals()
    c.set_srbd_residual(a_res, b_res)
    assert c.graphs == {}
    with_res = _addresses(c)
    assert set(with_res) - set(want) == {".residual_A", ".residual_B"}
    assert {p: with_res[p] for p in want} == want
    _period(c, obs, DECIM)
    graphs = c.graphs
    c.set_srbd_residual(*_residuals(seed=6))
    assert c.graphs == graphs and _addresses(c) == with_res
    assert torch.equal(c.state.residual_A, torch.as_tensor(_residuals(seed=6)[0]))
    c.set_srbd_residual(None, None)
    assert c.graphs == {} and _addresses(c) == want


def test_dropped_controller_is_freed_without_a_collection():
    """The captured steps reference the core and the input buffers, not the
    controller: dropping it frees it (and on the card its graphs) at once,
    never in a later garbage collection that could run inside another
    controller's capture."""
    c = _port()
    _period(c, _obs(B))
    c.reset([0])
    ref = weakref.ref(c)
    gc.disable()
    try:
        del c
        assert ref() is None
    finally:
        gc.enable()


def test_assigned_state_is_copied_and_recaptured():
    """`ctrl.state = other` (a state carried over from elsewhere) takes the
    values into memory of the controller's own and captures every call
    again at its next use."""
    c, other = _port(), _port()
    _period(other, _obs(B, np.random.default_rng(2)))
    _period(c, _obs(B))
    c.state = other.state
    assert c.graphs == {}
    mine, theirs = dict(leaves(c.state)), dict(leaves(other.state))
    assert list(mine) == list(theirs)
    for p, t in mine.items():
        assert torch.equal(t, theirs[p]), p
        assert t.untyped_storage().data_ptr() != theirs[p].untyped_storage().data_ptr(), p


# --- held results ---------------------------------------------------------

HELD = ("get_action", "ground_reaction_wrench", "grf_world", "solver_residuals", "mpc_cost",
        "centroidal_accel", "contact_state", "contact_phase", "swing_state", "swing_phase",
        "foot_placement", "foot_placement_b", "ref_foot_pos_b", "ref_foot_vel_b", "foot_pos_b",
        "foot_vel_b", "position_trajectory", "velocity_trajectory", "swing_foot_trajectory")


@pytest.fixture(scope="module")
def held_after_two_periods():
    """Every result taken after one period, its value then, and its value
    after the next period: (held, copies, later)."""
    c = _port()
    rng = np.random.default_rng(3)

    def obs():
        o = _obs(B, rng)
        o[:, 23:33] = rng.uniform(-0.2, 0.2, (B, 10))  # joint rates: the feet move
        return o

    _period(c, obs())
    read = lambda name: c.get_action() if name == "get_action" else getattr(c, name)
    held = {name: read(name) for name in HELD}
    copies = {name: t.clone() for name, t in held.items()}
    _period(c, obs(), DECIM)
    return held, copies, {name: read(name) for name in HELD}


@pytest.mark.parametrize("name", HELD)
def test_held_result_is_not_changed_by_later_calls(held_after_two_periods, name):
    held, copies, later = held_after_two_periods
    assert torch.equal(held[name], copies[name]), name
    if name not in ("contact_state", "swing_state"):  # the same gait phase both times
        assert not torch.equal(later[name], copies[name]), f"{name} did not move"


def test_results_share_no_memory_with_the_state():
    c = _port()
    _period(c, _obs(B))
    state = {t.untyped_storage().data_ptr() for _, t in leaves(c.state)}
    last = {t.untyped_storage().data_ptr() for _, t in leaves(c._last_mpc)}
    for name in HELD:
        t = c.get_action() if name == "get_action" else getattr(c, name)
        assert t.untyped_storage().data_ptr() not in state | last, name


# --- inputs ---------------------------------------------------------------


def test_caller_inputs_are_copied_in():
    """Changing the caller's obs / twist / height / mask tensors after the
    calls changes nothing in the controller: it runs on as one fed copies."""
    obs = torch.tensor(_obs(B, np.random.default_rng(4)))
    twist = torch.tensor(np.tile([0.2, 0.0, 0.1], (B, 1)))
    height = torch.full((B,), 0.55, dtype=torch.float64)
    mask = torch.tensor([False, True, False, False])
    c, ref = _port(), _port()
    for ctrl, args in ((c, (obs, twist, height, mask)),
                       (ref, tuple(t.clone() for t in (obs, twist, height, mask)))):
        ctrl.set_command(args[1], args[2])
        ctrl.update_state(args[0])
        ctrl.run_mpc()
        ctrl.reset(args[3])
    want = {p: t.clone() for p, t in leaves(c.state)}
    for t in (obs, twist, height):
        t.add_(1.0)
    mask.fill_(True)
    assert all(torch.equal(t, want[p]) for p, t in leaves(c.state))
    for ctrl in (c, ref):
        ctrl.run_lowlevel()
        ctrl.run_mpc()
    theirs = dict(leaves(ref.state))
    for p, t in leaves(c.state):
        assert torch.equal(t, theirs[p]), p
    assert torch.equal(c.get_action(), ref.get_action())


def test_inputs_broadcast_to_the_buffers_and_ids_may_be_negative():
    c = _port(num_envs=3)
    c.set_command(torch.tensor([0.1, 0.0, 0.2], dtype=torch.float64), 0.5)
    assert c.state.des.height.tolist() == [0.5] * 3
    assert c.state.des.velocity_b[:, 0].tolist() == [0.1] * 3
    c.update_state(_obs(3))
    c.run_mpc()
    for _ in range(3):
        c.update_state(_obs(3))
        c.run_lowlevel()
    c.reset([-1])
    assert c.state.mpc_mem.first_run.tolist() == [False, False, True]


# --- parity with the JAX wrapper ------------------------------------------


def test_wrapper_matches_jax_across_residual_toggle_and_reset():
    """Two periods of 10 ticks, float64, on both wrappers; between them a
    residual switched on (a structure change: every graph captured again)
    and a reset of two envs; then the residual switched off and a third
    period. tau and the wrench at every tick within the tolerance of
    tests/test_torch_controller.py."""
    rng = np.random.default_rng(7)
    obs = _obs(B, rng)
    twist = np.tile([0.2, 0.0, 0.1], (B, 1))
    jc = jpkg.MPCController(jpkg.ControllerConf(), jpkg.MPCConf(solver="ric_aug", verbose=False),
                            num_envs=B, gait_id=2, dtype=jnp.float64)
    tc = _port()
    a_res, b_res = _residuals()
    for c in (jc, tc):
        c.set_command(twist, np.full(B, 0.55))

    def period(start):
        for step in range(start, start + DECIM):
            for c in (jc, tc):
                c.update_state(obs)
                if step % DECIM == 0:
                    c.run_mpc()
                c.run_lowlevel()
            np.testing.assert_allclose(np.asarray(tc.get_action()), np.asarray(jc.get_action()),
                                       rtol=0, atol=ATOL, err_msg=f"tau, tick {step}")
            np.testing.assert_allclose(np.asarray(tc.ground_reaction_wrench),
                                       np.asarray(jc.ground_reaction_wrench), rtol=0, atol=ATOL,
                                       err_msg=f"wrench, tick {step}")

    period(0)
    for c in (jc, tc):
        c.set_srbd_residual(a_res, b_res)
        c.reset(np.array([0, 2]))
    period(DECIM)
    np.testing.assert_array_equal(np.asarray(tc.state.gait_phase), np.asarray(jc.state.gait_phase))
    for c in (jc, tc):
        c.set_srbd_residual(None, None)
    period(2 * DECIM)


# --- nothing waits for the device -----------------------------------------


class _NoHostSync(TorchDispatchMode):
    """Fails on the operators that read a tensor's value on the host: on the
    card they wait for the device, which a CUDA graph capture refuses. `on`
    False lets them through (a plain CPU solve inside a guarded call)."""

    SYNCS = ("_local_scalar_dense", "nonzero", "item")
    on = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if self.on and name in self.SYNCS:
            raise AssertionError(f"aten.{name} waits for the device")
        return func(*args, **(kwargs or {}))


def test_guard_catches_a_host_read():
    with pytest.raises(AssertionError, match="_local_scalar_dense"):
        with _NoHostSync():
            float(torch.ones(2).sum())
    with pytest.raises(AssertionError, match="nonzero"):
        with _NoHostSync():
            torch.ones(2).nonzero()


@pytest.mark.parametrize("robot", ["HECTOR", "T1", "T1-newton"])
@pytest.mark.parametrize("solver", ["pallas_ric_aug", "pallas_hybrid"])
def test_captured_calls_wait_for_nothing(robot, solver):
    """set_command, update_state, run_lowlevel, get_action, reset and
    run_mpc's assembly and postprocess read no tensor on the host (the CPU's
    witness that each can be captured); the hybrid's rank, gather and merge
    too. The plain solve between them is the CPU's own and is left out."""
    rng = np.random.default_rng(8)
    obs = _obs(B, rng) if robot == "HECTOR" else _t1_obs(B, rng)
    c = _port(solver=solver, robot=robot)
    c.update_state(obs)
    c.run_mpc()  # the first solve fills nothing the guard could see; run it once
    core = c.core
    with _NoHostSync():
        c.set_command(np.tile([0.1, 0.0, 0.0], (B, 1)), np.full(B, obs[0, 2].round(2)))
        c.update_state(obs)
        c.run_lowlevel()
        c.get_action()
        c.reset(np.array([1]))
        new_mem, x_ref, qp = core.assemble_mpc(c.state)
    sol = pdipm_cuda.solve(qp, core.opts)
    with _NoHostSync():
        out = mpc.postprocess_solution(qp, sol, c.state.est.rotation_body, x_ref,
                                       core.mpc_cfg.horizon_length,
                                       contact_frame=core.mpc_cfg.contact_frame)
    assert torch.isfinite(out.wrench).all()
    if solver == "pallas_hybrid":
        solved = []
        real = pdipm_cuda.solve

        def solve_outside(qp_, opts_):
            guard.on = False
            try:
                solved.append(opts_.backend)
                return real(qp_, opts_)
            finally:
                guard.on = True

        guard = _NoHostSync()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pdipm_cuda, "solve", solve_outside)
            with guard:
                merged, stats = pdipm_cuda.solve_hybrid(qp, core.opts, with_stats=True)
        assert solved == ["ric", "ric_aug"]
        assert torch.isfinite(merged.x).all() and int(stats.resolved) <= B


# --- which run_mpc is captured ----------------------------------------------


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("adaptive_tol", [0.0, 1e-2])
def test_eager_run_mpc_is_a_static_rule(solver, adaptive_tol):
    """`run_mpc` stays eager on the card only where `eager_run_mpc` names the
    mode and its reason: `dense` with `adaptive_tol > 0`, whose plain
    adaptive loop decides on the host; `dense` with `adaptive_tol == 0` is
    captured, its LU under cuSOLVER."""
    c = tpkg.MPCController(tpkg.ControllerConf(),
                           tpkg.MPCConf(solver=solver, adaptive_tol=adaptive_tol, verbose=False),
                           num_envs=1, device="cpu")
    reason = eager_run_mpc(c.core)
    if solver == "dense" and adaptive_tol > 0:
        assert "dense" in reason and "adaptive loop" in reason and "host" in reason
    else:
        assert reason is None


# --- launch counts of a captured step -------------------------------------


@dataclasses.dataclass
class _Carry:
    x: torch.Tensor


def test_captured_step_counts_what_ran(monkeypatch):
    """A stand-in step that issues one launch (a host count, as the kernel
    wrapper's) whose kernel adds one to a device counter (as the PDIPM
    kernels do, `pdipm_cuda.runs`): the warm-up and the capture each issue
    it and only the warm-up runs it; each replay runs it and issues
    nothing. No count is put back or made up: the device counter reads the
    launches that ran, the warm-up's included."""
    issued = {"k1": 0}
    ran = torch.zeros(1, dtype=torch.int32)
    collecting = []

    def step(c):
        issued["k1"] += 1
        _kernel(lambda: ran.add_(1))
        if _FakeGraph.capturing is not None:
            collecting.append(gc.isenabled())
        c.x = c.x + 1.0
        return c.x * 2.0

    carry = _Carry(torch.zeros(3))
    with _fake_cuda(monkeypatch):
        loop = cuda_graph.LoopStep(step, carry, graph=True)
    assert isinstance(loop.graph, _FakeGraph)
    # no garbage collection inside the capture (it could destroy a dead
    # graph there), and collection on again after it
    assert collecting == [False] and gc.isenabled()
    assert issued == {"k1": 2} and ran.tolist() == [1]
    # the warm-up was undone; the capture ran the step's Python once more on
    # the carry (a real capture runs no arithmetic, so the carry would read
    # 0 here)
    assert carry.x.tolist() == [1.0] * 3 and torch.equal(loop.out, torch.full((3,), 2.0))
    for _ in range(3):
        loop()
    assert issued == {"k1": 2} and ran.tolist() == [4]


def test_eager_step_counts_as_it_runs():
    issued = {"k1": 0}
    carry = _Carry(torch.zeros(2))

    def step(c):
        issued["k1"] += 1
        c.x = c.x + 1.0

    loop = cuda_graph.LoopStep(step, carry)
    for _ in range(4):
        loop()
    assert loop.graph is None and issued == {"k1": 4} and carry.x.tolist() == [4.0, 4.0]


def test_reset_counts_zeroes_device_counters_in_place(monkeypatch):
    """A captured graph adds to the device counters it was captured with, so
    `reset_counts` zeroes them where they are."""
    cpu = torch.device("cpu")
    runs = torch.tensor([5], dtype=torch.int32)
    ran = torch.tensor([3], dtype=torch.int32)
    monkeypatch.setattr(pdipm_cuda, "_runs", {("ric_aug", True, cpu): runs})
    monkeypatch.setattr(pdipm_cuda, "_ran", {("ric_aug", True, cpu): ran})
    assert pdipm_cuda.runs()["ric_aug"] == 8 and pdipm_cuda.runs(warp=False)["ric_aug"] == 0
    assert pdipm_cuda.chunks_ran()["ric_aug"] == 3
    pdipm_cuda.reset_counts()
    assert pdipm_cuda._runs[("ric_aug", True, cpu)] is runs and runs.tolist() == [0]
    assert pdipm_cuda._ran[("ric_aug", True, cpu)] is ran and ran.tolist() == [0]


def test_first_launch_inside_a_capture_raises(monkeypatch):
    """A route's device counter is made at its first launch; inside a capture
    the graph would zero it at every replay, so that raises."""
    monkeypatch.setattr(pdipm_cuda, "_runs", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        pdipm_cuda._counter(pdipm_cuda._runs, "ric_aug", pdipm_cuda.BLOCK, torch.device("cuda"))
    assert pdipm_cuda._runs == {}


def test_examples_reexport_the_graph_helpers():
    from biped_pympc_tpu_torch.examples import cuda_graph as ex

    assert ex.LoopStep is cuda_graph.LoopStep and ex.copy_into is cuda_graph.copy_into

"""The port's `BipedControllerCore.control_step`, the counterpart of the JAX
core's jitted `control_step` (`biped_pympc_tpu/control/controller.py:427`),
and the sharded step built on it (`parallel/mesh.controller_step`).

Against JAX, float64, HECTOR, two envs: tau, the wrench and every leaf of
the new state over three steps, and the sharded step on one CPU device.
The capture plumbing, on the CPU, through stand-ins for the CUDA graph
calls whose replay re-runs the captured step into the captured outputs:
one graph for each batch and dtype, captured again when the state's
structure changes; the eager bits over calls with new state objects; the
caller's tensors left as they were; a call inside another capture inline;
a failed capture raises."""

import contextlib
import dataclasses
import gc
import os
import traceback
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import biped_pympc_tpu as jpkg
import biped_pympc_tpu_torch as tpkg
from biped_pympc_tpu.control.controller import BipedControllerCore as JaxCore
from biped_pympc_tpu.parallel import mesh as jmesh
from biped_pympc_tpu_torch.control.controller import BipedControllerCore
from biped_pympc_tpu_torch.convert import controller_state_from_numpy
from biped_pympc_tpu_torch.ops import pdipm
from biped_pympc_tpu_torch.parallel import mesh as pmesh
from biped_pympc_tpu_torch.utils import cuda_graph
from biped_pympc_tpu_torch.utils.tree import leaves, tree_map

from test_torch_controller import _obs
from test_torch_wrapper_graph import _FakeGraph, _fake_cuda

torch.set_num_threads(1)
B = 2
STEPS = 3
# tau, the wrench and the state's float leaves against the JAX core, f64.
ATOL = 1e-8


def _inputs(batch=B, seed=0):
    """(obs, twist, height) as numpy, one draw a step."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        twist = np.zeros((batch, 3))
        twist[:, 0] = rng.uniform(0.0, 0.4, batch)
        twist[:, 2] = rng.uniform(-0.2, 0.2, batch)
        out.append((_obs(batch, rng), twist, np.full(batch, 0.55)))
    return out


def _port_core(solver="ric_aug", dtype=torch.float64):
    return BipedControllerCore(tpkg.ControllerConf(), tpkg.MPCConf(solver=solver, verbose=False),
                               gait_id=2, dtype=dtype, device="cpu")


def _captured(core):
    """The core with its control_step captured, as on the card (the CPU's
    stand-in graphs of `replaying_cuda`)."""
    core._capture = True
    return core


def _t(*arrays):
    return tuple(torch.tensor(a, dtype=torch.float64) for a in arrays)


def _assert_state_close(port_state, jax_state, step):
    want = dict(leaves(controller_state_from_numpy(jax.tree.map(np.asarray, jax_state),
                                                   torch.float64)))
    got = dict(leaves(port_state))
    assert list(got) == list(want)
    for path, t in got.items():
        w = want[path]
        if t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=0, atol=ATOL,
                                       err_msg=f"{path}, step {step}")
        else:
            assert torch.equal(t.to(w.dtype), w), f"{path}, step {step}"


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX core's jitted control_step over STEPS steps: [(state, tau,
    out)] after each, and its initial state."""
    core = JaxCore(jpkg.ControllerConf(), jpkg.MPCConf(solver="ric_aug", verbose=False),
                   gait_id=2, dtype=jnp.float64)
    state = core.init_state(B)
    init = state
    trace = []
    for obs, twist, height in _inputs():
        state, tau, out = core.control_step(state, jnp.asarray(obs), jnp.asarray(twist),
                                            jnp.asarray(height))
        trace.append((state, np.asarray(tau), np.asarray(out.wrench)))
    return init, trace


def test_control_step_matches_the_jax_core(jax_steps):
    """tau, the wrench and every leaf of the new state after each of three
    steps, within ATOL (integer and bool leaves exact)."""
    init, trace = jax_steps
    core = _port_core()
    state = core.init_state(B)
    _assert_state_close(state, init, "init")
    for step, ((obs, twist, height), (jstate, jtau, jwrench)) in enumerate(
            zip(_inputs(), trace)):
        tau, out = core.control_step(state, *_t(obs, twist, height))
        np.testing.assert_allclose(tau.numpy(), jtau, rtol=0, atol=ATOL, err_msg=f"tau {step}")
        np.testing.assert_allclose(out.wrench.numpy(), jwrench, rtol=0, atol=ATOL,
                                   err_msg=f"wrench {step}")
        _assert_state_close(state, jstate, step)
    assert core.graphs == {}  # the CPU runs it eagerly


@pytest.mark.parametrize("with_metrics", [False, True])
def test_sharded_step_matches_the_jax_mesh_step(with_metrics, monkeypatch):
    """The port's sharded step on a one-rank mesh (its one all-reduce a
    stand-in that leaves the values as they are, as one rank's sum does)
    against JAX's `mesh.controller_step` on one CPU device: tau, the wrench,
    the new state and the mean cost."""
    jcore = JaxCore(jpkg.ControllerConf(), jpkg.MPCConf(solver="ric_aug", verbose=False),
                    gait_id=2, dtype=jnp.float64)
    jm = jmesh.make_mesh(jax.devices()[:1])
    jstep = jmesh.controller_step(jcore, jm, with_metrics)
    jstate = jmesh.shard_state(jcore.init_state(B), jm)
    core = _port_core()
    reduced = []
    monkeypatch.setattr(pmesh.dist, "all_reduce", lambda t, group=None: reduced.append(t.numel()))
    step = pmesh.controller_step(core, pmesh.Mesh(0, 1, torch.device("cpu")), with_metrics)
    state = core.init_state(B)
    for i, (obs, twist, height) in enumerate(_inputs(seed=1)):
        jret = jstep(jstate, jnp.asarray(obs), jnp.asarray(twist), jnp.asarray(height))
        jstate = jret[0]
        ret = step(state, *_t(obs, twist, height))
        np.testing.assert_allclose(ret[0].numpy(), np.asarray(jret[1]), rtol=0, atol=ATOL)
        np.testing.assert_allclose(ret[1].wrench.numpy(), np.asarray(jret[2].wrench), rtol=0,
                                   atol=ATOL)
        _assert_state_close(state, jstate, i)
        if with_metrics:
            np.testing.assert_allclose(float(ret[2]), float(jret[3]), rtol=1e-12, atol=0)
    assert reduced == ([1] * STEPS if with_metrics else [])


def test_hybrid_metrics_are_one_all_reduce(monkeypatch):
    """With metrics, the hybrid's mean cost and its four counters cross the
    ranks in one all-reduce after the step, and come back in their dtypes."""
    core = _port_core("pallas_hybrid")
    reduced = []
    monkeypatch.setattr(pmesh.dist, "all_reduce", lambda t, group=None: reduced.append(t.clone()))
    step = pmesh.controller_step(core, pmesh.Mesh(0, 1, torch.device("cpu")), True)
    obs, twist, height = _inputs()[0]
    state = core.init_state(B)
    want_state = tree_map(torch.clone, state)
    tau_u, out_u = core.control_step(want_state, *_t(obs, twist, height))
    tau, out, (mean_cost, counts) = step(state, *_t(obs, twist, height))
    assert len(reduced) == 1 and reduced[0].shape == (5,)
    assert torch.equal(tau, tau_u) and out.hybrid_counts is None
    assert torch.equal(mean_cost, out_u.cost.mean())
    assert counts.dtype == out_u.hybrid_counts.dtype and torch.equal(counts, out_u.hybrid_counts)


# --- the capture plumbing on the CPU ----------------------------------------


@pytest.fixture
def replaying_cuda(monkeypatch):
    """`_fake_cuda`'s stand-ins, with a replay that re-runs the captured step
    from the carry and the input buffers and writes its outputs into the
    tensors the capture returned, as a CUDA graph's replay does; yields the
    list of graphs made."""
    made = []
    real_run = cuda_graph.LoopStep._run

    def run(loop):
        graph = _FakeGraph.capturing
        if graph is None:
            real_run(loop)
            return
        # A capture runs no arithmetic: the carry stays as it was.
        saved = tree_map(torch.clone, loop.carry)
        real_run(loop)
        cuda_graph.copy_into(loop.carry, saved)
        captured = loop.out

        def replay():
            # A replay runs no Python: the stand-in re-runs the step's, with
            # a call made inside it inline, as it was recorded.
            cuda_graph._building += 1
            try:
                real_run(loop)
            finally:
                cuda_graph._building -= 1
            cuda_graph.copy_into(captured, loop.out)
            loop.out = captured

        graph.work.append(replay)

    class Graph(_FakeGraph):
        def __init__(self):
            super().__init__()
            made.append(self)

    with _fake_cuda(monkeypatch):
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        monkeypatch.setattr(cuda_graph.LoopStep, "_run", run)
        yield made


def _same_state(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def test_captured_step_gives_the_eager_bits(replaying_cuda):
    """Captured once, then replayed: over five calls, each on a new state
    object cloned from a rolling eager run (which takes a step of its own
    between them, so no call starts where the last ended), the new state,
    tau and the MpcOutput equal the eager step's bit for bit; a tensor the
    caller held, before the call or after it, keeps its values through the
    later calls; the returned tau is the caller's own, the MpcOutput the
    graph's tensors in a new object."""
    core = _captured(_port_core())
    eager = core.init_state(B)
    steps = _inputs(seed=2) + _inputs(seed=3)
    held = []
    for i in range(5):
        core._control_step(eager, *_t(*steps[i + 1]))
        mine = tree_map(torch.clone, eager)
        held += [(t, t.clone()) for _, t in leaves(mine)]
        tau, out = core.control_step(mine, *_t(*steps[i]))
        tau_e, out_e = core._control_step(eager, *_t(*steps[i]))
        assert _same_state(mine, eager), i
        assert torch.equal(tau, tau_e) and _same_state(out, out_e), i
        held += [(t, t.clone()) for _, t in leaves(mine)] + [(tau, tau.clone())]
        assert all(torch.equal(t, was) for t, was in held), i
        step = core.graphs[(B, torch.float64)]
        assert tau is not step.loop.out[0] and out is not step.loop.out[1]
        assert out.wrench is step.loop.out[1].wrench
    assert len(replaying_cuda) == 1 and len(replaying_cuda[0].work) == 1


def test_one_graph_per_batch_and_structure(replaying_cuda):
    """A second batch size gets a graph of its own; the learned residuals
    switched on (another state structure) drop that batch's graph and
    capture a new one, whose replay gives the eager bits."""
    core = _captured(_port_core())
    for batch in (B, 3, B):
        obs, twist, height = _inputs(batch)[0]
        core.control_step(core.init_state(batch), *_t(obs, twist, height))
    assert sorted(core.graphs) == [(B, torch.float64), (3, torch.float64)]
    assert len(replaying_cuda) == 2
    first = core.graphs[(B, torch.float64)]
    state = core.init_state(B)
    rng = np.random.default_rng(4)
    state.residual_A, state.residual_B = _t(rng.uniform(-0.05, 0.05, (B, 12, 12)),
                                            rng.uniform(-0.02, 0.02, (B, 12, 12)))
    eager = tree_map(torch.clone, state)
    obs, twist, height = _inputs(seed=5)[0]
    tau, _ = core.control_step(state, *_t(obs, twist, height))
    tau_e, _ = core._control_step(eager, *_t(obs, twist, height))
    assert core.graphs[(B, torch.float64)] is not first and len(replaying_cuda) == 3
    assert torch.equal(tau, tau_e) and _same_state(state, eager)


def test_call_inside_another_capture_runs_inline(replaying_cuda):
    """control_step called by the step of an outer LoopStep runs inline in
    its warm-up and its capture (no graph of its own), and the outer graph's
    replays give the eager bits."""
    core = _captured(_port_core())
    obs, twist, height = _t(*_inputs(seed=6)[0])
    carry = core.init_state(B)
    eager = tree_map(torch.clone, carry)
    loop = cuda_graph.LoopStep(lambda st: core.control_step(st, obs, twist, height), carry,
                               graph=True)
    assert core.graphs == {} and len(replaying_cuda) == 1
    for _ in range(2):
        loop()
        tau_e, _ = core._control_step(eager, obs, twist, height)
        assert torch.equal(loop.out[0], tau_e) and _same_state(carry, eager)
    assert core.graphs == {} and not cuda_graph.capturing()


def test_failed_capture_raises(replaying_cuda, monkeypatch):
    """A capture that fails raises out of control_step: no graph is kept,
    nothing runs eagerly in its place, and the caller's state is as it was."""
    core = _captured(_port_core())

    @contextlib.contextmanager
    def refused(graph, **kw):
        yield
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(torch.cuda, "graph", refused)
    state = core.init_state(B)
    before = tree_map(torch.clone, state)
    with pytest.raises(RuntimeError, match="capturing"):
        core.control_step(state, *_t(*_inputs()[0]))
    assert core.graphs == {} and _same_state(state, before)
    assert not cuda_graph.capturing()


def test_eager_step_leaves_the_callers_tensors():
    """The eager step replaces the state's leaves and writes into none of
    them (what the captured step's copies mirror)."""
    core = _port_core()
    state = core.init_state(B)
    held = {p: (t, t.clone()) for p, t in leaves(state)}
    core.control_step(state, *_t(*_inputs()[0]))
    assert all(torch.equal(t, was) for t, was in held.values())
    assert any(t is not held[p][0] for p, t in leaves(state))


def test_dense_rule_runs_the_step_eagerly(replaying_cuda):
    """`solver="dense"` with adaptive_tol > 0 is named by `eager_run_mpc`,
    and its control_step runs eagerly; with adaptive_tol 0 it is captured."""
    obs, twist, height = _t(*_inputs()[0])
    for tol, graphs in ((1e-2, 0), (0.0, 1)):
        core = _captured(BipedControllerCore(
            tpkg.ControllerConf(), tpkg.MPCConf(solver="dense", adaptive_tol=tol, verbose=False),
            gait_id=2, dtype=torch.float64, device="cpu"))
        core.control_step(core.init_state(B), obs, twist, height)
        assert len(core.graphs) == graphs, tol


def test_cusolver_scope_restores_the_preferred_library(monkeypatch):
    """`pdipm._cusolver` selects cuSOLVER for a tensor on the card only, and
    puts the library that was preferred back afterwards, after an error too;
    for a CPU tensor it selects nothing."""
    calls = []
    lib = ["default"]

    def preferred(backend=None):
        if backend is not None:
            calls.append(backend)
            lib[0] = backend
        return lib[0]

    monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library", preferred)
    card = dataclasses.make_dataclass("T", [("device", torch.device)])(torch.device("cuda", 0))
    with pdipm._cusolver(card):
        assert lib == ["cusolver"]
    assert lib == ["default"] and calls == ["cusolver", "default"]
    with pytest.raises(ValueError):
        with pdipm._cusolver(card):
            raise ValueError("inside")
    assert lib == ["default"] and calls[2:] == ["cusolver", "default"]
    with pdipm._cusolver(torch.zeros(1)):
        pass
    assert len(calls) == 4


class _HostData(TorchDispatchMode):
    """Records every operation that takes a tensor no operation made and
    that was not alive when the mode began: data taken from the host during
    the call (a Python list as an index, `torch.tensor` of Python values),
    which on the card is a copy from pageable host memory that a capture
    refuses. 0-d tensors (Python numbers wrapped by an operator) pass."""

    def __init__(self):
        super().__init__()
        with warnings.catch_warnings():  # isinstance on deprecated module attributes
            warnings.simplefilter("ignore", FutureWarning)
            self.keep = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
        self.known = {id(t) for t in self.keep}
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in tree_flatten((args, kwargs or {}))[0]:
            if isinstance(t, torch.Tensor) and t.dim() > 0 and id(t) not in self.known:
                where = [f for f in traceback.extract_stack()[:-1]
                         if f"{os.sep}torch{os.sep}" not in f.filename][-1]
                self.found.append(f"{func} at {where.filename}:{where.lineno}")
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.known.add(id(t))
                self.keep.append(t)
        return out


def test_host_data_guard_catches_a_list_index():
    x = torch.zeros(2, 4)
    with _HostData() as guard:
        x[:, [1, 3]]
        x[:, 1] + 1.0
    assert len(guard.found) == 1 and "lift_fresh" in guard.found[0]


def test_dense_step_waits_for_nothing():
    """The whole control_step of `solver="dense"` (adaptive_tol 0), its
    plain solve included, reads no tensor on the host and takes no data
    from it: the CPU's witness that it can be captured on the card, where
    its LU runs under cuSOLVER."""
    from test_torch_wrapper_graph import _NoHostSync

    core = _port_core("dense")
    state = core.init_state(B)
    core.control_step(state, *_t(*_inputs()[0]))
    obs, twist, height = _t(*_inputs()[1])
    with _NoHostSync(), _HostData() as guard:
        tau, out = core.control_step(state, obs, twist, height)
    assert guard.found == []
    assert torch.isfinite(tau).all() and torch.isfinite(out.wrench).all()

"""The port's `MPCController` on the condensed routes vs the JAX package's,
float64: `solver="pallas_hybrid"` (the JAX Pallas kernels run by the
interpreter on the CPU) with its `hybrid_stats`, and `solver="pallas_ric"`
against the JAX package's pure-JAX `ric`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import biped_pympc_tpu as jpkg
import biped_pympc_tpu_torch as tpkg

from test_torch_controller import B, TICKS, _obs

torch.set_num_threads(1)


def _drive(jc, tc, check_solve=None):
    """Walk both controllers in lockstep for TICKS ticks from the same
    perturbed standing pose and command; returns [(tau, wrench) x 2] per tick."""
    rng = np.random.default_rng(3)
    obs = _obs(B, rng)
    twist = np.zeros((B, 3))
    twist[:, 0] = rng.uniform(0.0, 0.4, B)
    twist[:, 2] = rng.uniform(-0.2, 0.2, B)
    mu = rng.uniform(0.6, 1.0, B)
    for c in (jc, tc):
        c.set_command(twist, np.full(B, 0.55))
        c.set_contact_parameters(mu=mu)
    trace = []
    for step in range(TICKS):
        for c in (jc, tc):
            c.update_state(obs)
            if step % 10 == 0:
                c.run_mpc()
            c.run_lowlevel()
        if step % 10 == 0 and check_solve is not None:
            check_solve(jc, tc)
        trace.append([(np.asarray(c.get_action()), np.asarray(c.ground_reaction_wrench))
                      for c in (jc, tc)])
    return trace


def _assert_trace_close(trace):
    """tau and wrench at 1e-6 N(m) plus 1e-8 relative: over three solves of 20
    steps the condensed route amplifies f64 roundoff (W^-1 up to 1e8) to a few
    1e-9 relative on wrenches of hundreds of N (`test_torch_pdipm_ric.py`)."""
    for step, ((jt, jw), (tt, tw)) in enumerate(trace):
        np.testing.assert_allclose(tt, jt, rtol=1e-8, atol=1e-6, err_msg=f"tau, tick {step}")
        np.testing.assert_allclose(tw, jw, rtol=1e-8, atol=1e-6, err_msg=f"wrench, tick {step}")


def test_hybrid_controller_matches_jax():
    kw = dict(solver="pallas_hybrid", hybrid_budget=2, hybrid_flag_tol=-1.0, verbose=False)
    jc = jpkg.MPCController(jpkg.ControllerConf(), jpkg.MPCConf(**kw), num_envs=B, gait_id=2,
                            dtype=jnp.float64)
    tc = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(**kw), num_envs=B, gait_id=2,
                            dtype=torch.float64, device="cpu")
    assert tc.hybrid_stats == {} == jc.hybrid_stats
    seen = []

    def check_solve(jc, tc):
        assert tc.hybrid_stats == jc.hybrid_stats
        seen.append(tc.hybrid_stats)

    trace = _drive(jc, tc, check_solve)
    _assert_trace_close(trace)
    # every env is flagged at flag_tol -1, and the budget re-solves two
    assert seen == [{"flagged": B, "nonfinite": 0, "resolved": 2, "dropped_nonfinite": 0}] * 3
    # the walk is not trivial: the right foot swings and the left carries load
    assert (np.abs(trace[0][1][1][:, 1, 2]) < 1.0).all()
    assert (trace[0][1][1][:, 0, 2] < -50.0).all()


def test_pallas_ric_controller_matches_jax_ric():
    jc = jpkg.MPCController(jpkg.ControllerConf(), jpkg.MPCConf(solver="ric", verbose=False),
                            num_envs=B, gait_id=2, dtype=jnp.float64)
    tc = tpkg.MPCController(tpkg.ControllerConf(),
                            tpkg.MPCConf(solver="pallas_ric", verbose=False),
                            num_envs=B, gait_id=2, dtype=torch.float64, device="cpu")
    _assert_trace_close(_drive(jc, tc))
    assert tc.hybrid_stats == {}


@pytest.mark.parametrize("solver", ["pallas_ric_aug", "ric"])
def test_hybrid_stats_empty_for_other_solvers(solver):
    ctrl = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(solver=solver, verbose=False),
                              num_envs=2, gait_id=2, dtype=torch.float64, device="cpu")
    ctrl.set_command(np.zeros((2, 3)), np.full(2, 0.55))
    ctrl.update_state(_obs(2))
    assert ctrl.hybrid_stats == {}
    ctrl.run_mpc()
    assert ctrl.hybrid_stats == {}
    assert ctrl.core.opts.backend == solver.removeprefix("pallas_")

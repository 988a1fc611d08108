"""The slice as a whole: the torch port's `MPCController` vs the JAX package's
(`solver="pallas_ric_aug"`, its Pallas kernel run by the interpreter on the
CPU), float64, plus the port's standing-pose checks and its refusals."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import biped_pympc_tpu as jpkg
import biped_pympc_tpu_torch as tpkg
from biped_pympc_tpu_torch.convert import controller_state_from_numpy
from biped_pympc_tpu_torch.models.srbd import GRAVITY

torch.set_num_threads(1)
B = 8
TICKS = 30
Q0 = np.array([0.0, 0.0, 0.45, -0.9, 0.45])


def _obs(batch, rng=None):
    """HECTOR standing pose (tests/test_controller.py:12-19), optionally
    perturbed per env."""
    obs = np.zeros((batch, 43))
    obs[:, 2] = 0.55
    obs[:, 3] = 1.0
    obs[:, 13:18] = Q0
    obs[:, 18:23] = Q0
    if rng is not None:
        obs[:, 0:3] += rng.uniform(-0.01, 0.01, (batch, 3))
        obs[:, 4:7] = rng.uniform(-0.01, 0.01, (batch, 3))
        obs[:, 7:13] = rng.uniform(-0.05, 0.05, (batch, 6))
        obs[:, 13:23] += rng.uniform(-0.02, 0.02, (batch, 10))
    return obs


def _t1_obs(batch, rng):
    """T1 standing at 0.62 m, the feet under the hips (their exact IK),
    perturbed per env as `_obs`."""
    from biped_pympc_tpu_torch.models import t1

    obs = np.zeros((batch, 49))
    obs[:, 2] = 0.62
    obs[:, 3] = 1.0
    for leg in (0, 1):
        foot = t1.hip_horizontal_location(leg, torch.float64).expand(batch, 3).clone()
        foot[:, 2] = -0.62
        obs[:, 13 + 6 * leg:19 + 6 * leg] = t1.analytical_ik_newton(foot, leg).numpy()
    obs[:, 0:3] += rng.uniform(-0.01, 0.01, (batch, 3))
    obs[:, 4:7] = rng.uniform(-0.01, 0.01, (batch, 3))
    obs[:, 7:13] = rng.uniform(-0.05, 0.05, (batch, 6))
    obs[:, 13:25] += rng.uniform(-0.02, 0.02, (batch, 12))
    return obs


@functools.lru_cache(maxsize=None)
def _drive_both(contact_frame, robot):
    """30 ticks of both controllers on the same inputs, each robot with its
    `recommended_conf` (HECTOR's is the default ControllerConf)."""
    rng = np.random.default_rng(0)
    obs = _obs(B, rng) if robot == "HECTOR" else _t1_obs(B, rng)
    twist = np.zeros((B, 3))
    twist[:, 0] = rng.uniform(0.0, 0.4, B)
    twist[:, 2] = rng.uniform(-0.2, 0.2, B)
    height = np.full(B, obs[0, 2].round(2))
    mu = rng.uniform(0.6, 1.0, B)
    cconf, kw = jpkg.recommended_conf(robot)
    jc = jpkg.MPCController(
        cconf, jpkg.MPCConf(**{**kw, "solver": "pallas_ric_aug", "contact_frame": contact_frame,
                               "verbose": False}),
        num_envs=B, gait_id=2, dtype=jnp.float64)
    cconf, kw = tpkg.recommended_conf(robot)
    tc = tpkg.MPCController(
        cconf, tpkg.MPCConf(**{**kw, "solver": "pallas_ric_aug", "contact_frame": contact_frame,
                               "verbose": False}),
        num_envs=B, gait_id=2, dtype=torch.float64, device="cpu")
    for c in (jc, tc):
        c.set_command(twist, height)
        c.set_contact_parameters(mu=mu)
    trace = []
    for step in range(TICKS):
        for c in (jc, tc):
            c.update_state(obs)
            if step % 10 == 0:
                c.run_mpc()
            c.run_lowlevel()
        trace.append([(np.asarray(c.get_action()), np.asarray(c.ground_reaction_wrench),
                       np.array(c.state.gait_phase), np.asarray(c.contact_state))
                      for c in (jc, tc)])
    return jc, tc, trace


def _assert_traces_match(jc, tc, trace):
    for step, ((jt, jw, jp, js), (tt, tw, tp, ts)) in enumerate(trace):
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6, err_msg=f"tau, tick {step}")
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6, err_msg=f"wrench, tick {step}")
        assert np.array_equal(tp, jp), step
        assert np.array_equal(ts, js), step
    np.testing.assert_allclose(np.asarray(tc.solver_residuals), np.asarray(jc.solver_residuals),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(tc.swing_foot_trajectory),
                               np.asarray(jc.swing_foot_trajectory), rtol=0, atol=1e-10)


@pytest.mark.parametrize("contact_frame", ["world", "yaw"])
def test_port_controller_matches_jax(contact_frame):
    jc, tc, trace = _drive_both(contact_frame, "HECTOR")
    _assert_traces_match(jc, tc, trace)
    # the walk is not trivial: the right foot swings and the left carries load
    assert (np.abs(trace[0][1][1][:, 1, 2]) < 1.0).all()
    assert (trace[0][1][1][:, 0, 2] < -50.0).all()


@pytest.mark.parametrize("robot", ["HECTOR", "T1", "T1-newton"])
def test_port_controller_matches_jax_robot(robot):
    """Each robot with its `recommended_conf` (contact frame "yaw"), at the
    bounds of `test_port_controller_matches_jax`. T1 carries 40 kg: every
    tick some foot carries more than its weight's share of a 0.5 g load."""
    jc, tc, trace = _drive_both("yaw", robot)
    _assert_traces_match(jc, tc, trace)
    assert tc.get_action().shape == (B, 2 * tc.core.num_dof)
    fz = np.stack([t[1][1][:, :, 2] for t in trace])  # (ticks, B, 2)
    assert (fz.min(axis=2) < -0.5 * tc.core.robot.mass * GRAVITY / 2).all()


def test_port_resumes_from_jax_state():
    """A JAX controller state carried over as numpy gives the same next tick."""
    jc = copy.copy(_drive_both("world", "HECTOR")[0])  # ticks below replace the copy's state only
    tc = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(verbose=False), num_envs=B,
                            gait_id=2, dtype=torch.float64, device="cpu")
    tc.state = controller_state_from_numpy(jax.tree.map(np.asarray, jc.state), torch.float64)
    obs = _obs(B, np.random.default_rng(1))
    for c in (jc, tc):
        c.update_state(obs)
        c.run_mpc()
        c.run_lowlevel()
    np.testing.assert_allclose(np.asarray(tc.get_action()), np.asarray(jc.get_action()),
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def standing_ctrl():
    ctrl = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(verbose=False), num_envs=2,
                              gait_id=1, device="cpu")
    ctrl.set_command(np.zeros((2, 3)), np.full(2, 0.55))
    ctrl.update_state(_obs(2))
    ctrl.run_mpc()
    ctrl.run_lowlevel()
    return ctrl


def test_standing_grf_supports_weight(standing_ctrl):
    fz = -standing_ctrl.ground_reaction_wrench[:, :, 2].numpy()
    np.testing.assert_allclose(fz.sum(axis=1), 13.856 * GRAVITY, rtol=0.1)
    np.testing.assert_allclose(fz[:, 0], fz[:, 1], rtol=0.05)


def test_standing_no_mx_moment(standing_ctrl):
    np.testing.assert_allclose(standing_ctrl.ground_reaction_wrench[:, :, 3].numpy(), 0.0,
                               atol=1e-5)


def test_standing_torques_within_limits(standing_ctrl):
    tau = standing_ctrl.get_action().numpy()
    assert tau.shape == (2, 10)
    assert (np.abs(tau) <= np.array([33.5, 33.5, 33.5, 67.0, 33.5] * 2) + 1e-5).all()


def test_wrapper_property_shapes(standing_ctrl):
    c = standing_ctrl
    shapes = dict(centroidal_accel=(2, 6), contact_state=(2, 2), contact_phase=(2, 2),
                  swing_state=(2, 2), swing_phase=(2, 2), foot_placement=(2, 2, 3),
                  foot_placement_b=(2, 2, 3), ref_foot_pos_b=(2, 2, 3),
                  ref_foot_vel_b=(2, 2, 3), foot_pos_b=(2, 2, 3), foot_vel_b=(2, 2, 3),
                  mpc_cost=(2,), position_trajectory=(2, 10, 3),
                  velocity_trajectory=(2, 10, 3), swing_foot_trajectory=(2, 10, 3),
                  grf_world=(2, 12), solver_residuals=(2, 4), ground_reaction_wrench=(2, 2, 6))
    for name, shape in shapes.items():
        assert tuple(getattr(c, name).shape) == shape, name


def test_reset_masks_only_selected_envs():
    ctrl = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(verbose=False), num_envs=3,
                              gait_id=2, device="cpu")
    ctrl.set_command(np.zeros((3, 3)), np.full(3, 0.55))
    for step in range(5):
        ctrl.update_state(_obs(3))
        if step == 0:
            ctrl.run_mpc()  # clears the first-run latch
        ctrl.run_lowlevel()
    ctrl.reset(np.array([1]))
    phase = ctrl.state.gait_phase.numpy()
    assert phase[1] == 0.0 and (phase[[0, 2]] > 0).all()
    assert ctrl.state.mpc_mem.first_run.tolist() == [False, True, False]
    assert ctrl.state.swing_state.first_swing[1].all()


@pytest.mark.parametrize("solver", ["bcr", "pallas_bcr"])
def test_unknown_solver_names_raise(solver):
    """Every JAX solver name is ported; a name JAX does not know (here the
    cyclic-reduction route JAX removed) raises ValueError, as in JAX."""
    with pytest.raises(ValueError, match="unknown MPCConf.solver"):
        tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(solver=solver, verbose=False),
                           num_envs=1, device="cpu")


@pytest.mark.parametrize("solver, route", [("tridiag_aug", "tridiag_aug"), ("tridiag", "tridiag"),
                                           ("pallas_aug", "tridiag_aug"), ("pallas", "tridiag")])
def test_thomas_solver_names_build(solver, route):
    ctrl = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(solver=solver, verbose=False),
                              num_envs=1, device="cpu")
    assert ctrl.core.opts.backend == route


def test_control_step_equals_the_separate_calls():
    obs, twist, height = _obs(2, np.random.default_rng(2)), np.tile([0.2, 0.0, 0.1], (2, 1)), \
        np.full(2, 0.55)
    ctrls = [tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(verbose=False), num_envs=2,
                                gait_id=2, dtype=torch.float64, device="cpu") for _ in range(2)]
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    tau, out = ctrls[0].core.control_step(ctrls[0].state, t(obs), t(twist), t(height))
    c = ctrls[1]
    c.set_command(twist, height)
    c.update_state(obs)
    c.run_mpc()
    c.run_lowlevel()
    torch.testing.assert_close(tau, c.get_action(), rtol=0, atol=0)
    torch.testing.assert_close(out.wrench, c.ground_reaction_wrench, rtol=0, atol=0)

"""The torch port's HECTOR kinematics, gait, estimator, leg and swing control
vs the JAX package on numpy-seeded random states, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu.control import estimator as jest
from biped_pympc_tpu.control import gait as jgait
from biped_pympc_tpu.control import legs as jlegs
from biped_pympc_tpu.control import swing as jswing
from biped_pympc_tpu.models import hector as jhector
from biped_pympc_tpu.models import robot as jrobot
from biped_pympc_tpu_torch.control import estimator as port_est
from biped_pympc_tpu_torch.control import gait as tgait
from biped_pympc_tpu_torch.control import legs as tlegs
from biped_pympc_tpu_torch.control import swing as tswing
from biped_pympc_tpu_torch.models import hector as thector
from biped_pympc_tpu_torch.models import robot as trobot

torch.set_num_threads(1)
B = 16


def _close(t, j, atol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=atol)


def _q(seed):
    rng = np.random.default_rng(seed)
    return np.array([0.0, 0.0, 0.45, -0.9, 0.45]) + rng.uniform(-0.3, 0.3, (B, 5))


@pytest.mark.parametrize("leg", [0, 1])
def test_hector_fk_jacobian_ik_match_jax(leg):
    q = _q(leg)
    tq = torch.tensor(q)
    p_t, (o_t, a_t) = thector.forward_kinematics(tq, leg)
    p_j, (o_j, a_j) = jax.vmap(lambda v: jhector.forward_kinematics(v, leg))(jnp.asarray(q))
    for a, b in ((p_t, p_j), (o_t, o_j), (a_t, a_j)):
        _close(a, b, 1e-12)
    _close(thector.contact_jacobian(tq, leg),
           jax.vmap(lambda v: jhector.contact_jacobian(v, leg))(jnp.asarray(q)), 1e-12)
    p = p_j + np.random.default_rng(7).uniform(-0.03, 0.03, (B, 3))
    _close(thector.analytical_ik(torch.tensor(np.asarray(p)), leg),
           jax.vmap(lambda v: jhector.analytical_ik(v, leg))(p), 1e-12)
    _close(thector.hip_horizontal_location(leg, torch.float64),
           jhector.hip_horizontal_location(leg, jnp.float64), 0.0)


def test_get_robot_names():
    """The registry holds JAX's robots, each with JAX's parameters."""
    for name in ("HECTOR", "T1", "T1-newton"):
        t, j = trobot.get_robot(name), jrobot.get_robot(name)
        assert (t.name, t.num_dof, t.mass, t.mu, t.lt, t.lh, t.kp, t.kd, t.torque_limit) == \
            (j.name, j.num_dof, j.mass, j.mu, j.lt, j.lh, j.kp, j.kd, j.torque_limit)
        np.testing.assert_array_equal(t.i_body, j.i_body)
    with pytest.raises(ValueError):
        trobot.get_robot("Cassie")


@pytest.mark.parametrize("gait_id, dsp, ssp", [(1, 0, 0), (2, 0, 5), (2, 2, 9)])
def test_gait_tables_and_phases_equal(gait_id, dsp, ssp):
    phase = np.linspace(0.0, 0.999, B)
    if gait_id == 1:
        tp, jp = tgait.standing_gait(B), jgait.standing_gait()
    else:
        tp, jp = tgait.walking_gait(dsp, ssp, B), jgait.walking_gait(dsp, ssp)
    jpb = jax.tree.map(lambda a: jnp.tile(a[None], (B, 1)), jp)
    ph_t, ph_j = torch.tensor(phase), jnp.asarray(phase)
    assert np.array_equal(tgait.mpc_contact_table(ph_t, tp, 10).numpy(),
                          np.asarray(jax.vmap(lambda p, g: jgait.mpc_contact_table(p, g, 10))(ph_j, jpb)))
    for tf, jf in ((tgait.contact_sub_phase, jgait.contact_sub_phase),
                   (tgait.swing_sub_phase, jgait.swing_sub_phase)):
        _close(tf(ph_t, tp), jax.vmap(jf)(ph_j, jpb), 0.0)
    dt_mpc = np.full(B, 0.025)
    _close(tgait.advance_phase(ph_t, tp, 0.001, torch.tensor(dt_mpc)),
           jax.vmap(lambda p, g, d: jgait.advance_phase(p, g, 0.001, d))(ph_j, jpb, dt_mpc), 1e-15)
    _close(tgait.swing_duration_sec(tp, torch.tensor(dt_mpc)),
           jax.vmap(jgait.swing_duration_sec)(jpb, jnp.asarray(dt_mpc)), 0.0)


def _body_state(seed):
    rng = np.random.default_rng(seed)
    quat = rng.standard_normal((B, 4)) * [1.0, 0.1, 0.1, 0.5] + [3.0, 0, 0, 0]
    return dict(pos=rng.uniform(-1, 1, (B, 3)) + [0, 0, 0.55], quat=quat,
                vel_b=rng.uniform(-0.5, 0.5, (B, 3)), ang_b=rng.uniform(-0.5, 0.5, (B, 3)),
                feet_b=rng.uniform(-0.2, 0.2, (B, 2, 3)) + [0, 0, -0.5])


def test_estimator_matches_jax():
    s = _body_state(3)
    got = port_est.estimate(*(torch.tensor(s[k]) for k in ("pos", "quat", "vel_b", "ang_b", "feet_b")))
    want = jax.vmap(jest.estimate)(*(jnp.asarray(s[k]) for k in ("pos", "quat", "vel_b", "ang_b", "feet_b")))
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name), 1e-10)


def _leg_inputs(seed):
    rng = np.random.default_rng(seed)
    q = np.concatenate([_q(seed), _q(seed + 1)], axis=1)
    qd = rng.uniform(-1, 1, (B, 10))
    tau = rng.uniform(-5, 5, (B, 10))
    cp = np.where(rng.random((B, 2)) < 0.5, -1.0, rng.random((B, 2)))
    sp = np.where(cp == -1.0, rng.random((B, 2)), -1.0)
    return q, qd, tau, cp, sp


def test_legs_match_jax():
    q, qd, tau, cp, sp = _leg_inputs(4)
    rng = np.random.default_rng(5)
    wrench = rng.uniform(-50, 50, (B, 2, 6))
    p_des = rng.uniform(-0.05, 0.05, (B, 2, 3)) + np.array([[0.0, 0.1, -0.5], [0.0, -0.1, -0.5]])
    v_des = rng.uniform(-0.5, 0.5, (B, 2, 3))
    td = tlegs.update_data(trobot.HECTOR, *(torch.tensor(a) for a in (q, qd, tau, cp, sp)))
    jd = jax.vmap(lambda *a: jlegs.update_data(jrobot.HECTOR, *a))(
        *(jnp.asarray(a) for a in (q, qd, tau, cp, sp)))
    for name in jd._fields:
        _close(getattr(td, name), getattr(jd, name), 1e-10)
    tc = tlegs.init_command(B, 5, torch.float64)
    tc.wrench_ff, tc.p_des, tc.v_des = (torch.tensor(a) for a in (wrench, p_des, v_des))
    jc = jax.vmap(lambda _: jlegs.init_command(5, jnp.float64))(jnp.arange(B))._replace(
        wrench_ff=jnp.asarray(wrench), p_des=jnp.asarray(p_des), v_des=jnp.asarray(v_des))
    tc = tlegs.update_command(trobot.HECTOR, td, tc)
    jc = jax.vmap(lambda d, c: jlegs.update_command(jrobot.HECTOR, d, c))(jd, jc)
    for name in jc._fields:
        _close(getattr(tc, name), getattr(jc, name), 1e-10)
    _close(tlegs.joint_torque(trobot.HECTOR, td, tc),
           jax.vmap(lambda d, c: jlegs.joint_torque(jrobot.HECTOR, d, c))(jd, jc), 1e-10)


def _swing_states(seed):
    rng = np.random.default_rng(seed)
    arrays = dict(first_swing=rng.random((B, 2)) < 0.5,
                  swing_time_remaining=rng.uniform(0, 0.125, (B, 2)),
                  p0=rng.uniform(-0.2, 0.2, (B, 2, 3)),
                  foot_placement_w=rng.uniform(-0.3, 0.3, (B, 2, 3)),
                  foot_placement_b=rng.uniform(-0.3, 0.3, (B, 2, 3)))
    t = tswing.SwingState(**{k: torch.tensor(v) for k, v in arrays.items()})
    j = jswing.SwingState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return t, j


@pytest.mark.parametrize("frame", ["base", "world"])
@pytest.mark.parametrize("curve", ["bezier", "cycloid"])
def test_swing_matches_jax(frame, curve):
    ts, js = _swing_states(6)
    s = _body_state(7)
    rng = np.random.default_rng(8)
    _, _, _, cp, sp = _leg_inputs(9)
    rot = np.asarray(jax.vmap(jest.estimate)(*(jnp.asarray(s[k]) for k in (
        "pos", "quat", "vel_b", "ang_b", "feet_b"))).rotation_body)
    vel_w = rng.uniform(-0.5, 0.5, (B, 3))
    vel_des_b = rng.uniform(-0.5, 0.5, (B, 3))
    dur = np.full((B, 2), 0.125)
    hips = np.stack([np.asarray(jhector.hip_horizontal_location(leg, jnp.float64)) for leg in (0, 1)])
    height, cp1, cp2 = (rng.uniform(lo, hi, B) for lo, hi in ((0.05, 0.15), (0.2, 0.4), (0.6, 0.8)))
    t = torch.tensor

    tswing.update_swing_time(ts, t(cp), t(dur), 0.001)
    js = jax.vmap(lambda st, c, d: jswing.update_swing_time(st, c, d, 0.001))(js, cp, dur)
    tswing.compute_foot_placement(ts, t(s["pos"]), t(rot), t(vel_w), t(vel_des_b), t(hips))
    js = jax.vmap(lambda st, a, r, v, vd: jswing.compute_foot_placement(st, a, r, v, vd, hips))(
        js, s["pos"], rot, vel_w, vel_des_b)
    if frame == "world":
        args = (sp, cp, dur, s["feet_b"], s["pos"], vel_w, rot, height, cp1, cp2)
        p_t, v_t = tswing.compute_foot_desired_position_world(ts, *(t(a) for a in args), curve=curve)
        js, p_j, v_j = jax.vmap(lambda st, *a: jswing.compute_foot_desired_position_world(
            st, *a, curve=curve))(js, *args)
    else:
        args = (sp, cp, dur, s["feet_b"], height, cp1, cp2)
        p_t, v_t = tswing.compute_foot_desired_position(ts, *(t(a) for a in args), curve=curve)
        js, p_j, v_j = jax.vmap(lambda st, *a: jswing.compute_foot_desired_position(
            st, *a, curve=curve))(js, *args)
    _close(p_t, p_j, 1e-10)
    _close(v_t, v_j, 1e-10)
    for name in js._fields:
        _close(getattr(ts, name), getattr(js, name), 1e-10)

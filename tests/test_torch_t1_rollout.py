"""The Booster T1 in the port's closed loop against the JAX examples on the
CPU: the whole rollout at float64 (3 cycles, `solver="pallas_ric_aug"`, JAX's
Pallas kernel run by the interpreter) for "T1-newton" and for "T1" with the
exact observation IK, and the host loop `simulate` in float32 for a few
ticks; HECTOR refuses the T1 knob."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu.control.controller import BipedControllerCore as JaxCore
from biped_pympc_tpu_torch.convert import rollout_carry_from_numpy
from biped_pympc_tpu_torch.examples import closed_loop_sim, tpu_rollout

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import closed_loop_sim as jsim  # noqa: E402
import tpu_rollout as jrollout  # noqa: E402

torch.set_num_threads(1)
B = 4
CYCLES = 3
HEIGHT = 0.62


@pytest.mark.parametrize("robot, obs_ik", [("T1-newton", "robot"), ("T1", "newton")])
def test_t1_rollout_matches_jax(robot, obs_ik):
    """3 cycles from the JAX carry at float64 (bound 1e-8, as
    `test_torch_rollout.test_rollout_matches_jax`)."""
    cfg = jrollout.ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08)
    jcore = JaxCore(cfg, jrollout.MPCConf(solver="pallas_ric_aug", robot=robot, f_max=1450.0,
                                          verbose=False), gait_id=2, dtype=jnp.float64)
    rollout, cycles = jrollout.make_rollout(jcore, CYCLES * 0.01 + 1e-4, obs_ik=obs_ik)
    assert cycles == CYCLES
    state, x, foot_w = jrollout.init_carry(jcore, B, 0.3, HEIGHT)
    jcarry = (state, x.astype(jnp.float64), foot_w.astype(jnp.float64))
    _, jtraj = rollout(jcarry)

    core = tpu_rollout.make_core("pallas_ric_aug", robot, dtype=torch.float64, device="cpu",
                                 verbose=False)
    port_init = tpu_rollout.init_carry(core, B, 0.3, HEIGHT)
    carry = rollout_carry_from_numpy(jax.tree.map(np.asarray, jcarry), torch.float64)
    for a, b in ((port_init[1], carry[1]), (port_init[2], carry[2])):
        assert torch.equal(a, b)  # init_carry rounds as the JAX example does
    port, _ = tpu_rollout.make_rollout(core, CYCLES * 0.01 + 1e-4, obs_ik=obs_ik)
    _, traj = port(carry)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0, atol=1e-8)
    assert np.abs(traj[-1, :, 5].numpy() - HEIGHT).max() < 0.07


def test_t1_simulate_matches_jax():
    """`simulate(robot_name="T1", obs_ik="newton")` against JAX's for 20
    ticks (two MPC solves), both in float32 as the JAX example runs; the JAX
    example keeps a snapshot every 50 ticks, so the first tick's. The T1
    loop amplifies float32 roundoff: after 30 ticks the port's float32 and
    float64 runs part by ~460 N in fz, so only the first tick is held, its
    force to the JAX package's float32 bound (0.5 N)."""
    kw = dict(num_envs=2, seconds=0.02, robot_name="T1", obs_ik="newton", verbose=False)
    want = jsim.simulate(**kw)
    got = closed_loop_sim.simulate(**kw, every=50, device="cpu")
    for name in ("pos", "rpy", "vx", "fz"):
        assert got[name].shape == want[name].shape, name
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["rpy"], want["rpy"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["vx"], want["vx"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["fz"], want["fz"], rtol=0, atol=0.5)


def test_hector_refuses_the_t1_knob():
    """obs_ik="newton" is a T1 knob (`closed_loop_sim.py:103-105`)."""
    with pytest.raises(ValueError, match="T1 knob"):
        closed_loop_sim.simulate(1, 0.001, obs_ik="newton", verbose=False, device="cpu")
    core = tpu_rollout.make_core(device="cpu", verbose=False)
    with pytest.raises(ValueError, match="T1 knob"):
        tpu_rollout.make_rollout(core, 0.01, obs_ik="newton")
    with pytest.raises(ValueError, match="obs_ik must be"):
        tpu_rollout.make_rollout(core, 0.01, obs_ik="encoders")

"""The port's closed loop (`biped_pympc_tpu_torch/examples/`) against the JAX
examples on the CPU, float64: the SRBD oracle (`dynamics_rhs`,
`rk4_step_generic`), the rollout's closed-form plant step, the plant, the
whole rollout (`solver="pallas_ric_aug"`, JAX's Pallas kernel run by the
interpreter) and the host loop `simulate` against the rollout, tick for
tick. Also: one cycle copies no constant from the host, and the entry points
need a card unless asked for the CPU."""

import sys
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import biped_pympc_tpu.models.srbd as jsrbd
from biped_pympc_tpu.control.controller import BipedControllerCore as JaxCore
from biped_pympc_tpu.models.robot import get_robot as jax_robot
from biped_pympc_tpu.utils.maths import quat_to_rotmat as jquat_to_rotmat
from biped_pympc_tpu_torch.convert import rollout_carry_from_numpy
from biped_pympc_tpu_torch.examples import closed_loop_sim, srbd_plant, tpu_rollout
from biped_pympc_tpu_torch.models import srbd
from biped_pympc_tpu_torch.models.robot import HECTOR

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import srbd_plant as jplant  # noqa: E402
import tpu_rollout as jrollout  # noqa: E402

torch.set_num_threads(1)
B = 4
CYCLES = 3
# The examples' height is 0.5 here, exact in float32, so that the host loop
# (plant height as given) and the rollout (rounded to float32, as JAX
# rounds it) start from the same state.
HEIGHT = 0.5


def _lin_inputs(rng, b):
    """Random linearization points, states and inputs of the examples' plant."""
    rpy = rng.uniform(-0.3, 0.3, (b, 3))
    x = np.concatenate([rpy, rng.uniform(-0.5, 0.5, (b, 3)) + [0, 0, 0.5],
                        rng.uniform(-1, 1, (b, 6))], axis=1)
    u = rng.uniform(-80, 80, (b, 12))
    feet = rng.uniform(-0.3, 0.3, (b, 2, 3))
    return x, u, feet


def _lins(x, feet, robot):
    """The same SRBD linearization in JAX (per env) and in the port (batched)."""
    quat = np.asarray(srbd_plant.euler_to_quat(torch.tensor(x[:, :3])))
    rot = np.asarray(jax.vmap(jquat_to_rotmat)(jnp.asarray(quat)))
    ib = np.asarray(robot.i_body)
    iw = rot @ ib @ rot.transpose(0, 2, 1)
    res = np.array([0.1, -0.2, 0.3])
    jl = [jsrbd.SrbdLin(rot_body=jnp.asarray(rot[i]), inertia_world=jnp.asarray(iw[i]),
                        body_pos=jnp.asarray(x[i, 3:6]), foot_pos=jnp.asarray(feet[i]),
                        mass=jnp.float64(robot.mass), residual_lin_accel=jnp.asarray(res),
                        residual_ang_accel=jnp.asarray(-res)) for i in range(len(x))]
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    tl = srbd.SrbdLin(rot_body=t(rot), inertia_world=t(iw), body_pos=t(x[:, 3:6]),
                      foot_pos=t(feet), mass=t(np.full(len(x), robot.mass)),
                      residual_lin_accel=t(np.tile(res, (len(x), 1))),
                      residual_ang_accel=t(np.tile(-res, (len(x), 1))))
    return jl, tl, rot


@pytest.mark.parametrize("mode", ["rt_omega", "r_omega"])
def test_dynamics_rhs_and_rk4_match_jax(mode):
    x, u, feet = _lin_inputs(np.random.default_rng(0), B)
    jl, tl, _ = _lins(x, feet, jax_robot("HECTOR"))
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    rhs = srbd.dynamics_rhs(tl, t(x), t(u), mode).numpy()
    step = srbd.rk4_step_generic(tl, t(x), t(u), 0.001, mode).numpy()
    for i in range(B):
        np.testing.assert_allclose(rhs[i], np.asarray(jsrbd.dynamics_rhs(
            jl[i], jnp.asarray(x[i]), jnp.asarray(u[i]), mode)), rtol=0, atol=1e-12)
        np.testing.assert_allclose(step[i], np.asarray(jsrbd.rk4_step_generic(
            jl[i], jnp.asarray(x[i]), jnp.asarray(u[i]), 0.001, mode)), rtol=0, atol=1e-12)


def test_affine_rk4_closed_form_matches_oracle():
    """The twin of tests/test_tpu_rollout.py::test_affine_rk4_closed_form_matches_oracle
    at float64: the closed form against the port's literal RK4, with the
    closed form's float32-rounded constants (`make_affine_rk4_step`) given to
    the oracle too."""
    x, u, feet = _lin_inputs(np.random.default_rng(1), 16)
    _, tl, rot = _lins(x, feet, HECTOR)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    got = tpu_rollout.make_affine_rk4_step(HECTOR, 0.001)(t(x), t(u).reshape(-1, 4, 3),
                                                          t(feet), t(rot))
    i_inv32 = np.asarray(tpu_rollout.inverse_3x3(torch.tensor(HECTOR.i_body, dtype=torch.float32)),
                         np.float64)
    inertia = rot @ np.linalg.inv(i_inv32) @ rot.transpose(0, 2, 1)
    zeros = t(np.zeros((16, 3)))
    lin = srbd.SrbdLin(rot_body=tl.rot_body, inertia_world=t(inertia),
                       body_pos=tl.body_pos, foot_pos=tl.foot_pos,
                       mass=t(np.full(16, float(np.float32(HECTOR.mass)))),
                       residual_lin_accel=zeros, residual_ang_accel=zeros)
    g32 = float(np.float32(srbd.GRAVITY))
    want = srbd.rk4_step_generic(lin, t(x), t(u), 0.001)
    # The oracle's gravity is 9.81 in float64; the closed form's is rounded
    # to float32: v moves by dt (9.81 - g32), p by dt^2 / 2 of it.
    want[:, 11] -= 0.001 * (g32 - srbd.GRAVITY)
    want[:, 5] -= 0.5e-6 * (g32 - srbd.GRAVITY)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


def test_plant_matches_jax_plant():
    """`SrbdPlant` (float32) against the JAX example's plant on the same state:
    the observation and one step, within float32 roundoff (the JAX plant keeps
    its state in float64 between float32 steps)."""
    rng = np.random.default_rng(2)
    jp = jplant.SrbdPlant(jax_robot("HECTOR"), B, height=0.55, dt=0.001)
    tp = srbd_plant.SrbdPlant(HECTOR, B, height=0.55, dt=0.001, device="cpu")
    x = np.zeros((B, 12))
    x[:, :3] = rng.uniform(-0.1, 0.1, (B, 3))
    x[:, 3:6] = [0.02, -0.01, 0.55]
    x[:, 6:] = rng.uniform(-0.3, 0.3, (B, 6))
    x = x.astype(np.float32).astype(np.float64)
    feet = (jp.foot_w + rng.uniform(-0.02, 0.02, (B, 2, 3)) * [1, 1, 0]).astype(np.float32)
    jp.x, jp.foot_w = x.copy(), feet.astype(np.float64)
    tp.x, tp.foot_w = torch.tensor(x, dtype=torch.float32), torch.tensor(feet)
    np.testing.assert_allclose(tp.observation().numpy(), jp.observation(), rtol=0, atol=2e-6)
    grf = np.tile([5.0, 2.0, 140.0, -4.0, 1.0, 0.0, 0.0, 0.3, 0.1, 0.0, -0.2, 0.0], (B, 1))
    contact = np.array([[1.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]])
    p_des = rng.uniform(-0.1, 0.1, (B, 2, 3)) + [0.0, 0.0, -0.5]
    jp.step(grf, contact, p_des)
    gated = tp.step(grf, contact, p_des)
    np.testing.assert_allclose(tp.foot_w.numpy(), jp.foot_w, rtol=0, atol=5e-7)
    np.testing.assert_allclose(tp.x.numpy(), jp.x, rtol=0, atol=2e-6)
    assert float(gated[2, :3].abs().max()) == 0.0 and float(gated[0, 3:6].abs().max()) == 0.0


@pytest.fixture(scope="module")
def jax_rollout():
    """3 cycles of the JAX rollout at float64, pallas_ric_aug interpreted,
    from its own float32 `init_carry` in float64, B 4."""
    cfg = jrollout.ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08)
    core = JaxCore(cfg, jrollout.MPCConf(solver="pallas_ric_aug", verbose=False), gait_id=2,
                   dtype=jnp.float64)
    rollout, cycles = jrollout.make_rollout(core, CYCLES * 0.01 + 1e-4)
    assert cycles == CYCLES
    state, x, foot_w = jrollout.init_carry(core, B, 0.3, HEIGHT)
    carry = (state, x.astype(jnp.float64), foot_w.astype(jnp.float64))
    _, traj = rollout(carry)
    return jax.tree.map(np.asarray, carry), np.asarray(traj)


def _port_core(dtype=torch.float64, solver="pallas_ric_aug"):
    return tpu_rollout.make_core(solver, dtype=dtype, device="cpu", verbose=False)


def test_rollout_matches_jax(jax_rollout):
    """The port's rollout from the JAX carry (`convert.rollout_carry_from_numpy`)
    against the JAX rollout, 3 cycles at float64 (bound 1e-8)."""
    jcarry, jtraj = jax_rollout
    core = _port_core()
    port_init = tpu_rollout.init_carry(core, B, 0.3, HEIGHT)
    carry = rollout_carry_from_numpy(jcarry, torch.float64)
    for a, b in ((port_init[1], carry[1]), (port_init[2], carry[2])):
        assert torch.equal(a, b)  # init_carry rounds as the JAX example does
    rollout, cycles = tpu_rollout.make_rollout(core, CYCLES * 0.01 + 1e-4)
    _, traj = rollout(carry)
    assert traj.shape == (CYCLES, B, 12)
    np.testing.assert_allclose(traj.numpy(), jtraj, rtol=0, atol=1e-8)
    assert np.abs(jtraj[-1, :, 3] - jtraj[0, :, 3]).min() > 1e-4  # it moves


def test_simulate_matches_rollout_tick_for_tick():
    """The host loop (`simulate`, literal RK4 plant) against the rollout
    (closed form), both float64 with the same controller, after each of the
    first 3 cycles. Beyond float64 roundoff the two plants differ in gravity:
    the closed form's is -9.81 rounded to float32, as in JAX
    (`tpu_rollout.py:66`), 4.2e-7 m/s^2 off the literal RK4's. Over 30 ticks
    that moves z by ~1.9e-10 m and v_z by ~1.3e-8 m/s (1.6e-10 measured in
    the positions); bound 1e-8 on the positions, angles and vx."""
    out = closed_loop_sim.simulate(num_envs=2, seconds=CYCLES * 0.01, solver="ric_aug",
                                   height=HEIGHT, every=1, verbose=False, dtype=torch.float64,
                                   plant_dtype=torch.float64, device="cpu")
    core = _port_core(solver="ric_aug")
    rollout, _ = tpu_rollout.make_rollout(core, CYCLES * 0.01 + 1e-4)
    _, traj = rollout(tpu_rollout.init_carry(core, 2, 0.3, HEIGHT))
    ticks = np.arange(1, CYCLES + 1) * 10 - 1  # x after 10, 20, 30 ticks
    np.testing.assert_allclose(out["pos"][ticks], traj[:, :, 3:6].numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["rpy"][ticks], traj[:, :, 0:3].numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(out["vx"][ticks], traj[:, :, 9].numpy(), rtol=0, atol=1e-8)
    assert out["fz"].shape == (CYCLES * 10, 2, 2)


def _has_sequence(index) -> bool:
    index = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, (list, np.ndarray)) for i in index)


class _HostCopies(TorchFunctionMode):
    """Records the calls that, on the card, copy from pageable host memory or
    read a tensor on the host, and so wait for the stream, which a CUDA graph
    capture refuses: a tensor built from Python data, a Python sequence as an
    index, a tensor's value read as a Python number. (A Python number written
    into a tensor is a fill, not a copy.)"""

    READS = ("item", "tolist", "__bool__", "__int__", "__float__", "nonzero")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if (name in self.READS or name == "tensor"
                or (name == "as_tensor" and not torch.is_tensor(args[0]))
                or (name in ("__getitem__", "__setitem__") and _has_sequence(args[1]))):
            self.seen.append(f"{name} at {traceback.extract_stack(limit=2)[0]}")
        return func(*args, **(kwargs or {}))


def _kernel_path(monkeypatch):
    """`pdipm_cuda.solve` on CPU tensors as it runs on the card: the kernel
    wrapper's own tensor work (`run_kernel`: the inputs, the outputs, a
    workspace) around a stand-in library whose entries launch nothing."""
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    class Fake:
        def __getattr__(self, name):
            return lambda *args: 0

    def solve(qp, opts, state=None):
        res = pdipm_cuda.run_kernel(Fake(), qp, opts, None, state)
        return type(res)(*(torch.zeros_like(t) for t in (res.x, res.s, res.z, res.y,
                                                        res.residuals)))

    monkeypatch.setattr(pdipm_cuda, "solve", solve)
    # The stand-in's launches count in copies, not in the process's counts
    # that other tests of the same worker read.
    monkeypatch.setattr(pdipm_cuda, "launches", dict(pdipm_cuda.launches))
    monkeypatch.setattr(pdipm_cuda, "warp_launches", dict(pdipm_cuda.warp_launches))


@pytest.mark.parametrize("solver", ["pallas_ric_aug", "tridiag_aug"])
def test_cycle_copies_no_constant_from_the_host(solver, monkeypatch):
    """After one warm-up cycle (which fills the constant caches), a cycle of
    `ingest_state`, `run_mpc` and `run_lowlevel` with the plant, the solve on
    its kernel path, builds no tensor from host data and reads none on the
    host; nor does `joint_torque`."""
    _kernel_path(monkeypatch)
    core = _port_core(torch.float32, solver)
    state, x, foot_w = tpu_rollout.init_carry(core, 2, 0.3, 0.55)
    cycle = tpu_rollout.make_cycle(core, tpu_rollout.make_affine_rk4_step(core.robot, 0.001))
    x, foot_w = cycle(state, x, foot_w)
    core.joint_torque(state)
    mode = _HostCopies()
    with mode:
        x, foot_w = cycle(state, x, foot_w)
        core.joint_torque(state)
    assert mode.seen == []


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    """Without a card, each entry point raises unless asked for the CPU."""
    from biped_pympc_tpu_torch.examples import rl_env, rl_env_tpu, train_rl_mpc, train_rl_mpc_tpu

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda **kw: srbd_plant.SrbdPlant(HECTOR, 1, 0.55, 0.001, **kw),
             lambda **kw: closed_loop_sim.simulate(1, 0.001, verbose=False, **kw),
             lambda **kw: tpu_rollout.run(1, 0.01, **kw),
             lambda **kw: rl_env.RlMpcEnv(1, **kw),
             lambda **kw: rl_env_tpu.make_device_env(1, **kw),
             lambda **kw: train_rl_mpc.train(iters=0, n_dirs=1, envs_per=1, **kw),
             lambda **kw: train_rl_mpc_tpu.train(iters=0, n_dirs=1, envs_per=1, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
        call(device="cpu")

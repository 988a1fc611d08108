"""Whole-rollout closed-loop walking on the card (twin of
`examples/tpu_rollout.py`).

`closed_loop_sim.py` drives the control stack from a host loop, several
calls a 1 kHz tick. Here one MPC cycle (assemble the observation,
`ingest_state`, `run_mpc`, then `decimation` x (`run_lowlevel` + plant
tick), the snapshot written into a preallocated trajectory) is captured once
as a CUDA graph and replayed once per cycle: the host issues one replay a
cycle and nothing waits for the device in between. That is the H100's
counterpart of the JAX example's single `lax.scan` program. On the CPU the
same cycle runs eagerly. The tick order is `closed_loop_sim.simulate`'s.

Run:  python -m biped_pympc_tpu_torch.examples.tpu_rollout [num_envs] [seconds]
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from biped_pympc_tpu_torch.config import ControllerConf, MPCConf
from biped_pympc_tpu_torch.control.controller import BipedControllerCore, ControllerState
from biped_pympc_tpu_torch.examples.cuda_graph import LoopStep, copy_into, tree_map
from biped_pympc_tpu_torch.examples.srbd_plant import (assemble_obs, gate_grf, nominal_feet,
                                                       pin_feet)
from biped_pympc_tpu_torch.models import srbd, t1
from biped_pympc_tpu_torch.ops.linalg import inverse_3x3
from biped_pympc_tpu_torch.utils.consts import const
from biped_pympc_tpu_torch.utils.tracing import mark


def make_affine_rk4_step(robot, dt: float):
    """Closed-form RK4 step of the affine SRBD model, batched
    (`tpu_rollout.py:49`).

    Within a tick the affine model's angular and linear accelerations c_w,
    c_v are constant and only rpy_dot = R^T w, p_dot = v depend on the
    state, so the literal 4-stage RK4 (`srbd.rk4_step_generic`) collapses
    exactly to
        w+ = w + dt c_w                v+ = v + dt c_v
        rpy+ = rpy + dt R^T (w + dt/2 c_w)
        p+   = p + dt (v + dt/2 c_v)
    in the carry's dtype. I_b^-1, the mass and gravity are rounded to
    float32 first, as the JAX example rounds them even under x64
    (`tpu_rollout.py:64-66`).
    """
    i_inv32 = inverse_3x3(torch.tensor(robot.i_body, dtype=torch.float32))
    i_body_inv = i_inv32.numpy()
    mass = float(np.float32(robot.mass))
    g_vec = (0.0, 0.0, float(np.float32(-srbd.GRAVITY)))

    def step(x, u, foot_w, rot):
        """x (B, 12), u (B, 4, 3) [F_L, F_R, M_L, M_R] world, foot_w (B, 2, 3),
        rot (B, 3, 3) body-to-world at the linearization point."""
        dtype, dev = x.dtype, x.device
        rpy, pos, w, v = x[:, 0:3], x[:, 3:6], x[:, 6:9], x[:, 9:12]
        # Torque about the body, skew(p_f - p_b) F + M, then
        # I_w^-1 tau = R I_b^-1 R^T tau.
        r_feet = foot_w - pos[:, None, :]
        tau = (torch.linalg.cross(r_feet[:, 0], u[:, 0], dim=-1)
               + torch.linalg.cross(r_feet[:, 1], u[:, 1], dim=-1) + u[:, 2] + u[:, 3])
        rt_tau = (rot.transpose(-1, -2) @ tau[..., None])
        c_w = (rot @ (const(i_body_inv, dtype, dev) @ rt_tau))[..., 0]
        c_v = (u[:, 0] + u[:, 1]) / const(mass, dtype, dev) + const(g_vec, dtype, dev)
        # rt_omega mode: rpy_dot = R^T w (the shipped CUDA convention).
        w_mid = w + (dt / 2) * c_w
        rpy_dot = (rot.transpose(-1, -2) @ w_mid[..., None])[..., 0]
        return torch.cat([rpy + dt * rpy_dot, pos + dt * (v + (dt / 2) * c_v), w + dt * c_w,
                          v + dt * c_v], dim=1)

    return step


def obs_ik_fn(obs_ik: str, robot_name: str):
    """The IK standing in for the joint encoders when the observation is
    assembled: None (the controller robot's own IK) for "robot", T1's exact
    Gauss-Newton IK (`models/t1.analytical_ik_newton`) for "newton", which
    is a T1 knob: HECTOR's IK is exact, and asking for it there raises
    ValueError (`closed_loop_sim.py:103-105`)."""
    if obs_ik == "newton":
        if not robot_name.startswith("T1"):
            raise ValueError("obs_ik='newton' is a T1 knob (HECTOR IK is exact)")
        return t1.analytical_ik_newton
    if obs_ik != "robot":
        raise ValueError(f"obs_ik must be 'robot' or 'newton', got {obs_ik!r}")
    return None


def make_cycle(core: BipedControllerCore, plant_step, obs_ik=None):
    """cycle(state, x, foot_w) -> (x, foot_w): one MPC cycle of the
    closed loop, `closed_loop_sim.simulate`'s tick order: tick 0 ingests the
    observation and solves the MPC, whose world-frame GRFs hold for the
    cycle; every tick runs the low-level control, moves the feet and steps
    the plant with `plant_step(x, u (B, 4, 3), foot_w, rot)`. `obs_ik` is
    the observation's IK (`obs_ik_fn`; None the robot's own). `state` is
    updated in place (its leaves replaced). Each tick marks the phases
    `obs` and `plant` on the card (`utils/tracing.mark`); the core marks
    `ingest`, `assembly` and `lowlevel`."""
    robot = core.robot

    def tick(state, x, foot_w, grf=None):
        mark("obs", x)
        obs, rot = assemble_obs(robot, x, foot_w, obs_ik)
        core.ingest_state(state, obs)
        if grf is None:
            grf = core.run_mpc(state).grf_world
        core.run_lowlevel(state)
        mark("plant", x)
        contact = (state.contact_phase != -1).to(x.dtype)
        foot_w = pin_feet(x, foot_w, rot, contact, state.leg_cmd.p_des)
        u = gate_grf(grf, contact).reshape(-1, 4, 3)
        return plant_step(x, u, foot_w, rot), foot_w, grf

    def cycle(state: ControllerState, x, foot_w):
        x, foot_w, grf = tick(state, x, foot_w)
        for _ in range(core.mpc_cfg.decimation - 1):
            x, foot_w, _ = tick(state, x, foot_w, grf)
        return x, foot_w

    return cycle


@dataclasses.dataclass
class RolloutCarry:
    """What one captured cycle reads and writes: the closed loop's carry, the
    trajectory (cycles, B, 12) and the index of the next snapshot."""

    state: ControllerState
    x: torch.Tensor
    foot_w: torch.Tensor
    traj: torch.Tensor
    index: torch.Tensor  # (1,) int64


class Rollout:
    """rollout(carry) -> (carry, traj): `cycles` MPC cycles from carry =
    (state, x, foot_w); traj (cycles, B, 12) holds x after each cycle. The
    cycle is captured as a CUDA graph at the first call on the card (`graph`
    None) and replayed once a cycle; `graph=False` runs it eagerly there too.
    The returned carry and traj are the rollout's own buffers, overwritten by
    the next call: clone them to keep them."""

    def __init__(self, cycle, cycles: int, graph: bool | None = None):
        self.cycle, self.cycles, self.graph = cycle, cycles, graph
        self.loop = None

    def _step(self, c: RolloutCarry) -> None:
        c.x, c.foot_w = self.cycle(c.state, c.x, c.foot_w)
        mark("carry", c.x)
        c.traj.index_copy_(0, c.index, c.x[None])
        c.index.add_(1)

    def __call__(self, carry):
        state, x, foot_w = carry
        own = self.loop.carry if self.loop is not None else None
        if own is None or own.x.shape != x.shape:
            own = RolloutCarry(tree_map(torch.clone, state), x.clone(), foot_w.clone(),
                               x.new_zeros(self.cycles, *x.shape),
                               torch.zeros(1, dtype=torch.int64, device=x.device))
            self.loop = LoopStep(self._step, own, self.graph)
        else:
            copy_into((own.state, own.x, own.foot_w), (state, x, foot_w))
        own.index.zero_()
        for _ in range(self.cycles):
            self.loop()
        return (own.state, own.x, own.foot_w), own.traj


def make_rollout(core: BipedControllerCore, seconds: float, obs_ik: str = "robot",
                 graph: bool | None = None):
    """(rollout, cycles) (`tpu_rollout.py:98`): `Rollout` over
    int(seconds / dt) // decimation cycles of `make_cycle` with the closed-form
    plant (`make_affine_rk4_step`). obs_ik "robot" is the controller robot's
    own IK as the encoder stand-in, "newton" T1's exact IK for the
    observation only (`obs_ik_fn`)."""
    ik = obs_ik_fn(obs_ik, core.robot.name)
    dt = core.mpc_cfg.dt
    cycles = int(seconds / dt) // core.mpc_cfg.decimation
    cycle = make_cycle(core, make_affine_rk4_step(core.robot, dt), ik)
    return Rollout(cycle, cycles, graph), cycles


def init_carry(core: BipedControllerCore, num_envs: int, vx: float, height: float):
    """(state, x, foot_w) at the nominal standing state with the command set
    (`tpu_rollout.py:190`), in the controller's dtype. vx, the height and
    the hips are rounded to float32 first, as the JAX example builds them in
    float32 even under x64 (`tpu_rollout.py:190-204`)."""
    dtype, dev = core.dtype, core.device
    vx32, h32 = float(np.float32(vx)), float(np.float32(height))
    state = core.init_state(num_envs)
    twist = torch.zeros(num_envs, 3, dtype=dtype, device=dev)
    twist[:, 0] = vx32
    core.set_command(state, twist, torch.full((num_envs,), h32, dtype=dtype, device=dev))
    x = torch.zeros(num_envs, 12, dtype=dtype, device=dev)
    x[:, 5] = h32
    return state, x, nominal_feet(core.robot, num_envs, dtype, dev)


def make_core(solver: str = "tridiag_aug", robot_name: str = "HECTOR", dtype=torch.float32,
              device=None, verbose: bool = True) -> BipedControllerCore:
    """The examples' controller: walking gait, 5-step single support, 8 cm
    swing height, HECTOR's 500 N force cap and, for T1, the same ~3.7x-mg
    authority, 1450 N (`tpu_rollout.py:210-216`)."""
    cfg = ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08)
    f_max = 500.0 if robot_name == "HECTOR" else 1450.0
    return BipedControllerCore(cfg, MPCConf(solver=solver, robot=robot_name, f_max=f_max,
                                            verbose=verbose),
                               gait_id=2, dtype=dtype, device=device)


def run(num_envs: int = 4, seconds: float = 2.0, vx: float = 0.3, solver: str = "tridiag_aug",
        robot_name: str = "HECTOR", height: float | None = None, obs_ik: str = "robot",
        device=None) -> np.ndarray:
    """The rollout of `num_envs` bipeds walking at vx; returns the trajectory
    (cycles, B, 12) as numpy (`tpu_rollout.py:207`). `device` None is the
    card; `robot_name` "HECTOR", "T1" or "T1-newton" (at 0.62 m unless
    `height` is given)."""
    core = make_core(solver, robot_name, device=device)
    if height is None:
        height = 0.55 if robot_name == "HECTOR" else 0.62
    rollout, _ = make_rollout(core, seconds, obs_ik)
    _, traj = rollout(init_carry(core, num_envs, vx, height))
    return traj.cpu().numpy()


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    secs = float(sys.argv[2]) if len(sys.argv) > 2 else 2.0
    t0 = time.perf_counter()
    traj = run(n, secs)
    wall = time.perf_counter() - t0
    print(f"rolled out {traj.shape[0]} MPC cycles x {n} envs, one captured cycle replayed per "
          f"cycle on the card, in {wall:.2f} s (build and capture included)")
    print(f"final body position (env 0): {traj[-1, 0, 3:6].round(3)}")
    print(f"final vx (env 0): {traj[-1, 0, 9]:.3f}")

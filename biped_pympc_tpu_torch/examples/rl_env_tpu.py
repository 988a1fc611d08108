"""Device-resident RL-MPC environment (twin of `examples/rl_env_tpu.py`).

`rl_env.RlMpcEnv` drives the controller from the host, several calls a tick.
Here the same environment (knob application, the decimated control cycle,
the kinematic-feet SRBD plant, fall detection, masked reset, reward) is a
function of an explicit carry, and `make_rollout` evaluates a population of
per-env linear policies: on the card one RL step (the policy, one MPC cycle,
the reward and the masked reset) is captured once as a CUDA graph and
replayed `steps` times, the returns summed in a buffer the graph owns. Each
env's knobs, its sampling time and B-matrix residual included, are data of
the action, so one capture serves every action.

Layout: obs (B, 14) = [rpy, height, w_w, v_w, contact state, swing phase]
(`rl_env.RlMpcEnv._rl_obs`); action (B, 10) or (B, 16) (see `rl_env.py`);
policy a per-env linear map w (B, act, 14), action = tanh(w @ obs).
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from biped_pympc_tpu_torch.control.controller import ControllerState
from biped_pympc_tpu_torch.examples.cuda_graph import LoopStep, copy_into, tree_map
from biped_pympc_tpu_torch.examples.rl_env import (ACT_DIM, ACT_DIM_MATRIX, OBS_DIM,
                                                   matrix_residual_b)
from biped_pympc_tpu_torch.examples.tpu_rollout import (init_carry, make_affine_rk4_step,
                                                        make_core, make_cycle)

__all__ = ["ACT_DIM", "ACT_DIM_MATRIX", "OBS_DIM", "EnvCarry", "make_device_env",
           "make_rollout"]


@dataclasses.dataclass
class EnvCarry:
    state: ControllerState  # controller state, (B,) leaves
    x: torch.Tensor  # (B, 12) plant body state
    foot_w: torch.Tensor  # (B, 2, 3) world foot positions


def make_device_env(num_envs: int, vx_cmd: float = 0.3, solver: str = "pallas_ric_aug",
                    height: float = 0.55, plant_mass_scale: float = 1.0,
                    matrix_residual: bool = False, plant_force_scale=None, device=None):
    """(env_step, reset_all, rl_obs, core) of a device-resident env
    (`rl_env_tpu.py:56`); `device` None is the card.

    env_step(carry, action) -> (carry, reward (B,), done (B,) bool): one RL
    step = one MPC cycle, in `rl_env.RlMpcEnv.step`'s order (knobs, the
    decimated loop, score, masked reset of the fallen envs); it replaces the
    given carry's leaves and returns it. reset_all() -> EnvCarry at the
    nominal standing state with the command set. rl_obs(carry) -> (B, 14).

    plant_mass_scale scales the PLANT's mass while the MPC keeps the nominal
    model; plant_force_scale (3,) scales the force the plant receives per
    axis (an error proportional to the commanded force, which the B-matrix
    residual dims parameterize). matrix_residual grows the action to 16
    dims; the residual leaves exist from the reset on, so the carry's
    structure, and a capture, holds for every step.
    """
    core = make_core(solver, device=device, verbose=False)
    robot, dev = core.robot, core.device
    plant_robot = dataclasses.replace(robot, mass=robot.mass * plant_mass_scale)
    rk4_step = make_affine_rk4_step(plant_robot, core.mpc_cfg.dt)
    if plant_force_scale is None:
        plant_step = rk4_step
    else:
        fscale = torch.tensor(plant_force_scale, dtype=torch.float32, device=dev).reshape(1, 1, 3)

        def plant_step(x, u, foot_w, rot):
            # The plant delivers scaled FORCES (blocks 0-1 of [F_L, F_R, M_L, M_R]).
            return rk4_step(x, torch.cat([u[:, :2] * fscale, u[:, 2:]], dim=1), foot_w, rot)

    cycle = make_cycle(core, plant_step)
    _, x_nom, foot_nom = init_carry(core, num_envs, vx_cmd, height)
    zeros12 = torch.zeros(num_envs, 12, 12, device=dev)

    def reset_all() -> EnvCarry:
        state, x, foot_w = init_carry(core, num_envs, vx_cmd, height)
        if matrix_residual:
            state.residual_A, state.residual_B = zeros12.clone(), zeros12.clone()
        return EnvCarry(state, x, foot_w)

    def env_step(carry: EnvCarry, action: torch.Tensor):
        action = action.to(torch.float32).clamp(-1.0, 1.0)
        state = carry.state
        state.dt_mpc = 0.025 + 0.005 * action[:, 0]
        state.foot_height = 0.08 + 0.04 * action[:, 1]
        state.cp1 = 1.0 / 3.0 + 0.15 * action[:, 2]
        state.cp2 = 2.0 / 3.0 + 0.15 * action[:, 3]
        state.residual_lin_accel = 1.0 * action[:, 4:7]
        state.residual_ang_accel = 1.0 * action[:, 7:10]
        if matrix_residual:
            state.residual_B = matrix_residual_b(robot, action)
        x, foot_w = cycle(state, carry.x, carry.foot_w)

        # Falls and reward, with `rl_env.py`'s 0.55 generalized to the
        # commanded height (`rl_env_tpu.py:243-254`).
        fell = ((x[:, 0:2].abs().amax(dim=1) > 0.5) | (x[:, 5] < height - 0.25)
                | (x[:, 5] > height + 0.25))
        reward = (1.0 - 2.0 * (x[:, 9] - vx_cmd).abs() - 0.5 * (x[:, 5] - height).abs()
                  - 5.0 * fell.to(x.dtype))
        core.reset(state, fell)
        carry.x = torch.where(fell[:, None], x_nom, x)
        carry.foot_w = torch.where(fell[:, None, None], foot_nom, foot_w)
        return carry, reward, fell

    def rl_obs(carry: EnvCarry) -> torch.Tensor:
        state, x = carry.state, carry.x
        contact = (state.contact_phase != -1).to(x.dtype)
        sp = state.swing_phase
        swing = torch.where(sp == -1, torch.zeros_like(sp), sp).to(x.dtype)
        return torch.cat([x[:, 0:3], x[:, 5:6], x[:, 6:12], contact, swing], dim=1)

    return env_step, reset_all, rl_obs, core


@dataclasses.dataclass
class PopulationCarry:
    """What one captured RL step reads and writes: the env's carry, the
    policies (B, act, 14) and the summed rewards (B,)."""

    env: EnvCarry
    w: torch.Tensor
    total: torch.Tensor


class PopulationRollout:
    """rollout(carry, w_per_env) -> (carry, returns (B,)) over `steps` RL
    steps, each env under its own linear policy (`rl_env_tpu.py:275`). On the
    card (`graph` None) one RL step is captured at the first call and
    replayed; `graph=False` runs it eagerly. The returned carry and returns
    are the rollout's own buffers, overwritten by the next call."""

    def __init__(self, env_step, rl_obs, steps: int, graph: bool | None = None):
        self.env_step, self.rl_obs, self.steps, self.graph = env_step, rl_obs, steps, graph
        self.loop = None

    def _step(self, c: PopulationCarry) -> None:
        action = torch.tanh(torch.einsum("bao,bo->ba", c.w, self.rl_obs(c.env)))
        _, reward, _ = self.env_step(c.env, action)
        c.total = c.total + reward

    def __call__(self, carry: EnvCarry, w_per_env):
        w_per_env = torch.as_tensor(w_per_env, device=carry.x.device).to(carry.x.dtype)
        own = self.loop.carry if self.loop is not None else None
        if own is None or own.w.shape != w_per_env.shape:
            own = PopulationCarry(tree_map(torch.clone, carry), w_per_env.clone(),
                                  carry.x.new_zeros(carry.x.shape[0]))
            self.loop = LoopStep(self._step, own, self.graph)
        else:
            copy_into(own.env, carry)
            own.w.copy_(w_per_env)
        own.total.zero_()
        for _ in range(self.steps):
            self.loop()
        return own.env, own.total


def make_rollout(env_step, rl_obs, steps: int, graph: bool | None = None) -> PopulationRollout:
    """The population rollout of `steps` RL steps (`rl_env_tpu.py:266`)."""
    return PopulationRollout(env_step, rl_obs, steps, graph)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    env_step, reset_all, rl_obs, core = make_device_env(n)
    rollout = make_rollout(env_step, rl_obs, steps)
    carry = reset_all()
    w = torch.zeros(n, ACT_DIM, OBS_DIM, device=core.device)
    carry, returns = rollout(carry, w)
    print(f"{steps} RL steps x {n} envs, one captured step replayed per step on the card; "
          f"mean return {float(returns.mean()):.3f}")

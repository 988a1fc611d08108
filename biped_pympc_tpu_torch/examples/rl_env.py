"""Vectorized RL-MPC environment driven from the host (twin of
`examples/rl_env.py`).

The policy modulates the MPC's per-env knobs (`mpc_wrapper.py:48-64`) around
the kinematic-feet SRBD plant:

    env = RlMpcEnv(num_envs=64)
    obs = env.reset()
    for _ in range(200):
        action = policy(obs)            # (B, 10) in [-1, 1]
        obs, reward, done, info = env.step(action)

Action (B, 10), residuals on nominal values: [0] dt_mpc +-5 ms around 25 ms,
[1] swing height +-4 cm around 8 cm, [2], [3] Bezier control points +-0.15
around 1/3, 2/3, [4:7] residual linear and [7:10] angular accelerations
(+-1). With `matrix_residual=True` the action has 16 dims: [10:13] / [13:16]
scale the force / moment effectiveness rows of the SRBD B-matrix residual
(+-30%, `set_srbd_residual`). Episodes end on falls (|roll|, |pitch| > 0.5
or the height outside [0.3, 0.8]); fallen envs are reset (controller and
plant). Observations, rewards and dones are tensors on the env's device.

Run:  python -m biped_pympc_tpu_torch.examples.rl_env [num_envs] [steps]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from biped_pympc_tpu_torch.config import ControllerConf, MPCConf
from biped_pympc_tpu_torch.examples.srbd_plant import SrbdPlant
from biped_pympc_tpu_torch.wrapper import MPCController

OBS_DIM = 14
ACT_DIM = 10
ACT_DIM_MATRIX = 16  # with matrix_residual=True


def matrix_residual_b(robot, action: torch.Tensor) -> torch.Tensor:
    """(B, 12, 12) B-matrix residual of action dims 10:16: per axis, +-30% of
    1/m on the v_dot rows' force columns and of I_b^-1's diagonal on the
    omega_dot rows' moment columns (`rl_env.py:103-121`)."""
    b = action.shape[0]
    f = (0.3 / float(robot.mass)) * action[:, 10:13]
    i_inv_diag = torch.as_tensor(1.0 / np.diag(np.asarray(robot.i_body)), dtype=action.dtype,
                                 device=action.device)
    m = 0.3 * i_inv_diag * action[:, 13:16]
    eye = torch.eye(3, dtype=action.dtype, device=action.device)
    rb = action.new_zeros(b, 12, 12)
    rb[:, 9:12, 0:3] = f[:, :, None] * eye
    rb[:, 9:12, 3:6] = f[:, :, None] * eye
    rb[:, 6:9, 6:9] = m[:, :, None] * eye
    rb[:, 6:9, 9:12] = m[:, :, None] * eye
    return rb


class RlMpcEnv:
    """The batched env on the port's controller; `device` None is the card.
    `seed` is taken for the JAX signature: nothing here is random."""

    def __init__(self, num_envs: int = 16, vx_cmd: float = 0.3, solver: str = "tridiag_aug",
                 seed: int = 0, matrix_residual: bool = False, device=None):
        self.num_envs = num_envs
        self.vx_cmd = vx_cmd
        self.matrix_residual = matrix_residual
        self.act_dim = ACT_DIM_MATRIX if matrix_residual else ACT_DIM
        cfg = ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08)
        self.mpc_cfg = MPCConf(solver=solver, verbose=False)
        self.ctrl = MPCController(cfg, self.mpc_cfg, num_envs=num_envs, gait_id=2, device=device)
        self.device = self.ctrl.core.device
        self.plant = SrbdPlant(self.ctrl.core.robot, num_envs, height=0.55, dt=self.mpc_cfg.dt,
                               device=self.device)
        self._tick = 0

    def reset(self) -> torch.Tensor:
        mask = torch.ones(self.num_envs, dtype=torch.bool, device=self.device)
        self.plant.reset(mask)
        self.ctrl.reset(mask)
        twist = np.zeros((self.num_envs, 3), np.float32)
        twist[:, 0] = self.vx_cmd
        self.ctrl.set_command(twist, np.full(self.num_envs, 0.55, np.float32))
        self._tick = 0
        return self._rl_obs()

    def step(self, action):
        """One RL step = one MPC cycle (`decimation` low-level ticks)."""
        action = torch.as_tensor(action, device=self.device).to(torch.float32).clamp(-1.0, 1.0)
        ctrl = self.ctrl
        ctrl.update_mpc_sampling_time(0.025 + 0.005 * action[:, 0])
        ctrl.set_swing_parameters(foot_height=0.08 + 0.04 * action[:, 1],
                                  cp1=1.0 / 3.0 + 0.15 * action[:, 2],
                                  cp2=2.0 / 3.0 + 0.15 * action[:, 3])
        ctrl.set_srbd_accel(residual_lin_accel=1.0 * action[:, 4:7],
                            residual_ang_accel=1.0 * action[:, 7:10])
        if self.matrix_residual:
            ctrl.set_srbd_residual(torch.zeros(self.num_envs, 12, 12, device=self.device),
                                   matrix_residual_b(ctrl.core.robot, action))
        for k in range(self.mpc_cfg.decimation):
            ctrl.update_state(self.plant.observation())
            if k == 0:
                ctrl.run_mpc()
                grf = ctrl.grf_world
            ctrl.run_lowlevel()
            self.plant.step(grf, ctrl.contact_state, ctrl.ref_foot_pos_b)
        self._tick += 1

        x = self.plant.x
        fell = (x[:, 0:2].abs().amax(dim=1) > 0.5) | (x[:, 5] < 0.3) | (x[:, 5] > 0.8)
        reward = (1.0 - 2.0 * (x[:, 9] - self.vx_cmd).abs() - 0.5 * (x[:, 5] - 0.55).abs()
                  - 5.0 * fell.to(x.dtype))
        # Masked: a no-op where nothing fell, and no wait for the device.
        self.plant.reset(fell)
        ctrl.reset(fell)
        return self._rl_obs(), reward, fell, {"tick": self._tick}

    def _rl_obs(self) -> torch.Tensor:
        """(B, 14): [rpy, height, w_w, v_w, contact state, swing phase]."""
        x = self.plant.x
        return torch.cat([x[:, 0:3], x[:, 5:6], x[:, 6:12],
                          self.ctrl.contact_state.to(x.dtype),
                          self.ctrl.swing_phase.to(x.dtype)], dim=1).to(torch.float32)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    env = RlMpcEnv(num_envs=n)
    obs = env.reset()
    rng = np.random.default_rng(0)
    total = torch.zeros(n, device=env.device)
    for t in range(steps):
        action = 0.1 * rng.standard_normal((n, env.act_dim))  # random policy
        obs, reward, done, info = env.step(action)
        total += reward
        if t % 10 == 0:
            print(f"step {t:3d}  mean reward {float(reward.mean()):+.3f}  "
                  f"falls {int(done.sum())}  obs[0,:4]={obs[0, :4].cpu().numpy().round(3)}")
    print(f"\nmean episode return over {steps} steps: {float(total.mean()):.2f}")

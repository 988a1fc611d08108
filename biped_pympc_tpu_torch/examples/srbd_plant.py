"""Kinematic-feet SRBD plant for the closed-loop examples (twin of
`examples/srbd_plant.py`).

The plant integrates the single-rigid-body model the MPC linearizes
(`models/srbd.py`) under the commanded world-frame GRFs with the literal
4-stage RK4 (`srbd.rk4_step_generic`); the feet are kinematic (stance feet
pinned to their footholds, swing feet moved to the controller's body-frame
targets). Everything is batched torch on the plant's device, in its dtype
(float32 by default, as the JAX example's plant step, `srbd_plant.py:141-145`).
"""

from __future__ import annotations

import numpy as np
import torch

from biped_pympc_tpu_torch.control.controller import resolve_device
from biped_pympc_tpu_torch.models import srbd
from biped_pympc_tpu_torch.utils.consts import const
from biped_pympc_tpu_torch.utils.maths import quat_to_rotmat


def euler_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    """(B, 3) rpy -> (B, 4) wxyz quaternion (R = Rz Ry Rx convention)."""
    r, p, y = rpy[:, 0] / 2, rpy[:, 1] / 2, rpy[:, 2] / 2
    cr, sr, cp, sp, cy, sy = (torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p),
                              torch.cos(y), torch.sin(y))
    return torch.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy], dim=1)


def assemble_obs(robot, x: torch.Tensor, foot_w: torch.Tensor, ik=None):
    """The controller observation (B, 13 + 6 dof) of plant state x (B, 12) =
    [rpy, pos, omega_w, v_w] and world feet foot_w (B, 2, 3), and the body
    rotations (B, 3, 3): [pos, quat, v_b, w_b, q (IK of the body-frame feet),
    qd = 0, tau = 0] (`SrbdPlant.observation`, `tpu_rollout.py:130-146`).
    `ik` (p (B, 3), leg) -> q stands in for the joint encoders; None is the
    robot's own IK."""
    ik = robot.analytical_ik if ik is None else ik
    quat = euler_to_quat(x[:, :3])
    rot = quat_to_rotmat(quat)
    rt = rot.transpose(-1, -2)
    v_b = (rt @ x[:, 9:12, None])[..., 0]
    w_b = (rt @ x[:, 6:9, None])[..., 0]
    foot_b = (foot_w - x[:, None, 3:6]) @ rot  # R^T (p_w - root) per leg
    zeros = x.new_zeros(x.shape[0], 4 * robot.num_dof)
    obs = torch.cat([x[:, 3:6], quat, v_b, w_b, ik(foot_b[:, 0], 0), ik(foot_b[:, 1], 1), zeros],
                    dim=1)
    return obs, rot


def pin_feet(x, foot_w, rot, contact, p_des_b):
    """Stance feet stay where they are, swing feet go to the controller's
    body-frame targets p_des_b (B, 2, 3); no foot below the ground."""
    p_des_w = rot[:, None] @ p_des_b[..., None]
    foot_w = torch.where(contact[:, :, None] > 0.5, foot_w, p_des_w[..., 0] + x[:, None, 3:6])
    return torch.cat([foot_w[:, :, :2], foot_w[:, :, 2:].clamp_min(0.0)], dim=2)


def gate_grf(grf: torch.Tensor, contact: torch.Tensor) -> torch.Tensor:
    """(B, 12) world [F_L, F_R, M_L, M_R] with each foot's force and moment
    zeroed where it swings."""
    gate = torch.cat([contact[:, 0:1], contact[:, 1:2]] * 2, dim=1)  # (B, 4)
    return (grf.reshape(-1, 4, 3) * gate[:, :, None]).reshape(-1, 12)


def nominal_feet(robot, num_envs: int, dtype, device) -> torch.Tensor:
    """(B, 2, 3) world feet under the hips, the hips' xy rounded to float32 as
    the JAX examples take them (`srbd_plant.py:48-52`)."""
    hips = torch.stack([robot.hip_horizontal_location(leg, torch.float32, device)
                        for leg in (0, 1)]).to(dtype)
    feet = torch.zeros(num_envs, 2, 3, dtype=dtype, device=device)
    feet[:, :, :2] = hips[:, :2]
    return feet


class SrbdPlant:
    """Batched SRBD rigid body + kinematic feet. `device` None is the card
    (`control.controller.resolve_device`); `dtype` the plant's arithmetic;
    `ik` the observation's IK (`assemble_obs`; None the robot's own)."""

    def __init__(self, robot, num_envs: int, height: float, dt: float,
                 dtype=torch.float32, device=None, ik=None):
        self.robot = robot
        self.ik = ik
        self.num_envs = num_envs
        self.dt = dt
        self.height = height
        self.dtype = dtype
        self.device = resolve_device(device)
        # The body inertia and the mass rounded to float32, as the JAX plant
        # builds them (`srbd_plant.py:58-66`).
        self._i_body = const(np.asarray(robot.i_body, np.float32), dtype, self.device)
        self._mass = torch.full((num_envs,), float(np.float32(robot.mass)), dtype=dtype,
                                device=self.device)
        self._zeros3 = torch.zeros(num_envs, 3, dtype=dtype, device=self.device)
        self.x = torch.zeros(num_envs, 12, dtype=dtype, device=self.device)
        self.foot_w = torch.zeros(num_envs, 2, 3, dtype=dtype, device=self.device)
        self._rot = None
        self.reset(torch.ones(num_envs, dtype=torch.bool, device=self.device))

    def observation(self) -> torch.Tensor:
        """(B, 13 + 6 dof) controller observation vector (`assemble_obs`)."""
        obs, self._rot = assemble_obs(self.robot, self.x, self.foot_w, self.ik)
        return obs

    def step(self, grf_world: torch.Tensor, contact: torch.Tensor,
             p_des_b: torch.Tensor) -> torch.Tensor:
        """Advance one dt with the commanded world-frame GRFs (B, 12), gated by
        contact (B, 2); the feet move first (`pin_feet`, with the rotations
        of the last `observation`). Returns the gated GRFs."""
        t = lambda v: torch.as_tensor(v, device=self.device).to(self.dtype)
        contact = t(contact)
        self.foot_w = pin_feet(self.x, self.foot_w, self._rot, contact, t(p_des_b))
        grf = gate_grf(t(grf_world), contact)
        x = self.x
        rot = quat_to_rotmat(euler_to_quat(x[:, :3]))
        lin = srbd.SrbdLin(rot_body=rot, inertia_world=rot @ self._i_body @ rot.transpose(-1, -2),
                           body_pos=x[:, 3:6], foot_pos=self.foot_w, mass=self._mass,
                           residual_lin_accel=self._zeros3, residual_ang_accel=self._zeros3)
        self.x = srbd.rk4_step_generic(lin, x, grf, self.dt)
        return grf

    def reset(self, mask: torch.Tensor) -> None:
        """Reset the envs of mask (B,) bool to the nominal standing state."""
        mask = torch.as_tensor(mask, device=self.device)
        x0 = torch.zeros_like(self.x)
        x0[:, 5] = self.height
        self.x = torch.where(mask[:, None], x0, self.x)
        feet = nominal_feet(self.robot, self.num_envs, self.dtype, self.device)
        self.foot_w = torch.where(mask[:, None, None], feet, self.foot_w)

"""Leg control: kinematics, feed-forward + PD torque, batch-first (twin of
`biped_pympc_tpu/control/legs.py`)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from biped_pympc_tpu_torch.models.robot import RobotSpec
from biped_pympc_tpu_torch.utils.consts import const


@dataclass
class LegData:
    """Measured joint state and derived kinematics."""

    q: torch.Tensor  # (B, 2, dof)
    qd: torch.Tensor  # (B, 2, dof)
    tau: torch.Tensor  # (B, 2, dof)
    jac: torch.Tensor  # (B, 2, 6, dof)
    p: torch.Tensor  # (B, 2, 3) foot position, body frame
    v: torch.Tensor  # (B, 2, 3) foot velocity, body frame
    contact_phase: torch.Tensor  # (B, 2)
    swing_phase: torch.Tensor  # (B, 2)
    contact_bool: torch.Tensor  # (B, 2) 0/1
    swing_bool: torch.Tensor  # (B, 2) 0/1


@dataclass
class LegCommand:
    tau_ff: torch.Tensor  # (B, 2, dof) J^T wrench
    q_des: torch.Tensor  # (B, 2, dof)
    qd_des: torch.Tensor  # (B, 2, dof)
    p_des: torch.Tensor  # (B, 2, 3)
    v_des: torch.Tensor  # (B, 2, 3)
    wrench_ff: torch.Tensor  # (B, 2, 6) feed-forward foot wrench from the MPC
    kp: torch.Tensor  # (B, 2, dof)
    kd: torch.Tensor  # (B, 2, dof)


def init_command(batch: int, num_dof: int, dtype=torch.float32, device=None) -> LegCommand:
    z = lambda *s: torch.zeros(batch, *s, dtype=dtype, device=device)
    return LegCommand(tau_ff=z(2, num_dof), q_des=z(2, num_dof), qd_des=z(2, num_dof),
                      p_des=z(2, 3), v_des=z(2, 3), wrench_ff=z(2, 6),
                      kp=z(2, num_dof), kd=z(2, num_dof))


def init_data(batch: int, num_dof: int, dtype=torch.float32, device=None) -> LegData:
    z = lambda *s: torch.zeros(batch, *s, dtype=dtype, device=device)
    return LegData(q=z(2, num_dof), qd=z(2, num_dof), tau=z(2, num_dof),
                   jac=z(2, 6, num_dof), p=z(2, 3), v=z(2, 3),
                   contact_phase=z(2), swing_phase=z(2),
                   contact_bool=torch.ones(batch, 2, dtype=dtype, device=device),
                   swing_bool=z(2))


def update_data(robot: RobotSpec, q, qd, tau, contact_phase, swing_phase) -> LegData:
    """FK, Jacobians and foot velocity; q/qd/tau: (B, 2 * dof)."""
    nb, dof = q.shape[0], robot.num_dof
    q = q.reshape(nb, 2, dof)
    qd = qd.reshape(nb, 2, dof)
    tau = tau.reshape(nb, 2, dof)
    p = torch.stack([robot.foot_position(q[:, leg], leg) for leg in (0, 1)], dim=1)
    jac = torch.stack([robot.contact_jacobian(q[:, leg], leg) for leg in (0, 1)], dim=1)
    v = (jac[:, :, :3, :] @ qd[..., None])[..., 0]
    return LegData(q=q, qd=qd, tau=tau, jac=jac, p=p, v=v,
                   contact_phase=contact_phase, swing_phase=swing_phase,
                   contact_bool=(contact_phase != -1).to(q.dtype),
                   swing_bool=(swing_phase != -1).to(q.dtype))


def update_command(robot: RobotSpec, data: LegData, cmd: LegCommand) -> LegCommand:
    """PD gains (Kp zero in stance), stance J^T wrench feed-forward, swing
    IK targets (`leg_controller.py:72-119`)."""
    dtype, dev = data.q.dtype, data.q.device
    nb = data.q.shape[0]
    stance = data.contact_bool[..., None].bool()  # (B, 2, 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    kp = const(robot.kp, dtype, dev).expand(nb, 2, -1)
    kd = const(robot.kd, dtype, dev).expand(nb, 2, -1)
    kp = torch.where(stance, zero, kp)
    tau_stance = (data.jac.transpose(-1, -2) @ cmd.wrench_ff[..., None])[..., 0]
    tau_ff = torch.where(stance, tau_stance, zero)
    q_swing = torch.stack([robot.analytical_ik(cmd.p_des[:, leg], leg) for leg in (0, 1)], dim=1)
    q_des = torch.where(stance, zero, q_swing)
    qd_swing = (data.jac[:, :, :3, :].transpose(-1, -2) @ cmd.v_des[..., None])[..., 0]
    qd_swing[..., 0] = 0.0
    qd_swing[..., -1] = 0.0
    qd_des = torch.where(stance, zero, qd_swing)
    return LegCommand(tau_ff=tau_ff, q_des=q_des, qd_des=qd_des, p_des=cmd.p_des,
                      v_des=cmd.v_des, wrench_ff=cmd.wrench_ff, kp=kp, kd=kd)


def joint_torque(robot: RobotSpec, data: LegData, cmd: LegCommand) -> torch.Tensor:
    """clamp(tau_ff + Kp (q_des - q) + Kd (qd_des - qd)) -> (B, 2 * dof)."""
    tau = cmd.tau_ff + cmd.kp * (cmd.q_des - data.q) + cmd.kd * (cmd.qd_des - data.qd)
    limit = const(robot.torque_limit, tau.dtype, tau.device)
    tau = tau.reshape(tau.shape[0], -1)
    return torch.maximum(torch.minimum(tau, limit), -limit)

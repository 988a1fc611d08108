"""Convex-MPC pieces: reference trajectory, QP assembly, postprocess,
batch-first (twin of `biped_pympc_tpu/control/mpc.py`)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from biped_pympc_tpu_torch.control.estimator import EstimatorData
from biped_pympc_tpu_torch.models.robot import RobotSpec
from biped_pympc_tpu_torch.models.srbd import SrbdLin
from biped_pympc_tpu_torch.ops import qp as qps
from biped_pympc_tpu_torch.ops.pdipm import PdipmResult
from biped_pympc_tpu_torch.utils.consts import const
from biped_pympc_tpu_torch.utils.maths import rot_z


@dataclass
class DesiredState:
    """Body-frame command."""

    velocity_b: torch.Tensor  # (B, 3)
    ang_velocity_b: torch.Tensor  # (B, 3)
    height: torch.Tensor  # (B,)


def init_desired_state(batch: int, dtype=torch.float32, device=None,
                       height: float = 0.55) -> DesiredState:
    z = lambda *s: torch.zeros(batch, *s, dtype=dtype, device=device)
    return DesiredState(velocity_b=z(3), ang_velocity_b=z(3),
                        height=torch.full((batch,), height, dtype=dtype, device=device))


@dataclass
class MpcMemory:
    """Cross-solve latches."""

    first_run: torch.Tensor  # (B,) bool
    world_position_desired: torch.Tensor  # (B, 3)
    yaw_desired: torch.Tensor  # (B,)


def init_memory(batch: int, dtype=torch.float32, device=None) -> MpcMemory:
    return MpcMemory(first_run=torch.ones(batch, dtype=torch.bool, device=device),
                     world_position_desired=torch.zeros(batch, 3, dtype=dtype, device=device),
                     yaw_desired=torch.zeros(batch, dtype=dtype, device=device))


def reset_memory(mem: MpcMemory, mask: torch.Tensor) -> None:
    """Re-arm the first-run latch of the envs in mask (B,), in place."""
    mem.first_run = mem.first_run | mask


@dataclass
class MpcOutput:
    wrench: torch.Tensor  # (B, 2, 6) body-frame feed-forward foot wrench
    cost: torch.Tensor  # (B,) realized QP cost
    x_ref: torch.Tensor  # (B, T, 12)
    grf_world: torch.Tensor  # (B, 12) raw u_0 = [F_L, F_R, M_L, M_R], world frame
    solution: torch.Tensor  # (B, nz)
    residuals: torch.Tensor  # (B, 4)
    # solver="pallas_hybrid" only: (4,) int32 [flagged, nonfinite, resolved,
    # dropped_nonfinite] of the batch's solve (`pdipm_cuda.HybridStats`).
    hybrid_counts: Optional[torch.Tensor] = None
    # solver="pallas_hybrid" only: (B,) bool, the envs that took the
    # re-solve's answer (`pdipm_cuda.HybridStats.merged`).
    hybrid_merged: Optional[torch.Tensor] = None


def reference_trajectory(mem: MpcMemory, est: EstimatorData, des: DesiredState,
                         dt_mpc: torch.Tensor, horizon: int, decimation_dt: float,
                         yaw_wrap: bool = False):
    """Open-loop reference (`base_controller.py:166-257`); returns
    (new_mem, x_ref (B, T, 12)). Quirks kept from the reference: the
    position knot integrates the body-frame velocity directly; xy tracks the
    open-loop knot only when |v_des_x| < 1e-2; x_ref[k] targets x_{k+1}."""
    dtype, dev = est.root_position.dtype, est.root_position.device
    nb = est.root_position.shape[0]
    first = mem.first_run
    wpd = torch.where(first[:, None], est.root_position, mem.world_position_desired)
    yaw_des = torch.where(first, est.root_euler[:, 2], mem.yaw_desired)
    wpd = torch.stack([wpd[:, 0] + decimation_dt * des.velocity_b[:, 0],
                       wpd[:, 1] + decimation_dt * des.velocity_b[:, 1],
                       des.height], dim=1)
    yaw_des = yaw_des + decimation_dt * des.ang_velocity_b[:, 2]
    if yaw_wrap:
        # Measured yaw wraps to (-pi, pi]; keep the reference relative to it
        # so the tracking error always goes the short way around.
        two_pi = 2.0 * math.pi
        err = yaw_des - est.root_euler[:, 2]
        yaw_des = est.root_euler[:, 2] + (err - two_pi * torch.round(err / two_pi))

    stationary = des.velocity_b[:, 0].abs() < 1e-2
    t = dt_mpc[:, None] * torch.arange(horizon, dtype=dtype, device=dev)
    v_des_w = (est.rotation_body @ des.velocity_b[..., None])[..., 0]
    xy_base = torch.where(stationary[:, None], wpd[:, :2], est.root_position[:, :2])
    x_ref = torch.zeros(nb, horizon, 12, dtype=dtype, device=dev)
    x_ref[:, :, 2] = yaw_des[:, None] + des.ang_velocity_b[:, 2:3] * t
    x_ref[:, :, 3] = xy_base[:, 0:1] + v_des_w[:, 0:1] * t
    x_ref[:, :, 4] = xy_base[:, 1:2] + v_des_w[:, 1:2] * t
    x_ref[:, :, 5] = des.height[:, None]
    x_ref[:, :, 8] = des.ang_velocity_b[:, 2:3]
    x_ref[:, :, 9] = v_des_w[:, 0:1]
    x_ref[:, :, 10] = v_des_w[:, 1:2]
    new_mem = MpcMemory(first_run=torch.zeros_like(first), world_position_desired=wpd,
                        yaw_desired=yaw_des)
    return new_mem, x_ref


def _rotate_u_columns(b_mat: torch.Tensor, rz: torch.Tensor) -> torch.Tensor:
    """B @ blockdiag(rz, rz, rz, rz) per env, without the 12x12."""
    nb = b_mat.shape[0]
    return (b_mat.reshape(nb, 12, 4, 3) @ rz[:, None]).reshape(nb, 12, 12)


def build_mpc_qp(robot: RobotSpec, mem: MpcMemory, est: EstimatorData, des: DesiredState,
                 contact_table, dt_mpc, residual_lin_accel, residual_ang_accel,
                 q_weights, r_weights, horizon: int, decimation_dt: float,
                 euler_rate_mode: str = "rt_omega", f_max=qps.F_MAX, mu=None,
                 contact_frame: str = "world", residual_A=None, residual_B=None,
                 lt=None, lh=None):
    """QP assembly half of the MPC step; returns (new_mem, x_ref, qp).

    mu / f_max / lt / lh: scalars or (B,) per-env data; mu, lt, lh None use
    the robot's values. contact_frame "yaw" rotates Bd's input columns into
    yaw-aligned axes (the constraint rows stay constant); `postprocess`
    rotates the solution back.
    """
    dtype, dev = est.root_position.dtype, est.root_position.device
    nb = est.root_position.shape[0]
    new_mem, x_ref = reference_trajectory(mem, est, des, dt_mpc, horizon, decimation_dt,
                                          yaw_wrap=contact_frame == "yaw")
    rot = est.rotation_body
    i_body = const(robot.i_body, dtype, dev)
    lin = SrbdLin(
        rot_body=rot, inertia_world=rot @ i_body @ rot.transpose(-1, -2),
        body_pos=est.root_position, foot_pos=est.foot_position_w,
        mass=torch.full((nb,), robot.mass, dtype=dtype, device=dev),
        residual_lin_accel=residual_lin_accel, residual_ang_accel=residual_ang_accel,
        residual_A=residual_A, residual_B=residual_B,
    )
    x0 = torch.cat([est.root_euler, est.root_position, est.root_angular_velocity_w,
                    est.root_velocity_w], dim=1)
    qp = qps.build_qp(
        lin, x0, x_ref, contact_table.to(dtype), dt_mpc,
        robot.mu if mu is None else mu, q_weights, r_weights, horizon, euler_rate_mode,
        f_max, robot.lt if lt is None else lt, robot.lh if lh is None else lh)
    if contact_frame == "yaw":
        qp.dyn.B = _rotate_u_columns(qp.dyn.B, rot_z(est.root_euler[:, 2]))
    return new_mem, x_ref, qp


def postprocess_solution(qp: qps.StageQP, sol: PdipmResult, rot: torch.Tensor,
                         x_ref: torch.Tensor, horizon: int,
                         contact_frame: str = "world") -> MpcOutput:
    """u_0 -> body-frame wrench (`mpc_controller_cusadi.py:184-203`). With
    contact_frame "yaw" the solution's u is rotated back to world first."""
    nb = sol.x.shape[0]
    u0 = sol.x[:, qps.NX * horizon:qps.NX * horizon + qps.NU]
    grf = u0.reshape(nb, 4, 3).clone()
    if contact_frame == "yaw":
        # Ankle roll is unactuated about the yaw-frame x axis (the Mx = 0
        # equality axis): zero it there, then rotate back to world.
        rz = rot_z(torch.atan2(rot[:, 1, 0], rot[:, 0, 0]))
        grf[:, 2:, 0] = 0.0
        grf = grf @ rz.transpose(-1, -2)
        u0 = grf.reshape(nb, 12)
        grm = grf[:, 2:]
    else:
        grm = grf[:, 2:].clone()
        grm[:, :, 0] = 0.0  # Mx is unactuated
    f_body = grf[:, :2] @ rot
    m_body = grm @ rot
    wrench = -torch.cat([f_body, m_body], dim=2)
    cost = 0.5 * (sol.x * (qps.h_diag(qp) * sol.x)).sum(-1) + (qp.f * sol.x).sum(-1)
    return MpcOutput(wrench=wrench, cost=cost, x_ref=x_ref, grf_world=u0,
                     solution=sol.x, residuals=sol.residuals)

"""Frames from an externally estimated state, batch-first (twin of
`biped_pympc_tpu/control/estimator.py`)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from biped_pympc_tpu_torch.utils.maths import quat_to_euler, quat_to_rotmat


@dataclass
class EstimatorData:
    root_position: torch.Tensor  # (B, 3)
    root_quat: torch.Tensor  # (B, 4) (w, x, y, z)
    root_euler: torch.Tensor  # (B, 3)
    rotation_body: torch.Tensor  # (B, 3, 3)
    root_velocity_w: torch.Tensor  # (B, 3)
    root_angular_velocity_w: torch.Tensor  # (B, 3)
    root_velocity_b: torch.Tensor  # (B, 3)
    root_angular_velocity_b: torch.Tensor  # (B, 3)
    foot_position_w: torch.Tensor  # (B, 2, 3)


def init_data(batch: int, dtype=torch.float32, device=None) -> EstimatorData:
    z = lambda *s: torch.zeros(batch, *s, dtype=dtype, device=device)
    quat = z(4)
    quat[:, 0] = 1.0
    return EstimatorData(
        root_position=z(3), root_quat=quat, root_euler=z(3),
        rotation_body=torch.eye(3, dtype=dtype, device=device).repeat(batch, 1, 1),
        root_velocity_w=z(3), root_angular_velocity_w=z(3), root_velocity_b=z(3),
        root_angular_velocity_b=z(3), foot_position_w=z(2, 3),
    )


def estimate(root_position, root_quat, root_velocity_b, root_angular_velocity_b,
             foot_position_b) -> EstimatorData:
    """Body-frame twists to world; feet p_w = R p_b + root."""
    rot = quat_to_rotmat(root_quat)
    vel_w = (rot @ root_velocity_b[..., None])[..., 0]
    ang_w = (rot @ root_angular_velocity_b[..., None])[..., 0]
    foot_w = foot_position_b @ rot.transpose(-1, -2) + root_position[:, None, :]
    return EstimatorData(
        root_position=root_position, root_quat=root_quat,
        root_euler=quat_to_euler(root_quat), rotation_body=rot,
        root_velocity_w=vel_w, root_angular_velocity_w=ang_w,
        root_velocity_b=root_velocity_b,
        root_angular_velocity_b=root_angular_velocity_b,
        foot_position_w=foot_w,
    )

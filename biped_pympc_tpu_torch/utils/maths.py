"""Rotation / quaternion / skew utilities on (..., ) tensors
(twin of `biped_pympc_tpu/utils/maths.py`). Quaternions are (w, x, y, z)."""

from __future__ import annotations

import torch


def _mat3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_x(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about x: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _mat3([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about y: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _mat3([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about z: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _mat3([[c, -s, z], [s, c, z], [z, z, o]])


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion, normalized first -> (..., 3, 3) rotation."""
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _mat3([
        [ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz],
    ])


def quat_to_euler(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion -> (..., 3) roll, pitch, yaw."""
    w, x, y, z = quat.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return _mat3([[o, -z, y], [z, o, -x], [-y, x, o]])


def unskew(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew matrix -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)

"""HECTOR kinematics, batch-first (twin of `biped_pympc_tpu/models/hector.py`).

5-DoF leg (hip yaw, hip roll, hip pitch, knee, ankle): FK, geometric contact
Jacobian and analytic IK. As in the JAX package (PARITY.md), the right leg's
Jacobian uses the right leg's own joint axes, where the reference reuses
the left leg's.
"""

from __future__ import annotations

import numpy as np
import torch

from biped_pympc_tpu_torch.utils.consts import const
from biped_pympc_tpu_torch.utils.maths import rot_x, rot_z

NUM_DOF = 5
MASS = 13.856
I_BODY = np.array([[0.5413, 0.0, 0.0], [0.0, 0.5200, 0.0], [0.0, 0.0, 0.0691]])
MU = 1.0
LT = 0.07  # toe line-contact lever arm [m]
LH = 0.04  # heel line-contact lever arm [m]
KP = (40.0, 40.0, 70.0, 70.0, 40.0)
KD = (1.0, 1.0, 0.7, 0.7, 0.7)
TORQUE_LIMIT = (33.5, 33.5, 33.5, 67.0, 33.5, 33.5, 33.5, 33.5, 67.0, 33.5)

# Link offsets and fixed frame permutations (`hector.py:56-76`).
_P1 = np.array([-0.00, 0.047, -0.1265])
_P2 = np.array([0.0465, 0.015, -0.0705])
_P3 = np.array([-0.06, 0.018, 0.0])
_P4 = np.array([0.0, 0.01805, -0.22])
_P5 = np.array([0.0, 0.00, -0.22])
_P5E = np.array([0.0, 0.0, -0.042])
_R12 = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], dtype=np.float64)
_R23 = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float64)
_P2R = _R12.T @ _P2
_P3R = _R23.T @ _R12.T @ _P3
_P4R = _R23.T @ _R12.T @ _P4
_P5R = _R23.T @ _R12.T @ _P5
_P5ER = _R23.T @ _R12.T @ _P5E
# Right-leg mirrors: p1, p2 mirror y; p3, p4, p5 mirror z; p5e unmirrored.
_MIR_Y = np.array([1.0, -1.0, 1.0])
_MIR_Z = np.array([1.0, 1.0, -1.0])


def _mirror(leg: int):
    if leg == 0:
        return np.ones(3), np.ones(3)
    return _MIR_Y, _MIR_Z


def forward_kinematics(q: torch.Tensor, leg: int):
    """FK of one leg for q (B, 5). Returns (p0e (B, 3), (origins (B, 5, 3),
    axes (B, 5, 3))): the sole position and each joint's origin and z axis,
    in the torso frame."""
    mir_y, mir_z = _mirror(leg)
    c = lambda a: const(a, q.dtype, q.device)
    mv = lambda m, v: (m @ v[..., None])[..., 0]
    r12, r23 = c(_R12), c(_R23)
    r01 = rot_z(q[:, 0])
    t01 = c(_P1 * mir_y).expand(q.shape[0], 3)
    r01_12 = r01 @ r12
    r02 = r01_12 @ rot_z(q[:, 1])
    t02 = t01 + mv(r01_12, c(_P2R * mir_y))
    r02_23 = r02 @ r23
    r03 = r02_23 @ rot_z(q[:, 2])
    t03 = t02 + mv(r02_23, c(_P3R * mir_z))
    r04 = r03 @ rot_z(q[:, 3])
    t04 = t03 + mv(r03, c(_P4R * mir_z))
    r05 = r04 @ rot_z(q[:, 4])
    t05 = t04 + mv(r04, c(_P5R * mir_z))
    p0e = t05 + mv(r05, c(_P5ER))
    origins = torch.stack([t01, t02, t03, t04, t05], dim=1)
    axes = torch.stack([r[..., 2] for r in (r01, r02, r03, r04, r05)], dim=1)
    return p0e, (origins, axes)


def foot_position(q: torch.Tensor, leg: int) -> torch.Tensor:
    """(B, 3) sole position in the torso frame."""
    return forward_kinematics(q, leg)[0]


def contact_jacobian(q: torch.Tensor, leg: int) -> torch.Tensor:
    """(B, 6, 5) [linear; angular] Jacobian at the sole:
    J[:3, i] = z_i x (p0e - p_i), J[3:, i] = z_i."""
    p0e, (origins, axes) = forward_kinematics(q, leg)
    lin = torch.linalg.cross(axes, p0e[:, None, :] - origins, dim=-1)
    return torch.cat([lin.transpose(-1, -2), axes.transpose(-1, -2)], dim=1)


def analytical_ik(p_foot_b: torch.Tensor, leg: int) -> torch.Tensor:
    """(B, 3) desired sole position in the torso frame -> (B, 5) q; hip yaw
    0, ankle aligned with torso pitch (`hector.py:220-276`)."""
    dtype, dev = p_foot_b.dtype, p_foot_b.device
    side = 1.0 if leg == 1 else -1.0
    offset = const((-0.00 + 0.0465 - 0.06, -side * (0.047 + 0.015), -0.126 - 0.0705), dtype, dev)
    foot = p_foot_b - offset
    foot = foot + const((0.0, 0.0, 0.042), dtype, dev)
    thigh = 0.22
    calf = 0.22
    dist_yz = torch.sqrt(foot[:, 1] ** 2 + foot[:, 2] ** 2)
    dist_horiz = 0.018 + 0.01805
    q1 = torch.asin(torch.clamp(foot[:, 1] / dist_yz, -1.0, 1.0)) + torch.asin(
        torch.clamp(dist_horiz * side / dist_yz, -1.0, 1.0))
    hip_pitch_off = const((0.0, 0.018 * side, 0.0), dtype, dev)
    foot_hp = (rot_x(q1) @ foot[..., None])[..., 0] + hip_pitch_off
    r = torch.linalg.vector_norm(foot_hp, dim=-1)
    cos_q2 = torch.clamp((r ** 2 - thigh ** 2 - calf ** 2) / (2.0 * thigh * calf), -1.0, 1.0)
    sin_q2 = torch.clamp(-torch.sqrt(torch.clamp(1.0 - cos_q2 ** 2, min=1e-6)), -1.0, 1.0)
    knee = torch.atan2(sin_q2, cos_q2)
    hip_pitch = torch.atan2(-foot_hp[:, 0], -foot_hp[:, 2]) - torch.atan2(
        calf * sin_q2, thigh + calf * cos_q2)
    ankle = -hip_pitch - knee
    return torch.stack([torch.zeros_like(q1), q1, hip_pitch, knee, ankle], dim=-1)


def hip_horizontal_location(leg: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(3,) hip-roll projection used by the Raibert heuristic."""
    side = 1.0 if leg == 0 else -1.0
    return const((-0.00 + 0.0465 - 0.06, side * (0.047 + 0.015 + 0.036), 0.0), dtype,
                 device).clone()

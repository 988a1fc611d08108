"""Booster T1 kinematics, batch-first (twin of `biped_pympc_tpu/models/t1.py`).

6-DoF leg, joints [hip pitch, hip roll, hip yaw, knee pitch, ankle pitch,
ankle roll], as a `models/chain.SerialChain` with the URDF's constants
(`models/urdf.py` reads the same chain from `models/assets/`):

  Waist (fixed at q=0):        xyz (0.0625, 0, -0.1155)
  Hip_Pitch   axis y  origin (0, +-0.106, 0)
  Hip_Roll    axis x  origin (0, 0, -0.02)
  Hip_Yaw     axis z  origin (0, 0, -0.081854)
  Knee_Pitch  axis y  origin (-0.014, 0, -0.134)
  Ankle_Pitch axis y  origin (0, 0, -0.28)
  Ankle_Roll  axis x  origin (0, +-0.00025, -0.012)
  foot sole (fixed):           xyz (0, 0, -0.035192) L / (0, 0, -0.03519) R

`analytical_ik` is the reference's planar closed form; `analytical_ik_newton`
refines it with Gauss-Newton steps on the exact chain (the "T1-newton" robot).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from biped_pympc_tpu_torch.models.chain import SerialChain, jacobian_from_frames
from biped_pympc_tpu_torch.models.chain import forward_kinematics as _chain_fk
from biped_pympc_tpu_torch.ops.linalg import inverse_3x3
from biped_pympc_tpu_torch.utils.consts import const

NUM_DOF = 6
MASS = 40.0
I_BODY = np.array([[0.5413, 0.0, 0.0], [0.0, 0.5200, 0.0], [0.0, 0.0, 0.0691]])
MU = 1.0
# Toe / heel line-contact lever arms of the T1's foot: its collision box is
# 0.223 m long, centred 0.01 m ahead of the sole origin, so lt = 0.223 / 2 +
# 0.01 and lh = 0.223 / 2 - 0.01.
LT = 0.1215
LH = 0.1015
KP = (20.0, 20.0, 20.0, 20.0, 15.0, 15.0)
KD = (1.0, 1.0, 0.7, 0.7, 0.7, 0.7)
TORQUE_LIMIT = (33.5, 33.5, 33.5, 67.0, 33.5, 33.5, 33.5, 33.5, 33.5, 67.0, 33.5, 33.5)


def _leg_chain(side: float) -> SerialChain:
    return SerialChain(
        base_offset=np.array([0.0625, 0.0, -0.1155]),
        joint_offsets=np.array([
            [0.0, side * 0.106, 0.0],
            [0.0, 0.0, -0.02],
            [0.0, 0.0, -0.081854],
            [-0.014, 0.0, -0.134],
            [0.0, 0.0, -0.28],
            [0.0, side * 0.00025, -0.012],
        ]),
        axes="yxzyyx",
        tip_offset=np.array([0.0, 0.0, -0.035192 if side > 0 else -0.03519]),
    )


_CHAINS = (_leg_chain(1.0), _leg_chain(-1.0))  # (left, right)
# The joints the Gauss-Newton refinement moves: hip pitch, hip roll, knee,
# ankle pitch (hip yaw and ankle roll stay 0, the reference's convention).
_ACTIVE = (0, 1, 3, 4)


def forward_kinematics(q: torch.Tensor, leg: int):
    """q (B, 6) -> (p_sole (B, 3), (origins (B, 6, 3), axes (B, 6, 3)))."""
    return _chain_fk(_CHAINS[leg], q)


def foot_position(q: torch.Tensor, leg: int) -> torch.Tensor:
    """(B, 6) joint angles -> (B, 3) foot sole position in the torso frame."""
    return _chain_fk(_CHAINS[leg], q)[0]


def contact_jacobian(q: torch.Tensor, leg: int) -> torch.Tensor:
    """(B, 6, 6) LOCAL_WORLD_ALIGNED frame Jacobian at the foot sole."""
    p, (origins, axes) = _chain_fk(_CHAINS[leg], q)
    return jacobian_from_frames(p, origins, axes)


def analytical_ik(p_foot_b: torch.Tensor, leg: int) -> torch.Tensor:
    """(B, 3) sole position in the torso frame -> (B, 6) q by the closed form
    with hip yaw and ankle roll 0 (`t1.py:93-129`: its constants, clips and
    1e-6 epsilons)."""
    dtype, dev = p_foot_b.dtype, p_foot_b.device
    side = 1.0 if leg == 0 else -1.0
    r_torso_to_hip = const((0.0625, side * 0.106, -0.1155), dtype, dev)
    r_ankle_roll_to_ee = const((0.0, side * 0.00025, -0.035192), dtype, dev)
    l1 = 0.02 + 0.081854 + 0.134  # hip -> knee
    l2 = 0.28 + 0.012  # knee -> ankle roll
    knee_x_offset = -0.014

    v = p_foot_b - r_torso_to_hip - r_ankle_roll_to_ee
    hip_roll = torch.atan2(v[:, 1], -v[:, 2])
    cr, sr = torch.cos(hip_roll), torch.sin(hip_roll)
    xs = v[:, 0] - knee_x_offset
    zs = -v[:, 1] * sr + v[:, 2] * cr

    d = torch.sqrt(xs * xs + zs * zs)
    cos_beta = torch.clamp((l1 * l1 + d * d - l2 * l2) / (2 * l1 * d + 1e-6), -1.0, 1.0)
    beta = torch.arccos(cos_beta)
    cos_k = torch.clamp((l1 * l1 + l2 * l2 - d * d) / (2 * l1 * l2 + 1e-6), -1.0, 1.0)
    knee_pitch = math.pi - torch.arccos(cos_k)
    alpha = torch.atan2(xs, -zs)
    hip_pitch = alpha - beta
    ankle_pitch = -(hip_pitch + knee_pitch)
    zero = torch.zeros_like(hip_pitch)
    return torch.stack([hip_pitch, hip_roll, zero, knee_pitch, ankle_pitch, zero], dim=-1)


def analytical_ik_newton(p_foot_b: torch.Tensor, leg: int, iterations: int = 10) -> torch.Tensor:
    """Exact T1 IK: the closed-form seed, then `iterations` Gauss-Newton steps
    on the chain's FK over the pitch / roll joints (`t1.py:132-168`):

        dq = J4^T (J4 J4^T + lambda I)^-1 (p_des - FK(q)),  lambda = 1e-6,

    J4 the position Jacobian's columns [0, 1, 3, 4]. A fixed number of
    steps, no host branch: it runs inside a captured CUDA graph."""
    dtype, dev = p_foot_b.dtype, p_foot_b.device
    lam_eye = const(1e-6 * np.eye(3), dtype, dev)
    q = analytical_ik(p_foot_b, leg)
    zero = torch.zeros_like(q[:, 0])
    for _ in range(iterations):
        p, (origins, axes) = forward_kinematics(q, leg)
        jac = jacobian_from_frames(p, origins, axes)[:, :3, :]  # (B, 3, 6)
        j4 = torch.stack([jac[..., k] for k in _ACTIVE], dim=-1)  # (B, 3, 4)
        r = p_foot_b - p
        m = j4 @ j4.transpose(-1, -2) + lam_eye
        dq4 = (j4.transpose(-1, -2) @ (inverse_3x3(m) @ r[..., None]))[..., 0]
        q = q + torch.stack([dq4[:, 0], dq4[:, 1], zero, dq4[:, 2], dq4[:, 3], zero], dim=-1)
    return q


def hip_horizontal_location(leg: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(3,) CoG projection of the hip for the Raibert heuristic (`t1.py:171`)."""
    side = 1.0 if leg == 0 else -1.0
    return const((0.0625 - 0.014, side * 0.106, 0.0), dtype, device).clone()

"""Serial-chain forward kinematics and geometric Jacobian, batch-first (twin
of `biped_pympc_tpu/models/chain.py`).

A chain is per-joint (origin, axis) constants evaluated directly: batched
over (B, n) joint angles. The Jacobian is Pinocchio's LOCAL_WORLD_ALIGNED
frame Jacobian: linear rows at the frame origin in world axes, angular rows
the world-frame joint axes. The constants come from `utils/consts.const`,
built once per dtype and device, so a captured CUDA graph reads them at
fixed addresses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from biped_pympc_tpu_torch.utils.consts import const
from biped_pympc_tpu_torch.utils.maths import rot_x, rot_y, rot_z


class SerialChain(NamedTuple):
    """Fixed-topology serial chain, every joint revolute about x, y or z.

    base_offset: (3,) translation from the root frame to the first joint's
    parent frame; joint_offsets: (n, 3) translation from joint i-1's frame
    to joint i's; axes: a string over {'x', 'y', 'z'}; tip_offset: (3,)
    fixed translation from the last joint's frame to the end effector.
    """

    base_offset: np.ndarray
    joint_offsets: np.ndarray  # (n, 3)
    axes: str
    tip_offset: np.ndarray  # (3,)

    @property
    def num_dof(self) -> int:
        return len(self.axes)


_ROT = {"x": rot_x, "y": rot_y, "z": rot_z}
_COL = {"x": 0, "y": 1, "z": 2}


def forward_kinematics(chain: SerialChain, q: torch.Tensor):
    """q (B, n) -> (p_tip (B, 3), (origins (B, n, 3), axes_world (B, n, 3))).
    The rotation accumulates left to right, r = r @ rot(q_i), as in JAX."""
    c = lambda a: const(a, q.dtype, q.device)
    mv = lambda m, v: (m @ v[..., None])[..., 0]
    nb = q.shape[0]
    r = c(np.eye(3)).expand(nb, 3, 3)
    t = c(chain.base_offset).expand(nb, 3)
    origins, axes_world = [], []
    for i, ax in enumerate(chain.axes):
        t = t + mv(r, c(chain.joint_offsets[i]))
        origins.append(t)
        r = r @ _ROT[ax](q[:, i])
        axes_world.append(r[..., _COL[ax]])
    p_tip = t + mv(r, c(chain.tip_offset))
    return p_tip, (torch.stack(origins, dim=1), torch.stack(axes_world, dim=1))


def tip_position(chain: SerialChain, q: torch.Tensor) -> torch.Tensor:
    return forward_kinematics(chain, q)[0]


def jacobian_from_frames(p_tip: torch.Tensor, origins: torch.Tensor,
                         axes: torch.Tensor) -> torch.Tensor:
    """(B, 6, n) [linear; angular] Jacobian of `forward_kinematics`'s output:
    J[:3, i] = a_i x (p_tip - o_i), J[3:, i] = a_i."""
    lin = torch.linalg.cross(axes, p_tip[:, None, :] - origins, dim=-1)
    return torch.cat([lin.transpose(-1, -2), axes.transpose(-1, -2)], dim=1)


def geometric_jacobian(chain: SerialChain, q: torch.Tensor) -> torch.Tensor:
    """(B, 6, n) LOCAL_WORLD_ALIGNED frame Jacobian at the tip."""
    p_tip, (origins, axes) = forward_kinematics(chain, q)
    return jacobian_from_frames(p_tip, origins, axes)

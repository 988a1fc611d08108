"""Robot registry (twin of `biped_pympc_tpu/models/robot.py`). HECTOR only
so far; T1 waits for its models (ROADMAP Queue 1, item 11)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from biped_pympc_tpu_torch.models import hector


@dataclass(frozen=True)
class RobotSpec:
    name: str
    num_dof: int
    mass: float
    i_body: np.ndarray  # (3, 3)
    mu: float
    lt: float  # toe line-contact lever arm [m]
    lh: float  # heel line-contact lever arm [m]
    kp: tuple  # (num_dof,)
    kd: tuple  # (num_dof,)
    torque_limit: tuple  # (2 * num_dof,)
    # per-leg batched kinematics; the leg index is a Python int
    foot_position: Callable  # (q (B, dof), leg) -> (B, 3)
    contact_jacobian: Callable  # (q (B, dof), leg) -> (B, 6, dof)
    analytical_ik: Callable  # (p (B, 3), leg) -> (B, dof)
    hip_horizontal_location: Callable  # (leg, dtype, device) -> (3,)


HECTOR = RobotSpec(
    name="HECTOR", num_dof=hector.NUM_DOF, mass=hector.MASS, i_body=hector.I_BODY,
    mu=hector.MU, lt=hector.LT, lh=hector.LH, kp=hector.KP, kd=hector.KD,
    torque_limit=hector.TORQUE_LIMIT, foot_position=hector.foot_position,
    contact_jacobian=hector.contact_jacobian, analytical_ik=hector.analytical_ik,
    hip_horizontal_location=hector.hip_horizontal_location,
)


def get_robot(name: str) -> RobotSpec:
    """Name -> spec."""
    if name == "HECTOR":
        return HECTOR
    if name in ("T1", "T1-newton"):
        raise NotImplementedError(
            f"robot {name!r} is not ported to biped_pympc_tpu_torch yet "
            "(ROADMAP Queue 1, item 11: T1)")
    raise ValueError(f"Unknown robot {name!r}. Available: ['HECTOR']")

"""Robot registry (twin of `biped_pympc_tpu/models/robot.py`): a spec of
static parameters and per-leg batched kinematics for HECTOR, the Booster T1
and "T1-newton" (T1 with the Gauss-Newton-refined exact IK)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np

from biped_pympc_tpu_torch.models import hector, t1


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


def _spec(name: str, mod) -> RobotSpec:
    return RobotSpec(
        name=name, num_dof=mod.NUM_DOF, mass=mod.MASS, i_body=mod.I_BODY, mu=mod.MU,
        lt=mod.LT, lh=mod.LH, kp=mod.KP, kd=mod.KD, torque_limit=mod.TORQUE_LIMIT,
        foot_position=mod.foot_position, contact_jacobian=mod.contact_jacobian,
        analytical_ik=mod.analytical_ik, hip_horizontal_location=mod.hip_horizontal_location)


HECTOR = _spec("HECTOR", hector)
T1 = _spec("T1", t1)
# "T1-newton": T1 with the exact IK; the plain "T1" keeps the reference's
# planar IK, with its decimeter-level FK(IK(p)) error at bent poses.
T1_NEWTON = replace(T1, name="T1-newton", analytical_ik=t1.analytical_ik_newton)

_REGISTRY = {"HECTOR": HECTOR, "T1": T1, "T1-newton": T1_NEWTON}


def get_robot(name: str) -> RobotSpec:
    """Name -> spec."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown robot {name!r}. Available: {sorted(_REGISTRY)}") from None

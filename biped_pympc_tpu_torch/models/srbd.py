"""Single-rigid-body dynamics, batch-first (twin of
`biped_pympc_tpu/models/srbd.py`).

At a fixed linearization point the SRBD is affine in (state, input):
xdot = A x + B u + c with x = [rpy, p, omega_w, v_w] and
u = [F_L, F_R, M_L, M_R]. A is nilpotent (A^3 = 0), so RK4 with a
zero-order-hold input has an exact closed form.

euler_rate_mode: "rt_omega" (default) uses rpy_dot = R^T omega_w, what the
reference's shipped CUDA path computes; "r_omega" uses R omega_w, the
literal CasADi source.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from biped_pympc_tpu_torch.ops.linalg import inverse_3x3
from biped_pympc_tpu_torch.utils.consts import const
from biped_pympc_tpu_torch.utils.maths import skew

GRAVITY = 9.81


@dataclass
class SrbdLin:
    """Linearization point per env; every tensor has a leading (B,) axis.

    residual_A / residual_B: optional (B, 12, 12) learned corrections added
    to the continuous-time A / B before discretization.
    """

    rot_body: torch.Tensor  # (B, 3, 3) body-to-world rotation
    inertia_world: torch.Tensor  # (B, 3, 3)
    body_pos: torch.Tensor  # (B, 3)
    foot_pos: torch.Tensor  # (B, 2, 3) world-frame [left, right]
    mass: torch.Tensor  # (B,)
    residual_lin_accel: torch.Tensor  # (B, 3)
    residual_ang_accel: torch.Tensor  # (B, 3)
    residual_A: Optional[torch.Tensor] = None
    residual_B: Optional[torch.Tensor] = None


@dataclass
class AffineDynamics:
    """x+ = A x + B u + c (discrete) or xdot = A x + B u + c (continuous)."""

    A: torch.Tensor  # (B, 12, 12)
    B: torch.Tensor  # (B, 12, 12)
    c: torch.Tensor  # (B, 12)


def continuous_dynamics(lin: SrbdLin,
                        euler_rate_mode: str = "rt_omega") -> AffineDynamics:
    """Affine continuous-time SRBD at the linearization point."""
    rot = lin.rot_body
    dtype, dev = rot.dtype, rot.device
    nb = rot.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    rm = rot.transpose(-1, -2) if euler_rate_mode == "rt_omega" else rot
    i_inv = inverse_3x3(lin.inertia_world.to(dtype))
    body = lin.body_pos.to(dtype)
    feet = lin.foot_pos.to(dtype)
    mass = const(lin.mass, dtype, dev).expand(nb)

    A = torch.zeros(nb, 12, 12, dtype=dtype, device=dev)
    A[:, 0:3, 6:9] = rm
    A[:, 3:6, 9:12] = eye3
    B = torch.zeros(nb, 12, 12, dtype=dtype, device=dev)
    B[:, 6:9, 0:3] = i_inv @ skew(feet[:, 0] - body)
    B[:, 6:9, 3:6] = i_inv @ skew(feet[:, 1] - body)
    B[:, 6:9, 6:9] = i_inv
    B[:, 6:9, 9:12] = i_inv
    B[:, 9:12, 0:3] = eye3 / mass[:, None, None]
    B[:, 9:12, 3:6] = eye3 / mass[:, None, None]
    c = torch.zeros(nb, 12, dtype=dtype, device=dev)
    c[:, 6:9] = lin.residual_ang_accel.to(dtype)
    grav = const((0.0, 0.0, -GRAVITY), dtype, dev)
    c[:, 9:12] = grav + lin.residual_lin_accel.to(dtype)
    if lin.residual_A is not None:
        A = A + lin.residual_A.to(dtype)
    if lin.residual_B is not None:
        B = B + lin.residual_B.to(dtype)
    return AffineDynamics(A, B, c)


def discretize_rk4(cont: AffineDynamics, dt: torch.Tensor) -> AffineDynamics:
    """Exact RK4 of xdot = A x + B u + c over dt (B,):
    Ad = I + dA + dA^2/2 + dA^3/6 + dA^4/24,
    M = dt (I + dA/2 + dA^2/6 + dA^3/24), Bd = M B, cd = M c."""
    A = cont.A
    dt = const(dt, A.dtype, A.device).expand(A.shape[0])
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    dA = dt[:, None, None] * A
    dA2 = dA @ dA
    dA3 = dA2 @ dA
    dA4 = dA3 @ dA
    Ad = eye + dA + dA2 / 2.0 + dA3 / 6.0 + dA4 / 24.0
    M = dt[:, None, None] * (eye + dA / 2.0 + dA2 / 6.0 + dA3 / 24.0)
    return AffineDynamics(Ad, M @ cont.B, (M @ cont.c[..., None])[..., 0])


def discrete_dynamics(lin: SrbdLin, dt: torch.Tensor,
                      euler_rate_mode: str = "rt_omega") -> AffineDynamics:
    """Continuous model at `lin`, discretized with RK4 over dt."""
    return discretize_rk4(continuous_dynamics(lin, euler_rate_mode), dt)


def dynamics_rhs(lin: SrbdLin, x: torch.Tensor, u: torch.Tensor,
                 euler_rate_mode: str = "rt_omega") -> torch.Tensor:
    """xdot (B, 12) at x (B, 12), u (B, 12) (`srbd.py:168`)."""
    d = continuous_dynamics(lin, euler_rate_mode)
    return _mv(d.A, x) + _mv(d.B, u) + d.c


def rk4_step_generic(lin: SrbdLin, x: torch.Tensor, u: torch.Tensor, dt,
                     euler_rate_mode: str = "rt_omega") -> torch.Tensor:
    """The literal 4-stage RK4 of the affine model over dt with u held
    (`srbd.py:175`): the oracle of `discretize_rk4` and of the rollout's
    closed form, and the plant of `examples/srbd_plant.py`."""
    d = continuous_dynamics(lin, euler_rate_mode)
    f = lambda xx: _mv(d.A, xx) + _mv(d.B, u) + d.c
    k1 = f(x)
    k2 = f(x + dt / 2 * k1)
    k3 = f(x + dt / 2 * k2)
    k4 = f(x + dt * k3)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]

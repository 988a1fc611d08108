"""Structured SRBD-MPC QP, batch-first (twin of `biped_pympc_tpu/ops/qp.py`).

  decision  z = [x_1..x_T (12 each), u_0..u_{T-1} (12 each)], nz = 24 T
  cost      0.5 z^T H z + f^T z, H = diag([Q]*T ++ [R]*T)
  equality  A z = b: per stage x_{i+1} - Ad x_i - Bd u_i = b_i (12 T rows,
            b_0 = Ad x0 + cd, b_i = cd), then Mx_left = Mx_right = 0 (2 T)
  inequality G z <= d: 16 rows per stage on u_i (friction pyramid, toe/heel
            line contact, 0 <= fz <= f_max * contact, per foot)

Every function takes a batched `StageQP` and works on (B, ...) tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from biped_pympc_tpu_torch.models.srbd import AffineDynamics, SrbdLin, discrete_dynamics
from biped_pympc_tpu_torch.utils.consts import const

NX = 12
NU = 12
N_INEQ_PER_STAGE = 16
N_MX_PER_STAGE = 2

# HECTOR-sized defaults; per env they are data (`build_qp` arguments).
F_MAX = 500.0
LT = 0.07
LH = 0.04

_MX_COLS = (6, 9)  # u_i[6] = Mx_left, u_i[9] = Mx_right


@dataclass
class StageQP:
    """Per-env QP data; every tensor has a leading (B,) axis."""

    q_diag: torch.Tensor  # (B, 12)
    r_diag: torch.Tensor  # (B, 12)
    f: torch.Tensor  # (B, nz)
    dyn: AffineDynamics  # Ad, Bd (B, 12, 12), cd (B, 12)
    b0: torch.Tensor  # (B, 12) = Ad x0 + cd
    g_u: torch.Tensor  # (B, 16, 12)
    d: torch.Tensor  # (B, T, 16)

    @property
    def horizon(self) -> int:
        return self.d.shape[1]

    @property
    def nz(self) -> int:
        return 2 * NX * self.horizon

    @property
    def n_eq(self) -> int:
        return (NX + N_MX_PER_STAGE) * self.horizon

    @property
    def n_ineq(self) -> int:
        return N_INEQ_PER_STAGE * self.horizon


def stage_ineq_block(mu: torch.Tensor, lt: torch.Tensor,
                     lh: torch.Tensor) -> torch.Tensor:
    """(B, 16, 12) inequality rows on u_i = [f1, f2, m1, m2], per foot
    [x-, x+, y- , y+ friction, toe lt, heel lh, -fz, fz]."""
    nb = mu.shape[0]
    g = torch.zeros(nb, 16, 12, dtype=mu.dtype, device=mu.device)
    for foot, (fc, mc) in enumerate(((0, 6), (3, 9))):
        r = 8 * foot
        g[:, r + 0, fc + 0] = -1.0
        g[:, r + 1, fc + 0] = 1.0
        g[:, r + 2, fc + 1] = -1.0
        g[:, r + 3, fc + 1] = 1.0
        for k in range(4):
            g[:, r + k, fc + 2] = -mu
        g[:, r + 4, fc + 2] = -lt
        g[:, r + 4, mc + 1] = -1.0
        g[:, r + 5, fc + 2] = -lh
        g[:, r + 5, mc + 1] = 1.0
        g[:, r + 6, fc + 2] = -1.0
        g[:, r + 7, fc + 2] = 1.0
    return g


def build_qp(lin: SrbdLin, x0: torch.Tensor, x_ref: torch.Tensor,
             contact_table: torch.Tensor, dt_mpc, mu, q_diag: torch.Tensor,
             r_diag: torch.Tensor, horizon: int,
             euler_rate_mode: str = "rt_omega", f_max=F_MAX, lt=LT,
             lh=LH) -> StageQP:
    """Assemble the batch's QPs.

    x0 (B, 12), x_ref (B, T, 12), contact_table (B, T, 2); dt_mpc, mu,
    f_max, lt, lh: scalars or (B,) per-env values; q_diag / r_diag (12,) or
    (B, 12) weights.
    """
    dtype, dev = x0.dtype, x0.device
    nb = x0.shape[0]
    per_env = lambda v: const(v, dtype, dev).expand(nb)
    dyn = discrete_dynamics(lin, per_env(dt_mpc), euler_rate_mode)
    q_diag = const(q_diag, dtype, dev).expand(nb, NX)
    r_diag = const(r_diag, dtype, dev).expand(nb, NU)
    f_x = (-(q_diag[:, None, :] * x_ref)).reshape(nb, -1)
    f = torch.cat([f_x, torch.zeros(nb, NU * horizon, dtype=dtype, device=dev)], 1)
    b0 = (dyn.A @ x0[..., None])[..., 0] + dyn.c
    g_u = stage_ineq_block(per_env(mu), per_env(lt), per_env(lh))
    d = torch.zeros(nb, horizon, N_INEQ_PER_STAGE, dtype=dtype, device=dev)
    ct = contact_table.to(dtype)
    d[:, :, 7] = per_env(f_max)[:, None] * ct[:, :, 0]
    d[:, :, 15] = per_env(f_max)[:, None] * ct[:, :, 1]
    return StageQP(q_diag=q_diag.contiguous(), r_diag=r_diag.contiguous(),
                   f=f, dyn=dyn, b0=b0, g_u=g_u, d=d)


def take(qp: StageQP, idx: torch.Tensor) -> StageQP:
    """The envs `idx` (a 1-D index tensor) of a batch, every leaf gathered."""
    dyn = AffineDynamics(A=qp.dyn.A[idx], B=qp.dyn.B[idx], c=qp.dyn.c[idx])
    return StageQP(q_diag=qp.q_diag[idx], r_diag=qp.r_diag[idx], f=qp.f[idx], dyn=dyn,
                   b0=qp.b0[idx], g_u=qp.g_u[idx], d=qp.d[idx])


def h_diag(qp: StageQP) -> torch.Tensor:
    """(B, nz) diagonal of H."""
    T = qp.horizon
    return torch.cat([qp.q_diag.repeat(1, T), qp.r_diag.repeat(1, T)], dim=1)


def split_xu(qp: StageQP, zvec: torch.Tensor):
    """(B, nz) -> x (B, T, 12), u (B, T, 12)."""
    T = qp.horizon
    nb = zvec.shape[0]
    return zvec[:, :NX * T].reshape(nb, T, NX), zvec[:, NX * T:].reshape(nb, T, NU)


def g_matvec(qp: StageQP, zvec: torch.Tensor) -> torch.Tensor:
    """G z -> (B, ni)."""
    _, u = split_xu(qp, zvec)
    return (u @ qp.g_u.transpose(-1, -2)).reshape(zvec.shape[0], -1)


def gT_matvec(qp: StageQP, lam: torch.Tensor) -> torch.Tensor:
    """G^T lam -> (B, nz)."""
    T = qp.horizon
    nb = lam.shape[0]
    gu = lam.reshape(nb, T, N_INEQ_PER_STAGE) @ qp.g_u
    zx = torch.zeros(nb, NX * T, dtype=lam.dtype, device=lam.device)
    return torch.cat([zx, gu.reshape(nb, -1)], dim=1)


def a_matvec(qp: StageQP, zvec: torch.Tensor) -> torch.Tensor:
    """A z -> (B, ne): 12 T dynamics rows, then [Mx_L, Mx_R] per stage."""
    x, u = split_xu(qp, zvec)
    nb = zvec.shape[0]
    prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    dyn_rows = x - prev @ qp.dyn.A.transpose(-1, -2) - u @ qp.dyn.B.transpose(-1, -2)
    mx_rows = torch.stack([u[:, :, _MX_COLS[0]], u[:, :, _MX_COLS[1]]], dim=-1)
    return torch.cat([dyn_rows.reshape(nb, -1), mx_rows.reshape(nb, -1)], dim=1)


def aT_matvec(qp: StageQP, y: torch.Tensor) -> torch.Tensor:
    """A^T y -> (B, nz)."""
    T = qp.horizon
    nb = y.shape[0]
    y_dyn = y[:, :NX * T].reshape(nb, T, NX)
    y_mx = y[:, NX * T:].reshape(nb, T, N_MX_PER_STAGE)
    y_next = torch.cat([y_dyn[:, 1:], torch.zeros_like(y_dyn[:, :1])], dim=1)
    grad_x = y_dyn - y_next @ qp.dyn.A
    grad_u = -(y_dyn @ qp.dyn.B)
    grad_u[:, :, _MX_COLS[0]] += y_mx[:, :, 0]
    grad_u[:, :, _MX_COLS[1]] += y_mx[:, :, 1]
    return torch.cat([grad_x.reshape(nb, -1), grad_u.reshape(nb, -1)], dim=1)


def b_vec(qp: StageQP) -> torch.Tensor:
    """(B, ne) equality rhs."""
    T = qp.horizon
    nb = qp.b0.shape[0]
    b_dyn = qp.dyn.c[:, None, :].repeat(1, T, 1)
    b_dyn[:, 0] = qp.b0
    zmx = torch.zeros(nb, N_MX_PER_STAGE * T, dtype=qp.b0.dtype, device=qp.b0.device)
    return torch.cat([b_dyn.reshape(nb, -1), zmx], dim=1)


def d_vec(qp: StageQP) -> torch.Tensor:
    """(B, ni) inequality rhs."""
    return qp.d.reshape(qp.d.shape[0], -1)


def dense_a(qp: StageQP) -> torch.Tensor:
    """(B, ne, nz) dense A in the reference's row order, built from the stage
    blocks (`biped_pympc_tpu/ops/pdipm.py:283`)."""
    T = qp.horizon
    nb = qp.f.shape[0]
    Ad, Bd = qp.dyn.A, qp.dyn.B
    eye = torch.eye(NX, dtype=Ad.dtype, device=Ad.device)
    A = torch.zeros(nb, qp.n_eq, qp.nz, dtype=Ad.dtype, device=Ad.device)
    for i in range(T):
        r = NX * i
        A[:, r:r + NX, NX * i:NX * i + NX] = eye
        if i >= 1:
            A[:, r:r + NX, NX * (i - 1):NX * i] = -Ad
        A[:, r:r + NX, NX * T + NU * i:NX * T + NU * i + NU] = -Bd
        A[:, NX * T + 2 * i, NX * T + NU * i + _MX_COLS[0]] = 1.0
        A[:, NX * T + 2 * i + 1, NX * T + NU * i + _MX_COLS[1]] = 1.0
    return A


def dense_matrices(qp: StageQP):
    """Materialize (H, f, A, b, G, d) densely, each with a leading (B,)
    axis, in the reference layout. For tests; never on the solve path."""
    T = qp.horizon
    nb = qp.f.shape[0]
    H = torch.diag_embed(h_diag(qp))
    G = torch.zeros(nb, qp.n_ineq, qp.nz, dtype=qp.f.dtype, device=qp.f.device)
    for i in range(T):
        G[:, 16 * i:16 * i + 16, NX * T + NU * i:NX * T + NU * i + NU] = qp.g_u
    return H, qp.f, dense_a(qp), b_vec(qp), G, d_vec(qp)

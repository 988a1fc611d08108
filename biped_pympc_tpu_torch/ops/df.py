"""Double-float (compensated) refinement residual, batched torch (twin of
`biped_pympc_tpu/ops/df.py`).

The refinement residual r - K d of the augmented reduced system is a
cancellation: r and K d agree to nearly all their digits, and what survives
a plain f32 subtraction is the f32 matvec's own rounding error. Here each
output component accumulates its whole linear combination as one
(sum, error) pair built from error-free transformations (Knuth two_sum,
Dekker two_prod with a Veltkamp split), so the folded result carries about
twice the working precision.

This is the plain version of the `refine_residual="df"` path of the CUDA
kernel `csrc/pdipm_ric_aug.cu` (`df_residual`). Every step is a separate
torch op, so nothing is contracted into a fused multiply-add. The split
constant is 4097 (2^12 + 1, f32's) for both dtypes, as in the JAX package:
in f64 the product error is then approximate, which is harmless there.
"""

from __future__ import annotations

import torch

from biped_pympc_tpu_torch.ops.qp import N_INEQ_PER_STAGE, N_MX_PER_STAGE, NU, NX, _MX_COLS, StageQP

# Veltkamp split constant for float32 (24-bit significand): 2^12 + 1.
_SPLIT = 4097.0


def two_sum(a, b):
    """Error-free a + b: (s, e) with s = fl(a + b), s + e = a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b: (p, e) with p = fl(a * b), p + e = a * b."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


class Acc:
    """Compensated accumulator: one (sum, error) pair per output element."""

    def __init__(self, init: torch.Tensor):
        self.s = init
        self.c = torch.zeros_like(init)

    def add(self, x):
        self.s, e = two_sum(self.s, x.expand_as(self.s))
        self.c = self.c + e
        return self

    def add_prod(self, a, b, sign: float = 1.0):
        """Accumulate sign * a * b (elementwise, broadcastable)."""
        p, pe = two_prod((a * sign).expand_as(self.s), b.expand_as(self.s))
        self.s, se = two_sum(self.s, p)
        self.c = self.c + se + pe
        return self

    def add_matmul(self, v, m, sign: float = 1.0):
        """Accumulate sign * (v @ m): v (B, T, k), m (B, k, n) into (B, T, n),
        one compensated product per term."""
        for j in range(m.shape[-2]):
            self.add_prod(v[:, :, j:j + 1], m[:, None, j, :], sign)
        return self

    def value(self):
        return self.s + self.c


def residual_aug(qp: StageQP, hd, w_diag, beta: float, delta: float, dx, dz, dy, r1, r_z, r4):
    """Compensated refinement residual of the augmented reduced system:

        e1 = r1 - [(hd + beta) dx + G^T dz + A^T dy]
        ez = r_z - [G dx - W dz]
        e4 = r4 - [A dx - delta dy]

    each component one compensated linear combination (`hd + beta` itself
    through two_sum). Every tensor has a leading (B,) axis; returns
    (e1 (B, nz), ez (B, ni), e4 (B, ne)) folded to the working dtype.
    """
    T = qp.horizon
    nb = dx.shape[0]
    dtype, dev = dx.dtype, dx.device
    Ad, Bd, g_u = qp.dyn.A, qp.dyn.B, qp.g_u
    dx_x = dx[:, :NX * T].reshape(nb, T, NX)
    dx_u = dx[:, NX * T:].reshape(nb, T, NU)
    dz_s = dz.reshape(nb, T, N_INEQ_PER_STAGE)
    y_dyn = dy[:, :NX * T].reshape(nb, T, NX)
    y_mx = dy[:, NX * T:].reshape(nb, T, N_MX_PER_STAGE)
    y_next = torch.cat([y_dyn[:, 1:], torch.zeros_like(y_dyn[:, :1])], dim=1)
    scalar = lambda v: torch.full((), v, dtype=dtype, device=dev)

    # hd + beta compensated (beta underflows against the large Q entries).
    hb, hb_err = two_sum(hd, scalar(beta))
    q_b, q_e = hb[:, :NX * T].reshape(nb, T, NX), hb_err[:, :NX * T].reshape(nb, T, NX)
    r_b, r_e = hb[:, NX * T:].reshape(nb, T, NU), hb_err[:, NX * T:].reshape(nb, T, NU)

    # e1, x rows: r1_x - (q + beta) dx_x - y_dyn + y_next @ Ad
    a1x = Acc(r1[:, :NX * T].reshape(nb, T, NX))
    a1x.add_prod(q_b, dx_x, -1.0)
    a1x.add_prod(q_e, dx_x, -1.0)
    a1x.add(-y_dyn)
    a1x.add_matmul(y_next, Ad)

    # e1, u rows: r1_u - (r + beta) dx_u - dz_s @ g_u + y_dyn @ Bd - y_mx (cols)
    a1u = Acc(r1[:, NX * T:].reshape(nb, T, NU))
    a1u.add_prod(r_b, dx_u, -1.0)
    a1u.add_prod(r_e, dx_u, -1.0)
    a1u.add_matmul(dz_s, g_u, -1.0)
    a1u.add_matmul(y_dyn, Bd)
    y_mx_full = torch.zeros(nb, T, NU, dtype=dtype, device=dev)
    y_mx_full[:, :, _MX_COLS[0]] = y_mx[:, :, 0]
    y_mx_full[:, :, _MX_COLS[1]] = y_mx[:, :, 1]
    a1u.add(-y_mx_full)

    # ez: r_z - dx_u @ g_u^T + W dz
    az = Acc(r_z.reshape(nb, T, N_INEQ_PER_STAGE))
    az.add_matmul(dx_u, g_u.transpose(-1, -2), -1.0)
    az.add_prod(w_diag.reshape(nb, T, N_INEQ_PER_STAGE), dz_s)

    # e4, dynamics rows: r4_dyn - dx_x + prev @ Ad^T + dx_u @ Bd^T + delta y_dyn
    prev = torch.cat([torch.zeros_like(dx_x[:, :1]), dx_x[:, :-1]], dim=1)
    a4 = Acc(r4[:, :NX * T].reshape(nb, T, NX))
    a4.add(-dx_x)
    a4.add_matmul(prev, Ad.transpose(-1, -2))
    a4.add_matmul(dx_u, Bd.transpose(-1, -2))
    a4.add_prod(scalar(delta), y_dyn)

    # e4, Mx rows: r4_mx - dx_u[:, :, mx] + delta y_mx
    a4m = Acc(r4[:, NX * T:].reshape(nb, T, N_MX_PER_STAGE))
    a4m.add(-dx_u[:, :, list(_MX_COLS)])
    a4m.add_prod(scalar(delta), y_mx)

    e1 = torch.cat([a1x.value().reshape(nb, -1), a1u.value().reshape(nb, -1)], dim=1)
    ez = az.value().reshape(nb, -1)
    e4 = torch.cat([a4.value().reshape(nb, -1), a4m.value().reshape(nb, -1)], dim=1)
    return e1, ez, e4

"""Plain batched Mehrotra predictor-corrector interior-point solve of the
MPC's QPs, min 0.5 x'Hx + f'x s.t. A x = b, G x <= d, from the cold start
x = 0, s = max(d, 1), z = 1, y = 1, for a fixed number of Newton steps:
the update rule of the reference solver this repository follows (the
numpy golden of its JAX package, `reference_pdipm.solve`, step for step),
batched over envs in torch. Each Newton direction solves the KKT system
with s and z eliminated, [[H + beta + G' W^-1 G, A'], [A, -delta]], by a
dense LU; in exact arithmetic that is the direction of the full system.

In float64 it is the check's reference. In a half-width type (bfloat16,
float16), the control's, every quantity is held in that type and only the
LU factor and solve run in float32 on its rounded entries, since torch has
no half-width LU.
"""

from __future__ import annotations

import torch


def _frac_to_boundary(v, dv):
    cand = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -torch.ones_like(dv)),
                       torch.ones_like(v))
    return torch.clamp(torch.clamp(0.99 * cand.min(-1).values, max=1.0), min=1e-12)[:, None]


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def _solve(H, f, A, b, G, d, iterations, beta, delta):
    dtype = f.dtype
    lu_dtype = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    nb, nz = f.shape
    ne, ni = b.shape[1], d.shape[1]
    x, s = torch.zeros_like(f), torch.clamp(d, min=1.0)
    z = torch.ones_like(d)
    y = torch.ones(nb, ne, dtype=dtype, device=f.device)
    Gt, At = G.transpose(-1, -2), A.transpose(-1, -2)
    eye_e = torch.eye(ne, dtype=dtype, device=f.device)
    mu_end = None
    for _ in range(iterations):
        rx = H * x + f + _mv(Gt, z) + _mv(At, y)
        re = _mv(A, x) - b
        rs = _mv(G, x) + s - d
        mu = (s * z).sum(-1) / ni
        sig = z / s + delta
        w_inv = sig / (1.0 + delta * sig)
        kxx = torch.diag_embed(H + beta) + Gt @ (w_inv[..., None] * G)
        m = torch.cat([torch.cat([kxx, At], 2), torch.cat([A, -delta * eye_e.expand(nb, ne, ne)],
                                                            2)], 1)
        lu, piv = torch.linalg.lu_factor(m.to(lu_dtype))

        def reduced(r1, r2, r3, r4):
            r1h = r1 + _mv(Gt, w_inv * (r3 - r2 / sig))
            rhs = torch.cat([r1h, r4], 1).to(lu_dtype)[..., None]
            sol = torch.linalg.lu_solve(lu, piv, rhs)[..., 0].to(dtype)
            dx, dy = sol[:, :nz], sol[:, nz:]
            dz = w_inv * (_mv(G, dx) + r2 / sig - r3)
            return dx, (r2 - dz) / sig, dz, dy

        dx_a, ds_a, dz_a, dy_a = reduced(-rx, -(s * z) / s, -rs, -re)
        a_p, a_d = _frac_to_boundary(s, ds_a), _frac_to_boundary(z, dz_a)
        mu_aff = ((s + a_p * ds_a) * (z + a_d * dz_a)).sum(-1) / ni
        sigma = (mu_aff / mu) ** 3
        rc = s * z + ds_a * dz_a - (sigma * mu)[:, None]
        zero_x, zero_i, zero_e = torch.zeros_like(x), torch.zeros_like(s), torch.zeros_like(b)
        dx_c, ds_c, dz_c, dy_c = reduced(zero_x, -rc / s, zero_i, zero_e)
        dx, ds, dz, dy = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c, dy_a + dy_c
        a_p, a_d = _frac_to_boundary(s, ds), _frac_to_boundary(z, dz)
        x = x + a_p * dx
        s = torch.clamp(s + a_p * ds, min=1e-8)
        z = torch.clamp(z + a_d * dz, min=1e-8)
        y = y + a_d * dy
        mu_end = (s * z).sum(-1) / ni
    return x, mu_end


def solve_qp(H, f, A, b, G, d, iterations: int = 20, beta: float = 1e-8, delta: float = 1e-8,
             chunk: int = 1024):
    """(x (B, nz), final mu (B,)) after `iterations` Newton steps. H (B, nz)
    is the cost's diagonal, f (B, nz), A (B, ne, nz), b (B, ne), G (B, ni,
    nz), d (B, ni); the batch runs `chunk` envs at a time."""
    xs, mus = [], []
    for i in range(0, f.shape[0], chunk):
        sl = slice(i, i + chunk)
        x, mu = _solve(H[sl], f[sl], A[sl], b[sl], G[sl], d[sl], iterations, beta, delta)
        xs.append(x)
        mus.append(mu)
    return torch.cat(xs), torch.cat(mus)

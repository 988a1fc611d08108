"""Batched small-matrix inverses (twin of `biped_pympc_tpu/ops/linalg.py`).

Written out in torch so the plain solver performs the same eliminations as
the JAX package and the CUDA kernel; `torch.linalg.inv` serves only as a
test oracle.
"""

from __future__ import annotations

import torch


def inverse_3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate / determinant) inverse of (..., 3, 3)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def gauss_jordan_inverse(a: torch.Tensor, pivot: bool = True) -> torch.Tensor:
    """Invert (..., n, n) by Gauss-Jordan elimination on the (n, 2n) tableau.

    With `pivot`, each step picks the largest |entry| of column k among rows
    >= k (the first one on ties) and swaps it into row k; without, it takes
    the diagonal as it stands (`pdipm_pallas._gj_inverse_nopivot`), for the
    definite and quasi-definite blocks. Then it normalizes row k and
    eliminates column k from every other row.
    """
    n = a.shape[-1]
    batch = a.shape[:-2]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(*batch, n, n)
    aug = torch.cat([a, eye], dim=-1)
    rows = torch.arange(n, device=a.device)
    for k in range(n):
        row_p = aug[..., k, :]
        if pivot:
            cand = torch.where(rows >= k, aug[..., :, k].abs(),
                               torch.full_like(aug[..., :, k], -1.0))
            p = torch.argmax(cand, dim=-1)
            row_p = torch.gather(
                aug, -2, p[..., None, None].expand(*batch, 1, 2 * n))[..., 0, :]
            row_k = aug[..., k, :]
            is_p = (rows == p[..., None])[..., None]
            aug = torch.where(is_p, row_k[..., None, :], aug)
        pivot_row = row_p / row_p[..., k:k + 1]
        aug[..., k, :] = pivot_row
        factors = aug[..., :, k].clone()
        factors[..., k] = 0.0
        aug = aug - factors[..., None] * pivot_row[..., None, :]
    return aug[..., n:]

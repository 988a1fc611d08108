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


GJ_FORMS = ("inplace", "tableau")


def gauss_jordan_inverse(a: torch.Tensor, pivot: bool = True, form: str = "tableau") -> torch.Tensor:
    """Invert (..., n, n) by Gauss-Jordan elimination.

    With `pivot`, each step picks the largest |entry| of column k among rows
    >= k (the first one on ties) and swaps it into row k; without, it takes
    the diagonal as it stands, for the definite and quasi-definite blocks.
    `form` is the arithmetic of the no-pivot elimination: "tableau" divides
    row k by the pivot on the (n, 2n) tableau (`pdipm_pallas._gj_inverse_nopivot`),
    "inplace" multiplies by its reciprocal in place
    (`_gj_inverse_nopivot_inplace`, `_gj_inplace`). The pivoted elimination
    divides, as `pdipm_pallas._gj_inverse` does.
    """
    if form not in GJ_FORMS:
        raise ValueError(f"unknown Gauss-Jordan form {form!r}; expected one of {GJ_FORMS}")
    if form == "inplace":
        if pivot:
            raise ValueError("the in-place Gauss-Jordan form has no pivot search")
        return _gj_inplace(a)
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


def _onehot(n: int, k: int, like: torch.Tensor) -> torch.Tensor:
    return (torch.arange(n, device=like.device) == k).to(like.dtype)


def _gj_inplace(a: torch.Tensor) -> torch.Tensor:
    """In-place Jordan inverse of (..., n, n) without pivot search, term for
    term `pdipm_pallas._gj_inverse_nopivot_inplace`: row k scaled by the
    pivot's reciprocal, its diagonal the reciprocal itself, and one
    multiplicative cross-masked rank-1 update per step."""
    n = a.shape[-1]
    for k in range(n):
        ipiv = 1.0 / a[..., k, k]
        ek = _onehot(n, k, a)
        p_row = ipiv[..., None] * (a[..., k, :] * (1.0 - ek) + ek)
        f = a[..., :, k] * (1.0 - ek) - ek
        cross = (1.0 - ek)[:, None] * (1.0 - ek)[None, :]
        a = a * cross - f[..., :, None] * p_row[..., None, :]
    return a


def gauss_jordan_pair_inverse(pair: torch.Tensor, pivot: bool) -> torch.Tensor:
    """Invert the two (..., n, n) matrices packed side by side in the
    columns of `pair` (..., n, 2n), [A_L | A_R] -> [A_L^-1 | A_R^-1], by one
    paired elimination: `pdipm_pallas._gj_pair_pivot` with `pivot` (each half
    its own pivot search, as argmax: NaN above every number, the first
    maximum on ties, and its own row swaps), `_gj_pair_inplace` without. Both
    scale the pivot row by the pivot's reciprocal."""
    return _gj_pair_pivot(pair) if pivot else _gj_pair_inplace(pair)


def _gj_pair_inplace(a: torch.Tensor) -> torch.Tensor:
    """`pdipm_pallas._gj_pair_inplace` term for term on (..., n, 2n)."""
    n = a.shape[-2]
    hl = (torch.arange(2 * n, device=a.device) < n).to(a.dtype)
    hr = 1.0 - hl
    for k in range(n):
        ipiv_l = 1.0 / a[..., k, k]
        ipiv_r = 1.0 / a[..., k, n + k]
        ekr = _onehot(n, k, a)
        ekc = _onehot(2 * n, k, a) + _onehot(2 * n, n + k, a)
        ipiv_cols = hl * ipiv_l[..., None] + hr * ipiv_r[..., None]
        p_row = ipiv_cols * (a[..., k, :] * (1.0 - ekc) + ekc)
        p_row_l, p_row_r = p_row * hl, p_row * hr
        f_l = a[..., :, k] * (1.0 - ekr) - ekr
        f_r = a[..., :, n + k] * (1.0 - ekr) - ekr
        cross = (1.0 - ekr)[:, None] * (1.0 - ekc)[None, :]
        a = (a * cross - f_l[..., :, None] * p_row_l[..., None, :]
             - f_r[..., :, None] * p_row_r[..., None, :])
    return a


def _gj_pair_pivot(s_pair: torch.Tensor) -> torch.Tensor:
    """`pdipm_pallas._gj_pair_pivot` term for term on (..., n, 2n): the
    (n, 4n) tableau [A_L | I | A_R | I], per-half pivot rows gathered and
    swapped by one-hot masks."""
    n = s_pair.shape[-2]
    batch = s_pair.shape[:-2]
    eye = torch.eye(n, dtype=s_pair.dtype, device=s_pair.device).expand(*batch, n, n)
    aug = torch.cat([s_pair[..., :n], eye, s_pair[..., n:], eye], dim=-1)
    rows = torch.arange(n, device=s_pair.device)
    hl = (torch.arange(4 * n, device=s_pair.device) < 2 * n).to(s_pair.dtype)
    hr = 1.0 - hl
    for k in range(n):
        cand = lambda col: torch.where(rows >= k, aug[..., :, col].abs(),
                                       torch.full_like(aug[..., :, col], -1.0))
        oh_l = (rows == torch.argmax(cand(k), dim=-1)[..., None]).to(aug.dtype)
        oh_r = (rows == torch.argmax(cand(2 * n + k), dim=-1)[..., None]).to(aug.dtype)
        isk = _onehot(n, k, aug)
        row_k = aug[..., k, :]
        row_p = (oh_l[..., None] * aug).sum(dim=-2) * hl + (oh_r[..., None] * aug).sum(dim=-2) * hr
        swap = oh_l[..., None] * hl + oh_r[..., None] * hr
        keep = (1.0 - isk)[:, None] * (1.0 - swap)
        aug = aug * keep + isk[:, None] * row_p[..., None, :] + swap * row_k[..., None, :]
        ipiv_cols = hl / row_p[..., k, None] + hr / row_p[..., 2 * n + k, None]
        pivot_row = row_p * ipiv_cols
        aug = torch.where(isk.bool()[:, None], pivot_row[..., None, :], aug)
        f_l = (1.0 - isk) * aug[..., :, k]
        f_r = (1.0 - isk) * aug[..., :, 2 * n + k]
        aug = (aug - f_l[..., :, None] * (pivot_row * hl)[..., None, :]
               - f_r[..., :, None] * (pivot_row * hr)[..., None, :])
    return torch.cat([aug[..., n:2 * n], aug[..., 3 * n:]], dim=-1)

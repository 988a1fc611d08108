"""Fixed-iteration Mehrotra PDIPM, plain batched torch (twin of the routes
of the Pallas kernel `biped_pympc_tpu/ops/pdipm_pallas.py`: "ric_aug" and
"ric" with and without the foot split, "ric2", "tridiag_aug" and "tridiag",
with `kkt_scale` "none" or "jacobi"; and of the pure-JAX routes of the same
names in `biped_pympc_tpu/ops/pdipm.py`, "dense" among them).

This is the plain version of the CUDA kernels in `ops/pdipm_cuda.py`: the
CPU path runs it, and the kernels are held against it on the card. The
"dense" route (a batched LU of the whole condensed reduced KKT, which JAX
computes with XLA's LU outside any Pallas kernel) has no kernel: it runs
here on both devices. `solve`
starts from the cold start or from a given `PdipmState` (warm start);
`solve_adaptive_batch` runs the solve in chunks with an early stop.

Where the pure-JAX routes of `biped_pympc_tpu/ops/pdipm.py` ignore a field
of `PdipmOptions`, these routes follow the Pallas kernel, whose plain
version they are: `foot_pack` (the paired stage inverses, `:675-709`,
`:791-823`), `gj_form` (every no-pivot inverse, the y-chain's included,
`:327-331`), `k_pivot` (`:921`), `aug_pivot` (`:800-825`, `:1037`) and
`refine_skip_iters` (`:1499-1517`). `corrector_form`, `sigma_cap` and the
step constants follow `iteration_base` (`:1237-1485`).

The Riccati routes eliminate the slacks s and eliminate or keep the
inequality duals z per stage, then fold the stage blocks into a 12-wide
dual-Riccati chain in y with coupling S = Q~^-1 Ad^T, swept forward and
backward per solve.

- "ric_aug" (augmented): per stage the [u (12), z (16), nu (2)] block

      K_t = [[R+beta, G_u^T, e^T], [G_u, -W_t, 0], [e, 0, -delta I]]

  keeps every extreme scale (W up to ~1e8, -delta) on its own diagonal,
  where pivoted elimination handles it. K_t splits exactly by foot into two
  12-wide blocks [F (3), M_y (1), z_f (8)], two W-independent 2x2
  [M_x, nu] pairs and two M_z scalars.
- "ric" (condensed): z is eliminated with W^-1 = Sigma / (1 + delta Sigma),
  and the [u (12), nu (2)] block

      K_t = [[R+beta + G_u^T W_t^-1 G_u, e^T], [e, -delta I]]

  splits into two 4x4 SPD blocks on u columns {0,1,2,7} / {3,4,5,10}, the
  same 2x2 pairs and the same scalars. Cheaper, but the 1e8 scale enters the
  SPD blocks (the f32 tail the hybrid mode re-solves, `pdipm_cuda.py`).
- "ric2" (condensed, rank 2): the 12-wide SPD Ru = R+beta + G_u^T W_t^-1 G_u
  is inverted and the nu pair eliminated by the Schur identity,
  S = -delta I - E Ru^-1 E^T in closed form (`factor_ric2`, `:839`).

With `foot_split=False` the "ric" / "ric_aug" blocks are inverted whole, 14
and 30 wide (`factor_ric:896`, `factor_ric_aug:1007`), the dense cross-check
of the split.

- "ric_aug_core" (scaled Riccati core, `biped_pympc_tpu/ops/pdipm.py:836-985`):
  "ric_aug"'s system with the inputs scaled, u = C u_hat, C = diag(1 /
  sqrt(R + beta)), so the stage block is [[I, V^T], [V, -Wfull]], V = [G_u C;
  E C] (18 x 12), and u is eliminated first: S = -(Wfull + V V^T), block
  diagonal [8, 8, 1, 1], inverted with partial pivoting (by block with
  `foot_split`, else whole), K_hat^-1 applied by the block formula. A
  pure-JAX route with no Pallas kernel, so plain torch on both devices, as
  "dense" (`PLAIN_BACKENDS`). The JAX package keeps it as a closed negative:
  S is rank-deficient on a swinging foot, where its explicit inverse loses
  the solution in f32. `kkt_scale="jacobi"` inverts each stage block (never the
closed-form pairs and scalars) through D (D K D)^-1 D, D = |diag K|^-1/2
(`jacobi_scaled`, `:333`).

The block-Thomas routes eliminate the x_{t+1} rows in closed form (their
pivot Q + beta is diagonal) and factor the rest stage by stage, in order:
the stage block holds y_t next to [u, nu] ("tridiag", 26 wide, condensed as
"ric") or [u, z, nu] ("tridiag_aug", 42 wide, augmented as "ric_aug"), with
the Riccati term -Ad M_{t-1} Ad^T in its y block. Each block is inverted
whole, with partial pivoting (`pdipm_pallas.py:424-521`, `:1134-1230`).

Every tensor is batch-first; the T stages are a Python loop only where the
recursion is sequential (the y-chain, the Thomas factor and the sweeps).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from typing import Callable

import torch

from biped_pympc_tpu_torch.ops import df as dfm
from biped_pympc_tpu_torch.ops import qp as qps
from biped_pympc_tpu_torch.ops.linalg import GJ_FORMS, gauss_jordan_inverse, gauss_jordan_pair_inverse
from biped_pympc_tpu_torch.ops.qp import NU, NX, N_INEQ_PER_STAGE, N_MX_PER_STAGE, StageQP

BACKENDS = ("ric_aug", "ric", "tridiag_aug", "tridiag", "ric2", "dense", "ric_aug_core")
# z kept in the stage blocks; "df" runs here
AUG_BACKENDS = ("ric_aug", "tridiag_aug", "ric_aug_core")
# Routes with no CUDA kernel: JAX computes them outside any Pallas kernel, so
# the plain version here runs them on both devices.
PLAIN_BACKENDS = ("dense", "ric_aug_core")
REFINE_RESIDUALS = ("f32", "df")
KKT_SCALES = ("none", "jacobi")
CORRECTOR_FORMS = ("delta", "combined", "sum_refine", "aff_ref")
FOOT_PACKS = (False, True, "apply")
N_KA = NU + N_INEQ_PER_STAGE + N_MX_PER_STAGE  # 30: [u, z, nu] per stage
N_KC = NU + N_MX_PER_STAGE  # 14: [u, nu] per stage
# Foot-split index sets: each foot's constraint rows touch only its own
# {F, M_y}. u = [F_L, F_R, M_L, M_R]; z rows follow u in the 30-wide block.
FOOT_U_COLS = ((0, 1, 2, 7), (3, 4, 5, 10))
FOOT_BLOCKS = tuple(cols + tuple(range(NU + 8 * foot, NU + 8 * foot + 8))
                    for foot, cols in enumerate(FOOT_U_COLS))  # [F, M_y, z_f(8)]


@dataclass(frozen=True)
class PdipmOptions:
    """Solver settings: every field `_pdipm_kernel` reads, with the names and
    defaults of `biped_pympc_tpu/ops/pdipm.py:62-201`. Two JAX fields are
    left out: `interpret` (the Pallas lowering switch) and `inv_impl` (the
    stage inverse of the pure-JAX block routes, Gauss-Jordan or
    `jnp.linalg.inv`; these routes follow the Pallas kernel's inverses)."""

    iterations: int = 20
    iterations_per_launch: int = 5  # Newton steps per chunk of the adaptive solve
    beta: float = 1e-8  # primal regularization
    delta: float = 1e-8  # dual regularization
    frac_to_boundary: float = 0.99  # step = this x the largest feasible one
    alpha_min: float = 1e-12  # floor of a step length
    sz_floor: float = 1e-8  # floor of s and z after a step
    # "ric_aug" / "tridiag_aug" / "ric_aug_core" (augmented) | "ric" / "ric2" /
    # "tridiag" / "dense" (condensed)
    backend: str = "tridiag"
    refine_steps: int = 0  # iterative-refinement passes per reduced solve
    # The first min(this, iterations) Newton steps of a solve (of a launch,
    # under the adaptive solve's chunks) run at refine 0, the rest at
    # refine_steps; only when refine_steps > 0.
    refine_skip_iters: int = 0
    # Precision of the refinement residual r - K d: "f32" is the working
    # dtype, "df" one compensated (double-float) sum per component
    # (`ops/df.py`). "df" runs on the augmented routes only, and not with
    # corrector_form "sum_refine".
    refine_residual: str = "f32"
    sigma_cap: float = 0.0  # > 0: cap z / s + delta at this value before W is formed
    # The no-pivot Gauss-Jordan inverses: "inplace" scales the pivot row by
    # the pivot's reciprocal, "tableau" divides it (`linalg.gauss_jordan_inverse`).
    gj_form: str = "inplace"
    # "delta": refined affine + refined corrector solves, added (the
    # reference rule); "combined": unrefined affine, then one refined solve
    # of the summed rhs; "sum_refine": both unrefined, the sum refined
    # against the full 4-row KKT residual; "aff_ref": refined affine,
    # unrefined corrector.
    corrector_form: str = "delta"
    aug_pivot: bool = True  # "ric_aug": pivot search in the stage inverses
    k_pivot: bool = False  # "ric" unsplit: pivot search in the 14-wide stage inverse
    # "ric" / "ric_aug": invert each foot's block apart (the stage blocks
    # decouple exactly by foot) or, False, the whole 14- / 30-wide block;
    # "ric_aug_core" likewise its 18-wide S. Ignored by the others.
    foot_split: bool = False
    # "jacobi": each stage inverse of the Riccati routes through its Jacobi
    # equilibration, K^-1 = D (D K D)^-1 D (exact; only rounding changes).
    # The block-Thomas routes and the packed split ignore it, as in the JAX
    # kernel.
    kkt_scale: str = "none"
    # The split "ric" / "ric_aug" routes: False, or both feet's stage blocks
    # stored as one (n, 2n) pair [K_L | K_R], inverted by one paired
    # elimination (True) or by the split's own and then packed ("apply").
    foot_pack: bool | str = False


@dataclass
class PdipmState:
    x: torch.Tensor  # (B, nz)
    s: torch.Tensor  # (B, ni)
    z: torch.Tensor  # (B, ni)
    y: torch.Tensor  # (B, ne)


@dataclass
class PdipmResult:
    x: torch.Tensor
    s: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    residuals: torch.Tensor  # (B, 4): ||rx||, ||rs||, ||re|| of the last
    # step's start, and mu = s.z / ni after it


def init_state(qp: StageQP) -> PdipmState:
    """Cold start x = 0, s = max(d, 1), z = 1, y = 1."""
    d = qps.d_vec(qp)
    nb = d.shape[0]
    return PdipmState(
        x=torch.zeros_like(qp.f),
        s=torch.clamp(d, min=1.0),
        z=torch.ones_like(d),
        y=torch.ones(nb, qp.n_eq, dtype=d.dtype, device=d.device),
    )


def _frac_to_boundary(v: torch.Tensor, dv: torch.Tensor, opts: "PdipmOptions") -> torch.Tensor:
    """(B,) largest step in (0, 1] keeping v + alpha dv > 0, times
    `opts.frac_to_boundary`, at least `opts.alpha_min`."""
    neg = dv < 0
    cand = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                       torch.ones_like(v))
    alpha = torch.clamp(opts.frac_to_boundary * cand.min(dim=-1).values, max=1.0)
    return torch.clamp(alpha, min=opts.alpha_min)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


@dataclass
class _Factors:
    kinv: Callable  # (B, T, n) -> (B, T, n): K_t^-1 r per stage, n = 30 or 14
    yhat_inv: torch.Tensor  # (B, T, 12, 12) y-chain inverses
    q_inv: torch.Tensor  # (B, 12)
    s_coup: torch.Tensor  # (B, 12, 12) S = Q~^-1 Ad^T


def _jacobi_scaled(inverse, k: torch.Tensor, opts: "PdipmOptions") -> torch.Tensor:
    """inverse(k) for (..., n, n) blocks, through the Jacobi-equilibrated
    K_hat = D K D, D = 1 / sqrt(max(|diag K|, 1e-30)), when `opts.kkt_scale`
    is "jacobi": K^-1 = D K_hat^-1 D (`pdipm_pallas.py:333`)."""
    if opts.kkt_scale != "jacobi":
        return inverse(k)
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(k, dim1=-2, dim2=-1).abs(), min=1e-30))
    di, dj = d[..., :, None], d[..., None, :]
    return inverse(k * di * dj) * di * dj


def _nopivot(opts: "PdipmOptions") -> Callable:
    """The no-pivot inverse of `opts.gj_form` (`pdipm_pallas.py:327-331`)."""
    return lambda k: gauss_jordan_inverse(k, pivot=False, form=opts.gj_form)


def _pivoted_or_not(pivot: bool, opts: "PdipmOptions") -> Callable:
    """The pivoted inverse (`_gj_inverse`) when `pivot`, else `_nopivot`."""
    return gauss_jordan_inverse if pivot else _nopivot(opts)


def _packed(opts: "PdipmOptions") -> bool:
    """The split "ric" / "ric_aug" stage blocks are packed in pairs."""
    return bool(opts.foot_pack) and opts.foot_split and opts.backend in ("ric", "ric_aug")


def _bkb_packed(qp: StageQP, k8: torch.Tensor, opts: "PdipmOptions") -> torch.Tensor:
    """(B, T, 12, 12) Bd (K_t^-1)_uu Bd^T from the packed (B, T, 4, 8) pair of
    the feet's {F, M_y} inverses, in the order of `_split_bkb_pack`
    (`pdipm_pallas.py:630-645`): [Bd_L K_L^-1 | Bd_R K_R^-1] contracted with
    [Bd_L | Bd_R] over the 8 packed columns, plus the W-independent columns
    6, 8, 9, 11 (`_bkb_couter`)."""
    bd = qp.dyn.B
    bd_l, bd_r = (bd[:, :, list(cols)] for cols in FOOT_U_COLS)  # (B, 12, 4)
    m1 = torch.cat([bd_l[:, None] @ k8[..., :4], bd_r[:, None] @ k8[..., 4:]], dim=-1)
    bkb = m1 @ torch.cat([bd_l, bd_r], dim=-1).transpose(-1, -2)[:, None]
    couter = 0.0
    for j in (6, 8, 9, 11):
        rj = qp.r_diag[:, j] + opts.beta
        c = -opts.delta / (-rj * opts.delta - 1.0) if j in (6, 9) else 1.0 / rj
        couter = couter + bd[:, :, j, None] * bd[:, None, :, j] * c[:, None, None]
    return bkb + couter[:, None]


def _gtwg(qp: StageQP, w: torch.Tensor, cols=slice(None), rows=slice(None)) -> torch.Tensor:
    """(B, T, n, n) G^T diag(w_t) G over the given rows and columns of G_u."""
    g = qp.g_u[:, rows][:, :, cols]  # (B, r, n)
    return (g[:, None] * w[:, :, rows, None]).transpose(-1, -2) @ g[:, None]


def _scatter_w_independent(k_inv: torch.Tensor, qp: StageQP, opts: PdipmOptions) -> None:
    """Write the [M_x, nu] = [[r + beta, 1], [1, -delta]]^-1 pairs and the
    M_z = 1 / (r + beta) scalars into k_inv (B, T, n, n); nu rows are last."""
    n = k_inv.shape[-1]
    for j, nu in ((6, n - 2), (9, n - 1)):
        rj = qp.r_diag[:, j] + opts.beta
        det = -rj * opts.delta - 1.0
        k_inv[:, :, j, j] = (-opts.delta / det)[:, None]
        k_inv[:, :, j, nu] = (-1.0 / det)[:, None]
        k_inv[:, :, nu, j] = (-1.0 / det)[:, None]
        k_inv[:, :, nu, nu] = (rj / det)[:, None]
    for j in (8, 11):
        k_inv[:, :, j, j] = (1.0 / (qp.r_diag[:, j] + opts.beta))[:, None]


def _foot_inverses(blocks: torch.Tensor, opts: PdipmOptions, pivot: bool) -> tuple:
    """Inverses of the split's foot blocks (B, 2, T, n, n), pivoted or not,
    and None or, when packed, the (B, T, 4, 8) pair of their {F, M_y}
    corners. Packed (`foot_pack`, `pdipm_pallas.py:675-709`, `:791-823`):
    True inverts each stage's pair [K_L | K_R] by one paired elimination,
    "apply" the blocks as the split does and then packs them; neither
    equilibrates (the JAX kernel ignores `kkt_scale` there)."""
    if not _packed(opts):
        return _jacobi_scaled(_pivoted_or_not(pivot, opts), blocks, opts), None
    n = blocks.shape[-1]
    if opts.foot_pack == "apply":
        inv = _pivoted_or_not(pivot, opts)(blocks)
    else:
        pair = gauss_jordan_pair_inverse(torch.cat([blocks[:, 0], blocks[:, 1]], dim=-1), pivot)
        inv = torch.stack([pair[..., :n], pair[..., n:]], dim=1)
    return inv, torch.cat([inv[:, 0, :, :4, :4], inv[:, 1, :, :4, :4]], dim=-1)


def _stage_inverse_aug(qp: StageQP, w_diag: torch.Tensor, opts: PdipmOptions):
    """(B, T, 30, 30) augmented K_t^-1, and the packed corners (`_foot_inverses`);
    w_diag (B, T, 16) = Sigma^-1 + delta."""
    T = qp.horizon
    nb = w_diag.shape[0]
    dtype, dev = w_diag.dtype, w_diag.device
    # Foot blocks [[diag(r+beta), G_f^T], [G_f, -diag(W_f)]], all (B, 2, T).
    blocks = torch.zeros(nb, 2, T, 12, 12, dtype=dtype, device=dev)
    for foot, cols in enumerate(FOOT_U_COLS):
        cols = list(cols)
        g_f = qp.g_u[:, 8 * foot:8 * foot + 8][:, :, cols]  # (B, 8, 4)
        blocks[:, foot, :, :4, :4] = torch.diag_embed(qp.r_diag[:, cols] + opts.beta)[:, None]
        blocks[:, foot, :, :4, 4:] = g_f.transpose(-1, -2)[:, None]
        blocks[:, foot, :, 4:, :4] = g_f[:, None]
        blocks[:, foot, :, 4:, 4:] = torch.diag_embed(-w_diag[:, :, 8 * foot:8 * foot + 8])
    blocks_inv, k8 = _foot_inverses(blocks, opts, opts.aug_pivot)

    k_inv = torch.zeros(nb, T, N_KA, N_KA, dtype=dtype, device=dev)
    for foot, idx in enumerate(FOOT_BLOCKS):
        ix = torch.tensor(idx, device=dev)
        k_inv[:, :, ix[:, None], ix[None, :]] = blocks_inv[:, foot]
    _scatter_w_independent(k_inv, qp, opts)
    return k_inv, k8


def _stage_inverse_ric(qp: StageQP, w_inv: torch.Tensor, opts: PdipmOptions):
    """(B, T, 14, 14) condensed K_t^-1, and the packed corners (`_foot_inverses`);
    w_inv (B, T, 16) = Sigma / (1 + delta Sigma)."""
    T = qp.horizon
    nb = w_inv.shape[0]
    dtype, dev = w_inv.dtype, w_inv.device
    blocks = torch.stack([
        _gtwg(qp, w_inv, list(cols), slice(8 * foot, 8 * foot + 8))
        + torch.diag_embed(qp.r_diag[:, list(cols)] + opts.beta)[:, None]
        for foot, cols in enumerate(FOOT_U_COLS)], dim=1)  # (B, 2, T, 4, 4)
    blocks_inv, k8 = _foot_inverses(blocks, opts, pivot=False)
    k_inv = torch.zeros(nb, T, N_KC, N_KC, dtype=dtype, device=dev)
    for foot, cols in enumerate(FOOT_U_COLS):
        ix = torch.tensor(cols, device=dev)
        k_inv[:, :, ix[:, None], ix[None, :]] = blocks_inv[:, foot]
    _scatter_w_independent(k_inv, qp, opts)
    return k_inv, k8


def _e_select(dtype, dev) -> torch.Tensor:
    """(2, 12) selector E of the Mx rows: u columns 6 and 9."""
    e = torch.zeros(N_MX_PER_STAGE, NU, dtype=dtype, device=dev)
    e[0, 6] = e[1, 9] = 1.0
    return e


def _stage_inverse_ric_dense(qp: StageQP, w_inv: torch.Tensor,
                             opts: PdipmOptions) -> torch.Tensor:
    """(B, T, 14, 14) inverse of the unsplit condensed block
    [[R+beta + G_u^T W_t^-1 G_u, e^T], [e, -delta I]] (`factor_ric:896`):
    symmetric quasi-definite, so inverted without pivoting unless
    `opts.k_pivot` (`:921`)."""
    nb, T = w_inv.shape[0], qp.horizon
    dtype, dev = w_inv.dtype, w_inv.device
    e = _e_select(dtype, dev)
    k = torch.zeros(nb, T, N_KC, N_KC, dtype=dtype, device=dev)
    k[:, :, :NU, :NU] = _gtwg(qp, w_inv) + torch.diag_embed(qp.r_diag + opts.beta)[:, None]
    k[:, :, :NU, NU:] = e.T
    k[:, :, NU:, :NU] = e
    k[:, :, NU:, NU:] = -opts.delta * torch.eye(N_MX_PER_STAGE, dtype=dtype, device=dev)
    return _jacobi_scaled(_pivoted_or_not(opts.k_pivot, opts), k, opts)


def _stage_inverse_aug_dense(qp: StageQP, w_diag: torch.Tensor,
                             opts: PdipmOptions) -> torch.Tensor:
    """(B, T, 30, 30) inverse of the unsplit augmented block
    [[R+beta, G_u^T, e^T], [G_u, -W_t, 0], [e, 0, -delta I]]
    (`factor_ric_aug:1007`), with partial pivoting when `opts.aug_pivot`."""
    nb, T = w_diag.shape[0], qp.horizon
    dtype, dev = w_diag.dtype, w_diag.device
    e = _e_select(dtype, dev)
    z0, n0 = NU, NU + N_INEQ_PER_STAGE
    k = torch.zeros(nb, T, N_KA, N_KA, dtype=dtype, device=dev)
    k[:, :, :NU, :NU] = torch.diag_embed(qp.r_diag + opts.beta)[:, None]
    k[:, :, :NU, z0:n0] = qp.g_u.transpose(-1, -2)[:, None]
    k[:, :, z0:n0, :NU] = qp.g_u[:, None]
    k[:, :, z0:n0, z0:n0] = torch.diag_embed(-w_diag)
    k[:, :, :NU, n0:] = e.T
    k[:, :, n0:, :NU] = e
    k[:, :, n0:, n0:] = -opts.delta * torch.eye(N_MX_PER_STAGE, dtype=dtype, device=dev)
    return _jacobi_scaled(_pivoted_or_not(opts.aug_pivot, opts), k, opts)


def _stage_ric2(qp: StageQP, w_inv: torch.Tensor, opts: PdipmOptions):
    """The rank-2 stage factor (`factor_ric2:839`): Ru = R+beta + G_u^T W_t^-1
    G_u inverted without pivoting, S = -delta I - E Ru^-1 E^T (2x2) in closed
    form. Returns ((K^-1)_uu = Ru^-1 + (E Ru^-1)^T S^-1 (E Ru^-1), and K^-1
    applied by the block formula, `_kinv2_apply:885`)."""
    ru = _gtwg(qp, w_inv) + torch.diag_embed(qp.r_diag + opts.beta)[:, None]
    ru_inv = _jacobi_scaled(_nopivot(opts), ru, opts)  # (B, T, 12, 12)
    erui = ru_inv[:, :, (6, 9), :]  # E Ru^-1: rows 6 and 9
    sa = -opts.delta - ru_inv[:, :, 6, 6]
    sb = -ru_inv[:, :, 6, 9]
    sc = -opts.delta - ru_inv[:, :, 9, 9]
    det = sa * sc - sb * sb
    snu_inv = torch.stack([torch.stack([sc / det, -sb / det], dim=-1),
                           torch.stack([-sb / det, sa / det], dim=-1)], dim=-2)  # (B, T, 2, 2)
    kuu = ru_inv + erui.transpose(-1, -2) @ (snu_inv @ erui)

    def kinv(r):
        t1 = _mv(ru_inv, r[..., :NU])
        eta = _mv(snu_inv, r[..., NU:] - t1[..., (6, 9)])
        du = t1 - (erui * eta[..., None]).sum(dim=-2)
        return torch.cat([du, eta], dim=-1)

    return kuu, kinv


def _factor(qp: StageQP, bkb: torch.Tensor, kinv: Callable, opts: PdipmOptions) -> _Factors:
    """Fold the stage inverses (Bd (K_t^-1)_uu Bd^T (B, T, 12, 12) and K_t^-1
    applied) into the y-chain and factor it (every Riccati route). The
    y-chain blocks are negative definite: inverted without pivoting, in
    `opts.gj_form` (`pdipm_pallas.py:562`)."""
    T = qp.horizon
    dtype, dev = bkb.dtype, bkb.device
    Ad = qp.dyn.A
    q_inv = 1.0 / (qp.q_diag + opts.beta)

    eye = torch.eye(NX, dtype=dtype, device=dev)
    y_blk = -opts.delta * eye - torch.diag_embed(q_inv)  # (B, 12, 12)
    adqad = (Ad * q_inv[:, None, :]) @ Ad.transpose(-1, -2)
    s_coup = q_inv[:, :, None] * Ad.transpose(-1, -2)

    yhat_inv = []
    m_prev = None
    for t in range(T):
        yhat = y_blk - bkb[:, t]
        if t >= 1:
            yhat = yhat - adqad - s_coup.transpose(-1, -2) @ m_prev @ s_coup
        m_prev = _nopivot(opts)(yhat)
        yhat_inv.append(m_prev)
    return _Factors(kinv, torch.stack(yhat_inv, dim=1), q_inv, s_coup)


def _solve_stages(qp: StageQP, fac: _Factors, r1, r_z, r4):
    """One reduced solve through the stage inverses and the y-chain.

    r_z (B, T * nzs) is the rhs of the z rows kept in the stage blocks:
    nzs = 16 on the augmented route, 0 on the condensed one. Returns
    (dx (B, nz), dz (B, T * nzs), dy (B, ne)).
    """
    T = qp.horizon
    nb = r1.shape[0]
    Ad, Bd = qp.dyn.A, qp.dyn.B
    q_inv, s_coup, yinv = fac.q_inv, fac.s_coup, fac.yhat_inv
    c, ru, rnu, ry = _split_rhs(qp, r1, r4, q_inv)
    rz = r_z.reshape(nb, T, -1)
    nzs = rz.shape[2]

    r_un = torch.cat([ru, rz, rnu], dim=2)  # (B, T, n)
    kr = fac.kinv(r_un)
    r_y2 = ry + _mv(Bd[:, None], kr[:, :, :NU])
    wy = _y_sweeps(r_y2, s_coup, yinv)

    rhs_un = torch.cat([ru + wy @ Bd, r_un[:, :, NU:]], dim=2)
    un = fac.kinv(rhs_un)

    xs = _x_rows(c, wy, q_inv, Ad)
    dx = torch.cat([xs.reshape(nb, -1), un[:, :, :NU].reshape(nb, -1)], dim=1)
    dz = un[:, :, NU:NU + nzs].reshape(nb, -1)
    dy = torch.cat([wy.reshape(nb, -1), un[:, :, NU + nzs:].reshape(nb, -1)], dim=1)
    return dx, dz, dy


def _split_rhs(qp: StageQP, r1, r4, q_inv):
    """(c, ru, rnu, ry) per stage of the rhs, with the condensed y-row shift
    ry = g - Q~^-1 c + Ad Q~^-1 c_{t-1} [t >= 1] (`_split_condensed_rhs`)."""
    T = qp.horizon
    nb = r1.shape[0]
    c = r1[:, :NX * T].reshape(nb, T, NX)
    ru = r1[:, NX * T:].reshape(nb, T, NU)
    g = r4[:, :NX * T].reshape(nb, T, NX)
    rnu = r4[:, NX * T:].reshape(nb, T, N_MX_PER_STAGE)
    ry = g - q_inv[:, None] * c
    ry[:, 1:] += _mv(qp.dyn.A[:, None], q_inv[:, None] * c[:, :-1])
    return c, ru, rnu, ry


def _y_sweeps(r_y2, s_coup, yinv):
    """(B, T, 12) y of the dual Riccati chain: the forward sweep
    g_t = r_t - S^T Yhat_{t-1}^-1 g_{t-1}, then y_t = Yhat_t^-1 (g_t - S y_{t+1})."""
    T = r_y2.shape[1]
    s_t = s_coup.transpose(-1, -2)
    gg = [r_y2[:, 0]]
    for t in range(1, T):
        gg.append(r_y2[:, t] - _mv(s_t, _mv(yinv[:, t - 1], gg[-1])))
    wy = [None] * T
    y_next = None
    for t in range(T - 1, -1, -1):
        rhs = gg[t] if y_next is None else gg[t] - _mv(s_coup, y_next)
        y_next = _mv(yinv[:, t], rhs)
        wy[t] = y_next
    return torch.stack(wy, dim=1)


def _x_rows(c, wy, q_inv, Ad):
    """x_t = Q~^-1 (c_t - y_t + Ad^T y_{t+1} [t < T-1])."""
    xs = q_inv[:, None] * (c - wy)
    xs[:, :-1] += q_inv[:, None] * (wy[:, 1:] @ Ad)
    return xs


# "ric_aug_core"'s S is block diagonal: each foot's z rows, then the two nu
# scalars (`_CORE_S_BLOCKS`, `pdipm.py:876`).
_CORE_S_BLOCKS = (tuple(range(8)), tuple(range(8, 16)), (16,), (17,))
N_VC = N_INEQ_PER_STAGE + N_MX_PER_STAGE  # 18 coupled constraint rows


@dataclass
class _CoreFactors:
    s_inv: torch.Tensor  # (B, T, 18, 18) S^-1
    v: torch.Tensor  # (B, 18, 12) V = [G_u C; E C]
    c_u: torch.Tensor  # (B, 12) diag(C)
    bd_hat: torch.Tensor  # (B, 12, 12) Bd C
    yhat_inv: torch.Tensor  # (B, T, 12, 12)
    q_inv: torch.Tensor  # (B, 12)
    s_coup: torch.Tensor  # (B, 12, 12)


def _factor_core(qp: StageQP, w_diag: torch.Tensor, opts: PdipmOptions) -> _CoreFactors:
    """`_factor_ric_aug_core` (`pdipm.py:884`), batched; w_diag (B, T, 16) =
    Sigma^-1 + delta. Every inverse is the pivoted Gauss-Jordan elimination
    (the JAX route's `inv_impl="gj"`), the 1x1 blocks reciprocals."""
    T = qp.horizon
    nb = w_diag.shape[0]
    dtype, dev = w_diag.dtype, w_diag.device
    Ad, Bd = qp.dyn.A, qp.dyn.B
    q_inv = 1.0 / (qp.q_diag + opts.beta)

    c_u = torch.rsqrt(qp.r_diag + opts.beta)  # (B, 12)
    v = torch.zeros(nb, N_VC, NU, dtype=dtype, device=dev)
    v[:, :N_INEQ_PER_STAGE] = qp.g_u * c_u[:, None, :]
    v[:, N_INEQ_PER_STAGE, 6] = c_u[:, 6]
    v[:, N_INEQ_PER_STAGE + 1, 9] = c_u[:, 9]

    wfull = torch.cat([w_diag, w_diag.new_full((nb, T, N_MX_PER_STAGE), opts.delta)], dim=2)
    s = -(v @ v.transpose(-1, -2))[:, None].expand(nb, T, N_VC, N_VC)
    s = s - torch.diag_embed(wfull)
    if opts.foot_split:
        s_inv = torch.zeros_like(s)
        for blk in _CORE_S_BLOCKS:
            sl = slice(blk[0], blk[-1] + 1)
            sub = s[:, :, sl, sl]
            s_inv[:, :, sl, sl] = 1.0 / sub if len(blk) == 1 else gauss_jordan_inverse(sub)
    else:
        s_inv = gauss_jordan_inverse(s)

    vs = s_inv @ v[:, None]  # (B, T, 18, 12) = S^-1 V
    kuu_hat = torch.eye(NU, dtype=dtype, device=dev) + v.transpose(-1, -2)[:, None] @ vs
    bd_hat = Bd * c_u[:, None, :]

    eye = torch.eye(NX, dtype=dtype, device=dev)
    y_blk = -opts.delta * eye - torch.diag_embed(q_inv)
    adqad = Ad @ torch.diag_embed(q_inv) @ Ad.transpose(-1, -2)
    s_coup = torch.diag_embed(q_inv) @ Ad.transpose(-1, -2)
    bkb = bd_hat[:, None] @ kuu_hat @ bd_hat.transpose(-1, -2)[:, None]
    yhat_inv = []
    m_prev = torch.zeros(nb, NX, NX, dtype=dtype, device=dev)
    for t in range(T):
        yp = (y_blk - adqad if t >= 1 else y_blk) - bkb[:, t]
        m_prev = gauss_jordan_inverse(yp - s_coup.transpose(-1, -2) @ m_prev @ s_coup)
        yhat_inv.append(m_prev)
    return _CoreFactors(s_inv, v, c_u, bd_hat, torch.stack(yhat_inv, dim=1), q_inv, s_coup)


def _core_kinv_apply(fac: _CoreFactors, r_uh, r_zn):
    """K_hat^-1 [r_uh; r_zn] -> (du_hat (B, T, 12), dzn (B, T, 18))."""
    t = _mv(fac.s_inv, _mv(fac.v[:, None], r_uh) - r_zn)
    return r_uh + _mv(fac.v.transpose(-1, -2)[:, None], t), -t


def _solve_core(qp: StageQP, fac: _CoreFactors, r1, r_z, r4):
    """`_solve_ric_aug_core` (`pdipm.py:938`), batched: (dx, dz, dy) as
    `_solve_stages`."""
    T = qp.horizon
    nb = r1.shape[0]
    c, ru, rnu, ry = _split_rhs(qp, r1, r4, fac.q_inv)
    r_uh = ru * fac.c_u[:, None]
    r_zn = torch.cat([r_z.reshape(nb, T, N_INEQ_PER_STAGE), rnu], dim=2)
    du_hat0, _ = _core_kinv_apply(fac, r_uh, r_zn)
    r_y2 = ry + du_hat0 @ fac.bd_hat.transpose(-1, -2)
    wy = _y_sweeps(r_y2, fac.s_coup, fac.yhat_inv)
    du_hat, dzn = _core_kinv_apply(fac, r_uh + wy @ fac.bd_hat, r_zn)
    du = du_hat * fac.c_u[:, None]
    xs = _x_rows(c, wy, fac.q_inv, qp.dyn.A)
    dx = torch.cat([xs.reshape(nb, -1), du.reshape(nb, -1)], dim=1)
    dz = dzn[:, :, :N_INEQ_PER_STAGE].reshape(nb, -1)
    dy = torch.cat([wy.reshape(nb, -1), dzn[:, :, N_INEQ_PER_STAGE:].reshape(nb, -1)], dim=1)
    return dx, dz, dy


@dataclass
class _ThomasFactors:
    s_inv: torch.Tensor  # (B, T, n, n) stage-block inverses, n = 42 or 26
    q_inv: torch.Tensor  # (B, 12)


def _factor_thomas(qp: StageQP, w: torch.Tensor, opts: PdipmOptions, aug: bool) -> _ThomasFactors:
    """Block-Thomas factor (`pdipm_pallas.py:424` `factor`, `:1134`
    `factor_aug`). w (B, T, 16) is W = Sigma^-1 + delta (aug) or W^-1
    (condensed). Stage t's block on [u (12), z (16, aug only), nu (2), y (12)]

        [[R+beta (+ G_u^T W_t^-1 G_u), G_u^T, e^T, -Bd^T],
         [G_u, -W_t, 0, 0], [e, 0, -delta I, 0],
         [-Bd, 0, 0, -delta I - Ad M_{t-1} Ad^T - Q~^-1]]

    is inverted with partial pivoting; M_t = Q~^-1 + Q~^-1 N_yy Q~^-1 from its
    inverse's y block N_yy, M_{-1} = 0."""
    T = qp.horizon
    nb = w.shape[0]
    dtype, dev = w.dtype, w.device
    Ad, Bd, gu = qp.dyn.A, qp.dyn.B, qp.g_u
    nzs = N_INEQ_PER_STAGE if aug else 0
    nnu = NU + nzs
    ny = nnu + N_MX_PER_STAGE
    n = ny + NX
    q_inv = 1.0 / (qp.q_diag + opts.beta)
    eye = torch.eye(NX, dtype=dtype, device=dev)
    ru = torch.diag_embed(qp.r_diag + opts.beta)
    base = torch.zeros(nb, n, n, dtype=dtype, device=dev)
    base[:, :NU, ny:] = -Bd.transpose(-1, -2)
    base[:, ny:, :NU] = -Bd
    for j, nu in ((6, nnu), (9, nnu + 1)):
        base[:, j, nu] = 1.0
        base[:, nu, j] = 1.0
        base[:, nu, nu] = -opts.delta
    if aug:
        base[:, :NU, NU:nnu] = gu.transpose(-1, -2)
        base[:, NU:nnu, :NU] = gu

    s_inv = []
    m_prev = torch.zeros(nb, NX, NX, dtype=dtype, device=dev)
    for t in range(T):
        blk = base.clone()
        if aug:
            blk[:, :NU, :NU] = ru
            blk[:, NU:nnu, NU:nnu] = torch.diag_embed(-w[:, t])
        else:
            blk[:, :NU, :NU] = (gu * w[:, t, :, None]).transpose(-1, -2) @ gu + ru
        admadt = (Ad @ m_prev) @ Ad.transpose(-1, -2)
        blk[:, ny:, ny:] = -opts.delta * eye - admadt - torch.diag_embed(q_inv)
        inv = gauss_jordan_inverse(blk)
        s_inv.append(inv)
        m_prev = torch.diag_embed(q_inv) + q_inv[:, :, None] * inv[:, ny:, ny:] * q_inv[:, None, :]
    return _ThomasFactors(torch.stack(s_inv, dim=1), q_inv)


def _solve_thomas(qp: StageQP, fac: _ThomasFactors, r1, r_z, r4):
    """Two-sweep block-Thomas solve (`pdipm_pallas.py:478` `thomas_solve`,
    `:1183` `thomas_solve_aug`), x_{t+1} recovered per stage in closed form.
    r_z (B, T * nzs): nzs = 16 on the augmented route, 0 on the condensed
    one. Returns (dx (B, nz), dz (B, T * nzs), dy (B, ne))."""
    T = qp.horizon
    nb = r1.shape[0]
    Ad, q_inv, s_inv = qp.dyn.A, fac.q_inv, fac.s_inv
    n = s_inv.shape[-1]
    ny = n - NX
    nzs = ny - NU - N_MX_PER_STAGE

    rx = r1[:, :NX * T].reshape(nb, T, NX)
    ru = r1[:, NX * T:].reshape(nb, T, NU)
    ry = r4[:, :NX * T].reshape(nb, T, NX)
    rnu = r4[:, NX * T:].reshape(nb, T, N_MX_PER_STAGE)
    r = torch.cat([ru, r_z.reshape(nb, T, nzs), rnu, ry - q_inv[:, None] * rx], dim=2)

    # Forward: g_t[y] += Ad x_{t-1}, x_{t-1} = Q~^-1 (r_x - (S^-1 g)_{t-1}[y]).
    g = []
    x_prev = torch.zeros(nb, NX, dtype=r1.dtype, device=r1.device)
    for t in range(T):
        g_t = r[:, t].clone()
        g_t[:, ny:] += _mv(Ad, x_prev)
        g.append(g_t)
        x_prev = q_inv * (rx[:, t] - _mv(s_inv[:, t, ny:], g_t))
    # Backward: g_t[y] -= Q~^-1 Ad^T w_y(t+1); x_t = Q~^-1 (r_x + Ad^T w_y(t+1) - w_y(t)).
    w = [None] * T
    xs = [None] * T
    wy_next = torch.zeros_like(x_prev)
    for t in range(T - 1, -1, -1):
        adt_wy = _mv(Ad.transpose(-1, -2), wy_next)
        g_t = g[t].clone()
        g_t[:, ny:] -= q_inv * adt_wy
        w[t] = _mv(s_inv[:, t], g_t)
        wy_next = w[t][:, ny:]
        xs[t] = q_inv * (rx[:, t] + adt_wy - wy_next)
    w = torch.stack(w, dim=1)
    xs = torch.stack(xs, dim=1)
    dx = torch.cat([xs.reshape(nb, -1), w[:, :, :NU].reshape(nb, -1)], dim=1)
    dz = w[:, :, NU:NU + nzs].reshape(nb, -1)
    dy = torch.cat([w[:, :, ny:].reshape(nb, -1), w[:, :, NU + nzs:ny].reshape(nb, -1)], dim=1)
    return dx, dz, dy


@contextlib.contextmanager
def _cusolver(t: torch.Tensor):
    """On the card, torch's LU and LU solve under cuSOLVER (at the dense
    route's width and batch, cuBLAS's batched getrf and getrs), which a CUDA
    graph capture takes, instead of torch's default for matrices wider than
    16, MAGMA's batched LU, which a capture refuses; eager and captured
    calls then run the same library and give the same bits. The preferred
    library is restored on the way out, so no other call sees the switch.
    On the CPU (LAPACK) nothing changes."""
    if t.device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def _factor_dense(qp: StageQP, w_inv: torch.Tensor, opts: PdipmOptions):
    """LU of the condensed reduced KKT [[H + beta + G^T W^-1 G, A^T], [A,
    -delta I]], (nz + ne) wide, variables [x (12 T), u (12 T), y (ne)]
    (`biped_pympc_tpu/ops/pdipm.py:252`), under cuSOLVER on the card
    (`_cusolver`). Like JAX's `lu_factor` it checks nothing: a singular
    matrix gives non-finite values, and no check waits for the device."""
    T, nz, ne = qp.horizon, qp.nz, qp.n_eq
    hd = qps.h_diag(qp) + opts.beta
    m = torch.diag_embed(torch.cat([hd, hd.new_full((hd.shape[0], ne), -opts.delta)], dim=1))
    # The stage blocks G_u^T W^-1 G_u, formed as JAX forms them: the stage
    # Hessian (with R + beta on its diagonal) less R + beta.
    rb = torch.diag_embed(qp.r_diag + opts.beta)[:, None]
    ru = (_gtwg(qp, w_inv) + rb) - rb
    for t in range(T):
        r = NX * T + NU * t
        m[:, r:r + NU, r:r + NU] += ru[:, t]
    a = qps.dense_a(qp)
    m[:, nz:, :nz] = a
    m[:, :nz, nz:] = a.transpose(-1, -2)
    with _cusolver(m):
        lu, piv, _ = torch.linalg.lu_factor_ex(m, check_errors=False)
    return lu, piv


def _solve_dense(qp: StageQP, factors, r1_hat, r4):
    """(dx, no z, dy) of the condensed reduced system (`pdipm.py:277`),
    under cuSOLVER on the card."""
    lu, piv = factors
    with _cusolver(lu):
        sol = torch.linalg.lu_solve(lu, piv, torch.cat([r1_hat, r4], dim=1)[..., None])[..., 0]
    return sol[:, :qp.nz], r1_hat.new_zeros(r1_hat.shape[0], 0), sol[:, qp.nz:]


def _stage_solver(qp: StageQP, w: torch.Tensor, opts: PdipmOptions):
    """Factor route `opts.backend` at w (B, T, 16), W on the augmented routes
    and W^-1 on the condensed ones; return its reduced solve
    (r1, r_z, r4) -> (dx, dz, dy)."""
    if opts.backend == "dense":
        factors = _factor_dense(qp, w, opts)
        return lambda r1, r_z, r4: _solve_dense(qp, factors, r1, r4)
    if opts.backend == "ric_aug_core":
        core = _factor_core(qp, w, opts)
        return lambda r1, r_z, r4: _solve_core(qp, core, r1, r_z, r4)
    if opts.backend in ("tridiag", "tridiag_aug"):
        tf = _factor_thomas(qp, w, opts, aug=opts.backend == "tridiag_aug")
        return lambda r1, r_z, r4: _solve_thomas(qp, tf, r1, r_z, r4)
    k8 = None
    if opts.backend == "ric2":
        kuu, kinv = _stage_ric2(qp, w, opts)
    else:
        if opts.foot_split:
            split = _stage_inverse_aug if opts.backend == "ric_aug" else _stage_inverse_ric
            k_inv, k8 = split(qp, w, opts)
        else:
            dense = _stage_inverse_aug_dense if opts.backend == "ric_aug" else _stage_inverse_ric_dense
            k_inv = dense(qp, w, opts)
        kuu, kinv = k_inv[:, :, :NU, :NU], lambda r: _mv(k_inv, r)
    Bd = qp.dyn.B
    bkb = (Bd[:, None] @ kuu @ Bd.transpose(-1, -2)[:, None] if k8 is None
           else _bkb_packed(qp, k8, opts))
    fac = _factor(qp, bkb, kinv, opts)
    return lambda r1, r_z, r4: _solve_stages(qp, fac, r1, r_z, r4)


def refine_residual_aug(qp: StageQP, hd, w_diag, opts: PdipmOptions, dx, dz, dy, r1, r_z, r4):
    """Refinement residual of the augmented reduced system, (e1, ez, e4) =
    (r1, r_z, r4) - [[H + beta, G^T, A^T], [G, -W, 0], [A, 0, -delta]] (dx, dz, dy),
    in the working dtype or, with `opts.refine_residual == "df"`, one
    compensated sum per component (`ops/df.residual_aug`)."""
    if opts.refine_residual == "df":
        return dfm.residual_aug(qp, hd, w_diag, opts.beta, opts.delta, dx, dz, dy, r1, r_z, r4)
    m1 = (hd + opts.beta) * dx + qps.gT_matvec(qp, dz) + qps.aT_matvec(qp, dy)
    mz = qps.g_matvec(qp, dx) - w_diag * dz
    m4 = qps.a_matvec(qp, dx) - opts.delta * dy
    return r1 - m1, r_z - mz, r4 - m4


def _iteration(qp: StageQP, st: PdipmState, hd, d, b, opts: PdipmOptions, refine: int):
    """One Mehrotra predictor-corrector step in `opts.corrector_form`
    (`iteration_base`, `pdipm_pallas.py:1237-1485`), its reduced solves
    refined `refine` times where the form refines."""
    x, s, z, y = st.x, st.s, st.z, st.y
    ni = qp.n_ineq
    T = qp.horizon
    rx = hd * x + qp.f + qps.gT_matvec(qp, z) + qps.aT_matvec(qp, y)
    re = qps.a_matvec(qp, x) - b
    rs = qps.g_matvec(qp, x) + s - d
    mu = _dot(s, z) / ni

    sigma_d = z / s + opts.delta
    if opts.sigma_cap > 0.0:
        sigma_d = torch.clamp(sigma_d, max=opts.sigma_cap)
    if opts.backend in AUG_BACKENDS:
        w_diag = 1.0 / sigma_d + opts.delta  # W = Sigma^-1 + delta
        stage_solve = _stage_solver(qp, w_diag.reshape(-1, T, N_INEQ_PER_STAGE), opts)

        def reduced_solve(r1, r2, r3, r4, refine=refine):
            r_z = r3 - r2 / sigma_d
            dx, dz, dy = stage_solve(r1, r_z, r4)
            for _ in range(refine):
                e1, ezr, e4 = refine_residual_aug(qp, hd, w_diag, opts, dx, dz, dy, r1, r_z, r4)
                ex, ez, ey = stage_solve(e1, ezr, e4)
                dx, dz, dy = dx + ex, dz + ez, dy + ey
            ds = (r2 - dz) / sigma_d
            return dx, ds, dz, dy
    else:
        w_inv = sigma_d / (1.0 + opts.delta * sigma_d)  # (Sigma^-1 + delta)^-1
        stage_solve = _stage_solver(qp, w_inv.reshape(-1, T, N_INEQ_PER_STAGE), opts)
        no_z = x.new_zeros(x.shape[0], 0)

        def reduced_solve(r1, r2, r3, r4, refine=refine):
            r1_hat = r1 + qps.gT_matvec(qp, w_inv * (r3 - r2 / sigma_d))
            dx, _, dy = stage_solve(r1_hat, no_z, r4)
            for _ in range(refine):
                m1 = (hd + opts.beta) * dx + qps.gT_matvec(qp, w_inv * qps.g_matvec(qp, dx)) \
                    + qps.aT_matvec(qp, dy)
                m2 = qps.a_matvec(qp, dx) - opts.delta * dy
                ex, _, ey = stage_solve(r1_hat - m1, no_z, r4 - m2)
                dx, dy = dx + ex, dy + ey
            dz = w_inv * (qps.g_matvec(qp, dx) + r2 / sigma_d - r3)
            ds = (r2 - dz) / sigma_d
            return dx, ds, dz, dy

    form = opts.corrector_form
    dx_a, ds_a, dz_a, dy_a = reduced_solve(-rx, -(s * z) / s, -rs, -re,
                                           0 if form in ("combined", "sum_refine") else refine)
    alpha_ap = _frac_to_boundary(s, ds_a, opts)
    alpha_ad = _frac_to_boundary(z, dz_a, opts)
    mu_aff = _dot(s + alpha_ap[:, None] * ds_a, z + alpha_ad[:, None] * dz_a) / ni
    sigma = (mu_aff / mu) ** 3

    rc = s * z + ds_a * dz_a - (sigma * mu)[:, None]
    zeros = (torch.zeros_like(rx), torch.zeros_like(s), torch.zeros_like(re))
    if form == "combined":
        # One refined solve of the summed rhs; the reference's corrector rhs
        # keeps s z, so the sum is -(s z + rc) / s.
        dx, ds, dz, dy = reduced_solve(-rx, -(s * z + rc) / s, -rs, -re)
    else:
        dx_c, ds_c, dz_c, dy_c = reduced_solve(zeros[0], -rc / s, zeros[1], zeros[2],
                                               refine if form == "delta" else 0)
        dx, ds, dz, dy = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c, dy_a + dy_c
    if form == "sum_refine":
        # Refine the summed direction against the full 4-row KKT residual.
        r2s = -(s * z + rc) / s
        for _ in range(refine):
            m1 = hd * dx + opts.beta * dx + qps.gT_matvec(qp, dz) + qps.aT_matvec(qp, dy)
            m2 = sigma_d * ds + dz
            m3 = qps.g_matvec(qp, dx) + ds - opts.delta * dz
            m4 = qps.a_matvec(qp, dx) - opts.delta * dy
            ex, es, ez, ey = reduced_solve(-rx - m1, r2s - m2, -rs - m3, -re - m4, 0)
            dx, ds, dz, dy = dx + ex, ds + es, dz + ez, dy + ey
    alpha_p = _frac_to_boundary(s, ds, opts)[:, None]
    alpha_d = _frac_to_boundary(z, dz, opts)[:, None]

    x = x + alpha_p * dx
    s = torch.clamp(s + alpha_p * ds, min=opts.sz_floor)
    z = torch.clamp(z + alpha_d * dz, min=opts.sz_floor)
    y = y + alpha_d * dy
    norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
    residuals = torch.stack([norm(rx), norm(rs), norm(re), _dot(s, z) / ni], dim=-1)
    return PdipmState(x, s, z, y), residuals


def check_options(opts: PdipmOptions) -> None:
    """Raise ValueError for a route, residual precision, KKT scaling,
    Gauss-Jordan form, corrector form or foot packing these solvers lack,
    and for the df residual where the JAX kernel refuses it: on a condensed
    route or with corrector_form "sum_refine" (`pdipm_pallas.py:1582-1602`)."""
    for name, known in (("backend", BACKENDS), ("refine_residual", REFINE_RESIDUALS),
                        ("kkt_scale", KKT_SCALES), ("gj_form", GJ_FORMS),
                        ("corrector_form", CORRECTOR_FORMS), ("foot_pack", FOOT_PACKS)):
        value = getattr(opts, name)
        if not any(value == k and type(value) is type(k) for k in known):
            label = "PDIPM backend" if name == "backend" else name
            raise ValueError(f"unknown {label} {value!r}; expected one of {known}")
    if opts.refine_residual == "df" and opts.backend not in AUG_BACKENDS:
        raise ValueError("refine_residual='df' is implemented for the aug backends only "
                         f"(got backend={opts.backend!r}); see PdipmOptions.refine_residual")
    if opts.refine_residual == "df" and opts.corrector_form == "sum_refine":
        raise ValueError("refine_residual='df' is not implemented for corrector_form='sum_refine'")


def refine_schedule(opts: PdipmOptions) -> int:
    """Newton steps at the start of a solve (or of one launch) that run at
    refine 0: min(refine_skip_iters, iterations) when refine_steps > 0
    (`pdipm_pallas.py:1499-1517`)."""
    return min(opts.refine_skip_iters, opts.iterations) if opts.refine_steps > 0 else 0


def solve(qp: StageQP, opts: PdipmOptions = PdipmOptions(),
          state: PdipmState | None = None) -> PdipmResult:
    """Run `opts.iterations` Newton steps on every env, from `state` (a
    batch-first PdipmState: warm start, chunked continuation) or, when None,
    from the cold start. With 0 iterations the residuals are zeros."""
    check_options(opts)
    st = init_state(qp) if state is None else state
    hd, d, b = qps.h_diag(qp), qps.d_vec(qp), qps.b_vec(qp)
    residuals = torch.zeros(qp.f.shape[0], 4, dtype=qp.f.dtype, device=qp.f.device)
    skip = refine_schedule(opts)
    for it in range(opts.iterations):
        st, residuals = _iteration(qp, st, hd, d, b, opts, 0 if it < skip else opts.refine_steps)
    return PdipmResult(st.x, st.s, st.z, st.y, residuals)


def chunks(opts: PdipmOptions) -> tuple[int, int, int]:
    """(chunk, n_full, rem) of the adaptive solve: n_full launches of
    `chunk` Newton steps, then one of `rem` (`pdipm.py:1246-1247`)."""
    if opts.iterations < 1 or opts.iterations_per_launch < 1:
        raise ValueError("the adaptive solve needs iterations >= 1 and "
                         f"iterations_per_launch >= 1: {opts}")
    chunk = min(opts.iterations_per_launch, opts.iterations)
    n_full, rem = divmod(opts.iterations, chunk)
    return chunk, n_full, rem


def solve_adaptive_batch(qp: StageQP, opts: PdipmOptions = PdipmOptions(),
                         tol: float = 1e-2) -> PdipmResult:
    """Adaptive-iteration solve (`biped_pympc_tpu/ops/pdipm.py:1236`).

    Runs `opts.iterations_per_launch`-step chunks, each warm-started from
    the last, while fewer than n_full chunks ran and the largest residual
    criterion over the batch, max(||rx||, ||rs||, ||re||, mu), is above
    `tol`; then a remainder of `iterations % chunk` steps if the criterion
    is still above `tol`. The criterion starts at +inf, so the first chunk
    always runs. One decision gates the whole batch. A NaN anywhere in the
    residuals makes `max > tol` false and ends the loop, as in the JAX
    package (ROADMAP, Queue 3). `refine_skip_iters` counts per chunk, as
    JAX's chunked launches count it (`biped_pympc_tpu/ops/pdipm.py:88-91`).
    """
    check_options(opts)
    chunk, n_full, rem = chunks(opts)
    st = init_state(qp)
    res = torch.full((qp.f.shape[0], 4), float("inf"), dtype=qp.f.dtype, device=qp.f.device)
    go = lambda: bool(res.amax() > tol)
    k = 0
    while k < n_full and go():
        r = solve(qp, replace(opts, iterations=chunk), st)
        st, res = PdipmState(r.x, r.s, r.z, r.y), r.residuals
        k += 1
    if rem and go():
        r = solve(qp, replace(opts, iterations=rem), st)
        st, res = PdipmState(r.x, r.s, r.z, r.y), r.residuals
    return PdipmResult(st.x, st.s, st.z, st.y, res)


def kkt_error(qp: StageQP, res: PdipmResult) -> torch.Tensor:
    """(B, 4) KKT residual inf-norms of a solution under the exact operator
    (`biped_pympc_tpu/ops/pdipm.py:1214`): [||H x + f + G^T z + A^T y||,
    ||G x + s - d||, ||A x - b||, ||s o z||]. Unlike `PdipmResult.residuals`
    (2-norms at the start of the last Newton step), this measures the
    returned iterate itself."""
    rx = qps.h_diag(qp) * res.x + qp.f + qps.gT_matvec(qp, res.z) + qps.aT_matvec(qp, res.y)
    rs = qps.g_matvec(qp, res.x) + res.s - qps.d_vec(qp)
    re = qps.a_matvec(qp, res.x) - qps.b_vec(qp)
    inf = lambda v: v.abs().amax(dim=-1)
    return torch.stack([inf(rx), inf(rs), inf(re), inf(res.s * res.z)], dim=-1)

"""The yardstick of the kernels' rooflines: the least work of the solve, and
the published peaks of the card.

`newton_step_flops` is the count this repository has held its PDIPM
kernels to since they were written: the least floating-point operations
of one Newton step of one env (a multiply-add counts 2), from the shapes
alone, whichever route computes the step. It is 3.131e5 at horizon 10
with one refinement pass.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def newton_step_flops(T: int, refine_steps: int) -> float:
    """Least flops of one Newton step of one env at horizon T, with nx = nu
    = 12 and 16 inequalities a stage, the reference's corrector form (two
    reduced solves a step, each followed by `refine_steps` refinement
    passes). Per stage: the factor as one structured elimination (-W
    diagonal, the nu rows a selector beside -delta I, every symmetric
    product counted once: Ad M Ad'; U = R + beta + G' W^-1 G + e'e / delta;
    U's Cholesky factor L and L^-1 Bd'; the y Schur complement, its inverse
    and M_t); per reduced solve, z and nu into the u rhs and out again and
    one two-sweep solve on [u, y]; per refinement pass one more solve and
    one residual; the KKT residuals, rhs, step rule and update."""
    nx, nu, nc = 12, 12, 16
    factor = (2 * nx ** 3 + nx * (nx + 1) * nx
              + nu * nc + nu * (nu + 1) * nc + 2 * nu
              + nu ** 3 // 3 + nu ** 2 * nx
              + nx * (nx + 1) * nu + 2 * nx + nx ** 3
              + nx * (nx + 1) + nx)
    core = 2 * nu ** 2 + 4 * nx * nu + 8 * nx ** 2 + 9 * nx
    z_in_out = 4 * nc * nu + 3 * nc + 8
    residual = 2090
    passes = 2 * refine_steps
    return T * (factor + 2 * (z_in_out + core) + passes * (core + residual) + 2850)


def solve_flops(cfg: dict) -> float:
    """Least flops of one batched solve of a configuration."""
    return (newton_step_flops(cfg["horizon_length"], cfg["solver_refine_steps"])
            * cfg["newton_iterations"] * cfg["num_envs"])

"""Configuration dataclasses (twin of `biped_pympc_tpu/config.py`).

The port's own copy: importing the JAX package's config would run its
`__init__`, which imports jax. Field names and defaults are the JAX
package's, restricted to the knobs this port implements. The solver menu
holds every JAX name, and each runs the same algorithm here (`SOLVERS`,
`control/controller.py`).

Note on Q: the reference's default Q carries 13 entries (a leftover of a
13-state formulation); the QP consumes the first 12. 13 are accepted and
truncated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Tuple, Union

_DEFAULT_Q = (150.0, 150.0, 250.0, 100.0, 100.0, 250.0, 1.0, 1.0, 5.0, 10.0, 10.0, 1.0)
_DEFAULT_R = (1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4)

# "ric_aug" / "pallas_ric_aug" select the augmented Riccati PDIPM, "ric" /
# "pallas_ric" the condensed one (each foot-split or whole,
# `solver_foot_split`), "pallas_ric2" the condensed one with the nu pair
# eliminated by a rank-2 update, "pallas_hybrid" the condensed pass with a
# budgeted augmented re-solve, "tridiag_aug" / "pallas_aug" the augmented
# block-Thomas PDIPM (42-wide stage blocks) and "tridiag" / "pallas" the
# condensed one (26-wide): each the hand-written CUDA kernel for CUDA
# tensors, its plain torch version for CPU tensors. "dense" is a batched LU
# of the whole condensed reduced KKT, plain torch on both devices (as in
# JAX, where XLA's LU computes it outside any Pallas kernel).
SOLVERS = ("ric_aug", "pallas_ric_aug", "ric", "pallas_ric", "pallas_ric2", "pallas_hybrid",
           "tridiag_aug", "pallas_aug", "tridiag", "pallas", "dense")


@dataclass(frozen=True)
class ControllerConf:
    """Gait and swing settings (`biped_pympc_tpu/config.py:24`)."""

    ssp_durations: int = 5
    dsp_durations: int = 0
    swing_height: float = 0.1
    swing_reference_frame: Literal["world", "base"] = "base"
    swing_curve: Literal["bezier", "cycloid"] = "bezier"


def recommended_conf(robot: str = "HECTOR"):
    """(ControllerConf, MPCConf kwargs) per robot
    (`biped_pympc_tpu/config.py:35`). Apply as `MPCConf(**kw)`."""
    if robot.startswith("T1"):
        return (
            ControllerConf(ssp_durations=9, dsp_durations=2,
                           swing_height=0.12),
            {"robot": robot, "f_max": 1450.0, "contact_frame": "yaw"},
        )
    return ControllerConf(), {"robot": robot, "contact_frame": "yaw"}


@dataclass(frozen=True)
class MPCConf:
    """MPC and solver settings (`biped_pympc_tpu/config.py:65`).

    solver: one of `SOLVERS`; another name raises ValueError when a
    controller is built. "pallas_ric" is the bare condensed route: under
    domain randomization its f32 solve is non-finite on 0.6-0.7% of envs and
    carries an error tail of tens of N (the JAX package's TPU measurements,
    `biped_pympc_tpu/config.py:81-98`).
    "pallas_hybrid" re-solves the worst envs with the augmented route, which
    makes it finite while the budget covers the non-finite envs; it does not
    remove the error tail.
    hybrid_budget: envs the hybrid re-solves per call; <= 0 selects
    max(64, batch // 32). hybrid_flag_tol: a re-solved env takes the
    augmented result where its criterion exceeds this (non-finite envs
    always do). hybrid_flag: the criterion, "resid" (the solver's final
    residuals) or "kkt" (`pdipm.kkt_error` of the returned iterate).
    adaptive_tol: when > 0, solve in `adaptive_chunk`-step launches, each
    warm-started from the last, and stop early once every env's residual
    criterion max(||rx||, ||rs||, ||re||, mu) is below this tolerance (or at
    the `newton_iterations` cap). One stop decision gates the whole batch.
    Mirrors the reference's own loop over fused 5-iteration launches; not
    fixed-iteration parity. 0 keeps the fixed-iteration solve.
    "pallas_hybrid" ignores it, as in the JAX package.
    solver_foot_split: on the "ric" / "ric_aug" routes, invert each foot's
    stage block apart (exact: the blocks decouple by foot) or, False, the
    whole 14- / 30-wide block, the dense cross-check
    (`biped_pympc_tpu/config.py:137-155`; the JAX package measured a
    narrower f32 stress tail for the unsplit condensed route on its TPU).
    solver_foot_pack: packing of the split's two foot blocks
    (`biped_pympc_tpu/config.py:156-169`): True or "apply" runs the packed
    kernel of the route (K5e, `pdipm_ric_pack.cu` / `pdipm_ric_aug_pack.cu`)
    for a "pallas_*" name with the split on and a "ric" / "ric_aug" route,
    and is ignored elsewhere, as in the JAX package. "pallas_hybrid" then
    runs the packed condensed route and re-solves with the packed augmented
    one.
    solver_kkt_scale: "jacobi" inverts each stage block of the Riccati
    routes through its Jacobi equilibration (exact; only rounding changes;
    `biped_pympc_tpu/config.py:184-199`). The block-Thomas routes ignore it.
    f_max: per-foot vertical-force cap [N].
    euler_rate_mode: see `models/srbd.py`. contact_frame: "world" keeps the
    contact rows in world axes (reference parity, valid near yaw 0);
    "yaw" expresses u in yaw-aligned axes so turning works at any heading.
    """

    dt: float = 0.001
    dt_mpc: float = 0.025
    horizon_length: int = 10
    decimation: int = 10
    Q: Tuple[float, ...] = _DEFAULT_Q
    R: Tuple[float, ...] = _DEFAULT_R
    solver: Literal[
        "tridiag_aug", "tridiag", "dense", "ric", "ric_aug",
        "pallas", "pallas_aug", "pallas_ric", "pallas_ric2",
        "pallas_ric_aug", "pallas_hybrid",
    ] = "ric_aug"
    hybrid_budget: int = 0
    hybrid_flag_tol: float = 1.0
    hybrid_flag: Literal["resid", "kkt"] = "resid"
    robot: Literal["HECTOR", "T1", "T1-newton"] = "HECTOR"
    newton_iterations: int = 20
    solver_beta: float = 1e-8
    solver_delta: float = 1e-8
    f_max: float = 500.0
    solver_refine_steps: int = 1
    solver_foot_split: bool = True
    solver_foot_pack: Union[bool, Literal["apply"]] = False
    adaptive_tol: float = 0.0
    adaptive_chunk: int = 5
    solver_kkt_scale: Literal["none", "jacobi"] = "none"
    euler_rate_mode: Literal["rt_omega", "r_omega"] = "rt_omega"
    contact_frame: Literal["world", "yaw"] = "world"
    print_solve_time: bool = False
    # Init-time config dump, as the reference prints at dataclass creation.
    verbose: bool = True

    def __post_init__(self):
        if len(self.Q) == 13:
            object.__setattr__(self, "Q", tuple(self.Q[:12]))
        if len(self.Q) != 12:
            raise ValueError(f"Q must have 12 weights, got {len(self.Q)}")
        if len(self.R) != 12:
            raise ValueError(f"R must have 12 weights, got {len(self.R)}")
        if self.verbose:
            print("[INFO] MPC Configuration:")
            print("+--------------------------------+")
            print(f"  dt: {self.dt}")
            print(f"  dt_mpc: {self.dt_mpc}")
            print(f"  horizon_length: {self.horizon_length}")
            print(f"  decimation: {self.decimation}")
            print(f"  Q: {self.Q}")
            print(f"  R: {self.R}")
            print(f"  solver: {self.solver}")
            print(f"  robot: {self.robot}")
            print("+--------------------------------+")

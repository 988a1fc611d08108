"""The least work of the hybrid speed mode's re-solve: the yardstick of
`benchmark/roofline.py` (`newton_step_flops`) over the envs the budget
re-solves, which the augmented route solves from the cold start for the
configured Newton steps whether or not their answers are merged."""

from __future__ import annotations

from benchmark.roofline import newton_step_flops


def resolve_flops(cfg: dict, budget: int) -> float:
    """Least flops of one re-solve of `budget` envs of a configuration."""
    return (newton_step_flops(cfg["horizon_length"], cfg["solver_refine_steps"])
            * cfg["newton_iterations"] * budget)

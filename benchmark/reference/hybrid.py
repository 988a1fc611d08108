"""The hybrid speed mode's selection and merge, plain: which envs a solve
re-solves, which of those take the re-solve's answer, and the four counters
it reports. It imports nothing of the program under test.

The mode solves every env with the fast (condensed) route, ranks each env
by its criterion, re-solves the `budget` worst envs from the cold start
with the robust (augmented) route, and merges:

- criterion: an env's largest final residual (flag "resid": the largest of
  its four residual entries), +inf where that is not finite or any value
  of its x, s, z or y is not finite;
- rank: the `budget` largest criteria in descending order, ties kept in
  index order (lower index first), so every non-finite env ranks before
  every finite one and the lowest-indexed non-finite envs come first; a
  budget <= 0 means max(64, B // 32), and the budget is at most B;
- need: a ranked env takes the re-solve's answer where its criterion is
  over `flag_tol` or infinite; every other env keeps the fast answer;
- counters: flagged (envs of the whole batch over `flag_tol` or infinite),
  nonfinite (envs ranked +inf), resolved (ranked envs that need the
  re-solve) and dropped_nonfinite (non-finite envs outside the budget).

So a solve merges exactly min(budget, flagged) envs (`resolved_of`): the
ranked envs are the budget's largest criteria, which hold every flagged
env up to the budget.

Both routes compute the same Mehrotra iterate, so the answers themselves
are held to the float64 solve of `qpsolve.py`; this module decides only
where each answer comes from. Results are dicts of (B, ...) tensors keyed
by field name (x, s, z, y, residuals); the merge copies values, so it is
exact in every dtype.
"""

from __future__ import annotations

import math

import torch

FIELDS = ("x", "s", "z", "y", "residuals")
COUNTERS = ("flagged", "nonfinite", "resolved", "dropped_nonfinite")


def budget_of(batch: int, budget: int) -> int:
    """The envs a solve re-solves: `budget`, or max(64, B // 32) where it is
    <= 0, at most B."""
    return min(max(64, batch // 32) if budget <= 0 else budget, batch)


def resolved_of(flagged, batch: int, budget: int):
    """The envs a solve merges, given its flagged count: every flagged env up
    to the budget. `flagged` is an int, or an integer tensor on any device."""
    k = budget_of(batch, budget)
    return torch.clamp(flagged, max=k) if torch.is_tensor(flagged) else min(flagged, k)


def criterion(fast: dict) -> list:
    """Per env, its largest final residual as a float, or +inf where that or
    any value of its x, s, z or y is not finite."""
    out = []
    for i in range(fast["residuals"].shape[0]):
        worst = max(float(v) for v in fast["residuals"][i].tolist())
        finite = math.isfinite(worst) and all(
            bool(torch.isfinite(fast[k][i]).all()) for k in ("x", "s", "z", "y"))
        out.append(worst if finite else math.inf)
    return out


def rank(crit: list, budget: int) -> list:
    """The `budget` env indices of largest criterion, largest first, ties in
    index order."""
    return sorted(range(len(crit)), key=lambda i: (-crit[i], i))[:budget]


def hybrid(fast: dict, robust: dict, budget: int, flag_tol: float):
    """(merged fields, counters, merged mask) of one solve: `fast` is the fast
    route's result on the whole batch, `robust` the robust route's result on
    the ranked envs in rank order (row j for the j-th ranked env)."""
    batch = fast["residuals"].shape[0]
    crit = criterion(fast)
    ranked = rank(crit, budget_of(batch, budget))
    merged = {k: fast[k].clone() for k in FIELDS}
    mask = torch.zeros(batch, dtype=torch.bool)
    resolved = 0
    for j, env in enumerate(ranked):
        if crit[env] > flag_tol or math.isinf(crit[env]):
            for k in FIELDS:
                merged[k][env] = robust[k][j]
            mask[env] = True
            resolved += 1
    nonfinite = sum(math.isinf(c) for c in crit)
    counts = {"flagged": sum(c > flag_tol or math.isinf(c) for c in crit),
              "nonfinite": nonfinite, "resolved": resolved,
              "dropped_nonfinite": nonfinite - sum(math.isinf(crit[i]) for i in ranked)}
    return merged, counts, mask

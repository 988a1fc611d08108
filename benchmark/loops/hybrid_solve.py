"""The batched MPC solve of `loops/solve.py` in the hybrid speed mode
(solver="pallas_hybrid"): the condensed route on every env, the worst envs
re-solved by the augmented route and merged. The configuration's
`hybrid_budget`, `hybrid_flag_tol` and `hybrid_flag` go into `MPCConf`.

Besides the solve loop's per-env extremes of the wrench, every solve's
four counters (`MPCController.hybrid_counts`: flagged, nonfinite, resolved,
dropped_nonfinite) are summed on the device and the envs that took the
re-solve's answer (`MPCController.hybrid_merged`) are gathered in one mask,
with no synchronization inside the window; so are the solves that break the
mode's rule (`reference/hybrid.resolved_of`): `resolved` other than
min(budget, flagged), or a merged mask that does not hold `resolved` envs.
The checks add to the solve's three: no non-finite env left unrescued in
any solve, no solve off the rule, and the 75th percentile of the wrench gap
over the envs the program merged, which a merge that keeps the condensed
answers fails, and which an empty mask fails outright.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark import port
from benchmark.common import Check, env_gap, quantile
from benchmark.loops import solve
from benchmark.reference.hybrid import COUNTERS, budget_of, resolved_of

METRIC, UNIT = solve.METRIC, solve.UNIT


class Loop(solve.Loop):
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        from biped_pympc_tpu_torch.wrapper import MPCController

        if not hasattr(MPCController, "hybrid_counts"):
            raise SystemExit("this program's MPCController has no hybrid_counts accessor: "
                             "the hybrid cell reads its counters without a sync")
        self.cfg, self.mix, self.device = cfg, mix, device
        ccfg, mcfg, gait_id, dtype = port.confs(cfg)
        mcfg = dataclasses.replace(mcfg, hybrid_budget=cfg["hybrid_budget"],
                                   hybrid_flag_tol=cfg["hybrid_flag_tol"],
                                   hybrid_flag=cfg["hybrid_flag"])
        B = self.batch = cfg["num_envs"]
        gen = torch.Generator(device).manual_seed(seed)
        self.obs = port.draw_observations(cfg, mix, gen, 1, B, device)[0]
        self.twist = port.uniform(gen, (B, 3), -mix["twist"], mix["twist"], device)
        self.phase = port.uniform(gen, (B,), 0.0, 1.0, device)
        self.height = torch.full((B,), mix["height"], device=device)
        ctrl = self.ctrl = MPCController(ccfg, mcfg, B, gait_id=gait_id, dtype=dtype,
                                         device=device)
        ctrl.set_command(self.twist, self.height)
        ctrl.update_state(self.obs)
        ctrl.state.gait_phase.copy_(self.phase)
        self.mem = {k: v.clone() for k, v in port.state_dict(ctrl.state.mpc_mem).items()}
        self._mem_now = port.state_dict(ctrl.state.mpc_mem)
        self._solve()  # the first call captures the graph
        w = ctrl.state.leg_cmd.wrench_ff
        self.wmin, self.wmax = w.clone(), w.clone()
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self.counts = torch.zeros(len(COUNTERS), dtype=torch.int64, device=device)
        self.merged = ctrl.hybrid_merged
        self.off_rule = torch.zeros((), dtype=torch.int64, device=device)
        self.solves = 0

    def _unit(self, i):
        super()._unit(i)
        counts, merged = self.ctrl.hybrid_counts, self.ctrl.hybrid_merged
        self.counts += counts
        self.merged |= merged
        resolved = counts[COUNTERS.index("resolved")]
        want = resolved_of(counts[COUNTERS.index("flagged")], self.batch, self.cfg["hybrid_budget"])
        self.off_rule += (resolved != want) | (merged.sum() != resolved)
        self.solves += 1

    def trace_info(self) -> dict:
        """The solve's, with the budget and the window's mean counters a solve."""
        per = (self.counts.double() / max(self.solves, 1)).tolist()
        return dict(super().trace_info(), budget=budget_of(self.batch, self.cfg["hybrid_budget"]),
                    hybrid=dict(zip(COUNTERS, per)))

    def release(self):
        self.counts, self.merged, self.off_rule = (self.counts.cpu(), self.merged.cpu(),
                                                   self.off_rule.cpu())
        super().release()

    def follow(self, ref):
        self._followed = super().follow(ref)
        return self._followed

    def use_control(self, dtype, device):
        super().use_control(dtype, device)
        self.counts, self.off_rule = torch.zeros_like(self.counts), torch.zeros_like(self.off_rule)

    def checks(self, limits: dict, device) -> list:
        out = super().checks(limits, device)
        w_ref = self._followed[0].cpu()
        gap = torch.maximum(env_gap(self.wmax, w_ref), env_gap(self.wmin, w_ref))[self.merged]
        return out + [
            Check("dropped_nonfinite_envs", float(self.counts[COUNTERS.index("dropped_nonfinite")]),
                  0.0),
            Check("off_rule_solves", float(self.off_rule), 0.0),
            # On this traffic nearly every env is flagged, so a sound solve merges
            # the whole budget; no merged env at all is a re-solve left out.
            Check("wrench_gap_merged_p75_N", quantile(gap, 0.75) if gap.numel() else math.inf,
                  limits["wrench_gap_merged_p75_N"])]

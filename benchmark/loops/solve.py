"""The batched MPC solve through the public wrapper: `MPCController.run_mpc`
(on the card one captured CUDA graph) replayed back to back on one
randomized walking batch, with no synchronization inside the window.

Every solve sees the same QPs: before each, the solve's cross-solve
latches (`mpc_mem`) are put back as they were, so the reference trajectory
does not drift with the number of solves. Every solve's wrench is folded
into a running per-env minimum and maximum on the device; after the window
the reference solves the batch's QPs once in float64, and the largest gap
of any solve of the window is read from those two extremes.
"""

from __future__ import annotations

import torch

from benchmark import port
from benchmark.common import Check, env_gap, quantile, rate_window
from benchmark.reference.control import Reference

METRIC, UNIT = "qp_units_per_s", "units/s"


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        from biped_pympc_tpu_torch.wrapper import MPCController

        self.cfg, self.mix, self.device = cfg, mix, device
        ccfg, mcfg, gait_id, dtype = port.confs(cfg)
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

    def _solve(self):
        for k, v in self.mem.items():
            self._mem_now[k].copy_(v)
        self.ctrl.run_mpc()

    def _unit(self, i):
        self._solve()
        w = self.ctrl.state.leg_cmd.wrench_ff
        torch.minimum(self.wmin, w, out=self.wmin)
        torch.maximum(self.wmax, w, out=self.wmax)
        self.bad += (~torch.isfinite(w)).flatten(1).any(1).sum()

    def window(self, seconds: float) -> dict:
        n, secs = rate_window(self._unit, seconds, self.mix["in_flight"], self.device)
        units = self.batch * self.cfg["newton_iterations"] / 5.0 * n
        return {"value": units / secs, "attempted": n * self.batch, "failed": int(self.bad)}

    def run_units(self, n: int):
        for _ in range(n):
            self._solve()

    def trace_info(self) -> dict:
        return {"cfg": self.cfg, "batch": self.batch, "per_unit": "solve"}

    def release(self):
        """Free the program's state; keep what the check reads."""
        self.wmin, self.wmax = self.wmin.cpu(), self.wmax.cpu()
        self.ctrl = self._mem_now = None

    def follow(self, ref):
        """The reference's wrench (B, 2, 6) and final mu (B,) of the batch."""
        st = ref.init_state(self.batch)
        t = lambda x: x.to(device=ref.device, dtype=ref.dtype)
        ref.set_command(st, t(self.twist), t(self.height))
        st["gait_phase"] = t(self.phase)
        ref.ingest(st, t(self.obs))
        w, _, mu = ref.run_mpc(st)
        return w, mu

    def use_control(self, dtype, device):
        """Put the reference computed in `dtype` in the program's place."""
        w, _ = self.follow(Reference(self.cfg, dtype, device))
        self.wmin = self.wmax = w.float().cpu()
        self.bad = (~torch.isfinite(self.wmin)).flatten(1).any(1).sum()

    def checks(self, limits: dict, device) -> list:
        w_ref, mu = self.follow(Reference(self.cfg, torch.float64, device))
        w_ref, mu = w_ref.cpu(), mu.cpu()
        gap = torch.maximum(env_gap(self.wmax, w_ref), env_gap(self.wmin, w_ref))
        conv = mu <= limits["converged_mu"]
        return [Check("wrench_gap_p75_N", quantile(gap, 0.75), limits["wrench_gap_p75_N"]),
                Check("wrench_gap_converged_N", float(gap[conv].max()) if conv.any() else 0.0,
                      limits["wrench_gap_converged_N"]),
                Check("nonfinite_env_solves", float(self.bad), 0.0)]

"""The public `MPCController` API driven as an external simulator drives it,
one 100 Hz control period after another in a closed loop: `set_command`,
then `decimation` ticks of `update_state` (each the next observation of a
device-resident pool), `run_mpc` at the first tick, `run_lowlevel` and
`get_action`; the next period starts once the last torques are ready.
A period is timed on the host clock from its first call to the end of a
synchronize after its last `get_action`.

The check follows the program period by period: for a sample of the
window's periods drawn from the seed it keeps the controller's carried
state before the period and the period's torques and wrench, and the
reference runs that period in float64 from that state; the period the
set-up runs from the controller's first state checks the start.
"""

from __future__ import annotations

import time

import torch

from benchmark import port
from benchmark.common import Check, Reservoir, env_gap, percentile, quantile, sync
from benchmark.reference.control import Reference

METRIC, UNIT = "period_ms_p95", "ms"


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        from biped_pympc_tpu_torch.wrapper import MPCController

        self.cfg, self.mix, self.device = cfg, mix, device
        ccfg, mcfg, gait_id, dtype = port.confs(cfg)
        B = self.batch = cfg["num_envs"]
        gen = torch.Generator(device).manual_seed(seed)
        self.obs = port.draw_observations(cfg, mix, gen, mix["observations"], B, device)
        self.cmds = port.uniform(gen, (mix["commands"], B, 3), -mix["twist"], mix["twist"],
                                 device)
        self.height = torch.full((B,), mix["height"], device=device)
        self.ctrl = MPCController(ccfg, mcfg, B, gait_id=gait_id, dtype=dtype, device=device)
        self.sample = Reservoir(mix["samples"], seed)
        self.kept = [None] * mix["samples"]
        self.k = 0  # periods run
        self.first = (None, self._period(keep=True))  # the first calls capture the graphs
        self.bad = 0

    def _period(self, keep=False):
        """One control period; returns (its index, its torques, its wrench)
        when `keep`, else its torques."""
        ctrl, k = self.ctrl, self.k
        ctrl.set_command(self.cmds[k % len(self.cmds)], self.height)
        taus = []
        for tick in range(self.cfg["decimation"]):
            ctrl.update_state(self.obs[(k * self.cfg["decimation"] + tick) % len(self.obs)])
            if tick == 0:
                ctrl.run_mpc()
            ctrl.run_lowlevel()
            taus.append(ctrl.get_action())
        self.k += 1
        if keep:
            return k, torch.stack(taus, 1), ctrl.state.leg_cmd.wrench_ff.clone()
        return taus

    def window(self, seconds: float) -> dict:
        times = []
        t_end = time.perf_counter() + seconds
        i = 0
        while time.perf_counter() < t_end:
            slot = self.sample.take(i)
            pre = port.carried(self.ctrl.state) if slot is not None else None
            sync(self.device)
            t0 = time.perf_counter()
            out = self._period(keep=slot is not None)
            sync(self.device)
            times.append(time.perf_counter() - t0)
            taus = out[1] if slot is not None else torch.stack(out, 1)
            self.bad += int((~torch.isfinite(taus)).flatten(1).any(1).sum())
            if slot is not None:
                self.kept[slot] = (pre, out)
            i += 1
        self.times = times
        return {"value": 1e3 * percentile(times, 95.0), "attempted": len(times) * self.batch,
                "failed": self.bad}

    def run_units(self, n: int) -> dict:
        """n periods, each `run_mpc` and each tick without a solve between
        CUDA events: {span name: [(start event, end event)]}."""
        ctrl, dec = self.ctrl, self.cfg["decimation"]
        ev = lambda: torch.cuda.Event(enable_timing=True)
        spans = {"run_mpc": [], "tick": []}
        for _ in range(n):
            k = self.k
            ctrl.set_command(self.cmds[k % len(self.cmds)], self.height)
            for tick in range(dec):
                a = ev()
                a.record()
                ctrl.update_state(self.obs[(k * dec + tick) % len(self.obs)])
                if tick == 0:
                    m = ev(), ev()
                    m[0].record()
                    ctrl.run_mpc()
                    m[1].record()
                    spans["run_mpc"].append(m)
                ctrl.run_lowlevel()
                ctrl.get_action()
                b = ev()
                b.record()
                if tick:
                    spans["tick"].append((a, b))
            self.k += 1
            sync(self.device)
        return spans

    def trace_info(self) -> dict:
        return {"cfg": self.cfg, "batch": self.batch, "per_unit": "period"}

    def release(self):
        self.ctrl = None

    def follow(self, ref, pre, k):
        """The reference's period k from the carried state `pre` (None: the
        controller's first state): (torques (B, decimation, 2 dof), wrench)."""
        t = lambda v: v.to(device=ref.device, dtype=ref.dtype)
        st = ref.init_state(self.batch)
        if pre is not None:
            st.update(port.to_reference({n: v.to(ref.device) for n, v in pre.items()}, ref.dtype))
        ref.set_command(st, t(self.cmds[k % len(self.cmds)]), t(self.height))
        dec, taus = self.cfg["decimation"], []
        for tick in range(dec):
            ref.ingest(st, t(self.obs[(k * dec + tick) % len(self.obs)]))
            if tick == 0:
                wrench, _, _ = ref.run_mpc(st)
            ref.run_lowlevel(st)
            taus.append(ref.joint_torque(st))
        return torch.stack(taus, 1), wrench

    def samples(self):
        return [self.first] + [s for s in self.kept if s is not None]

    def use_control(self, dtype, device):
        """Put the reference computed in `dtype` in the program's place."""
        ref = Reference(self.cfg, dtype, device)

        def out(pre, k):
            taus, wrench = self.follow(ref, pre, k)
            return k, taus.float(), wrench.float()

        self.first = (None, out(None, self.first[1][0]))
        self.kept = [None if s is None else (s[0], out(s[0], s[1][0])) for s in self.kept]
        self.bad = sum(int((~torch.isfinite(o[1])).flatten(1).any(1).sum())
                       for _, o in self.samples())

    def checks(self, limits: dict, device) -> list:
        ref = Reference(self.cfg, torch.float64, device)
        tgap, wgap = [], []
        for pre, (k, taus, wrench) in self.samples():
            taus_ref, w_ref = self.follow(ref, pre, k)
            tgap.append(env_gap(taus.to(device), taus_ref).cpu())
            wgap.append(env_gap(wrench.to(device), w_ref).cpu())
        return [Check("torque_gap_p75_Nm", max(quantile(g, 0.75) for g in tgap),
                      limits["torque_gap_p75_Nm"]),
                Check("wrench_gap_p75_N", max(quantile(g, 0.75) for g in wgap),
                      limits["wrench_gap_p75_N"]),
                Check("nonfinite_env_periods", float(self.bad), 0.0)]

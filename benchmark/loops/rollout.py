"""The closed loop on the device: the captured MPC cycle of the program's
rollout example (the observation through the robot's IK, `ingest_state`,
`run_mpc`, then `decimation` ticks of the low level and the affine RK4
plant) replayed cycle after cycle, in episodes of `episode_cycles` cycles,
each restarted from the seed's initial carry by a copy inside the window.

The closed loop amplifies rounding, so after some cycles the float32
program and a float64 reference part for reasons that are no fault. The
check therefore follows the program cycle by cycle: for a sample of the
window's cycles drawn from the seed it keeps the carry before and after
the replay, and the reference runs that one cycle in float64 from the
program's carried state; the window's first cycle starts from the
reference's own initial carry, which checks the start.
"""

from __future__ import annotations

import torch

from benchmark import port
from benchmark.common import Check, Reservoir, env_gap, quantile, rate_window
from benchmark.reference.control import Reference

METRIC, UNIT = "env_steps_per_s", "env-steps/s"


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        from biped_pympc_tpu_torch.control.controller import BipedControllerCore
        from biped_pympc_tpu_torch.examples import srbd_plant, tpu_rollout
        from biped_pympc_tpu_torch.utils.cuda_graph import LoopStep, copy_into, tree_map

        self.cfg, self.mix, self.device = cfg, mix, device
        self._copy_into = copy_into
        ccfg, mcfg, gait_id, dtype = port.confs(cfg)
        B = self.batch = cfg["num_envs"]
        gen = torch.Generator(device).manual_seed(seed)
        self.vx = port.uniform(gen, (B,), mix["vx"][0], mix["vx"][1], device)
        self.height = cfg["height"]
        core = BipedControllerCore(ccfg, mcfg, gait_id=gait_id, dtype=dtype, device=device)
        state = core.init_state(B)
        twist = torch.zeros(B, 3, dtype=dtype, device=device)
        twist[:, 0] = self.vx
        core.set_command(state, twist, torch.full((B,), self.height, dtype=dtype, device=device))
        x = torch.zeros(B, 12, dtype=dtype, device=device)
        x[:, 5] = self.height
        feet = srbd_plant.nominal_feet(core.robot, B, dtype, device)
        self.start = (state, x, feet)
        self.cycles = mix["episode_cycles"]
        rollout, _ = tpu_rollout.make_rollout(core, self.cycles * mcfg.decimation * mcfg.dt)
        own = tpu_rollout.RolloutCarry(tree_map(torch.clone, state), x.clone(), feet.clone(),
                                       x.new_zeros(self.cycles, *x.shape),
                                       torch.zeros(1, dtype=torch.int64, device=device))
        rollout.loop = LoopStep(rollout._step, own)  # captures the cycle on the card
        self.rollout, self.own = rollout, own
        self.sample = Reservoir(mix["samples"], seed)
        self.kept = [None] * mix["samples"]
        self.first = None
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self._restart()

    def _restart(self):
        own = self.own
        self._copy_into((own.state, own.x, own.foot_w), self.start)
        own.index.zero_()

    def _snapshot(self):
        own = self.own
        return {"state": port.carried(own.state), "x": own.x.clone(), "foot_w": own.foot_w.clone(),
                "wrench": own.state.leg_cmd.wrench_ff.clone()}

    def _unit(self, i):
        if i and i % self.cycles == 0:
            self._restart()
        slot = self.sample.take(i - 1) if i else None
        pre = self._snapshot() if slot is not None else None
        self.rollout.loop()
        if i == 0:
            self.first = self._snapshot()
        if slot is not None:
            self.kept[slot] = (pre, self._snapshot())
        self.bad += (~torch.isfinite(self.own.x)).any(1).sum()

    def window(self, seconds: float) -> dict:
        n, secs = rate_window(self._unit, seconds, self.mix["in_flight"], self.device)
        steps = n * self.cfg["decimation"] * self.batch
        self.bad_steps = int(self.bad) * self.cfg["decimation"]
        return {"value": steps / secs, "attempted": steps, "failed": self.bad_steps}

    def run_units(self, n: int):
        """n cycles (at most an episode) from the start of an episode."""
        self._restart()
        for _ in range(min(n, self.cycles)):
            self.rollout.loop()

    def trace_info(self) -> dict:
        return {"cfg": self.cfg, "batch": self.batch, "per_unit": "cycle"}

    def release(self):
        """Free the program's state; keep what the check reads."""
        self.rollout = self.own = self.start = None

    def samples(self):
        """(pre, post) pairs the check follows: the window's first cycle
        (pre None: the reference's own start) and the drawn ones."""
        return [(None, self.first)] + [k for k in self.kept if k is not None]

    def follow(self, ref, pre):
        """The reference's cycle from `pre` (None: its own start):
        {"x", "foot_w", "wrench"} after it."""
        st = ref.init_state(self.batch, self.vx.to(device=ref.device, dtype=ref.dtype),
                            self.height)
        if pre is None:
            x, feet = ref.init_plant(self.batch, self.height)
        else:
            st.update(port.to_reference({k: v.to(ref.device) for k, v in pre["state"].items()},
                                        ref.dtype))
            x, feet = (pre[k].to(device=ref.device, dtype=ref.dtype) for k in ("x", "foot_w"))
        x, feet, _ = ref.cycle_step(st, x, feet)
        return {"x": x, "foot_w": feet, "wrench": st["leg_cmd.wrench_ff"]}

    def use_control(self, dtype, device):
        """Put the reference computed in `dtype` in the program's place."""
        ref = Reference(self.cfg, dtype, device)
        out = lambda pre: {k: v.float() for k, v in self.follow(ref, pre).items()}
        self.first = out(None)
        self.kept = [None if k is None else (k[0], out(k[0])) for k in self.kept]
        self.bad_steps = sum(int((~torch.isfinite(post["x"])).any(1).sum())
                             for _, post in self.samples()) * self.cfg["decimation"]

    def checks(self, limits: dict, device) -> list:
        ref = Reference(self.cfg, torch.float64, device)
        wgap, pgap = [], []
        for pre, post in self.samples():
            r = self.follow(ref, pre)
            post = {k: post[k].to(device) for k in ("x", "foot_w", "wrench")}
            wgap.append(env_gap(post["wrench"], r["wrench"]).cpu())
            pgap.append(torch.maximum(env_gap(post["x"], r["x"]),
                                      env_gap(post["foot_w"], r["foot_w"])).cpu())
        return [Check("wrench_gap_p75_N", max(quantile(g, 0.75) for g in wgap),
                      limits["wrench_gap_p75_N"]),
                Check("plant_gap_p75", max(quantile(g, 0.75) for g in pgap),
                      limits["plant_gap_p75"]),
                Check("nonfinite_env_steps", float(self.bad_steps), 0.0)]

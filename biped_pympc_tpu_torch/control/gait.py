"""Phase-based gait generation, batch-first (twin of
`biped_pympc_tpu/control/gait.py`).

The only gait state is the phase per env; the rest is a function of
(phase, durations, dt_mpc). Durations are int32 MPC steps per env, shape
(B, 2) = [left, right]. Over one cycle (`gait_generator.py:24-31`):
  phase 0 .. ssp[1]: right swing; + dsp[0]: double support;
  + ssp[0]: left swing; + dsp[1]: double support.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class GaitParams:
    dsp_steps: torch.Tensor  # (B, 2) int32
    ssp_steps: torch.Tensor  # (B, 2) int32

    @property
    def cycle_steps(self) -> torch.Tensor:
        """(B,) cycle length in MPC steps."""
        return (self.dsp_steps + self.ssp_steps).sum(dim=-1)

    @property
    def swing_steps(self) -> torch.Tensor:
        """(B, 2) per-foot swing durations."""
        return self.ssp_steps


def _params(dsp, ssp, batch, device) -> GaitParams:
    rows = lambda v: torch.tensor(v, dtype=torch.int32, device=device).repeat(batch, 1)
    return GaitParams(dsp_steps=rows(dsp), ssp_steps=rows(ssp))


def standing_gait(batch: int, device=None) -> GaitParams:
    """gait_id 1: dsp = [5, 5], ssp = [0, 0]."""
    return _params([5, 5], [0, 0], batch, device)


def walking_gait(dsp: int, ssp: int, batch: int, device=None) -> GaitParams:
    """gait_id 2."""
    return _params([dsp, dsp], [ssp, ssp], batch, device)


def _phase_fracs(p: GaitParams, dtype):
    cycle = p.cycle_steps.to(dtype)[:, None]
    return p.ssp_steps.to(dtype) / cycle, p.dsp_steps.to(dtype) / cycle


def _safe_div(num, den):
    return num / torch.where(den != 0, den, torch.ones_like(den))


def swing_duration_sec(p: GaitParams, dt_mpc: torch.Tensor) -> torch.Tensor:
    """(B, 2) swing duration in seconds."""
    return p.swing_steps.to(dt_mpc.dtype) * dt_mpc[:, None]


def gait_duration_sec(p: GaitParams, dt_mpc: torch.Tensor) -> torch.Tensor:
    return p.cycle_steps.to(dt_mpc.dtype) * dt_mpc


def advance_phase(phase: torch.Tensor, p: GaitParams, dt: float,
                  dt_mpc: torch.Tensor) -> torch.Tensor:
    """phase += dt / gait seconds, wrapped once it passes 1."""
    phase = phase + dt / gait_duration_sec(p, dt_mpc)
    return phase - (phase > 1.0).to(phase.dtype)


def contact_sub_phase(phase: torch.Tensor, p: GaitParams) -> torch.Tensor:
    """(B, 2) stance sub-phase; -1 while the foot swings. Keeps the
    reference's use of ssp[0] in the left threshold (symmetric gaits)."""
    ssp, dsp = _phase_fracs(p, phase.dtype)
    neg = torch.full_like(phase, -1.0)
    th1 = ssp[:, 0] + dsp[:, 0]
    th2 = th1 + ssp[:, 1]
    left = torch.where(phase < th1, _safe_div(phase, th1),
                       torch.where(phase >= th2, _safe_div(phase - th2, dsp[:, 0]), neg))
    rth = ssp[:, 1]
    right = torch.where(phase >= rth,
                        _safe_div(phase - rth, dsp[:, 0] + ssp[:, 1] + dsp[:, 1]), neg)
    return torch.stack([left, right], dim=-1)


def swing_sub_phase(phase: torch.Tensor, p: GaitParams) -> torch.Tensor:
    """(B, 2) swing sub-phase; -1 while the foot is in stance."""
    ssp, dsp = _phase_fracs(p, phase.dtype)
    neg = torch.full_like(phase, -1.0)
    l_start = ssp[:, 1] + dsp[:, 0]
    l_end = l_start + ssp[:, 0]
    left = torch.where((phase >= l_start) & (phase < l_end),
                       _safe_div(phase - l_start, ssp[:, 0]), neg)
    right = torch.where(phase < ssp[:, 1], _safe_div(phase, ssp[:, 1]), neg)
    return torch.stack([left, right], dim=-1)


def mpc_contact_table(phase: torch.Tensor, p: GaitParams, horizon: int) -> torch.Tensor:
    """(B, horizon, 2) int32 contact table: future MPC steps binned into
    the gait's four phases."""
    cycle = p.cycle_steps[:, None]
    step0 = (phase * p.cycle_steps.to(phase.dtype)).to(torch.int32)
    steps = (step0[:, None] + torch.arange(horizon, dtype=torch.int32, device=phase.device)) % cycle
    ssp1 = p.ssp_steps[:, 1:2]
    dsp0 = p.dsp_steps[:, 0:1]
    ssp0 = p.ssp_steps[:, 0:1]
    right_swing = steps < ssp1
    left_swing = (steps >= ssp1 + dsp0) & (steps < ssp1 + dsp0 + ssp0)
    return torch.stack([~left_swing, ~right_swing], dim=-1).to(torch.int32)

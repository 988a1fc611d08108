"""Swing-leg control: Raibert foot placement and Bezier / cycloid swing
curves, batch-first (twin of `biped_pympc_tpu/control/swing.py`).

"base" plans the curve in the body frame from the measured body-frame foot;
"world" latches the world-frame foot, plans in world, and expresses the
targets in the body frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# Raibert heuristic constants (`swing_leg_controller.py:178-182`).
P_REL_MAX_X = 0.3
P_REL_MAX_Y = 0.3
K_X = 0.03
K_Y = 0.03


@dataclass
class SwingState:
    first_swing: torch.Tensor  # (B, 2) bool
    swing_time_remaining: torch.Tensor  # (B, 2) seconds
    p0: torch.Tensor  # (B, 2, 3) latched lift-off foot position
    foot_placement_w: torch.Tensor  # (B, 2, 3) world-frame Raibert target
    foot_placement_b: torch.Tensor  # (B, 2, 3) body-frame Raibert target


def init_state(batch: int, dtype=torch.float32, device=None) -> SwingState:
    z = lambda *s: torch.zeros(batch, *s, dtype=dtype, device=device)
    return SwingState(first_swing=torch.ones(batch, 2, dtype=torch.bool, device=device),
                      swing_time_remaining=z(2), p0=z(2, 3),
                      foot_placement_w=z(2, 3), foot_placement_b=z(2, 3))


def reset(state: SwingState, mask: torch.Tensor) -> None:
    """Re-arm the first-swing latch of the envs in mask (B,), in place."""
    state.first_swing = state.first_swing | mask[:, None]


def update_swing_time(state: SwingState, contact_phase, swing_duration, dt: float) -> None:
    """Remaining swing time: the duration on a first swing tick, else minus
    dt; feet in contact re-arm the latch. Updates `state` in place."""
    state.swing_time_remaining = torch.where(
        state.first_swing, swing_duration, state.swing_time_remaining - dt)
    state.first_swing = state.first_swing | (contact_phase >= 0)


def raibert_placement(root_pos, rot_body, root_vel_w, vel_des_w, swing_time_remaining,
                      hip_positions) -> torch.Tensor:
    """(B, 2, 3) world foothold:
    root + R hip + 0.5 v t_remaining + clamp(k (v - v_des)), z = 0."""
    base = (root_pos[:, None, :] + hip_positions @ rot_body.transpose(-1, -2)
            + 0.5 * root_vel_w[:, None, :] * swing_time_remaining[:, :, None])
    fb_x = torch.clamp(K_X * (root_vel_w[:, 0] - vel_des_w[:, 0]), -P_REL_MAX_X, P_REL_MAX_X)
    fb_y = torch.clamp(K_Y * (root_vel_w[:, 1] - vel_des_w[:, 1]), -P_REL_MAX_Y, P_REL_MAX_Y)
    fb = torch.stack([fb_x, fb_y, torch.zeros_like(fb_x)], dim=-1)
    placement = base + fb[:, None, :]
    placement[:, :, 2] = 0.0
    return placement


def compute_foot_placement(state: SwingState, root_pos, rot_body, root_vel_w, vel_des_b,
                           hip_positions) -> None:
    """Raibert placement in world and body frames, in place."""
    vel_des_w = (rot_body @ vel_des_b[..., None])[..., 0]
    placement_w = raibert_placement(root_pos, rot_body, root_vel_w, vel_des_w,
                                    state.swing_time_remaining, hip_positions)
    state.foot_placement_w = placement_w
    state.foot_placement_b = (placement_w - root_pos[:, None, :]) @ rot_body


def cubic_bezier(phase, swing_time, p0, pf, height, cp1, cp2):
    """Cubic Bezier swing curve; both z control points are
    (8 z_apex - z0 - zf) / 6 so the curve peaks `height` above p0 at phase
    0.5. phase, swing_time, height, cp1, cp2: (B,); p0, pf: (B, 3).
    Returns (p, v), each (B, 3)."""
    p1 = p0 + cp1[:, None] * (pf - p0)
    p2 = p0 + cp2[:, None] * (pf - p0)
    z_apex = p0[:, 2] + height
    zc = (8.0 * z_apex - p0[:, 2] - pf[:, 2]) / 6.0
    p1 = torch.cat([p1[:, :2], zc[:, None]], dim=1)
    p2 = torch.cat([p2[:, :2], zc[:, None]], dim=1)
    ph = phase[:, None]
    om = 1.0 - ph
    p = om ** 3 * p0 + 3 * om ** 2 * ph * p1 + 3 * om * ph ** 2 * p2 + ph ** 3 * pf
    v = (3 * om ** 2 * (p1 - p0) + 6 * om * ph * (p2 - p1)
         + 3 * ph ** 2 * (pf - p2)) / swing_time[:, None]
    return p, v


def cycloid(phase, swing_time, p0, pf, height):
    """Cycloid swing curve; shapes as `cubic_bezier`."""
    ph = 2.0 * math.pi * phase[:, None]
    st = swing_time[:, None]
    p = (pf - p0) * (ph - torch.sin(ph)) / (2.0 * math.pi) + p0
    v = (pf - p0) * (1.0 - torch.cos(ph)) / st
    pz = height * (1.0 - torch.cos(ph[:, 0])) / 2.0 + p0[:, 2]
    vz = height * math.pi * torch.sin(ph[:, 0]) / swing_time
    return (torch.cat([p[:, :2], pz[:, None]], dim=1),
            torch.cat([v[:, :2], vz[:, None]], dim=1))


def _curves(state, swing_phase, swing_duration, p0, target, foot_height, cp1, cp2, curve):
    ps, vs = [], []
    for i in (0, 1):
        ph = torch.clamp(swing_phase[:, i], 0.0, 1.0)
        if curve == "cycloid":
            p, v = cycloid(ph, swing_duration[:, i], p0[:, i], target[:, i], foot_height)
        else:
            p, v = cubic_bezier(ph, swing_duration[:, i], p0[:, i], target[:, i],
                                foot_height, cp1, cp2)
        ps.append(p)
        vs.append(v)
    return torch.stack(ps, dim=1), torch.stack(vs, dim=1)


def _latch(state: SwingState, swing_phase, contact_phase, foot_pos):
    """Latch p0 on the first swing tick, drop the latch while swinging,
    re-arm it in contact (in place). Returns p0."""
    latch = state.first_swing & (swing_phase >= 0)
    p0 = torch.where(latch[..., None], foot_pos, state.p0)
    first = torch.where(swing_phase >= 0, torch.zeros_like(state.first_swing), state.first_swing)
    state.first_swing = first | (contact_phase >= 0)
    state.p0 = p0
    return p0


def compute_foot_desired_position(state: SwingState, swing_phase, contact_phase,
                                  swing_duration, foot_pos_b, foot_height, cp1, cp2,
                                  curve: str = "bezier"):
    """Body-frame ("base") swing targets; updates the latches in place.
    Returns (p_des (B, 2, 3), v_des (B, 2, 3))."""
    p0 = _latch(state, swing_phase, contact_phase, foot_pos_b)
    return _curves(state, swing_phase, swing_duration, p0, state.foot_placement_b,
                   foot_height, cp1, cp2, curve)


def compute_foot_desired_position_world(state: SwingState, swing_phase, contact_phase,
                                        swing_duration, foot_pos_w, root_pos, root_vel_w,
                                        rot_body, foot_height, cp1, cp2,
                                        curve: str = "bezier"):
    """World-frame planning, targets returned in the body frame:
    p_b = R^T (p_w - root), v_b = R^T (v_w - root_vel_w)."""
    p0 = _latch(state, swing_phase, contact_phase, foot_pos_w)
    p_w, v_w = _curves(state, swing_phase, swing_duration, p0, state.foot_placement_w,
                       foot_height, cp1, cp2, curve)
    return ((p_w - root_pos[:, None, :]) @ rot_body,
            (v_w - root_vel_w[:, None, :]) @ rot_body)

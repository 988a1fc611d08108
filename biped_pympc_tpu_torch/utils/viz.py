"""Debug visualization: the SRBD box with its feet and ground-reaction
arrows (twin of `biped_pympc_tpu/utils/viz.py`).

`log_rollout_frame` packs one control step of an `MPCController` into the
layout `animate_srbd` takes (base pose, foot positions, ground-reaction
wrench), as numpy copied from the controller's device. matplotlib is
imported only inside `animate_srbd`: nothing else here needs it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np


class SrbdFrames(NamedTuple):
    """A logged rollout of one env, world frame, numpy."""

    pose: np.ndarray  # (T, 6) [roll, pitch, yaw, x, y, z]
    foot_pos: np.ndarray  # (T, 2, 3) left / right foot position
    grf: np.ndarray  # (T, 2, 3) left / right ground-reaction force
    grm: Optional[np.ndarray] = None  # (T, 2, 3) reaction moments


def log_rollout_frame(ctrl, env: int = 0) -> tuple:
    """One frame (pose, foot_pos, grf, grm) of env `env` of an MPCController:

        frames.append(log_rollout_frame(ctrl))
        anim = animate_srbd(SrbdFrames(*map(np.stack, zip(*frames))))
    """
    np_ = lambda t: t[env].detach().double().cpu().numpy()
    est = ctrl.state.est
    pose = np.concatenate([np_(est.root_euler), np_(est.root_position)])
    foot = np_(est.foot_position_w)  # (2, 3)
    wrench = np_(ctrl.ground_reaction_wrench)  # (2, 6) per leg
    return pose, foot, wrench[:, :3], wrench[:, 3:]


def _euler_to_rot(rpy: np.ndarray) -> np.ndarray:
    """ZYX yaw-pitch-roll rotation (the `utils/maths.py` convention)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx


_BOX_FACES = ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4), (2, 3, 7, 6), (1, 2, 6, 5), (0, 3, 7, 4))


def animate_srbd(frames: SrbdFrames, box_lwh: Sequence[float] = (0.2, 0.1, 0.3),
                 interval_ms: int = 50, force_scale: float = 2e-3, moment_scale: float = 2e-2,
                 save_path: Optional[str] = None):
    """Animate the SRBD box with GRF (red / orange) and GRM (blue) arrows at
    the feet. Returns the matplotlib FuncAnimation (the caller keeps it
    alive); with `save_path` it also writes a gif (PillowWriter)."""
    import matplotlib

    if save_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    pose = np.asarray(frames.pose)
    foot = np.asarray(frames.foot_pos)
    grf = np.asarray(frames.grf)
    grm = None if frames.grm is None else np.asarray(frames.grm)
    n = pose.shape[0]

    length, width, height = box_lwh
    corners = 0.5 * np.array([
        [-length, -width, -height], [length, -width, -height], [length, width, -height],
        [-length, width, -height], [-length, -width, height], [length, -width, height],
        [length, width, height], [-length, width, height]])

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    center = pose[:, 3:6].mean(axis=0)
    ax.set_xlim(center[0] - 0.6, center[0] + 0.6)
    ax.set_ylim(center[1] - 0.6, center[1] + 0.6)
    ax.set_zlim(0.0, center[2] + 0.6)
    ax.set_box_aspect((1, 1, 1))

    box = Poly3DCollection([], alpha=0.4, facecolor="tab:gray", edgecolor="k")
    ax.add_collection3d(box)
    arrows = []

    def draw(i):
        nonlocal arrows
        for a in arrows:
            a.remove()
        arrows = []
        rot = _euler_to_rot(pose[i, :3])
        pts = pose[i, 3:6] + corners @ rot.T
        box.set_verts([[pts[j] for j in f] for f in _BOX_FACES])
        for leg, color in ((0, "tab:red"), (1, "tab:orange")):
            p = foot[i, leg]
            f = grf[i, leg] * force_scale
            arrows.append(ax.quiver(p[0], p[1], p[2], f[0], f[1], f[2], color=color))
            if grm is not None:
                m = grm[i, leg] * moment_scale
                arrows.append(ax.quiver(p[0], p[1], p[2], m[0], m[1], m[2], color="tab:blue"))
        return [box]

    anim = FuncAnimation(fig, draw, frames=n, interval=interval_ms, blit=False)
    if save_path is not None:
        from matplotlib.animation import PillowWriter

        anim.save(save_path, writer=PillowWriter(fps=max(1, 1000 // interval_ms)))
        plt.close(fig)
    return anim

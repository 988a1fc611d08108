"""Plain convex-MPC biped controller and SRBD plant, the benchmark's
reference: gait timing, the state estimate from an observation, leg
kinematics, swing planning, QP assembly, the QP solve (`qpsolve.py`), the
postprocessed foot wrench, joint torques, and the closed loop's
observation and affine RK4 plant step.

The equations are those of the single-rigid-body MPC biped controller this
repository ports (Biped-PyMPC); the settings come from a configuration file
of `benchmark/configs/`. It imports nothing of the program under test. The
controller's state is a flat dict of tensors keyed as the program's state
leaves are named (`gait_phase`, `swing_state.p0`, ...), so that a check can
start the reference from a state the program reached. Every function works
in the dtype of its inputs (float64 for the check, lower for the control).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.qpsolve import solve_qp
from benchmark.reference.robots import ROBOTS, _mv

GRAVITY = 9.81
NX = NU = 12
# Raibert heuristic constants.
K_FB, FB_MAX = 0.03, 0.3


def _mat3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_to_rotmat(q):
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return _mat3([[w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z]])


def quat_to_euler(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y)),
                        torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0)),
                        torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))], dim=-1)


def euler_to_quat(rpy):
    r, p, y = (rpy[:, i] / 2 for i in range(3))
    cr, sr, cp, sp, cy, sy = (torch.cos(r), torch.sin(r), torch.cos(p), torch.sin(p),
                              torch.cos(y), torch.sin(y))
    return torch.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy], dim=1)


def inv(m):
    """Inverse of a batch of small matrices; a half-width type is inverted
    in float32 and rounded back (torch has no half-width inverse)."""
    if m.dtype in (torch.bfloat16, torch.float16):
        return torch.linalg.inv(m.float()).to(m.dtype)
    return torch.linalg.inv(m)


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return _mat3([[o, -z, y], [z, o, -x], [-y, x, o]])


class Reference:
    """The controller of one configuration (a dict read from its JSON file)
    in `dtype` on `device`."""

    def __init__(self, cfg: dict, dtype=torch.float64, device="cpu"):
        self.cfg, self.dtype, self.device = cfg, dtype, torch.device(device)
        self.robot = ROBOTS[cfg["robot"]]
        self.dof = self.robot.num_dof
        self.T = cfg["horizon_length"]
        ssp, dsp = cfg["ssp_durations"], cfg["dsp_durations"]
        self.ssp, self.dsp = (ssp, ssp), (dsp, dsp)
        self.cycle = 2 * (ssp + dsp)

    def t(self, v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=self.dtype, device=self.device)

    # state

    def init_state(self, batch: int, vx=None, height=None) -> dict:
        """The controller's state at start, with the command (vx (B,), height)."""
        z = lambda *s: torch.zeros(batch, *s, dtype=self.dtype, device=self.device)
        st = {"gait_phase": z(), "swing_state.first_swing": torch.ones(
                  batch, 2, dtype=torch.bool, device=self.device),
              "swing_state.p0": z(2, 3), "mpc_mem.first_run": torch.ones(
                  batch, dtype=torch.bool, device=self.device),
              "mpc_mem.world_position_desired": z(3), "mpc_mem.yaw_desired": z(),
              "des.velocity_b": z(3), "des.ang_velocity_b": z(3),
              "des.height": torch.full((batch,), 0.55, dtype=self.dtype, device=self.device),
              "leg_cmd.wrench_ff": z(2, 6)}
        st["swing_state.swing_time_remaining"] = self.swing_duration(batch)
        if vx is not None:
            twist = z(3)
            twist[:, 0] = vx
            self.set_command(st, twist, torch.full((batch,), height, dtype=self.dtype,
                                                   device=self.device))
        return st

    def swing_duration(self, batch):
        return self.t([s * self.cfg["dt_mpc"] for s in self.ssp]).expand(batch, 2).clone()

    def set_command(self, st, twist, height):
        st["des.velocity_b"] = torch.cat([twist[:, :2], torch.zeros_like(twist[:, :1])], 1)
        st["des.ang_velocity_b"] = torch.cat([torch.zeros_like(twist[:, :2]), twist[:, 2:]], 1)
        st["des.height"] = height

    # gait

    def contact_sub_phase(self, ph):
        ssp, dsp = (self.t(v) / self.cycle for v in (self.ssp, self.dsp))
        th1 = ssp[0] + dsp[0]
        th2 = th1 + ssp[1]
        div = lambda a, b: a / b if float(b) != 0 else a
        neg = torch.full_like(ph, -1.0)
        left = torch.where(ph < th1, div(ph, th1),
                           torch.where(ph >= th2, div(ph - th2, dsp[0]), neg))
        right = torch.where(ph >= ssp[1], div(ph - ssp[1], dsp[0] + ssp[1] + dsp[1]), neg)
        return torch.stack([left, right], -1)

    def swing_sub_phase(self, ph):
        ssp, dsp = (self.t(v) / self.cycle for v in (self.ssp, self.dsp))
        start = ssp[1] + dsp[0]
        neg = torch.full_like(ph, -1.0)
        left = torch.where((ph >= start) & (ph < start + ssp[0]), (ph - start) / ssp[0], neg)
        right = torch.where(ph < ssp[1], ph / ssp[1], neg)
        return torch.stack([left, right], -1)

    def contact_table(self, ph):
        """(B, T, 2) 1 where a foot stands at each of the horizon's steps."""
        step0 = (ph * self.cycle).to(torch.int64)
        steps = (step0[:, None] + torch.arange(self.T, device=ph.device)) % self.cycle
        right_swing = steps < self.ssp[1]
        left_swing = (steps >= self.ssp[1] + self.dsp[0]) & (
            steps < self.ssp[1] + self.dsp[0] + self.ssp[0])
        return torch.stack([~left_swing, ~right_swing], -1).to(self.dtype)

    # the 1 kHz tick

    def ingest(self, st, obs):
        """Joint kinematics and the state estimate from an observation
        [pos, quat wxyz, v_b, w_b, q, qd, tau]."""
        d2, nb, r = 2 * self.dof, obs.shape[0], self.robot
        q = obs[:, 13:13 + d2].reshape(nb, 2, self.dof)
        qd = obs[:, 13 + d2:13 + 2 * d2].reshape(nb, 2, self.dof)
        st["contact_phase"] = self.contact_sub_phase(st["gait_phase"])
        st["swing_phase"] = self.swing_sub_phase(st["gait_phase"])
        st["leg_data.q"], st["leg_data.qd"] = q, qd
        st["leg_data.p"] = torch.stack([r.foot(q[:, i], i) for i in (0, 1)], 1)
        st["leg_data.jac"] = torch.stack([r.jacobian(q[:, i], i) for i in (0, 1)], 1)
        rot = quat_to_rotmat(obs[:, 3:7])
        st["est.root_position"] = obs[:, 0:3]
        st["est.root_euler"] = quat_to_euler(obs[:, 3:7])
        st["est.rotation_body"] = rot
        st["est.root_velocity_w"] = _mv(rot, obs[:, 7:10])
        st["est.root_angular_velocity_w"] = _mv(rot, obs[:, 10:13])
        st["est.foot_position_w"] = st["leg_data.p"] @ rot.transpose(-1, -2) \
            + obs[:, None, 0:3]

    def run_lowlevel(self, st):
        """Swing timing, Raibert footholds, Bezier swing targets in the body
        frame, the leg command, and the gait phase advanced by one tick."""
        c, r = self.cfg, self.robot
        nb = st["gait_phase"].shape[0]
        cph = self.contact_sub_phase(st["gait_phase"])
        sph = self.swing_sub_phase(st["gait_phase"])
        dur = self.swing_duration(nb)
        first = st["swing_state.first_swing"]
        remaining = torch.where(first, dur, st["swing_state.swing_time_remaining"] - c["dt"])
        first = first | (cph >= 0)
        rot, pos, vel_w = st["est.rotation_body"], st["est.root_position"], st["est.root_velocity_w"]
        vdes_w = _mv(rot, st["des.velocity_b"])
        hips = self.t(r.hip)
        place = (pos[:, None] + hips @ rot.transpose(-1, -2)
                 + 0.5 * vel_w[:, None] * remaining[:, :, None])
        fb = torch.stack([torch.clamp(K_FB * (vel_w[:, i] - vdes_w[:, i]), -FB_MAX, FB_MAX)
                          for i in (0, 1)] + [torch.zeros_like(pos[:, 0])], -1)
        place = place + fb[:, None]
        place = torch.cat([place[..., :2], torch.zeros_like(place[..., 2:])], -1)
        target = (place - pos[:, None]) @ rot
        if c["swing_reference_frame"] != "base" or c["swing_curve"] != "bezier":
            raise ValueError("the reference plans Bezier swings in the body frame only")
        foot = st["leg_data.p"]
        latch = first & (sph >= 0)
        p0 = torch.where(latch[..., None], foot, st["swing_state.p0"])
        first = torch.where(sph >= 0, torch.zeros_like(first), first) | (cph >= 0)
        h = self.t(c["swing_height"])
        p_des, v_des = [], []
        for i in (0, 1):
            ph = torch.clamp(sph[:, i], 0.0, 1.0)[:, None]
            a, b = p0[:, i], target[:, i]
            zc = (8.0 * (a[:, 2] + h) - a[:, 2] - b[:, 2]) / 6.0
            p1 = torch.cat([(a + (b - a) / 3.0)[:, :2], zc[:, None]], 1)
            p2 = torch.cat([(a + 2.0 * (b - a) / 3.0)[:, :2], zc[:, None]], 1)
            om = 1.0 - ph
            p_des.append(om ** 3 * a + 3 * om ** 2 * ph * p1 + 3 * om * ph ** 2 * p2 + ph ** 3 * b)
            v_des.append((3 * om ** 2 * (p1 - a) + 6 * om * ph * (p2 - p1)
                          + 3 * ph ** 2 * (b - p2)) / dur[:, i:i + 1])
        p_des, v_des = torch.stack(p_des, 1), torch.stack(v_des, 1)
        stance = (cph != -1)[..., None]
        jac = st["leg_data.jac"]
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        st["leg_cmd.kp"] = torch.where(stance, zero, self.t(r.kp))
        st["leg_cmd.kd"] = self.t(r.kd).expand(nb, 2, self.dof)
        st["leg_cmd.tau_ff"] = torch.where(
            stance, _mv(jac.transpose(-1, -2), st["leg_cmd.wrench_ff"]), zero)
        q_sw = torch.stack([r.ik(p_des[:, i], i) for i in (0, 1)], 1)
        st["leg_cmd.q_des"] = torch.where(stance, zero, q_sw)
        qd_sw = _mv(jac[:, :, :3].transpose(-1, -2), v_des)
        qd_sw[..., 0] = 0.0
        qd_sw[..., -1] = 0.0
        st["leg_cmd.qd_des"] = torch.where(stance, zero, qd_sw)
        st["leg_cmd.p_des"], st["leg_cmd.v_des"] = p_des, v_des
        st["swing_state.swing_time_remaining"], st["swing_state.p0"] = remaining, p0
        st["swing_state.first_swing"] = first
        phase = st["gait_phase"] + c["dt"] / (self.cycle * c["dt_mpc"])
        st["gait_phase"] = phase - (phase > 1.0).to(phase.dtype)

    def joint_torque(self, st):
        """(B, 2 dof) clamp(tau_ff + Kp (q_des - q) + Kd (qd_des - qd))."""
        tau = (st["leg_cmd.tau_ff"] + st["leg_cmd.kp"] * (st["leg_cmd.q_des"] - st["leg_data.q"])
               + st["leg_cmd.kd"] * (st["leg_cmd.qd_des"] - st["leg_data.qd"]))
        lim = self.t(self.robot.torque_limit)
        return torch.clamp(tau.reshape(tau.shape[0], -1), -lim, lim)

    # the 100 Hz solve

    def assemble(self, st):
        """The batch's QPs as dense matrices, and the latches they update."""
        c, r, T = self.cfg, self.robot, self.T
        nb = st["gait_phase"].shape[0]
        pos, eul, rot = st["est.root_position"], st["est.root_euler"], st["est.rotation_body"]
        vb, wb, h = st["des.velocity_b"], st["des.ang_velocity_b"], st["des.height"]
        first = st["mpc_mem.first_run"]
        ddt = c["decimation"] * c["dt"]
        wpd = torch.where(first[:, None], pos, st["mpc_mem.world_position_desired"])
        yaw = torch.where(first, eul[:, 2], st["mpc_mem.yaw_desired"]) + ddt * wb[:, 2]
        wpd = torch.stack([wpd[:, 0] + ddt * vb[:, 0], wpd[:, 1] + ddt * vb[:, 1], h], 1)
        if c["contact_frame"] != "world":
            raise ValueError("the reference keeps contact rows in world axes only")
        tk = c["dt_mpc"] * self.t(np.arange(T))
        v_w = _mv(rot, vb)
        xy = torch.where((vb[:, 0].abs() < 1e-2)[:, None], wpd[:, :2], pos[:, :2])
        x_ref = torch.zeros(nb, T, NX, dtype=self.dtype, device=self.device)
        x_ref[:, :, 2] = yaw[:, None] + wb[:, 2:3] * tk
        x_ref[:, :, 3] = xy[:, 0:1] + v_w[:, 0:1] * tk
        x_ref[:, :, 4] = xy[:, 1:2] + v_w[:, 1:2] * tk
        x_ref[:, :, 5] = h[:, None]
        x_ref[:, :, 8] = wb[:, 2:3]
        x_ref[:, :, 9] = v_w[:, 0:1]
        x_ref[:, :, 10] = v_w[:, 1:2]
        # Continuous SRBD at the current state, rpy_dot = R^T w.
        i_w_inv = inv(rot @ self.t(r.i_body) @ rot.transpose(-1, -2))
        eye3 = torch.eye(3, dtype=self.dtype, device=self.device)
        A = torch.zeros(nb, NX, NX, dtype=self.dtype, device=self.device)
        A[:, 0:3, 6:9] = rot.transpose(-1, -2)
        A[:, 3:6, 9:12] = eye3
        B = torch.zeros(nb, NX, NU, dtype=self.dtype, device=self.device)
        feet = st["est.foot_position_w"]
        for i in (0, 1):
            B[:, 6:9, 3 * i:3 * i + 3] = i_w_inv @ skew(feet[:, i] - pos)
            B[:, 6:9, 6 + 3 * i:9 + 3 * i] = i_w_inv
            B[:, 9:12, 3 * i:3 * i + 3] = eye3 / r.mass
        cvec = torch.zeros(nb, NX, dtype=self.dtype, device=self.device)
        cvec[:, 11] = -GRAVITY
        # RK4 of the affine model over dt_mpc in closed form.
        dA = c["dt_mpc"] * A
        eye = torch.eye(NX, dtype=self.dtype, device=self.device)
        dA2 = dA @ dA
        dA3 = dA2 @ dA
        Ad = eye + dA + dA2 / 2 + dA3 / 6 + dA3 @ dA / 24
        M = c["dt_mpc"] * (eye + dA / 2 + dA2 / 6 + dA3 / 24)
        Bd, cd = M @ B, _mv(M, cvec)
        x0 = torch.cat([eul, pos, st["est.root_angular_velocity_w"], st["est.root_velocity_w"]], 1)
        nz, ne, ni = 2 * NX * T, (NX + 2) * T, 16 * T
        q_w, r_w = self.t(c["Q"]), self.t(c["R"])
        H = torch.cat([q_w.repeat(T), r_w.repeat(T)]).expand(nb, nz)
        f = torch.cat([-(q_w * x_ref).reshape(nb, -1),
                       torch.zeros(nb, NU * T, dtype=self.dtype, device=self.device)], 1)
        Aeq = torch.zeros(nb, ne, nz, dtype=self.dtype, device=self.device)
        beq = torch.zeros(nb, ne, dtype=self.dtype, device=self.device)
        G = torch.zeros(nb, ni, nz, dtype=self.dtype, device=self.device)
        d = torch.zeros(nb, ni, dtype=self.dtype, device=self.device)
        g_u = self.friction_rows(nb)
        table = self.contact_table(st["gait_phase"])
        for k in range(T):
            rows, xc, uc = slice(NX * k, NX * k + NX), NX * k, NX * T + NU * k
            Aeq[:, rows, xc:xc + NX] = eye
            if k:
                Aeq[:, rows, xc - NX:xc] = -Ad
            Aeq[:, rows, uc:uc + NU] = -Bd
            beq[:, rows] = cd + (_mv(Ad, x0) if k == 0 else 0.0)
            Aeq[:, NX * T + 2 * k, uc + 6] = 1.0  # the ankles' M_x is unactuated
            Aeq[:, NX * T + 2 * k + 1, uc + 9] = 1.0
            G[:, 16 * k:16 * k + 16, uc:uc + NU] = g_u
            d[:, 16 * k + 7] = c["f_max"] * table[:, k, 0]
            d[:, 16 * k + 15] = c["f_max"] * table[:, k, 1]
        mem = {"mpc_mem.first_run": torch.zeros_like(first),
               "mpc_mem.world_position_desired": wpd, "mpc_mem.yaw_desired": yaw}
        return (H, f, Aeq, beq, G, d), mem

    def friction_rows(self, nb):
        """(B, 16, 12) per foot: friction pyramid x-, x+, y-, y+, toe, heel,
        -fz <= 0, fz <= f_max in contact (0 in swing)."""
        r = self.robot
        g = torch.zeros(nb, 16, NU, dtype=self.dtype, device=self.device)
        for foot, (fc, mc) in enumerate(((0, 6), (3, 9))):
            k = 8 * foot
            for j, (col, sign) in enumerate(((0, -1), (0, 1), (1, -1), (1, 1))):
                g[:, k + j, fc + col] = sign
                g[:, k + j, fc + 2] = -r.mu
            g[:, k + 4, fc + 2], g[:, k + 4, mc + 1] = -r.lt, -1.0
            g[:, k + 5, fc + 2], g[:, k + 5, mc + 1] = -r.lh, 1.0
            g[:, k + 6, fc + 2], g[:, k + 7, fc + 2] = -1.0, 1.0
        return g

    def run_mpc(self, st, solve=None):
        """Assemble, solve (`solve` or the configured Newton steps of
        `solve_qp`), postprocess; returns (body wrench (B, 2, 6), world
        [F_L, F_R, M_L, M_R] as solved (B, 4, 3), final mu (B,))."""
        qp, mem = self.assemble(st)
        c = self.cfg
        solve = solve or (lambda qp: solve_qp(*qp, iterations=c["newton_iterations"],
                                              beta=c["solver_beta"], delta=c["solver_delta"]))
        x, mu = solve(qp)
        nb, T = x.shape[0], self.T
        grf = x[:, NX * T:NX * T + NU].reshape(nb, 4, 3)
        rot = st["est.rotation_body"]
        grm = grf[:, 2:].clone()
        grm[:, :, 0] = 0.0
        wrench = -torch.cat([grf[:, :2] @ rot, grm @ rot], 2)
        st.update(mem)
        st["leg_cmd.wrench_ff"] = wrench
        return wrench, grf, mu

    # the closed loop

    def observe(self, x, foot_w):
        """Observation of plant state x (B, 12) = [rpy, pos, w_w, v_w] and
        world feet (B, 2, 3), the joints from the robot's IK; and the rotation."""
        quat = euler_to_quat(x[:, :3])
        rot = quat_to_rotmat(quat)
        rt = rot.transpose(-1, -2)
        foot_b = (foot_w - x[:, None, 3:6]) @ rot
        q = [self.robot.ik(foot_b[:, i], i) for i in (0, 1)]
        zeros = x.new_zeros(x.shape[0], 4 * self.dof)
        return torch.cat([x[:, 3:6], quat, _mv(rt, x[:, 9:12]), _mv(rt, x[:, 6:9]), *q, zeros],
                         1), rot

    def plant_step(self, x, u, foot_w, rot):
        """One dt of the SRBD under world [F_L, F_R, M_L, M_R] u (B, 4, 3):
        RK4 of the affine model, whose accelerations are constant over a tick.
        The body's inertia, mass and gravity are taken at float32, as the
        plant states them."""
        dt = self.cfg["dt"]
        r = self.robot
        i_inv = self.t(np.linalg.inv(r.i_body.astype(np.float32)).astype(np.float32))
        mass, g = float(np.float32(r.mass)), float(np.float32(-GRAVITY))
        pos, w, v = x[:, 3:6], x[:, 6:9], x[:, 9:12]
        rf = foot_w - pos[:, None]
        tau = (torch.linalg.cross(rf[:, 0], u[:, 0], dim=-1)
               + torch.linalg.cross(rf[:, 1], u[:, 1], dim=-1) + u[:, 2] + u[:, 3])
        c_w = _mv(rot, _mv(i_inv, _mv(rot.transpose(-1, -2), tau)))
        c_v = (u[:, 0] + u[:, 1]) / mass + self.t((0.0, 0.0, g))
        rpy_dot = _mv(rot.transpose(-1, -2), w + dt / 2 * c_w)
        return torch.cat([x[:, :3] + dt * rpy_dot, pos + dt * (v + dt / 2 * c_v),
                          w + dt * c_w, v + dt * c_v], 1)

    def init_plant(self, batch, height):
        """(x, foot_w) at the standing start, feet under the hips, the hips'
        xy and the height taken at float32."""
        x = torch.zeros(batch, 12, dtype=self.dtype, device=self.device)
        x[:, 5] = float(np.float32(height))
        feet = torch.zeros(batch, 2, 3, dtype=self.dtype, device=self.device)
        feet[:, :, :2] = self.t(np.float32(self.robot.hip)[:, :2])
        return x, feet

    def cycle_step(self, st, x, foot_w, solve=None):
        """One MPC cycle of the closed loop: tick 0 observes, ingests and
        solves; each of the `decimation` ticks runs the low level, moves the
        feet (stance feet stay, swing feet go to their targets, none below
        ground) and steps the plant under the solve's gated world GRFs.
        Returns (x, foot_w, mu of the solve)."""
        grf = mu = None
        for _ in range(self.cfg["decimation"]):
            obs, rot = self.observe(x, foot_w)
            self.ingest(st, obs)
            if grf is None:
                _, grf, mu = self.run_mpc(st, solve)
            self.run_lowlevel(st)
            contact = (st["contact_phase"] != -1).to(x.dtype)
            p_des_w = _mv(rot[:, None], st["leg_cmd.p_des"]) + x[:, None, 3:6]
            foot_w = torch.where(contact[:, :, None] > 0.5, foot_w, p_des_w)
            foot_w = torch.cat([foot_w[..., :2], foot_w[..., 2:].clamp_min(0.0)], 2)
            gate = torch.cat([contact, contact], 1)[:, :, None]
            x = self.plant_step(x, grf * gate, foot_w, rot)
        return x, foot_w, mu

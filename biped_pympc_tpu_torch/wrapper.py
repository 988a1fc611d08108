"""RL-facing `MPCController` (twin of `biped_pympc_tpu/wrapper.py`).

A stateful shell around `BipedControllerCore`: it owns a `ControllerState`
on one device and forwards each call. It runs on the card (the current CUDA
device) unless the caller asks for the CPU with `device="cpu"`; with no
device given and no card it raises.

    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=4096, gait_id=2)
    # on the CPU, with the plain torch solver:
    # MPCController(ControllerConf(), MPCConf(), num_envs=8, gait_id=2, device="cpu")
    ctrl.set_command(twist, height)
    ctrl.update_state(obs)          # every sim step (1 kHz)
    if step % mpc_cfg.decimation == 0:
        ctrl.run_mpc()              # batched QP solve
    ctrl.run_lowlevel()
    tau = ctrl.get_action()

Inputs may be tensors on any device or numpy arrays; they are moved to the
controller's device and dtype.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from biped_pympc_tpu_torch.config import ControllerConf, MPCConf
from biped_pympc_tpu_torch.control import gait, swing
from biped_pympc_tpu_torch.control.controller import BipedControllerCore, ControllerState
from biped_pympc_tpu_torch.ops.linalg import inverse_3x3
from biped_pympc_tpu_torch.utils.consts import const


class MPCController:
    """Batched biped MPC controller (`mpc_wrapper.py:4-12`)."""

    def __init__(self, cfg: ControllerConf, mpc_cfg: MPCConf, num_envs: int,
                 gait_id: int = 1, dtype=torch.float32, device=None):
        self.num_envs = num_envs
        self.core = BipedControllerCore(cfg, mpc_cfg, gait_id=gait_id, dtype=dtype,
                                        device=device)
        self.state: ControllerState = self.core.init_state(num_envs)
        self._last_mpc = None

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.core.dtype, device=self.core.device)

    def _timed(self, label, fn):
        if not self.core.mpc_cfg.print_solve_time:
            return fn()
        sync = (torch.cuda.synchronize if self.core.device.type == "cuda" else lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        print(f"{label} took:  {1e3 * (time.perf_counter() - t0):.3f} ms")
        return out

    # operations (`mpc_wrapper.py:17-43`)

    def set_command(self, twist, height) -> None:
        self.core.set_command(self.state, self._t(twist), self._t(height))

    def update_state(self, state_vec) -> None:
        self.core.ingest_state(self.state, self._t(state_vec))

    def run_mpc(self) -> None:
        self._last_mpc = self._timed("MPC solve time", lambda: self.core.run_mpc(self.state))

    def run_lowlevel(self) -> None:
        self._timed("low level control", lambda: self.core.run_lowlevel(self.state))

    def get_action(self) -> torch.Tensor:
        return self.core.joint_torque(self.state)

    def reset(self, env_ids) -> None:
        """env_ids: integer indices or a (B,) bool mask."""
        ids = torch.as_tensor(env_ids, device=self.core.device)
        if ids.dtype == torch.bool:
            mask = ids
        else:
            mask = torch.zeros(self.num_envs, dtype=torch.bool, device=self.core.device)
            mask[ids.long()] = True
        self.core.reset(self.state, mask)

    # DRL interface (`mpc_wrapper.py:48-64`)

    def _per_env(self, val, like: torch.Tensor) -> torch.Tensor:
        return self._t(val).expand_as(like).clone()

    def update_mpc_sampling_time(self, dt_mpc) -> None:
        self.state.dt_mpc = self._per_env(dt_mpc, self.state.dt_mpc)

    def set_swing_parameters(self, foot_height, cp1, cp2) -> None:
        self.state.foot_height = self._per_env(foot_height, self.state.foot_height)
        self.state.cp1 = self._per_env(cp1, self.state.cp1)
        self.state.cp2 = self._per_env(cp2, self.state.cp2)

    def set_srbd_accel(self, residual_lin_accel, residual_ang_accel) -> None:
        self.state.residual_lin_accel = self._per_env(residual_lin_accel,
                                                      self.state.residual_lin_accel)
        self.state.residual_ang_accel = self._per_env(residual_ang_accel,
                                                      self.state.residual_ang_accel)

    def set_srbd_residual(self, A_residual, B_residual) -> None:
        """Per-env learned dynamics residuals (B, 12, 12) added to the SRBD
        linearization's continuous-time A / B blocks before discretization
        (`biped_pympc_tpu/wrapper.py:112-145`). None for both clears them;
        exactly one None is zero-filled in the controller dtype. A shape
        other than (num_envs, 12, 12) raises ValueError."""
        if (A_residual is None) != (B_residual is None):
            zeros = torch.zeros(self.num_envs, 12, 12, dtype=self.core.dtype,
                                device=self.core.device)
            A_residual = zeros if A_residual is None else A_residual
            B_residual = zeros if B_residual is None else B_residual
        if A_residual is not None:
            A_residual, B_residual = self._t(A_residual), self._t(B_residual)
            want = (self.num_envs, 12, 12)
            if tuple(A_residual.shape) != want or tuple(B_residual.shape) != want:
                raise ValueError(f"set_srbd_residual expects shapes {want}, got "
                                 f"{tuple(A_residual.shape)} and {tuple(B_residual.shape)}")
        self.state.residual_A = A_residual
        self.state.residual_B = B_residual

    def set_contact_parameters(self, mu=None, f_max=None, lt=None, lh=None) -> None:
        """Per-env friction coefficient, vertical-force cap [N] and toe / heel
        lever arms [m]: (B,) values or scalars; None leaves one unchanged."""
        for name, val in (("mu", mu), ("f_max", f_max), ("lt", lt), ("lh", lh)):
            if val is not None:
                setattr(self.state, name, self._per_env(val, getattr(self.state, name)))

    # checkpoint / resume (`biped_pympc_tpu/wrapper.py:329-370`)

    def save_state(self, path: str) -> None:
        """Write every `ControllerState` tensor to an .npz file, keyed by its
        field path ("est.root_position"), with the list of paths, as JSON,
        under "__structure__"."""
        leaves = dict(_state_leaves(self.state))
        np.savez(path, __structure__=np.frombuffer(json.dumps(list(leaves)).encode(), np.uint8),
                 **{k: v.detach().cpu().numpy() for k, v in leaves.items()})

    def load_state(self, path: str) -> None:
        """Restore a state written by `save_state` (same config and batch).
        The saved structure must match the current state's: the optional
        residual_A / residual_B (`set_srbd_residual`) change it, so call
        `set_srbd_residual` first to match. A structure or shape mismatch
        raises ValueError and leaves the state as it was."""
        leaves = dict(_state_leaves(self.state))
        with np.load(path) as data:
            saved = json.loads(bytes(data["__structure__"]).decode())
            if saved != list(leaves):
                raise ValueError(
                    "checkpoint structure does not match the current controller state (most "
                    "commonly: residual_A/B from set_srbd_residual present on one side only; "
                    "call set_srbd_residual to match before load_state). Saved only: "
                    f"{sorted(set(saved) - set(leaves))}; current only: "
                    f"{sorted(set(leaves) - set(saved))}")
            new = {}
            for key, old in leaves.items():
                arr = data[key]
                if tuple(arr.shape) != tuple(old.shape):
                    raise ValueError(f"checkpoint leaf {key} shape {tuple(arr.shape)} != "
                                     f"{tuple(old.shape)} (batch size / config mismatch)")
                new[key] = torch.as_tensor(arr, dtype=old.dtype, device=old.device)
        for key, value in new.items():
            *parents, name = key.split(".")
            obj = self.state
            for p in parents:
                obj = getattr(obj, p)
            setattr(obj, name, value)

    def to_numpy(self, x) -> np.ndarray:
        if torch.is_tensor(x):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    # properties (`mpc_wrapper.py:72-205`)

    @property
    def ground_reaction_wrench(self) -> torch.Tensor:
        """(B, 2, 6) body-frame feed-forward foot wrench."""
        return self.state.leg_cmd.wrench_ff

    @property
    def grf_world(self) -> torch.Tensor:
        """(B, 12) world-frame u0 = [F_L, F_R, M_L, M_R] of the last
        `run_mpc`; zeros before the first."""
        if self._last_mpc is None:
            return torch.zeros(self.num_envs, 12, dtype=self.core.dtype, device=self.core.device)
        return self._last_mpc.grf_world

    @property
    def hybrid_stats(self) -> dict:
        """{'flagged', 'nonfinite', 'resolved', 'dropped_nonfinite'} ints of the
        last `run_mpc` (solver="pallas_hybrid" only; {} for other solvers and
        before the first solve). `dropped_nonfinite > 0` means the hybrid's
        finiteness guarantee lapsed on that solve. Reading it waits for the
        device."""
        if self._last_mpc is None or self._last_mpc.hybrid_counts is None:
            return {}
        c = self._last_mpc.hybrid_counts.tolist()
        return {"flagged": c[0], "nonfinite": c[1], "resolved": c[2], "dropped_nonfinite": c[3]}

    @property
    def solver_residuals(self) -> torch.Tensor:
        """(B, 4) [||rx||, ||rs||, ||re||, mu] of the last `run_mpc`; +inf
        before the first."""
        if self._last_mpc is None:
            return torch.full((self.num_envs, 4), float("inf"), dtype=self.core.dtype,
                              device=self.core.device)
        return self._last_mpc.residuals

    @property
    def centroidal_accel(self) -> torch.Tensor:
        """(B, 6) [linear; angular] acceleration from the commanded wrench."""
        w = self.state.leg_cmd.wrench_ff
        robot = self.core.robot
        lin = w[:, :, :3].sum(dim=1) / robot.mass
        rot = self.state.est.rotation_body
        i_body = const(robot.i_body, w.dtype, w.device)
        i_world = rot @ i_body @ rot.transpose(-1, -2)
        ang = (inverse_3x3(i_world) @ w[:, :, 3:].sum(dim=1)[..., None])[..., 0]
        return torch.cat([lin, ang], dim=1)

    @property
    def contact_state(self) -> torch.Tensor:
        """(B, 2) 1 in stance."""
        return (self.state.contact_phase != -1).to(self.core.dtype)

    @property
    def contact_phase(self) -> torch.Tensor:
        """(B, 2) stance sub-phase, 0 while swinging."""
        cp = self.state.contact_phase
        return torch.where(cp == -1, torch.zeros_like(cp), cp)

    @property
    def swing_state(self) -> torch.Tensor:
        return (self.state.swing_phase != -1).to(self.core.dtype)

    @property
    def swing_phase(self) -> torch.Tensor:
        sp = self.state.swing_phase
        return torch.where(sp == -1, torch.zeros_like(sp), sp)

    @property
    def foot_placement(self) -> torch.Tensor:
        """(B, 2, 3) planned world-frame footholds."""
        return self.state.swing_state.foot_placement_w

    @property
    def foot_placement_b(self) -> torch.Tensor:
        return self.state.swing_state.foot_placement_b

    @property
    def ref_foot_pos_b(self) -> torch.Tensor:
        return self.state.leg_cmd.p_des

    @property
    def ref_foot_vel_b(self) -> torch.Tensor:
        return self.state.leg_cmd.v_des

    @property
    def foot_pos_b(self) -> torch.Tensor:
        return self.state.leg_data.p

    @property
    def foot_vel_b(self) -> torch.Tensor:
        return self.state.leg_data.v

    @property
    def mpc_cost(self) -> torch.Tensor:
        return self.state.mpc_cost

    @property
    def position_trajectory(self) -> torch.Tensor:
        """(B, T, 3) x_ref[:, :, :3] (the reference's literal slice, which is
        the euler block)."""
        return self.state.x_ref[:, :, :3]

    @property
    def velocity_trajectory(self) -> torch.Tensor:
        """(B, T, 3) linear-velocity rows of x_ref."""
        return self.state.x_ref[:, :, 9:12]

    @property
    def swing_foot_trajectory(self) -> torch.Tensor:
        """(B, 10, 3) body-frame curve of the swinging foot at 10 phases."""
        st = self.state
        n = 10
        nb = self.num_envs
        phases = torch.linspace(0.0, 1.0, n, dtype=self.core.dtype, device=self.core.device)
        dur = gait.swing_duration_sec(st.gait_params, st.dt_mpc)
        rep = lambda v: v.repeat_interleave(n, dim=0)
        sw = st.swing_state
        contact = st.leg_data.contact_bool
        out = 0.0
        for i in (0, 1):
            p, _ = swing.cubic_bezier(phases.repeat(nb), rep(dur[:, i]), rep(sw.p0[:, i]),
                                      rep(sw.foot_placement_b[:, i]), rep(st.foot_height),
                                      rep(st.cp1), rep(st.cp2))
            out = out + p.reshape(nb, n, 3) * (1.0 - contact[:, i])[:, None, None]
        return out


def _state_leaves(obj, prefix=""):
    """(field path, tensor) of every tensor in a state dataclass tree; None
    fields are absent."""
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if value is None:
            continue
        if dataclasses.is_dataclass(value):
            yield from _state_leaves(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", value


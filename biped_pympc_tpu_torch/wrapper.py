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
controller's device and dtype and copied into the controller's own input
buffers (broadcast to their shapes), so changing them after a call changes
nothing.

Each call the JAX wrapper forwards to a jitted function (`set_command`,
`update_state`, `run_mpc`, `run_lowlevel`, `get_action`, `reset`) is, on the
card, one CUDA graph: captured at the call's first use, after a warm-up on a
side stream, and replayed at every later call (`utils/cuda_graph.LoopStep`;
the counterpart of JAX's compile at the first call). A graph reads and
writes fixed addresses, so:

- the state's tensors keep their addresses: a call copies the leaves the
  core's method replaced back into them, and the DRL setters and
  `load_state` write into them;
- every tensor the wrapper hands out (`get_action()`, the properties) is the
  caller's own copy, which no later call changes;
- `set_srbd_residual` between None and a tensor changes the state's
  structure: every graph is dropped and captured again at its next call,
  as JAX recompiles once; assigning `ctrl.state` does the same.

On the CPU the same plumbing runs eagerly (input buffers, a working copy of
the state, the replaced leaves copied back), without the replay. A failed
capture raises; nothing falls back to the eager call. The one mode whose
`run_mpc` is not captured, `solver="dense"` with `adaptive_tol > 0`, is
named by a static rule, `eager_run_mpc` (`control/controller.py`), with its
reason. The eager calls are the core's methods: `ctrl.core.run_mpc(state)`
and so on.

While a profiler records (`utils/profiling.trace()`), each public call is a
span `wrapper.<call>` (`utils/tracing.span`), with the children
`wrapper.copy_in` (its inputs copied into the buffers), the graph's own
span (`graph.capture`, `graph.replay` or `graph.eager`) and
`wrapper.copy_out` (`get_action`'s copy). `MPCConf.print_solve_time` times
`run_mpc`'s and `run_lowlevel`'s spans and prints them.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from biped_pympc_tpu_torch.config import ControllerConf, MPCConf
from biped_pympc_tpu_torch.control import gait, swing
from biped_pympc_tpu_torch.control.controller import (BipedControllerCore, ControllerState,
                                                      eager_run_mpc)
from biped_pympc_tpu_torch.ops.linalg import inverse_3x3
from biped_pympc_tpu_torch.utils.consts import const
from biped_pympc_tpu_torch.utils.cuda_graph import LoopStep, tree_map
from biped_pympc_tpu_torch.utils.tracing import span, timed


class MPCController:
    """Batched biped MPC controller (`mpc_wrapper.py:4-12`)."""

    def __init__(self, cfg: ControllerConf, mpc_cfg: MPCConf, num_envs: int,
                 gait_id: int = 1, dtype=torch.float32, device=None):
        self.num_envs = num_envs
        self.core = BipedControllerCore(cfg, mpc_cfg, gait_id=gait_id, dtype=dtype,
                                        device=device)
        self.state = self.core.init_state(num_envs)
        # The calls' inputs: a call copies its arguments in, its graph reads them.
        buf = lambda *s: torch.zeros(num_envs, *s, dtype=dtype, device=self.core.device)
        self._twist, self._height = buf(3), buf()
        self._obs = buf(13 + 6 * self.core.num_dof)
        self._mask = torch.zeros(num_envs, dtype=torch.bool, device=self.core.device)
        self._last_mpc = None

    @property
    def state(self) -> ControllerState:
        """The controller's state; its tensors are written in place by every
        call (read them, or clone them to keep them)."""
        return self._state

    @state.setter
    def state(self, state: ControllerState) -> None:
        """Take `state` (a checkpoint converted from elsewhere) as the
        controller's: every leaf copied into memory of its own on the
        controller's device, and every graph captured again at its next
        call."""
        self._state = tree_map(lambda t: t.to(self.core.device, copy=True), state)
        self._calls: dict[str, LoopStep] = {}

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.core.dtype, device=self.core.device)

    def _call(self, name: str, step, graph: bool | None = None):
        """`step(state)` as the call `name`: on the card captured at its first
        call and replayed at every later one (`graph` False: eager), on the
        CPU eager; the state's replaced leaves copied back. Returns what the
        step returned (captured: the graph's output, valid until its next
        replay)."""
        loop = self._calls.get(name)
        if loop is None:
            loop = self._calls[name] = LoopStep(step, self._state, graph)
        loop()
        return loop.out

    def _span(self, name: str, label: str):
        """`span(name)`; with `print_solve_time` also timed, and printed
        under `label`."""
        if self.core.mpc_cfg.print_solve_time:
            return timed(name, label, self.core.device)
        return span(name)

    @property
    def graphs(self) -> dict:
        """{call: LoopStep} of the calls made since the last structure change;
        a LoopStep's `graph` is None where the call ran eagerly."""
        return dict(self._calls)

    # operations (`mpc_wrapper.py:17-43`)

    # The steps a call captures reference the core and the input buffers, not
    # the controller: a controller that is dropped is freed at once (its
    # graphs with it), not by a later garbage collection.

    def set_command(self, twist, height) -> None:
        core, twist_in, height_in = self.core, self._twist, self._height
        with span("wrapper.set_command"):
            with span("wrapper.copy_in"):
                twist_in.copy_(self._t(twist))
                height_in.copy_(self._t(height))
            self._call("set_command", lambda st: core.set_command(st, twist_in, height_in))

    def update_state(self, state_vec) -> None:
        core, obs = self.core, self._obs
        with span("wrapper.update_state"):
            with span("wrapper.copy_in"):
                obs.copy_(self._t(state_vec))
            self._call("update_state", lambda st: core.ingest_state(st, obs))

    def run_mpc(self) -> None:
        """The batched solve. `_last_mpc` is its output: on the card the
        graph's own, valid until the next `run_mpc`, as in JAX."""
        graph = False if eager_run_mpc(self.core) else None
        with self._span("wrapper.run_mpc", "MPC solve time"):
            self._last_mpc = self._call("run_mpc", self.core.run_mpc, graph)

    def run_lowlevel(self) -> None:
        with self._span("wrapper.run_lowlevel", "low level control"):
            self._call("run_lowlevel", self.core.run_lowlevel)

    def get_action(self) -> torch.Tensor:
        with span("wrapper.get_action"):
            tau = self._call("get_action", self.core.joint_torque)
            with span("wrapper.copy_out"):
                return tau.clone()

    def reset(self, env_ids) -> None:
        """env_ids: integer indices or a (B,) bool mask. Integer ids are
        written into the mask buffer here, outside the graph, because their
        number varies."""
        with span("wrapper.reset"):
            with span("wrapper.copy_in"):
                ids = torch.as_tensor(env_ids, device=self.core.device)
                if ids.dtype == torch.bool:
                    self._mask.copy_(ids)
                else:
                    self._mask.fill_(False)
                    self._mask.index_fill_(0, ids.long().reshape(-1), True)
            core, mask = self.core, self._mask
            self._call("reset", lambda st: core.reset(st, mask))

    # DRL interface (`mpc_wrapper.py:48-64`): each writes into the state's
    # own tensors, which the captured graphs read.

    def _set_per_env(self, leaf: torch.Tensor, val) -> None:
        leaf.copy_(self._t(val).expand_as(leaf))

    def update_mpc_sampling_time(self, dt_mpc) -> None:
        self._set_per_env(self._state.dt_mpc, dt_mpc)

    def set_swing_parameters(self, foot_height, cp1, cp2) -> None:
        st = self._state
        for leaf, val in ((st.foot_height, foot_height), (st.cp1, cp1), (st.cp2, cp2)):
            self._set_per_env(leaf, val)

    def set_srbd_accel(self, residual_lin_accel, residual_ang_accel) -> None:
        self._set_per_env(self._state.residual_lin_accel, residual_lin_accel)
        self._set_per_env(self._state.residual_ang_accel, residual_ang_accel)

    def set_srbd_residual(self, A_residual, B_residual) -> None:
        """Per-env learned dynamics residuals (B, 12, 12) added to the SRBD
        linearization's continuous-time A / B blocks before discretization
        (`biped_pympc_tpu/wrapper.py:112-145`). None for both clears them;
        exactly one None is zero-filled in the controller dtype. A shape
        other than (num_envs, 12, 12) raises ValueError. Between None and a
        tensor the state's structure changes, and every graph is captured
        again at its next call (JAX recompiles once); a tensor over a tensor
        is copied in."""
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
        st = self._state
        if (A_residual is None) != (st.residual_A is None):
            st.residual_A = None if A_residual is None else A_residual.clone()
            st.residual_B = None if B_residual is None else B_residual.clone()
            self._calls = {}
        elif A_residual is not None:
            st.residual_A.copy_(A_residual)
            st.residual_B.copy_(B_residual)

    def set_contact_parameters(self, mu=None, f_max=None, lt=None, lh=None) -> None:
        """Per-env friction coefficient, vertical-force cap [N] and toe / heel
        lever arms [m]: (B,) values or scalars; None leaves one unchanged."""
        for name, val in (("mu", mu), ("f_max", f_max), ("lt", lt), ("lh", lh)):
            if val is not None:
                self._set_per_env(getattr(self._state, name), val)

    # checkpoint / resume (`biped_pympc_tpu/wrapper.py:329-370`)

    def save_state(self, path: str) -> None:
        """Write every `ControllerState` tensor to an .npz file, keyed by its
        field path ("est.root_position"), with the list of paths, as JSON,
        under "__structure__"."""
        leaves = dict(_state_leaves(self._state))
        np.savez(path, __structure__=np.frombuffer(json.dumps(list(leaves)).encode(), np.uint8),
                 **{k: v.detach().cpu().numpy() for k, v in leaves.items()})

    def load_state(self, path: str) -> None:
        """Restore a state written by `save_state` (same config and batch)
        into the state's own tensors. The saved structure must match the
        current state's: the optional residual_A / residual_B
        (`set_srbd_residual`) change it, so call `set_srbd_residual` first to
        match. A structure or shape mismatch raises ValueError and leaves the
        state as it was."""
        leaves = dict(_state_leaves(self._state))
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
                new[key] = torch.as_tensor(arr, dtype=old.dtype)
        for key, value in new.items():
            leaves[key].copy_(value)

    def to_numpy(self, x) -> np.ndarray:
        if torch.is_tensor(x):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    # properties (`mpc_wrapper.py:72-205`): each a tensor of the caller's own

    @property
    def ground_reaction_wrench(self) -> torch.Tensor:
        """(B, 2, 6) body-frame feed-forward foot wrench."""
        return self.state.leg_cmd.wrench_ff.clone()

    @property
    def grf_world(self) -> torch.Tensor:
        """(B, 12) world-frame u0 = [F_L, F_R, M_L, M_R] of the last
        `run_mpc`; zeros before the first."""
        if self._last_mpc is None:
            return torch.zeros(self.num_envs, 12, dtype=self.core.dtype, device=self.core.device)
        return self._last_mpc.grf_world.clone()

    @property
    def hybrid_counts(self) -> torch.Tensor | None:
        """(4,) int32 [flagged, nonfinite, resolved, dropped_nonfinite] of the
        last `run_mpc` on the controller's device, copied there without
        waiting for the device (solver="pallas_hybrid" only; None for other
        solvers and before the first solve)."""
        if self._last_mpc is None or self._last_mpc.hybrid_counts is None:
            return None
        return self._last_mpc.hybrid_counts.clone()

    @property
    def hybrid_merged(self) -> torch.Tensor | None:
        """(B,) bool: the envs whose answer in the last `run_mpc` is the
        re-solve's, on the controller's device, copied there without waiting
        for the device (solver="pallas_hybrid" only; None otherwise)."""
        if self._last_mpc is None or self._last_mpc.hybrid_merged is None:
            return None
        return self._last_mpc.hybrid_merged.clone()

    @property
    def hybrid_stats(self) -> dict:
        """{'flagged', 'nonfinite', 'resolved', 'dropped_nonfinite'} ints of the
        last `run_mpc` (`hybrid_counts`; {} for other solvers and before the
        first solve). `dropped_nonfinite > 0` means the hybrid's finiteness
        guarantee lapsed on that solve. Reading it waits for the device."""
        counts = self.hybrid_counts
        if counts is None:
            return {}
        c = counts.tolist()
        return {"flagged": c[0], "nonfinite": c[1], "resolved": c[2], "dropped_nonfinite": c[3]}

    @property
    def solver_residuals(self) -> torch.Tensor:
        """(B, 4) [||rx||, ||rs||, ||re||, mu] of the last `run_mpc`; +inf
        before the first."""
        if self._last_mpc is None:
            return torch.full((self.num_envs, 4), float("inf"), dtype=self.core.dtype,
                              device=self.core.device)
        return self._last_mpc.residuals.clone()

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
        return self.state.swing_state.foot_placement_w.clone()

    @property
    def foot_placement_b(self) -> torch.Tensor:
        return self.state.swing_state.foot_placement_b.clone()

    @property
    def ref_foot_pos_b(self) -> torch.Tensor:
        return self.state.leg_cmd.p_des.clone()

    @property
    def ref_foot_vel_b(self) -> torch.Tensor:
        return self.state.leg_cmd.v_des.clone()

    @property
    def foot_pos_b(self) -> torch.Tensor:
        return self.state.leg_data.p.clone()

    @property
    def foot_vel_b(self) -> torch.Tensor:
        return self.state.leg_data.v.clone()

    @property
    def mpc_cost(self) -> torch.Tensor:
        return self.state.mpc_cost.clone()

    @property
    def position_trajectory(self) -> torch.Tensor:
        """(B, T, 3) x_ref[:, :, :3] (the reference's literal slice, which is
        the euler block)."""
        return self.state.x_ref[:, :, :3].clone()

    @property
    def velocity_trajectory(self) -> torch.Tensor:
        """(B, T, 3) linear-velocity rows of x_ref."""
        return self.state.x_ref[:, :, 9:12].clone()

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


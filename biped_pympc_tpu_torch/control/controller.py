"""The control stack over the env batch (twin of
`biped_pympc_tpu/control/controller.py`).

`ControllerState` holds every per-env buffer with a leading (B,) axis. The
entry points of `BipedControllerCore` update it in place (they replace its
fields, so no second copy of the state is built per tick):

    ingest_state : (state, obs)                   (`update_state`, 1 kHz)
    run_mpc      : state -> MpcOutput             (every `decimation` ticks)
    run_lowlevel : state                          (1 kHz)
    joint_torque : state -> (B, 2 * dof)
    control_step : (state, obs, twist, height) -> (tau, MpcOutput), the
                   whole tick with the solve; on the card one CUDA graph
"""

from __future__ import annotations

import copy
import weakref
from dataclasses import dataclass

import torch

from biped_pympc_tpu_torch.config import SOLVERS, ControllerConf, MPCConf
from biped_pympc_tpu_torch.control import estimator, gait, legs, mpc, swing
from biped_pympc_tpu_torch.models.robot import RobotSpec, get_robot
from biped_pympc_tpu_torch.ops import pdipm_cuda
from biped_pympc_tpu_torch.ops.pdipm import PdipmOptions
from biped_pympc_tpu_torch.utils import cuda_graph
from biped_pympc_tpu_torch.utils.tracing import mark
from biped_pympc_tpu_torch.utils.tree import leaves, tree_map

# Route of each solver name (`biped_pympc_tpu/control/controller.py:121`);
# "pallas_hybrid" runs the condensed route first and re-solves with "ric_aug".
_BACKEND = {"pallas_ric": "ric", "pallas_ric2": "ric2", "pallas_ric_aug": "ric_aug",
            "pallas_hybrid": "ric", "pallas": "tridiag", "pallas_aug": "tridiag_aug"}


def solver_options(c: MPCConf) -> PdipmOptions:
    """The PDIPM options of an MPCConf, mapped as the JAX controller maps them
    (`biped_pympc_tpu/control/controller.py:121-147`): the foot split only
    on "ric" / "ric_aug", the KKT scaling as it is, and the foot packing
    (K5e: PERF.md section 6, its K5e rows) only for a "pallas_*" name with
    the split on and a "ric" / "ric_aug" route, keeping its value (True or
    "apply"); every other field at its default."""
    if c.solver not in SOLVERS:
        raise ValueError(f"unknown MPCConf.solver {c.solver!r}; expected one of {SOLVERS}")
    backend = _BACKEND.get(c.solver, c.solver)
    split = c.solver_foot_split and backend in ("ric", "ric_aug")
    # solver_foot_pack last, so that its value survives the chain.
    pack = (c.solver_foot_split and c.solver.startswith("pallas")
            and backend in ("ric", "ric_aug") and c.solver_foot_pack)
    return PdipmOptions(iterations=c.newton_iterations, iterations_per_launch=c.adaptive_chunk,
                        beta=c.solver_beta, delta=c.solver_delta,
                        refine_steps=c.solver_refine_steps, backend=backend, foot_split=split,
                        kkt_scale=c.solver_kkt_scale, foot_pack=pack)


@dataclass
class ControllerState:
    """All per-env controller state; every tensor has a leading (B,) axis."""

    gait_phase: torch.Tensor  # (B,)
    gait_params: gait.GaitParams
    dt_mpc: torch.Tensor  # (B,) per-env MPC sampling time
    est: estimator.EstimatorData
    des: mpc.DesiredState
    leg_data: legs.LegData
    leg_cmd: legs.LegCommand
    swing_state: swing.SwingState
    mpc_mem: mpc.MpcMemory
    foot_height: torch.Tensor  # (B,)
    cp1: torch.Tensor  # (B,)
    cp2: torch.Tensor  # (B,)
    residual_lin_accel: torch.Tensor  # (B, 3)
    residual_ang_accel: torch.Tensor  # (B, 3)
    mu: torch.Tensor  # (B,) friction coefficient
    f_max: torch.Tensor  # (B,) per-foot vertical-force cap [N]
    lt: torch.Tensor  # (B,) toe line-contact lever arm [m]
    lh: torch.Tensor  # (B,) heel line-contact lever arm [m]
    x_ref: torch.Tensor  # (B, T, 12)
    mpc_cost: torch.Tensor  # (B,)
    contact_phase: torch.Tensor  # (B, 2)
    swing_phase: torch.Tensor  # (B, 2)
    # Learned dynamics residuals added to the continuous-time A / B blocks
    # (`MPCController.set_srbd_residual`); None keeps the residual-free QP.
    residual_A: torch.Tensor | None = None  # (B, 12, 12)
    residual_B: torch.Tensor | None = None  # (B, 12, 12)


def resolve_device(device) -> torch.device:
    """The controller's device: `device` as given, or the current CUDA device
    when it is None. Without a card, None raises: the CPU runs only when the
    caller asks for it (`device="cpu"`)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device=\"cpu\" to run the "
                           "controller on the CPU (the plain torch solver)")
    return torch.device("cuda", torch.cuda.current_device())


def eager_run_mpc(core: "BipedControllerCore") -> str | None:
    """Why `run_mpc` of this controller runs eagerly on the card, or None
    when it is captured, by a static rule on the configuration:
    `solver="dense"` with `adaptive_tol > 0`, whose plain adaptive loop
    (`pdipm.solve_adaptive_batch`) decides on the host after each chunk
    whether to go on. With `adaptive_tol == 0` `dense` is captured: its
    batched LU and solve run under cuSOLVER (`pdipm._factor_dense`), which
    a capture takes, not under torch's default for matrices wider than 16,
    MAGMA, which a capture refuses (`tests/test_torch_port_rules.py::
    test_dense_lu_cannot_be_captured_on_card`)."""
    if core.opts.backend != "dense" or core.mpc_cfg.adaptive_tol <= 0.0:
        return None
    return ("solver='dense' with adaptive_tol > 0: its plain adaptive loop decides on the host "
            "after each chunk whether to go on")


def _signature(state: ControllerState, *inputs) -> tuple:
    """Structure, shapes, dtypes and devices of a state and the inputs: what
    a captured graph was captured for."""
    return (tuple((p, t.shape, t.dtype, t.device) for p, t in leaves(state))
            + tuple((t.shape, t.dtype, t.device) for t in inputs))


def _set_leaf(state, path: str, value: torch.Tensor) -> None:
    *parents, name = path[1:].split(".")
    for field in parents:
        state = getattr(state, field)
    setattr(state, name, value)


class _CapturedStep:
    """`control_step` of one signature as a CUDA graph (`LoopStep`): the graph
    owns its carry, a copy of the state it was first called with, and its
    input buffers (obs, twist, height). A call copies the caller's state and
    inputs in, replays, and gives the caller's state a copy of every leaf
    the step replaces, as the eager step replaces them; the caller's own
    tensors are never written. Returns tau (a copy) and the graph's own
    MpcOutput (a new object over the graph's tensors, which the next replay
    overwrites)."""

    def __init__(self, core, state, obs, twist, height):
        self.signature = _signature(state, obs, twist, height)
        self.inputs = tuple(t.clone() for t in (obs, twist, height))
        carry = tree_map(torch.clone, state)
        inputs, replaced = self.inputs, []
        # The step holds the core weakly: the core holds its graphs, and a
        # cycle through them would wait for a garbage collection to free it.
        body = weakref.WeakMethod(core._control_step)

        def step(work):
            out = body()(work, *inputs)
            replaced[:] = [p for (p, w), (_, c) in zip(leaves(work), leaves(carry)) if w is not c]
            return out

        self.replaced = replaced
        self.loop = cuda_graph.LoopStep(step, carry, graph=True)

    def __call__(self, state, obs, twist, height):
        cuda_graph.copy_into(self.loop.carry, state)
        for buf, x in zip(self.inputs, (obs, twist, height)):
            buf.copy_(x)
        self.loop()
        carry = dict(leaves(self.loop.carry))
        for path in self.replaced:
            _set_leaf(state, path, carry[path].clone())
        tau, out = self.loop.out
        return tau.clone(), copy.copy(out)


class BipedControllerCore:
    """Static configuration and the batched step functions. `device` None
    selects the card (`resolve_device`)."""

    def __init__(self, cfg: ControllerConf, mpc_cfg: MPCConf, gait_id: int = 1,
                 dtype=torch.float32, device=None):
        self.opts = solver_options(mpc_cfg)
        if gait_id not in (1, 2):
            raise ValueError(f"Invalid gait_id: {gait_id} (1 or 2)")
        self.cfg = cfg
        self.mpc_cfg = mpc_cfg
        self.gait_id = gait_id
        self.dtype = dtype
        self.device = resolve_device(device)
        self.robot: RobotSpec = get_robot(mpc_cfg.robot)
        self.num_dof = self.robot.num_dof
        t = lambda v: torch.tensor(v, dtype=dtype, device=self.device)
        self._q_weights = t(mpc_cfg.Q)
        self._r_weights = t(mpc_cfg.R)
        self._hips = torch.stack([self.robot.hip_horizontal_location(leg, dtype, self.device)
                                  for leg in (0, 1)])
        # control_step is captured on the card (and eager on the CPU).
        self._capture = self.device.type == "cuda"
        self._graphs: dict[tuple, _CapturedStep] = {}

    def init_state(self, batch: int) -> ControllerState:
        dt, dev = self.dtype, self.device
        if self.gait_id == 1:
            gp = gait.standing_gait(batch, dev)
        else:
            gp = gait.walking_gait(self.cfg.dsp_durations, self.cfg.ssp_durations, batch, dev)
        full = lambda v, *s: torch.full((batch, *s), float(v), dtype=dt, device=dev)
        state = ControllerState(
            gait_phase=full(0.0), gait_params=gp, dt_mpc=full(self.mpc_cfg.dt_mpc),
            est=estimator.init_data(batch, dt, dev), des=mpc.init_desired_state(batch, dt, dev),
            leg_data=legs.init_data(batch, self.num_dof, dt, dev),
            leg_cmd=legs.init_command(batch, self.num_dof, dt, dev),
            swing_state=swing.init_state(batch, dt, dev), mpc_mem=mpc.init_memory(batch, dt, dev),
            foot_height=full(self.cfg.swing_height), cp1=full(1.0 / 3.0), cp2=full(2.0 / 3.0),
            residual_lin_accel=full(0.0, 3), residual_ang_accel=full(0.0, 3),
            mu=full(self.robot.mu), f_max=full(self.mpc_cfg.f_max),
            lt=full(self.robot.lt), lh=full(self.robot.lh),
            x_ref=full(0.0, self.mpc_cfg.horizon_length, 12), mpc_cost=full(0.0),
            contact_phase=full(0.0, 2), swing_phase=full(0.0, 2),
        )
        state.swing_state.swing_time_remaining = gait.swing_duration_sec(gp, state.dt_mpc)
        return state

    def reset(self, state: ControllerState, mask: torch.Tensor) -> None:
        """Episodic reset of the envs in mask (B,) bool: gait phase to 0,
        first-run / first-swing latches re-armed."""
        state.gait_phase = torch.where(mask, torch.zeros_like(state.gait_phase),
                                       state.gait_phase)
        mpc.reset_memory(state.mpc_mem, mask)
        swing.reset(state.swing_state, mask)

    def set_command(self, state: ControllerState, twist: torch.Tensor,
                    height: torch.Tensor) -> None:
        """twist: (B, 3) = [vx, vy, wz] body frame; height: (B,)."""
        des = state.des
        des.velocity_b = torch.cat([twist[:, :2], des.velocity_b[:, 2:]], dim=1)
        des.ang_velocity_b = torch.cat([des.ang_velocity_b[:, :2], twist[:, 2:3]], dim=1)
        des.height = height

    def ingest_state(self, state: ControllerState, obs: torch.Tensor) -> None:
        """obs: (B, 13 + 6 dof) = [pos, quat wxyz, v_b, w_b, q, qd, tau]."""
        mark("ingest", obs)
        dof2 = 2 * self.num_dof
        contact_phase = gait.contact_sub_phase(state.gait_phase, state.gait_params)
        swing_phase = gait.swing_sub_phase(state.gait_phase, state.gait_params)
        state.leg_data = legs.update_data(
            self.robot, obs[:, 13:13 + dof2], obs[:, 13 + dof2:13 + 2 * dof2],
            obs[:, 13 + 2 * dof2:13 + 3 * dof2], contact_phase, swing_phase)
        state.est = estimator.estimate(obs[:, 0:3], obs[:, 3:7], obs[:, 7:10], obs[:, 10:13],
                                       state.leg_data.p)
        state.contact_phase = contact_phase
        state.swing_phase = swing_phase

    def assemble_mpc(self, state: ControllerState):
        """QP assembly phase of `run_mpc`: (new_mem, x_ref, qp), batched."""
        c = self.mpc_cfg
        table = gait.mpc_contact_table(state.gait_phase, state.gait_params, c.horizon_length)
        return mpc.build_mpc_qp(
            self.robot, state.mpc_mem, state.est, state.des, table, state.dt_mpc,
            state.residual_lin_accel, state.residual_ang_accel, self._q_weights,
            self._r_weights, c.horizon_length, c.decimation * c.dt,
            euler_rate_mode=c.euler_rate_mode, f_max=state.f_max, mu=state.mu,
            contact_frame=c.contact_frame, lt=state.lt, lh=state.lh,
            residual_A=state.residual_A, residual_B=state.residual_B)

    def run_mpc(self, state: ControllerState) -> mpc.MpcOutput:
        """Assemble every env's QP, solve them in one batched PDIPM (the CUDA
        kernels on the card, the plain version on the CPU), postprocess; the
        wrench becomes the legs' feed-forward term. With `adaptive_tol > 0`
        the solve is the chunked adaptive one, except in the hybrid mode
        (`biped_pympc_tpu/control/controller.py:313-336`). Its phase mark,
        `assembly`, covers the assembly, the solve and the postprocess."""
        mark("assembly", state.gait_phase)
        c = self.mpc_cfg
        new_mem, x_ref, qp = self.assemble_mpc(state)
        counts = merged = None
        if c.solver == "pallas_hybrid":
            sol, stats = pdipm_cuda.solve_hybrid(qp, self.opts, budget=c.hybrid_budget,
                                                 flag_tol=c.hybrid_flag_tol, flag=c.hybrid_flag,
                                                 with_stats=True)
            counts = torch.stack([stats.flagged, stats.nonfinite, stats.resolved,
                                  stats.dropped_nonfinite])
            merged = stats.merged
        elif c.adaptive_tol > 0.0:
            sol = pdipm_cuda.solve_adaptive(qp, self.opts, tol=c.adaptive_tol)
        else:
            sol = pdipm_cuda.solve(qp, self.opts)
        out = mpc.postprocess_solution(qp, sol, state.est.rotation_body, x_ref,
                                       c.horizon_length, contact_frame=c.contact_frame)
        out.hybrid_counts, out.hybrid_merged = counts, merged
        state.leg_cmd.wrench_ff = out.wrench
        state.mpc_mem = new_mem
        state.x_ref = out.x_ref
        state.mpc_cost = out.cost
        return out

    def run_lowlevel(self, state: ControllerState) -> None:
        """Swing control, leg command and gait phase advance."""
        mark("lowlevel", state.gait_phase)
        contact_phase = gait.contact_sub_phase(state.gait_phase, state.gait_params)
        swing_phase = gait.swing_sub_phase(state.gait_phase, state.gait_params)
        swing_dur = gait.swing_duration_sec(state.gait_params, state.dt_mpc)
        sw = state.swing_state
        est = state.est
        swing.update_swing_time(sw, contact_phase, swing_dur, self.mpc_cfg.dt)
        swing.compute_foot_placement(sw, est.root_position, est.rotation_body,
                                     est.root_velocity_w, state.des.velocity_b, self._hips)
        if self.cfg.swing_reference_frame == "world":
            p_des, v_des = swing.compute_foot_desired_position_world(
                sw, swing_phase, contact_phase, swing_dur, est.foot_position_w,
                est.root_position, est.root_velocity_w, est.rotation_body,
                state.foot_height, state.cp1, state.cp2, curve=self.cfg.swing_curve)
        else:
            p_des, v_des = swing.compute_foot_desired_position(
                sw, swing_phase, contact_phase, swing_dur, state.leg_data.p,
                state.foot_height, state.cp1, state.cp2, curve=self.cfg.swing_curve)
        state.leg_cmd.p_des = p_des
        state.leg_cmd.v_des = v_des
        state.leg_cmd = legs.update_command(self.robot, state.leg_data, state.leg_cmd)
        state.gait_phase = gait.advance_phase(state.gait_phase, state.gait_params,
                                              self.mpc_cfg.dt, state.dt_mpc)
        state.contact_phase = contact_phase
        state.swing_phase = swing_phase

    def joint_torque(self, state: ControllerState) -> torch.Tensor:
        """(B, 2 * dof) final PD + feed-forward torque, clamped."""
        return legs.joint_torque(self.robot, state.leg_data, state.leg_cmd)

    def control_step(self, state: ControllerState, obs, twist, height):
        """One full tick including the MPC solve (set_command, ingest_state,
        run_mpc, run_lowlevel, joint_torque); returns (tau, MpcOutput) and
        replaces the state's leaves as those calls do.

        On the card it is the counterpart of the JAX core's jitted
        `control_step`: one CUDA graph for each batch size and dtype,
        captured at its first call (`utils/cuda_graph.LoopStep`, after a
        warm-up on a side stream) and replayed at every later one. The
        graph owns a copy of the state and of the inputs: a call copies the
        caller's state and inputs in, replays, and gives the caller's state
        a new tensor for every leaf the step replaces, so the state after
        the call holds the eager call's bits and no tensor the caller held
        changes. tau is the caller's own; the MpcOutput's tensors are the
        graph's, valid until the next call of the same batch and dtype (as
        the wrapper's `run_mpc` output). A state of another structure (the
        learned residuals on or off) or of other shapes drops the graph and
        captures a new one. A failed capture raises.

        On the CPU and inside a capture (`cuda_graph.capturing()`: the call
        is recorded into the graph being built) it runs eagerly, as it does
        on the card where `eager_run_mpc` names a reason."""
        if not self._capture or cuda_graph.capturing() or eager_run_mpc(self):
            return self._control_step(state, obs, twist, height)
        key = (obs.shape[0], obs.dtype)
        step = self._graphs.get(key)
        if step is None or step.signature != _signature(state, obs, twist, height):
            self._graphs.pop(key, None)
            step = self._graphs[key] = _CapturedStep(self, state, obs, twist, height)
        return step(state, obs, twist, height)

    @property
    def graphs(self) -> dict:
        """{(batch, dtype): captured control_step} of this core; `.loop` is
        its LoopStep (`pool_bytes`)."""
        return dict(self._graphs)

    def _control_step(self, state: ControllerState, obs, twist, height):
        """The tick run eagerly: what the graph captures, and its reference."""
        self.set_command(state, twist, height)
        self.ingest_state(state, obs)
        out = self.run_mpc(state)
        self.run_lowlevel(state)
        return self.joint_torque(state), out

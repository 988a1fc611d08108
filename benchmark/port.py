"""The benchmark's side of the program under test: its configuration objects
built from a configuration file, the observations the traffic draws, and
the program's state read as the reference's flat dict. Everything that
touches the program is imported inside the functions, so that the
benchmark's modules import without it."""

from __future__ import annotations

import torch

# State leaves a step of the controller carries from one call to the next
# and the reference takes from the program where it follows it step by step.
CARRIED = ("gait_phase", "swing_state.first_swing", "swing_state.swing_time_remaining",
           "swing_state.p0", "mpc_mem.first_run", "mpc_mem.world_position_desired",
           "mpc_mem.yaw_desired")


def confs(cfg: dict):
    """(ControllerConf, MPCConf, gait_id, dtype) of a configuration file."""
    from biped_pympc_tpu_torch.config import ControllerConf, MPCConf

    ccfg = ControllerConf(ssp_durations=cfg["ssp_durations"], dsp_durations=cfg["dsp_durations"],
                          swing_height=cfg["swing_height"],
                          swing_reference_frame=cfg["swing_reference_frame"],
                          swing_curve=cfg["swing_curve"])
    mcfg = MPCConf(dt=cfg["dt"], dt_mpc=cfg["dt_mpc"], horizon_length=cfg["horizon_length"],
                   decimation=cfg["decimation"], Q=tuple(cfg["Q"]), R=tuple(cfg["R"]),
                   solver=cfg["solver"], robot=cfg["robot"],
                   newton_iterations=cfg["newton_iterations"], solver_beta=cfg["solver_beta"],
                   solver_delta=cfg["solver_delta"], f_max=cfg["f_max"],
                   solver_refine_steps=cfg["solver_refine_steps"],
                   solver_foot_split=cfg["solver_foot_split"], contact_frame=cfg["contact_frame"],
                   euler_rate_mode=cfg["euler_rate_mode"], verbose=False)
    return ccfg, mcfg, cfg["gait_id"], getattr(torch, cfg["dtype"])


def uniform(gen, shape, lo, hi, device, dtype=torch.float32):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=dtype)


def draw_observations(cfg: dict, mix: dict, gen, count: int, batch: int, device):
    """(count, batch, 13 + 6 dof) observations of the randomized walking
    class: body height z0 +- dz, level, at rest, the joints of both legs
    the standing pose +- dq, joint velocities and torques 0."""
    dof2 = 2 * len(cfg["standing_q"])
    obs = torch.zeros(count, batch, 13 + 3 * dof2, device=device)
    z0, dz = mix["height"], mix["height_noise"]
    obs[..., 2] = uniform(gen, (count, batch), z0 - dz, z0 + dz, device)
    obs[..., 3] = 1.0
    q0 = torch.tensor(cfg["standing_q"] * 2, device=device)
    dq = mix["joint_noise"]
    obs[..., 13:13 + dof2] = q0 + uniform(gen, (count, batch, dof2), -dq, dq, device)
    return obs


def state_dict(state) -> dict:
    """The program's controller state as {leaf path: tensor}, the paths
    without their leading dot (the reference's keys)."""
    from biped_pympc_tpu_torch.utils.tree import leaves

    return {path[1:]: t for path, t in leaves(state)}


def carried(state, clone: bool = True) -> dict:
    """The carried leaves (`CARRIED`) of the program's state, cloned."""
    d = state_dict(state)
    return {k: d[k].clone() if clone else d[k] for k in CARRIED}


def to_reference(d: dict, dtype=torch.float64) -> dict:
    """A state dict in the reference's float type (flags stay bool)."""
    return {k: v if v.dtype == torch.bool else v.to(dtype) for k, v in d.items()}

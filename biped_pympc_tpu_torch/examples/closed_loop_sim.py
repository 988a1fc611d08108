"""Closed-loop batched walking from a host loop: the port's `MPCController` and
the SRBD plant, no simulation engine (twin of `examples/closed_loop_sim.py`).

The plant is the single rigid body the MPC linearizes, stepped with the
literal RK4 (`srbd_plant.SrbdPlant`); the feet are kinematic and the joints
follow the controller's IK. Every 1 kHz tick is a few calls from the host,
the way a simulator drives the controller; `tpu_rollout.py` runs the same
ticks as one captured CUDA graph per MPC cycle.

Run:  python -m biped_pympc_tpu_torch.examples.closed_loop_sim [num_envs] [seconds]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from biped_pympc_tpu_torch.config import ControllerConf, MPCConf
from biped_pympc_tpu_torch.examples.srbd_plant import SrbdPlant
from biped_pympc_tpu_torch.examples.tpu_rollout import obs_ik_fn
from biped_pympc_tpu_torch.wrapper import MPCController


def simulate(num_envs: int = 4, seconds: float = 2.0, vx: float = 0.3,
             solver: str = "tridiag_aug", robot_name: str = "HECTOR",
             height: float | None = None, seed: int = 0, verbose: bool = True,
             obs_ik: str = "robot", mpc_overrides: dict | None = None, every: int = 50,
             dtype=torch.float32, plant_dtype=torch.float32, device=None):
    """Run the closed loop; returns a dict of numpy trajectories, one
    snapshot after every tick whose index is a multiple of `every` (50, as
    in JAX): "pos" (n, B, 3), "rpy" (n, B, 3), "vx" (n, B) and the gated
    vertical forces "fz" (n, B, 2) (`closed_loop_sim.py:46`).

    `dtype` is the controller's, `plant_dtype` the plant's (float32, as the
    JAX example steps its plant), `device` None the card. `robot_name` is
    "HECTOR", "T1" or "T1-newton". obs_ik "robot" is the controller robot's
    own IK as the encoder stand-in; "newton" is T1's exact Gauss-Newton IK
    for the observation only (the controller keeps its own IK for the swing
    targets), a T1 knob: for HECTOR it raises ValueError. `seed` is taken
    for the JAX signature; nothing here is random.
    """
    ik = obs_ik_fn(obs_ik, robot_name)
    cfg = ControllerConf(ssp_durations=5, dsp_durations=0, swing_height=0.08)
    # HECTOR's 500 N force cap; T1 gets the same ~3.7x-mg authority.
    f_max = 500.0 if robot_name == "HECTOR" else 1450.0
    mpc_cfg = MPCConf(solver=solver, robot=robot_name, f_max=f_max, verbose=verbose,
                      **(mpc_overrides or {}))
    ctrl = MPCController(cfg, mpc_cfg, num_envs=num_envs, gait_id=2, dtype=dtype, device=device)
    if height is None:
        height = 0.55 if robot_name == "HECTOR" else 0.62
    plant = SrbdPlant(ctrl.core.robot, num_envs, height, mpc_cfg.dt, plant_dtype,
                      ctrl.core.device, ik=ik)
    steps = int(seconds / mpc_cfg.dt)
    twist = np.zeros((num_envs, 3), np.float32)
    twist[:, 0] = vx
    ctrl.set_command(twist, np.full(num_envs, height, np.float32))
    grf = torch.zeros(num_envs, 12, dtype=plant_dtype, device=ctrl.core.device)

    traj = {"pos": [], "rpy": [], "vx": [], "fz": []}
    for step in range(steps):
        ctrl.update_state(plant.observation())
        if step % mpc_cfg.decimation == 0:
            ctrl.run_mpc()
            grf = ctrl.grf_world
        ctrl.run_lowlevel()
        gated = plant.step(grf, ctrl.contact_state, ctrl.ref_foot_pos_b)
        if step % every == 0:
            x = plant.x
            traj["pos"].append(x[:, 3:6].clone())
            traj["rpy"].append(x[:, :3].clone())
            traj["vx"].append(x[:, 9].clone())
            traj["fz"].append(gated[:, [2, 5]])
            if verbose:
                x0, f0 = x[0].tolist(), gated[0].tolist()
                print(f"t={step * mpc_cfg.dt:5.2f}s  x={x0[3]:+.3f}  z={x0[5]:.3f}  "
                      f"rp=({x0[0]:+.3f},{x0[1]:+.3f})  vx={x0[9]:+.3f}  "
                      f"fz=({f0[2]:6.1f},{f0[5]:6.1f})")
    return {k: torch.stack(v).double().cpu().numpy() for k, v in traj.items()}


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    secs = float(sys.argv[2]) if len(sys.argv) > 2 else 2.0
    out = simulate(num_envs=n, seconds=secs)
    print(f"\nfinal body position (env 0): {out['pos'][-1][0].round(3)}")
    print("closed-loop simulation finished.")

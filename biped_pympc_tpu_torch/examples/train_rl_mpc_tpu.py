"""RL-MPC training with the environment on the card (twin of
`examples/train_rl_mpc_tpu.py`).

The population evaluation is `rl_env_tpu.make_rollout`: every perturbation
direction owns a group of envs carrying its own policy as data, and the
`steps x decimation` closed loop, MPC solves included, runs as replays of
one captured RL step. The host's work per ARS iteration is the (act x 14)
weight update. Same estimator and batch layout as `train_rl_mpc.train`.

Run:  python -m biped_pympc_tpu_torch.examples.train_rl_mpc_tpu [--iters 10] [--dirs 4]
          [--envs-per 4] [--steps 40] [--bench]
`--bench` prints a learning-curve and throughput record per iteration and a
summary; it writes no file. `--mesh` shards the population over the ranks of
a process group, one card each (`parallel/mesh.py`): start it with
`torchrun --nproc_per_node=<cards> -m biped_pympc_tpu_torch.examples.train_rl_mpc_tpu --mesh`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from biped_pympc_tpu_torch.examples.rl_env_tpu import (ACT_DIM, ACT_DIM_MATRIX, OBS_DIM,
                                                       make_device_env, make_rollout)
from biped_pympc_tpu_torch.examples.train_rl_mpc import ars_update, population
from biped_pympc_tpu_torch.parallel import mesh as pmesh


def _shard_rollout(mesh, rollout_fn):
    """rollout(carry, w_per_env) -> (carry, returns (B,)) of the whole
    population over the mesh (`train_rl_mpc_tpu.py:38`): each rank runs
    `rollout_fn` on its shard, its own carry and its rows of the global
    w_per_env (B, act, 14), and the returns are gathered in rank order, the
    only collective. `make_sharded_training` and `train(mesh=...)` share it."""
    def rollout(carry, w_per_env):
        w = torch.as_tensor(w_per_env)
        lo, hi = pmesh.shard_range(w.shape[0], mesh)
        carry, returns = rollout_fn(carry, w[lo:hi])
        return carry, pmesh.all_gather(returns, mesh)

    return rollout


def _apply_newton_iterations(core, n):
    """Set the solver's Newton steps before the first rollout (20, the
    reference default, leaves the options as they are)."""
    if n and n != 20:
        core.opts = dataclasses.replace(core.opts, iterations=n)


def make_sharded_training(mesh, num_envs: int, steps: int = 40, solver: str = "pallas_ric_aug",
                          newton_iterations: int | None = None, plant_mass_scale: float = 1.0,
                          matrix_residual: bool = False):
    """The population evaluation with the env axis split over the mesh's
    ranks (`train_rl_mpc_tpu.py:60`): (sharded_rollout, carry0, w0), the
    rollout(carry, w_per_env) -> (carry, returns (num_envs,)) of
    `_shard_rollout`, this rank's initial carry (num_envs / ranks envs on the
    mesh's device) and a zero global policy batch (num_envs, act, 14). The
    rollout has no collective but the gather of the returns; the weight
    update on the host is the only global synchronization."""
    act_dim = ACT_DIM_MATRIX if matrix_residual else ACT_DIM
    lo, hi = pmesh.shard_range(num_envs, mesh)
    env_step, reset_all, rl_obs, core = make_device_env(
        hi - lo, solver=solver, plant_mass_scale=plant_mass_scale,
        matrix_residual=matrix_residual, device=mesh.device)
    _apply_newton_iterations(core, newton_iterations)
    rollout = _shard_rollout(mesh, make_rollout(env_step, rl_obs, steps))
    w0 = torch.zeros(num_envs, act_dim, OBS_DIM, device=mesh.device)
    return rollout, reset_all(), w0


def train(iters: int = 10, n_dirs: int = 4, envs_per: int = 4, steps: int = 40,
          step_size: float = 0.02, noise: float = 0.05, solver: str = "pallas_ric_aug",
          seed: int = 0, plant_mass_scale: float = 1.0, matrix_residual: bool = False,
          plant_force_scale=None, newton_iterations: int = 20, verbose: bool = True,
          emit=None, mesh=None, device=None):
    """ARS with antithetic directions over device rollouts
    (`train_rl_mpc_tpu.py:110`); returns (W, history of mean returns,
    throughput stats). `device` None is the card. `mesh` (`parallel.mesh.Mesh`)
    splits the population over its ranks, each on its own device (the
    mesh's; `device` is then ignored): every rank evaluates its shard, the
    returns are gathered, and every rank makes the same update from the same
    seed (`_shard_rollout`)."""
    rng = np.random.default_rng(seed)
    num_envs = 2 * n_dirs * envs_per
    act_dim = ACT_DIM_MATRIX if matrix_residual else ACT_DIM
    lo, hi = (0, num_envs) if mesh is None else pmesh.shard_range(num_envs, mesh)
    env_step, reset_all, rl_obs, core = make_device_env(
        hi - lo, solver=solver, plant_mass_scale=plant_mass_scale,
        matrix_residual=matrix_residual, plant_force_scale=plant_force_scale,
        device=device if mesh is None else mesh.device)
    # 10 is the JAX package's measured closed-loop-viable HECTOR point.
    _apply_newton_iterations(core, newton_iterations)
    rollout = make_rollout(env_step, rl_obs, steps)
    if mesh is not None:
        rollout = _shard_rollout(mesh, rollout)
    sync = torch.cuda.synchronize if core.device.type == "cuda" else lambda: None

    w = np.zeros((act_dim, OBS_DIM))
    history = []
    env_steps_per_rollout = num_envs * steps * core.mpc_cfg.decimation
    t_rollouts = []
    for it in range(iters):
        deltas = rng.standard_normal((n_dirs, act_dim, OBS_DIM))
        w_per_env = population(w, deltas, noise, envs_per)
        carry = reset_all()
        sync()
        t0 = time.perf_counter()
        _, returns = rollout(carry, w_per_env)
        returns = returns.double().cpu().numpy()
        dt_s = time.perf_counter() - t0
        if it > 0:  # iteration 0 pays the build and the capture
            t_rollouts.append(dt_s)
        w, _ = ars_update(w, deltas, returns, envs_per, step_size)
        history.append(float(returns.mean()))
        if verbose:
            print(f"iter {it:3d}  mean return {history[-1]:8.3f}  rollout {1e3 * dt_s:7.1f} ms  "
                  f"({env_steps_per_rollout / dt_s / 1e3:.0f}k env-steps/s)", flush=True)
        if emit is not None:
            emit({"iter": it, "mean_return": history[-1], "rollout_s": dt_s})

    stats = {}
    if t_rollouts:
        t_med = float(np.median(t_rollouts))
        stats = {"env_steps_per_s": env_steps_per_rollout / t_med,
                 "rollout_ms_p50": 1e3 * t_med, "num_envs": num_envs, "steps": steps}
    return w, history, stats


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dirs", type=int, default=4)
    p.add_argument("--envs-per", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--solver", default="pallas_ric_aug")
    p.add_argument("--mass-error", type=float, default=1.0,
                   help="plant mass scale (the policy learns the SRBD residuals that close "
                        "the gap between the MPC's model and the plant)")
    p.add_argument("--matrix-residual", action="store_true",
                   help="16-dim actions with the B-matrix force / moment effectiveness "
                        "residuals (set_srbd_residual)")
    p.add_argument("--force-error", type=float, default=1.0,
                   help="plant z-axis GRF effectiveness (e.g. 0.7: 70%% of the commanded "
                        "vertical force is delivered)")
    p.add_argument("--newton-iters", type=int, default=20,
                   help="PDIPM Newton steps (10 is the JAX package's viable HECTOR point)")
    p.add_argument("--noise", type=float, default=0.05)
    p.add_argument("--step-size", type=float, default=0.02)
    p.add_argument("--bench", action="store_true",
                   help="print a JSON record per iteration and a summary (no file is written)")
    p.add_argument("--mesh", action="store_true",
                   help="shard the population over the ranks of a process group, one card "
                        "each (start with torchrun; parallel/mesh.py)")
    p.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = p.parse_args()

    mesh = None
    if args.mesh:
        import torch.distributed as dist

        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
        mesh = pmesh.make_mesh(args.device)
        print(f"rank {mesh.rank}: sharding the population over {mesh.world} rank(s), this "
              f"shard on {mesh.device}", flush=True)

    emit = (lambda rec: print(json.dumps({"train_rl_mpc_tpu": rec}), flush=True)
            ) if args.bench else None
    force_scale = None if args.force_error == 1.0 else (1.0, 1.0, args.force_error)
    w, history, stats = train(
        iters=args.iters, n_dirs=args.dirs, envs_per=args.envs_per, steps=args.steps,
        solver=args.solver, emit=emit, plant_mass_scale=args.mass_error, noise=args.noise,
        step_size=args.step_size, mesh=mesh,
        matrix_residual=args.matrix_residual, plant_force_scale=force_scale,
        newton_iterations=args.newton_iters, device=args.device)
    print(f"\nreturn: first {history[0]:.3f} -> last {history[-1]:.3f} "
          f"(best {max(history):.3f})")
    print(f"policy norm {np.linalg.norm(w):.4f}")
    if stats:
        print(f"throughput: {stats['env_steps_per_s']:.0f} env-steps/s at "
              f"{stats['num_envs']} envs")
        if emit is not None:
            emit({"summary": stats, "return_first": history[0], "return_last": history[-1],
                  "return_best": max(history)})
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""RL-MPC training over the host env: a linear policy learns the MPC knobs with
Augmented Random Search (twin of `examples/train_rl_mpc.py`).

Every perturbation direction (+delta and -delta) owns a group of envs, so
one batched rollout of `rl_env.RlMpcEnv` evaluates the whole population, each
env under its own policy through the per-env knobs (`mpc_wrapper.py:48-64`).
No gradient flows through the controller. The directions come from
`np.random.default_rng(seed)` as in JAX, so a seed draws the same ones.

Run:  python -m biped_pympc_tpu_torch.examples.train_rl_mpc [--iters 10] [--dirs 4]
          [--envs-per 4] [--steps 40]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from biped_pympc_tpu_torch.examples.rl_env import ACT_DIM, OBS_DIM, RlMpcEnv


def population(w: np.ndarray, deltas: np.ndarray, noise: float, envs_per: int) -> np.ndarray:
    """(num_envs, act, obs) per-env policies, groups [dir0+, dir0-, dir1+, ...]
    of `envs_per` envs (`train_rl_mpc.py:74-80`)."""
    n_dirs = deltas.shape[0]
    w_per_env = np.empty((2 * n_dirs * envs_per, *w.shape), np.float32)
    for d in range(n_dirs):
        base = 2 * d * envs_per
        w_per_env[base: base + envs_per] = w + noise * deltas[d]
        w_per_env[base + envs_per: base + 2 * envs_per] = w - noise * deltas[d]
    return w_per_env


def ars_update(w: np.ndarray, deltas: np.ndarray, returns: np.ndarray, envs_per: int,
               step_size: float) -> tuple:
    """(new w, r_plus - r_minus): the antithetic ARS step on the group means,
    scaled by the returns' spread (`train_rl_mpc.py:82-88`)."""
    n_dirs = deltas.shape[0]
    grouped = returns.reshape(2 * n_dirs, envs_per).mean(axis=1)
    r_plus, r_minus = grouped[0::2], grouped[1::2]
    sigma = np.concatenate([r_plus, r_minus]).std() + 1e-8
    grad = np.einsum("d,dao->ao", r_plus - r_minus, deltas) / n_dirs
    return w + step_size / sigma * grad, r_plus - r_minus


def rollout_returns(env: RlMpcEnv, w_per_env, steps: int) -> np.ndarray:
    """One batched rollout from reset; the per-env summed reward."""
    w_per_env = torch.as_tensor(w_per_env, device=env.device).to(torch.float32)
    obs = env.reset()
    total = torch.zeros(env.num_envs, dtype=torch.float64, device=env.device)
    for _ in range(steps):
        action = torch.tanh(torch.einsum("bao,bo->ba", w_per_env, obs))
        obs, reward, _, _ = env.step(action)
        total += reward
    return total.cpu().numpy()


def train(iters: int = 10, n_dirs: int = 4, envs_per: int = 4, steps: int = 40,
          step_size: float = 0.02, noise: float = 0.05, solver: str = "ric_aug", seed: int = 0,
          verbose: bool = True, device=None):
    """ARS with antithetic directions; returns (W (act, obs), history of mean
    returns). `device` None is the card."""
    rng = np.random.default_rng(seed)
    env = RlMpcEnv(num_envs=2 * n_dirs * envs_per, solver=solver, seed=seed, device=device)
    w = np.zeros((ACT_DIM, OBS_DIM))
    history = []
    for it in range(iters):
        deltas = rng.standard_normal((n_dirs, ACT_DIM, OBS_DIM))
        returns = rollout_returns(env, population(w, deltas, noise, envs_per), steps)
        w, spread = ars_update(w, deltas, returns, envs_per, step_size)
        history.append(float(returns.mean()))
        if verbose:
            print(f"iter {it:3d}  mean return {history[-1]:8.3f}  "
                  f"best dir spread {spread.max():+.3f}", flush=True)
    return w, history


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dirs", type=int, default=4)
    p.add_argument("--envs-per", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = p.parse_args()
    w, history = train(iters=args.iters, n_dirs=args.dirs, envs_per=args.envs_per,
                       steps=args.steps, device=args.device)
    print(f"\nreturn: first {history[0]:.3f} -> last {history[-1]:.3f} "
          f"(best {max(history):.3f})")
    print(f"policy norm {np.linalg.norm(w):.4f}")


if __name__ == "__main__":
    main()

"""Batched planar-drone LQR sweeps and region of attraction (twin of
`examples/planar_drone.py`).

Thousands of closed-loop simulations at once, sweeping the controller's
weights (Q, R), the model's mass and the actuator limit F_lim across the env
batch. The per-env LQR gain is a batched fixed-point DARE solve in host
float64 (setup); the rollout steps every env together in torch on one
device, 100 steps at a time, which on the card are one captured CUDA graph
replayed (`examples/cuda_graph.LoopStep`).

Physics (planar bi-rotor, arm L): state [x, y, th, xd, yd, thd], inputs
[F1, F2],
    m xdd = -(F1 + F2) sin th
    m ydd =  (F1 + F2) cos th - m g
    I thdd = L (F1 - F2)
hover F1 = F2 = m g / 2; LQR about hover on the nonlinear model with the
thrusts clipped to [0, F_lim]; success ||state(T)|| < 1e-3.

Run: python -m biped_pympc_tpu_torch.examples.planar_drone [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from biped_pympc_tpu_torch.control.controller import resolve_device
from biped_pympc_tpu_torch.examples.cuda_graph import LoopStep

G = 9.81
ARM = 0.25  # rotor arm length [m]
DT = 0.001  # control / simulation step
CHUNK = 100  # steps a replay, and the stride of the coarse trajectory


def _inertia(mass):
    return 0.5 * mass * ARM**2


def hover_linearization(mass: np.ndarray):
    """Batched (Ad, Bd) of the bi-rotor linearized about hover, forward-Euler
    discretized at DT, numpy float64 (`planar_drone.py:52`)."""
    mass = np.atleast_1d(np.asarray(mass, np.float64))
    n = mass.shape[0]
    inertia = np.asarray(_inertia(mass))
    a = np.zeros((n, 6, 6))
    a[:, 0, 3] = a[:, 1, 4] = a[:, 2, 5] = 1.0
    a[:, 3, 2] = -G  # d(xdd)/d(th) at hover: -(F1+F2)/m = -g
    b = np.zeros((n, 6, 2))
    b[:, 4, 0] = b[:, 4, 1] = 1.0 / mass
    b[:, 5, 0] = ARM / inertia
    b[:, 5, 1] = -ARM / inertia
    return np.eye(6)[None] + DT * a, DT * b


def dare_gain(q_diag, r_diag, mass, iterations: int = 20000, dtype=torch.float32, device="cpu"):
    """Per-env discrete LQR gains by batched fixed-point Riccati iteration in
    host float64 (`planar_drone.py:70`; the float32 fixed point loses the
    slow modes). (6,) / (2,) / scalar for one env or (B, 6) / (B, 2) / (B,)
    batches; returns (2, 6) or (B, 2, 6) in `dtype` on `device`."""
    q_diag = np.atleast_2d(np.asarray(q_diag, np.float64))
    r_diag = np.atleast_2d(np.asarray(r_diag, np.float64))
    single = np.ndim(mass) == 0 and q_diag.shape[0] == 1
    ad, bd = hover_linearization(mass)
    n = ad.shape[0]
    q = np.zeros((n, 6, 6))
    q[:, np.arange(6), np.arange(6)] = q_diag
    r = np.zeros((n, 2, 2))
    r[:, np.arange(2), np.arange(2)] = r_diag

    adT = np.swapaxes(ad, 1, 2)
    bdT = np.swapaxes(bd, 1, 2)
    p = q.copy()
    for _ in range(iterations):
        btp = bdT @ p
        k = np.linalg.solve(r + btp @ bd, btp @ ad)
        acl = ad - bd @ k
        p = q + np.swapaxes(k, 1, 2) @ r @ k + np.swapaxes(acl, 1, 2) @ p @ acl
    btp = bdT @ p
    k = np.linalg.solve(r + btp @ bd, btp @ ad)  # (n, 2, 6)
    k = torch.tensor(k, dtype=dtype, device=device)
    return k[0] if single else k


def drone_step(state, gain, f_lim, mass):
    """One closed-loop nonlinear step of every env: state (B, 6), gain
    (B, 2, 6), f_lim (B, 2), mass (B,) -> (B, 6)."""
    hover = 0.5 * mass * G
    u = hover[:, None] - (gain @ state[..., None])[..., 0]  # LQR about hover
    u = torch.minimum(torch.clamp(u, min=0.0), f_lim)
    x, y, th, xd, yd, thd = state.unbind(-1)
    thrust = u[:, 0] + u[:, 1]
    xdd = -thrust * torch.sin(th) / mass
    ydd = thrust * torch.cos(th) / mass - G
    thdd = ARM * (u[:, 0] - u[:, 1]) / _inertia(mass)
    # Semi-implicit Euler (velocity first) for long-horizon stability.
    xd, yd, thd = xd + DT * xdd, yd + DT * ydd, thd + DT * thdd
    return torch.stack([x + DT * xd, y + DT * yd, th + DT * thd, xd, yd, thd], dim=-1)


@dataclasses.dataclass
class _Carry:
    state: torch.Tensor  # (B, 6)


def rollout(state0, gains, f_lim, mass, n_steps: int, graph: bool | None = None):
    """Batched closed-loop rollout of n_steps // 100 chunks of 100 steps
    (`planar_drone.py:113`): (final states (B, 6), coarse trajectory
    (n_steps // 100, B, 3), the pose after each chunk). On the card
    (`graph` None) a chunk is captured once as a CUDA graph and replayed;
    `graph=False` runs it eagerly."""
    def chunk(c: _Carry) -> None:
        s = c.state
        for _ in range(CHUNK):
            s = drone_step(s, gains, f_lim, mass)
        c.state = s

    carry = _Carry(state0.clone())
    loop = LoopStep(chunk, carry, graph)
    coarse = []
    for _ in range(n_steps // CHUNK):
        loop()
        coarse.append(carry.state[:, :3].clone())
    return carry.state, torch.stack(coarse)


def lqr_sweeps(n_per_init: int = 50, t_end: float = 15.0, dtype=torch.float32, device=None):
    """The three sweeps of `planar_drone.py:132` (Q_x, R_1 and the mass over
    log-spaced values) and the baseline, each from 3 initial displacements;
    {name: {"final_err_median", "settled_frac", "coarse_traj_shape"}}.
    `device` None is the card."""
    dev = resolve_device(device)
    n_envs = 3 * n_per_init
    inits = torch.tensor(np.repeat([[-2.0, -2.0, 0, 0, 0, 0], [1.0, -1.0, 0, 0, 0, 0],
                                    [-1.0, 2.0, 0, 0, 0, 0]], n_per_init, axis=0),
                         dtype=dtype, device=dev)
    q_def = np.ones((n_envs, 6))
    r_def = np.ones((n_envs, 2))
    mass_def = np.ones(n_envs)
    f_lim = torch.full((n_envs, 2), 50.0, dtype=dtype, device=dev)
    n_steps = int(t_end / DT)
    logspace = np.tile(np.logspace(np.log10(0.05), np.log10(20.0), n_per_init), 3)
    q_x = q_def.copy()
    q_x[:, 0] = logspace
    r_1 = r_def.copy()
    r_1[:, 0] = np.tile(np.logspace(-2, 2, n_per_init), 3)
    cases = {"baseline": (q_def, r_def, mass_def), "Q_x": (q_x, r_def, mass_def),
             "R_1": (q_def, r_1, mass_def),
             "mass": (q_def, r_def, np.tile(np.logspace(np.log10(0.25), np.log10(4.0),
                                                        n_per_init), 3))}
    sweeps = {}
    for name, (q, r, m) in cases.items():
        gains = dare_gain(q, r, m, dtype=dtype, device=dev)
        mass = torch.tensor(m, dtype=dtype, device=dev)
        final, coarse = rollout(inits, gains, f_lim, mass, n_steps)
        err = torch.linalg.vector_norm(final, dim=1)
        sweeps[name] = {"final_err_median": float(torch.quantile(err.double(), 0.5)),
                        "settled_frac": float((err < 1e-2).double().mean()),
                        "coarse_traj_shape": tuple(coarse.shape)}
    return sweeps


def region_of_attraction(n_envs: int = 30000, t_end: float = 10.0, seed: int = 0,
                         dtype=torch.float32, device=None):
    """The F_lim sweep of `planar_drone.py:172`: random initial linear and
    angular momentum, one shared LQR gain; {F_lim: success share}, success
    ||state(T)|| < 1e-3. `device` None is the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    v_max, omega_max = 20.0, 5.0
    omg = omega_max * (2 * rng.random(n_envs) - 1)
    ang = np.pi * (2 * rng.random(n_envs) - 1)
    mag = v_max * (2 * rng.random(n_envs) - 1)
    zeros = np.zeros(n_envs)
    state0 = torch.tensor(np.stack([zeros, zeros, zeros, mag * np.cos(ang), mag * np.sin(ang),
                                    omg], axis=1), dtype=dtype, device=dev)
    mass = torch.ones(n_envs, dtype=dtype, device=dev)
    gain = dare_gain(np.ones(6), np.ones(2), 1.0, dtype=dtype, device=dev)
    gains = gain.expand(n_envs, 2, 6).contiguous()
    n_steps = int(t_end / DT)
    results = {}
    for f_lim_val in (10.0, 20.0, 30.0, 40.0, 50.0):
        f_lim = torch.full((n_envs, 2), f_lim_val, dtype=dtype, device=dev)
        final, _ = rollout(state0, gains, f_lim, mass, n_steps)
        results[f_lim_val] = float((torch.linalg.vector_norm(final, dim=1) < 1e-3).double().mean())
    return results


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true", help="small sizes for a smoke run")
    p.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = p.parse_args()

    t0 = time.perf_counter()
    if args.quick:
        sweeps = lqr_sweeps(n_per_init=4, t_end=2.0, device=args.device)
        roa = region_of_attraction(n_envs=256, t_end=2.0, device=args.device)
    else:
        sweeps = lqr_sweeps(device=args.device)
        roa = region_of_attraction(device=args.device)

    print("LQR sweeps (150 envs x 15 s unless --quick):")
    for name, stats in sweeps.items():
        print(f"  {name:9s}: median final err {stats['final_err_median']:.2e}, "
              f"settled {100 * stats['settled_frac']:.0f}%")
    print("Region of attraction, success fraction vs F_lim:")
    for f, frac in roa.items():
        print(f"  F_lim {f:5.1f} N: {100 * frac:5.1f}%")
    print(f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()

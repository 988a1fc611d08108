"""The port's RL-MPC environments and trainers (`biped_pympc_tpu_torch/examples/`)
on the CPU: the device env against the host env and against the JAX
package's `rl_env_tpu` (its Pallas kernel run by the interpreter), the
matrix-residual and plant-force-scale knobs, and one ARS iteration of each
trainer."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu_torch.convert import env_carry_from_numpy
from biped_pympc_tpu_torch.examples import rl_env, rl_env_tpu, train_rl_mpc, train_rl_mpc_tpu

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import rl_env_tpu as jrl  # noqa: E402

torch.set_num_threads(1)
N, STEPS = 3, 4
ATOL = 2e-2  # tests/test_train_rl_mpc.py::test_device_env_matches_host_env


def _policies(act_dim=rl_env_tpu.ACT_DIM):
    rng = np.random.default_rng(0)
    return (0.02 * rng.standard_normal((N, act_dim, rl_env_tpu.OBS_DIM))).astype(np.float32)


def _device_returns(solver, **kw):
    env_step, reset_all, rl_obs, _ = rl_env_tpu.make_device_env(N, vx_cmd=0.3, solver=solver,
                                                                device="cpu", **kw)
    rollout = rl_env_tpu.make_rollout(env_step, rl_obs, STEPS)
    carry, total = rollout(reset_all(), _policies())
    return carry, total.double().numpy()


def test_device_env_matches_host_env():
    """The twin of tests/test_train_rl_mpc.py::test_device_env_matches_host_env:
    the same policies through the host loop (literal RK4 plant) and the device
    env (closed form), same solver, same returns within 2e-2."""
    w = torch.tensor(_policies())
    env = rl_env.RlMpcEnv(num_envs=N, vx_cmd=0.3, solver="tridiag_aug", device="cpu")
    obs = env.reset()
    host = torch.zeros(N, dtype=torch.float64)
    for _ in range(STEPS):
        obs, reward, done, _ = env.step(torch.tanh(torch.einsum("bao,bo->ba", w, obs)))
        host += reward
    _, dev = _device_returns("tridiag_aug")
    np.testing.assert_allclose(dev, host.numpy(), rtol=0, atol=ATOL)
    assert (dev > 1.0).all()  # no env fell (a fall costs 5)


def test_device_env_matches_jax():
    """The port's device env against JAX's, B 3, 4 RL steps, the product solver
    (pallas_ric_aug), float32 on both sides, from JAX's reset carry carried
    over (`convert.env_carry_from_numpy`)."""
    env_step, reset_all, rl_obs, _ = jrl.make_device_env(N, vx_cmd=0.3)
    jcarry = reset_all()
    _, want = jrl.make_rollout(env_step, rl_obs, STEPS)(jcarry, jnp.asarray(_policies()))
    t_step, _, t_obs, _ = rl_env_tpu.make_device_env(N, vx_cmd=0.3, device="cpu")
    carry = env_carry_from_numpy(jax.tree.map(np.asarray, jcarry))
    _, got = rl_env_tpu.make_rollout(t_step, t_obs, STEPS)(carry, _policies())
    np.testing.assert_allclose(got.double().numpy(), np.asarray(want, np.float64), rtol=0,
                               atol=ATOL)


def test_matrix_residual_and_force_scale_actions_run():
    """16-dim actions drive the B-matrix residual (the trajectory moves off the
    zero policy's, all finite); a plant that delivers 70% of the vertical
    force falls behind the nominal one in z velocity."""
    env_step, reset_all, rl_obs, _ = rl_env_tpu.make_device_env(
        2, solver="tridiag_aug", matrix_residual=True, device="cpu")
    rollout = rl_env_tpu.make_rollout(env_step, rl_obs, 3)
    w0 = torch.zeros(2, rl_env_tpu.ACT_DIM_MATRIX, rl_env_tpu.OBS_DIM)
    c0, r0 = rollout(reset_all(), w0)
    x0 = c0.x.clone()
    w1 = w0.clone()
    w1[:, 10:13, 3] = 2.0  # a force-effectiveness residual through the height feature
    c1, r1 = rollout(reset_all(), w1)
    assert c1.state.residual_B is not None and float(c1.state.residual_B.abs().max()) > 0
    assert bool(torch.isfinite(r0).all() & torch.isfinite(r1).all())
    assert not torch.allclose(x0, c1.x, atol=1e-4)

    a = torch.zeros(2, rl_env_tpu.ACT_DIM)
    xs = []
    for scale in (None, (1.0, 1.0, 0.7)):
        env_step, reset_all, _, _ = rl_env_tpu.make_device_env(
            2, solver="tridiag_aug", plant_force_scale=scale, device="cpu")
        carry, reward, done = env_step(reset_all(), a)
        xs.append(carry.x)
        assert reward.shape == done.shape == (2,)
    assert not torch.allclose(xs[0], xs[1], atol=1e-6)
    assert float(xs[1][:, 11].mean()) < float(xs[0][:, 11].mean())


def _first_direction(seed, act_dim):
    return np.random.default_rng(seed).standard_normal((1, act_dim, rl_env_tpu.OBS_DIM))[0]


@pytest.mark.parametrize("trainer", ["host", "device"])
def test_one_ars_iteration_updates_w_from_the_seed(trainer):
    """One iteration with one direction: w moves along the seed's first
    direction (np.random.default_rng(seed), as in JAX), and a second run with
    the same seed gives the same w."""
    def run():
        kw = dict(iters=1, n_dirs=1, envs_per=1, steps=2, seed=3, verbose=False, device="cpu")
        if trainer == "host":
            return train_rl_mpc.train(solver="tridiag_aug", **kw)[0]
        return train_rl_mpc_tpu.train(solver="tridiag_aug", **kw)[0]

    w = run()
    d = _first_direction(3, w.shape[0])
    cos = float((w * d).sum() / (np.linalg.norm(w) * np.linalg.norm(d)))
    assert np.linalg.norm(w) > 0 and abs(abs(cos) - 1.0) < 1e-12
    np.testing.assert_array_equal(run(), w)

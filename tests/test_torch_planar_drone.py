"""The port's planar drone (`biped_pympc_tpu_torch/examples/planar_drone.py`)
against the JAX example on the CPU: the hover linearization, the DARE gains
and a short closed-loop rollout at float64, and the JAX test's criterion on
the region of attraction (`tests/test_planar_drone.py:47`)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu_torch.examples import planar_drone as tpd

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import planar_drone as jpd  # noqa: E402

torch.set_num_threads(1)
MASSES = np.array([0.25, 1.0, 4.0])


def test_linearization_and_gains_match_jax():
    for a, b in zip(tpd.hover_linearization(MASSES), jpd.hover_linearization(MASSES)):
        np.testing.assert_array_equal(a, b)
    q, r = np.ones((3, 6)), np.ones((3, 2))
    q[:, 0] = [0.5, 1.0, 2.0]
    want = np.asarray(jpd.dare_gain(q, r, MASSES, iterations=3000))
    got = tpd.dare_gain(q, r, MASSES, iterations=3000)
    assert got.dtype == torch.float32 and got.shape == (3, 2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    single = tpd.dare_gain(np.ones(6), np.ones(2), 1.0, iterations=3000, dtype=torch.float64)
    assert single.shape == (2, 6)
    ad, bd = tpd.hover_linearization(1.0)
    eig = np.linalg.eigvals(ad[0] - bd[0] @ single.numpy())
    assert np.abs(eig).max() < 1.0 - 1e-5


def test_rollout_matches_jax():
    """500 steps of 6 envs at float64 (bound 1e-9), the graph-free rollout."""
    rng = np.random.default_rng(1)
    s0 = np.concatenate([rng.uniform(-1, 1, (6, 3)), rng.uniform(-2, 2, (6, 3))], axis=1)
    gains = np.asarray(tpd.dare_gain(np.ones((6, 6)), np.ones((6, 2)), np.linspace(0.5, 2, 6),
                                     iterations=3000, dtype=torch.float64))
    f_lim = np.tile([[9.0], [30.0]], (3, 2))
    mass = np.linspace(0.5, 2.0, 6)
    want = jpd.rollout(*(jnp.asarray(a) for a in (s0, gains, f_lim, mass)), 500)
    got = tpd.rollout(*(torch.tensor(a) for a in (s0, gains, f_lim, mass)), 500, graph=False)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-9)
    assert got[1].shape == (5, 6, 3)


def test_roa_success_share_rises_with_thrust():
    """More thrust, no smaller basin, and most mild perturbations recover
    (the JAX test's case: 64 envs, 10 s, F_lim 8 vs 50 N)."""
    rng = np.random.default_rng(3)
    n = 64
    v = 6.0 * (2 * rng.random((n, 2)) - 1)
    omg = 2.0 * (2 * rng.random(n) - 1)
    s0 = torch.tensor(np.concatenate([np.zeros((n, 3)), v, omg[:, None]], axis=1),
                      dtype=torch.float32)
    gains = tpd.dare_gain(np.ones(6), np.ones(2), 1.0).expand(n, 2, 6).contiguous()
    fracs = []
    for f_lim in (8.0, 50.0):
        final, _ = tpd.rollout(s0, gains, torch.full((n, 2), f_lim), torch.ones(n),
                               int(10.0 / tpd.DT))
        fracs.append(float((torch.linalg.vector_norm(final, dim=1) < 1e-3).double().mean()))
    assert fracs[1] >= fracs[0]
    assert fracs[1] > 0.5, fracs


def test_sweeps_run_on_the_cpu(monkeypatch):
    sweeps = tpd.lqr_sweeps(n_per_init=2, t_end=0.2, device="cpu")
    assert set(sweeps) == {"baseline", "Q_x", "R_1", "mass"}
    assert all(s["coarse_traj_shape"] == (2, 6, 3) for s in sweeps.values())
    roa = tpd.region_of_attraction(n_envs=8, t_end=0.2, device="cpu")
    assert sorted(roa) == [10.0, 20.0, 30.0, 40.0, 50.0]
    assert all(0.0 <= v <= 1.0 for v in roa.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpd.region_of_attraction(n_envs=8, t_end=0.2)

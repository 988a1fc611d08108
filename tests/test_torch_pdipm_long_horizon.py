"""The plain versions of K5b's, K5d-a's, K5a's, K5c's and K5d-c's routes at
horizon 20, where their kernels now run in f64 too: the port's
`tridiag_aug`, unsplit `ric_aug` (with and without the Jacobi scaling),
`tridiag`, `ric2` and unsplit `ric` against the JAX package's pure-JAX
`pdipm.solve` of the same names, f64, B = 2 walking QPs with swing stages,
six Newton steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu.models.srbd import SrbdLin
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu.ops import qp as jqp
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm

torch.set_num_threads(1)
T = 20
STEPS = 6
ATOL = 1e-8  # the augmented routes' bound at h10 (`test_torch_pdipm.ATOL`); K5a's holds it too


def _walking_qp(seed):
    """One HECTOR QP at horizon T: small random start, forward command, each
    foot in swing for five stages."""
    f64 = jnp.float64
    lin = SrbdLin(
        rot_body=jnp.eye(3, dtype=f64),
        inertia_world=jnp.asarray(np.diag([0.5413, 0.52, 0.0691]), dtype=f64),
        body_pos=jnp.asarray([0.0, 0.0, 0.55], dtype=f64),
        foot_pos=jnp.asarray([[0.05, 0.08, 0.0], [0.05, -0.08, 0.0]], dtype=f64),
        mass=jnp.asarray(13.856, dtype=f64),
        residual_lin_accel=jnp.zeros(3, dtype=f64),
        residual_ang_accel=jnp.zeros(3, dtype=f64),
    )
    rng = np.random.default_rng(seed)
    x0 = jnp.asarray(rng.uniform(-0.05, 0.05, 12), dtype=f64).at[5].add(0.5)
    x_ref = jnp.zeros((T, 12), dtype=f64).at[:, 5].set(0.55).at[:, 9].set(0.1 + 0.1 * seed)
    contact = np.ones((T, 2))
    contact[3 + seed:8 + seed, 0] = 0.0
    contact[11 + seed:16 + seed, 1] = 0.0
    q = jnp.asarray([150.0, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1], dtype=f64)
    r = jnp.full(12, 1e-5, dtype=f64).at[6:].set(1e-4)
    return jqp.build_qp(lin, x0, x_ref, jnp.asarray(contact, f64), jnp.asarray(0.025, f64),
                        jnp.asarray(1.0, f64), q, r, T)


@pytest.fixture(scope="module")
def batch():
    return jax.tree.map(lambda *xs: jnp.stack(xs), *[_walking_qp(s) for s in range(2)])


# The routes: K5b's block-Thomas (pivoted 42-wide blocks), K5d-a's unsplit
# Riccati (pivoted 30-wide blocks), the latter also Jacobi-scaled, K5a's
# condensed block-Thomas (pivoted 26-wide blocks), K5c's rank-2 route
# (12-wide Ru blocks) and K5d-c's unsplit condensed Riccati (14-wide). The
# JAX package's pure `pdipm.solve` has no "ric2" (its Pallas kernel has):
# K5c is held against the pure unsplit "ric", which eliminates the same
# condensed stage block whole (`JAX_TWIN`).
ROUTES = {"tridiag_aug": dict(backend="tridiag_aug"),
          "ric_aug unsplit": dict(backend="ric_aug", foot_split=False),
          "ric_aug unsplit jacobi": dict(backend="ric_aug", foot_split=False, kkt_scale="jacobi"),
          "tridiag": dict(backend="tridiag"),
          "ric2": dict(backend="ric2"),
          "ric unsplit": dict(backend="ric", foot_split=False)}
JAX_TWIN = {"ric2": dict(backend="ric", foot_split=False)}


@pytest.mark.parametrize("route", ROUTES)
def test_plain_matches_pure_jax_at_horizon_20(batch, route):
    kw = dict(ROUTES[route], refine_steps=1, iterations=STEPS)
    jkw = dict(JAX_TWIN.get(route, ROUTES[route]), refine_steps=1, iterations=STEPS)
    ref = jax.jit(jax.vmap(lambda q: jpdipm.solve(q, jpdipm.PdipmOptions(**jkw))))(batch)
    got = tpdipm.solve(stage_qp_from_numpy(jax.tree.map(np.asarray, batch)),
                       tpdipm.PdipmOptions(**kw))
    assert got.x.shape == (2, 24 * T)
    for name in "xszy":
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got.residuals.numpy(), np.asarray(ref.residuals),
                               rtol=1e-6, atol=1e-13)

"""The torch port's maths, linalg, SRBD model and QP assembly vs the JAX
package, on the same numpy-seeded inputs, in float64 (atol 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu.models import srbd as jsrbd
from biped_pympc_tpu.ops import linalg as jlinalg
from biped_pympc_tpu.ops import qp as jqp
from biped_pympc_tpu.utils import maths as jmaths
from biped_pympc_tpu_torch.models import srbd as tsrbd
from biped_pympc_tpu_torch.ops import linalg as tlinalg
from biped_pympc_tpu_torch.ops import qp as tqp
from biped_pympc_tpu_torch.utils import maths as tmaths

torch.set_num_threads(1)
ATOL = 1e-12
B = 6
T = 10


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["rot_x", "rot_y", "rot_z", "quat_to_rotmat",
                                  "quat_to_euler", "skew", "unskew"])
def test_maths_matches_jax(name):
    rng = np.random.default_rng(0)
    arg = {"quat_to_rotmat": (B, 4), "quat_to_euler": (B, 4), "skew": (B, 3),
           "unskew": (B, 3, 3)}.get(name, (B,))
    a = rng.standard_normal(arg)
    if name == "quat_to_euler":
        a /= np.linalg.norm(a, axis=-1, keepdims=True)
    _close(getattr(tmaths, name)(torch.tensor(a)), getattr(jmaths, name)(jnp.asarray(a)))


def test_unskew_inverts_skew():
    v = torch.tensor(np.random.default_rng(1).standard_normal((B, 3)))
    _close(tmaths.unskew(tmaths.skew(v)), v.numpy())


@pytest.mark.parametrize("n", [3, 12])
def test_linalg_inverses_match_jax(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((B, n, n)) + 0.5 * np.eye(n)
    if n == 3:
        _close(tlinalg.inverse_3x3(torch.tensor(a)), jlinalg.inverse_3x3(jnp.asarray(a)), 1e-10)
    got = tlinalg.gauss_jordan_inverse(torch.tensor(a))
    _close(got, jlinalg.gauss_jordan_inverse(jnp.asarray(a)), 1e-10)
    _close(got, torch.linalg.inv(torch.tensor(a)).numpy(), 1e-10)


def _lin_inputs(seed, residual):
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-0.3, 0.3, (B, 3))
    rot = np.asarray(jmaths.rot_z(rpy[:, 2]) @ jmaths.rot_y(rpy[:, 1]) @ jmaths.rot_x(rpy[:, 0]))
    i_body = np.diag([0.5413, 0.52, 0.0691])
    d = dict(
        rot_body=rot, inertia_world=rot @ i_body @ np.swapaxes(rot, 1, 2),
        body_pos=rng.uniform(-0.1, 0.1, (B, 3)) + [0, 0, 0.55],
        foot_pos=rng.uniform(-0.15, 0.15, (B, 2, 3)) * [1, 1, 0],
        mass=np.full(B, 13.856),
        residual_lin_accel=rng.standard_normal((B, 3)) * 0.1,
        residual_ang_accel=rng.standard_normal((B, 3)) * 0.1,
    )
    if residual:
        d["residual_A"] = rng.standard_normal((B, 12, 12)) * 0.01
        d["residual_B"] = rng.standard_normal((B, 12, 12)) * 0.01
    return d


@pytest.mark.parametrize("mode", ["rt_omega", "r_omega"])
@pytest.mark.parametrize("residual", [False, True])
def test_srbd_discrete_dynamics_matches_jax(mode, residual):
    d = _lin_inputs(2, residual)
    dt = np.random.default_rng(3).uniform(0.02, 0.03, B)
    tl = tsrbd.SrbdLin(**{k: torch.tensor(v) for k, v in d.items()})
    jl = jsrbd.SrbdLin(**{k: jnp.asarray(v) for k, v in d.items()})
    cont_t = tsrbd.continuous_dynamics(tl, mode)
    cont_j = jax.vmap(lambda l: jsrbd.continuous_dynamics(l, mode))(jl)
    for a, b in zip((cont_t.A, cont_t.B, cont_t.c), cont_j):
        _close(a, b)
    disc_t = tsrbd.discrete_dynamics(tl, torch.tensor(dt), mode)
    disc_j = jax.vmap(lambda l, h: jsrbd.discrete_dynamics(l, h, mode))(jl, jnp.asarray(dt))
    for a, b in zip((disc_t.A, disc_t.B, disc_t.c), disc_j):
        _close(a, b)


def _qp_inputs(seed):
    rng = np.random.default_rng(seed)
    d = _lin_inputs(seed, False)
    x0 = rng.uniform(-0.05, 0.05, (B, 12)) + np.eye(12)[5] * 0.55
    x_ref = np.zeros((B, T, 12))
    x_ref[:, :, 5] = 0.55
    x_ref[:, :, 9] = rng.uniform(0, 0.5, (B, 1))
    contact = rng.integers(0, 2, (B, T, 2)).astype(np.float64)
    per_env = dict(mu=rng.uniform(0.4, 1.0, B), f_max=rng.uniform(300, 600, B),
                   lt=rng.uniform(0.05, 0.08, B), lh=rng.uniform(0.03, 0.05, B),
                   dt=rng.uniform(0.02, 0.03, B))
    q = np.array([150.0, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1])
    r = np.array([1e-5] * 6 + [1e-4] * 6)
    return d, x0, x_ref, contact, per_env, q, r


def _build_both(seed):
    d, x0, x_ref, contact, pe, q, r = _qp_inputs(seed)
    t = torch.tensor
    tq = tqp.build_qp(tsrbd.SrbdLin(**{k: t(v) for k, v in d.items()}), t(x0), t(x_ref),
                      t(contact), t(pe["dt"]), t(pe["mu"]), t(q), t(r), T,
                      f_max=t(pe["f_max"]), lt=t(pe["lt"]), lh=t(pe["lh"]))
    jl = jsrbd.SrbdLin(**{k: jnp.asarray(v) for k, v in d.items()})
    jq = jax.vmap(lambda l, a, xr, c, dt, mu, fm, lt, lh: jqp.build_qp(
        l, a, xr, c, dt, mu, jnp.asarray(q), jnp.asarray(r), T, "rt_omega", fm, lt, lh))(
        jl, jnp.asarray(x0), jnp.asarray(x_ref), jnp.asarray(contact),
        *(jnp.asarray(pe[k]) for k in ("dt", "mu", "f_max", "lt", "lh")))
    return tq, jq


def test_build_qp_leaves_match_jax():
    tq, jq = _build_both(4)
    _close(tq.q_diag, jq.q_diag)
    _close(tq.r_diag, jq.r_diag)
    _close(tq.f, jq.f)
    _close(tq.dyn.A, jq.dyn.A)
    _close(tq.dyn.B, jq.dyn.B)
    _close(tq.dyn.c, jq.dyn.c)
    _close(tq.b0, jq.b0)
    _close(tq.g_u, jq.g_u)
    _close(tq.d, jq.d)
    assert (tq.nz, tq.n_eq, tq.n_ineq) == (240, 140, 160)


def test_structured_operators_match_dense():
    tq, jq = _build_both(5)
    H, f, A, b, G, d = tqp.dense_matrices(tq)
    rng = np.random.default_rng(6)
    zz = torch.tensor(rng.standard_normal((B, tq.nz)))
    lam = torch.tensor(rng.standard_normal((B, tq.n_ineq)))
    yy = torch.tensor(rng.standard_normal((B, tq.n_eq)))
    mv = lambda m, v: (m @ v[..., None])[..., 0].numpy()
    _close(tqp.g_matvec(tq, zz), mv(G, zz))
    _close(tqp.gT_matvec(tq, lam), mv(G.transpose(1, 2), lam))
    _close(tqp.a_matvec(tq, zz), mv(A, zz))
    _close(tqp.aT_matvec(tq, yy), mv(A.transpose(1, 2), yy))
    _close(tqp.h_diag(tq), torch.diagonal(H, dim1=1, dim2=2).numpy())
    _close(tqp.b_vec(tq), jax.vmap(jqp.b_vec)(jq))
    _close(tqp.d_vec(tq), jax.vmap(jqp.d_vec)(jq))
    _close(f, jq.f)

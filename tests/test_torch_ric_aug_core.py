"""`PdipmOptions(backend="ric_aug_core")` in the port (the scaled Riccati
core, plain torch on both devices) against the JAX package's pure-JAX route
(`biped_pympc_tpu/ops/pdipm.py:836-985`), float64: the factors and one
reduced solve at an iterate, and whole solves.

The route's S = -(W + V V^T) is rank-deficient on a swinging foot, where its
explicit inverse loses the solution (the JAX package keeps the route as a
closed negative, `tests/test_pdipm.py:280`): there two correct roundings of
it part by up to ~1e-2 after 15-20 Newton steps. So the whole 20-step solves
are held on QPs with both feet in stance, and the QPs with a swinging foot
over 8 steps, before the parting. Both with one refinement pass (the
controller's): unrefined, JAX's "ric_aug_core" and "ric_aug" part by 5e-3
relative after 20 steps on the stance QPs, and the port from JAX by 5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm
from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_pdipm import _make_qp

torch.set_num_threads(1)
B = 4
T = 10
RTOL = 1e-8  # whole solves, relative to max(1, |v|)
FACTOR_RTOL = 1e-10
WITNESS_FACTOR = 4


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def _batch(swing: bool):
    contact = np.ones((T, 2))
    contact[2:6, 0] = 0.0
    qs = [_make_qp(seed=s, vx=0.1 * s, contact=contact if swing and s % 2 else None)
          for s in range(B)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qs)


@pytest.fixture(scope="module")
def stance():
    return _batch(False)


def _iterate(batch, steps=15):
    """w_diag (B, T, 16) and a seeded rhs at the iterate after `steps`
    Newton steps of "ric_aug" (as `tests/test_pdipm.py:280`)."""
    opts = jpdipm.PdipmOptions(backend="ric_aug", iterations=steps)
    res = jax.vmap(lambda q: jpdipm.solve(q, opts))(batch)
    w_diag = (1.0 / (res.z / res.s + opts.delta) + opts.delta).reshape(B, T, 16)
    rng = np.random.default_rng(0)
    qp = stage_qp_from_numpy(jax.tree.map(np.asarray, batch))
    rhs = [rng.standard_normal((B, n)) for n in (qp.nz, qp.n_ineq, qp.n_eq)]
    return qp, w_diag, rhs


@pytest.mark.parametrize("split", [False, True])
def test_core_factor_and_solve_match_jax(stance, split):
    """The factors within 1e-10 relative; the solve within 1e-10, or 4x the
    gap between JAX's own two factorizations of the system ("ric_aug_core"
    and "ric_aug") where that is larger: the system's conditioning (W up to
    ~1e8) puts ~1.6e-8 relative between them in dx."""
    qp, w_diag, rhs = _iterate(stance)
    jo = jpdipm.PdipmOptions(foot_split=split)
    jf = jax.vmap(lambda q, w: jpdipm._factor_ric_aug_core(q, w, jo))(stance, w_diag)
    fac = tpdipm._factor_core(qp, torch.tensor(np.asarray(w_diag)),
                              tpdipm.PdipmOptions(foot_split=split))
    for name, got, want in (("s_inv", fac.s_inv, jf[0]), ("v", fac.v, jf[1]),
                            ("c_u", fac.c_u, jf[2]), ("bd_hat", fac.bd_hat, jf[4]),
                            ("yhat_inv", fac.yhat_inv, jf[5]), ("q_inv", fac.q_inv, jf[6]),
                            ("s_coup", fac.s_coup, jf[7])):
        assert _rel(got.numpy(), want) <= FACTOR_RTOL, name
    args = [jnp.asarray(r) for r in rhs]
    want = jax.vmap(jpdipm._solve_ric_aug_core)(stance, jf, *args)
    fa = jax.vmap(lambda q, w: jpdipm._factor_ric_aug(q, w, jo))(stance, w_diag)
    other = jax.vmap(jpdipm._solve_ric_aug)(stance, fa, *args)
    got = tpdipm._solve_core(qp, fac, *(torch.tensor(r) for r in rhs))
    for name, g, w, o in zip(("dx", "dz", "dy"), got, want, other):
        assert _rel(g.numpy(), w) <= max(FACTOR_RTOL, WITNESS_FACTOR * _rel(o, w)), name


def _solve_both(batch, **kw):
    ref = jax.jit(jax.vmap(lambda q: jpdipm.solve(q, jpdipm.PdipmOptions(
        backend="ric_aug_core", **kw))))(batch)
    qp = stage_qp_from_numpy(jax.tree.map(np.asarray, batch))
    opts = tpdipm.PdipmOptions(backend="ric_aug_core", **kw)
    return ref, tpdipm.solve(qp, opts), pdipm_cuda.solve(qp, opts)


@pytest.mark.parametrize("swing, iterations, residual, split", [
    (False, 20, "f32", False), (False, 20, "f32", True), (False, 20, "df", False),
    (True, 8, "f32", False), (True, 8, "f32", True)])
def test_core_solve_matches_jax(swing, iterations, residual, split):
    ref, *ours = _solve_both(_batch(swing), iterations=iterations, refine_steps=1,
                             refine_residual=residual, foot_split=split)
    for res in ours:
        for name in "xszy":
            assert _rel(getattr(res, name).numpy(), getattr(ref, name)) <= RTOL, name
        np.testing.assert_allclose(res.residuals.numpy(), np.asarray(ref.residuals), rtol=1e-6,
                                   atol=1e-12)


def test_core_runs_plain_on_the_card(monkeypatch, stance):
    """On CUDA tensors `pdipm_cuda.solve` and `solve_adaptive` run the plain
    route: no kernel library is asked for."""
    qp = stage_qp_from_numpy(jax.tree.map(np.asarray, stance))
    opts = tpdipm.PdipmOptions(backend="ric_aug_core", iterations=3)

    def no_library(route):
        raise AssertionError(f"asked for the {route} kernel")

    monkeypatch.setattr(pdipm_cuda, "_device", lambda qp_, o: torch.device("cuda", 0))
    monkeypatch.setattr(pdipm_cuda, "_library", no_library)
    want = tpdipm.solve(qp, opts)
    for res in (pdipm_cuda.solve(qp, opts), pdipm_cuda.solve_adaptive(qp, opts, tol=0.0)):
        for name in "xszy":
            assert torch.equal(getattr(res, name), getattr(want, name)), name

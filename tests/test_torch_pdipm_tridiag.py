"""The torch port's plain PDIPM on the block-Thomas routes (`backend="tridiag"`,
26-wide condensed stage blocks; `backend="tridiag_aug"`, 42-wide augmented)
vs the JAX package: the pure-JAX routes of the same names (a 38- / 54-wide
factorization of the same Newton step), the compensated residual, horizon 20
and the numpy golden solver. Float64. The Pallas kernel of these routes, run
by the Pallas interpreter, is in `test_torch_pdipm_tridiag_pallas.py`."""

import jax
import numpy as np
import pytest
import torch

from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu.ops import qp as jqp
from biped_pympc_tpu.ops import reference_pdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm
from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_horizon20 import _qp20
from test_torch_pdipm import ATOL, _assert_state_close, batch, port_opts  # noqa: F401 (fixture)
from test_torch_pdipm_ric import RIC_RTOL

torch.set_num_threads(1)
ROUTES = ("tridiag_aug", "tridiag")


def _jax_opts(backend, **kw):
    return jpdipm.PdipmOptions(backend=backend, refine_steps=1, **kw)


def _assert_matches_pure_jax(backend, got, ref):
    """The augmented route holds ATOL (1e-8) absolute, as `ric_aug` does. The
    condensed route amplifies f64 roundoff by its W^-1 blocks (up to 1e8) on
    envs still far from converged, as `ric` does, so it also gets RIC_RTOL
    (1e-9) relative: measured 3e-10 relative, 3e-8 absolute on duals ~400."""
    rtol = RIC_RTOL if backend == "tridiag" else 0.0
    for name in "xszy":
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(got.residuals.numpy(), np.asarray(ref.residuals),
                               rtol=1e-6, atol=1e-13)


@pytest.fixture(scope="module")
def port_qp(batch):  # noqa: F811
    return stage_qp_from_numpy(jax.tree.map(np.asarray, batch))


@pytest.fixture(scope="module")
def port_results(port_qp):
    return {b: tpdipm.solve(port_qp, port_opts(backend=b)) for b in ROUTES}


@pytest.mark.parametrize("backend", ROUTES)
def test_plain_matches_pure_jax(batch, port_results, backend):  # noqa: F811
    ref = jax.jit(jax.vmap(lambda q: jpdipm.solve(q, _jax_opts(backend))))(batch)
    _assert_matches_pure_jax(backend, port_results[backend], ref)


def test_tridiag_aug_df_matches_pure_jax(batch, port_qp):  # noqa: F811
    """Six steps with the compensated residual, the bound of
    `test_torch_df.test_plain_df_solve_matches_pure_jax`: 1e-9 relative and
    absolute (the two sum the compensated terms in different orders)."""
    got = tpdipm.solve(port_qp, port_opts(backend="tridiag_aug", iterations=6,
                                                    refine_residual="df"))
    jopts = _jax_opts("tridiag_aug", iterations=6, refine_residual="df")
    ref = jax.jit(jax.vmap(lambda q: jpdipm.solve(q, jopts)))(batch)
    for name in "xszy":
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    # At f64 the compensated residual changes the solve only at roundoff.
    plain = tpdipm.solve(port_qp, port_opts(backend="tridiag_aug", iterations=6))
    np.testing.assert_allclose(got.x.numpy(), plain.x.numpy(), rtol=1e-9, atol=1e-9)


def test_tridiag_refuses_df_with_the_jax_message(batch, port_qp):  # noqa: F811
    with pytest.raises(ValueError) as jax_err:
        jpdipm.solve(jax.tree.map(lambda a: a[0], batch),
                     _jax_opts("tridiag", refine_residual="df"))
    opts = port_opts(backend="tridiag", refine_residual="df")
    for solve in (tpdipm.solve, pdipm_cuda.solve, pdipm_cuda.solve_adaptive,
                  tpdipm.solve_adaptive_batch):
        with pytest.raises(ValueError) as err:
            solve(port_qp, opts)
        assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("backend", ROUTES)
def test_horizon20_matches_pure_jax(backend):
    qp = _qp20()
    ref = jax.jit(lambda q: jpdipm.solve(q, _jax_opts(backend)))(qp)
    qb = jax.tree.map(lambda a: np.asarray(a)[None], qp)
    got = tpdipm.solve(stage_qp_from_numpy(qb), port_opts(backend=backend))
    assert got.x.shape == (1, 480)
    ref_b = jpdipm.PdipmResult(*(np.asarray(v)[None] for v in ref))
    _assert_matches_pure_jax(backend, got, ref_b)


@pytest.mark.parametrize("backend", ROUTES)
def test_plain_matches_golden(batch, port_results, backend):  # noqa: F811
    """The two-tier bound of `test_pdipm_matches_golden`."""
    res = port_results[backend]
    for i in range(batch.f.shape[0]):
        qp = jax.tree.map(lambda a: a[i], batch)
        H, f, A, b, G, d = jqp.dense_matrices(qp)
        gx, gs, gz, gy, gres = reference_pdipm.solve(
            H, f, A, b, G, d, *reference_pdipm.initialize_variables(G, d, A.shape[0]),
            iterations=20)
        for name, want in zip("xszy", (gx, gs, gz, gy)):
            err = np.abs(getattr(res, name)[i].numpy() - want)
            assert np.median(err) < 3e-7, (i, name, np.sort(err)[-5:])
            assert err.max() < 1e-5, (i, name, np.sort(err)[-5:])
        np.testing.assert_allclose(res.residuals[i].numpy(), gres, rtol=1e-6, atol=1e-13)


@pytest.mark.parametrize("thomas, riccati", [("tridiag_aug", "ric_aug"), ("tridiag", "ric")])
def test_thomas_and_riccati_routes_agree(port_qp, port_results, thomas, riccati):
    """Two factorizations of one Newton step reach the same solution at f64
    (the bound of `test_torch_pdipm_ric.test_routes_agree_where_converged`)."""
    ric = tpdipm.solve(port_qp, port_opts(backend=riccati))
    np.testing.assert_allclose(port_results[thomas].x.numpy(), ric.x.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", ROUTES)
def test_cpu_dispatch_is_the_plain_version(port_qp, port_results, backend):
    before = dict(pdipm_cuda.launches)
    res = pdipm_cuda.solve(port_qp, port_opts(backend=backend))
    assert pdipm_cuda.launches == before
    _assert_state_close(res, port_results[backend], atol=0.0)
    adaptive = pdipm_cuda.solve_adaptive(port_qp, port_opts(backend=backend), 0.0)
    assert pdipm_cuda.launches == before
    _assert_state_close(adaptive, port_results[backend], atol=0.0)

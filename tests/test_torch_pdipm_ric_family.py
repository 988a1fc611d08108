"""The torch port's plain PDIPM on the rest of the Riccati family: the rank-2
route (`backend="ric2"`), the unsplit routes (`foot_split=False`, dense 14-
and 30-wide stage blocks) and the Jacobi equilibration (`kkt_scale="jacobi"`),
against the split routes, each other and the JAX package's pure-JAX routes;
and the options these routes refuse. Float64. The Pallas kernel of the same
routes, run by the Pallas interpreter, is in
`test_torch_pdipm_ric_family_pallas.py`."""

import jax
import numpy as np
import pytest
import torch

from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm
from biped_pympc_tpu_torch.ops import pdipm_cuda
from biped_pympc_tpu_torch.ops.linalg import gauss_jordan_inverse

from test_torch_pdipm import ATOL, _assert_state_close, batch, port_opts  # noqa: F401 (fixture)
from test_torch_pdipm_ric import INTERP_ITERS, RIC_RTOL

torch.set_num_threads(1)
# Eight Newton steps: every phase of the step runs, short of the late steps
# where the condensed routes amplify f64 roundoff by their 1e8-scale W^-1
# blocks (RIC_RTOL) and two exact factorizations part at ~3e-10 relative.
SHORT = 8


@pytest.fixture(scope="module")
def port_qp(batch):  # noqa: F811
    return stage_qp_from_numpy(jax.tree.map(np.asarray, batch))


def _solve(qp, **kw):
    return tpdipm.solve(qp, port_opts(**kw))


def _assert_close(got, want, rtol, atol):
    for name in "xszy":
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("backend", ["ric", "ric_aug"])
def test_unsplit_matches_split(port_qp, backend):
    """The stage blocks decouple exactly by foot, so the dense 14- / 30-wide
    inverse and the split one agree to roundoff: the bound and step count of
    `tests/test_pdipm_pallas.py::test_pallas_foot_split_matches_dense`."""
    split = _solve(port_qp, backend=backend, iterations=INTERP_ITERS)
    dense = _solve(port_qp, backend=backend, iterations=INTERP_ITERS, foot_split=False)
    _assert_close(dense, split, rtol=1e-12, atol=1e-12)


def test_unsplit_ric_aug_matches_split_over_20_steps(port_qp):
    """The augmented route keeps every extreme scale on a pivoted diagonal:
    over the full 20 steps the two factorizations still agree to 1e-12."""
    _assert_close(_solve(port_qp, foot_split=False), _solve(port_qp), rtol=1e-12, atol=1e-12)


def test_unsplit_ric_matches_split_over_20_steps(port_qp):
    """The condensed route over 20 steps: RIC_RTOL relative (measured 2.3e-10)."""
    _assert_close(_solve(port_qp, backend="ric", foot_split=False), _solve(port_qp, backend="ric"),
                  rtol=RIC_RTOL, atol=ATOL)


def test_ric2_matches_ric(port_qp):
    """The rank-2 block formula and the split inverse are two exact
    eliminations of one condensed stage block: 20 steps, rtol 1e-9 / atol
    1e-10 (measured 2.3e-10 relative to max(1, |v|)), in the Gauss-Jordan
    form the bound was measured in, "tableau"."""
    _assert_close(_solve(port_qp, backend="ric2", gj_form="tableau"),
                  _solve(port_qp, backend="ric", gj_form="tableau"), rtol=1e-9, atol=1e-10)


def test_ric2_matches_ric_inplace(port_qp):
    """The same in the default form, "inplace", which scales each pivot row
    by the pivot's reciprocal and so rounds the 1e8-scale blocks otherwise:
    20 steps, rtol 1e-8 / atol 1e-9 (measured 3.1e-9 relative and 3.3e-10
    absolute, on 2 of 960 entries of x)."""
    _assert_close(_solve(port_qp, backend="ric2"), _solve(port_qp, backend="ric"),
                  rtol=1e-8, atol=1e-9)


ROUTES = {"ric_aug": dict(backend="ric_aug"), "ric": dict(backend="ric"),
          "ric_aug_dense": dict(backend="ric_aug", foot_split=False),
          "ric_dense": dict(backend="ric", foot_split=False), "ric2": dict(backend="ric2")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_jacobi_matches_unscaled(port_qp, route):
    """K^-1 = D (D K D)^-1 D is exact: at f64 the equilibrated factorization
    changes only the rounding: rtol 1e-9 over SHORT steps, with a 1e-12
    floor for entries near zero (ric2 reads 4.2e-13 on a y of 2e-4)."""
    kw = dict(ROUTES[route], iterations=SHORT)
    _assert_close(_solve(port_qp, kkt_scale="jacobi", **kw), _solve(port_qp, **kw),
                  rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("backend", ["ric", "ric_aug"])
@pytest.mark.parametrize("kkt_scale", ["none", "jacobi"])
def test_unsplit_matches_pure_jax(batch, port_qp, backend, kkt_scale):  # noqa: F811
    """The JAX package's pure-JAX route with foot_split=False: the same dense
    stage blocks (inverted there with pivoting throughout, equilibrated the
    same way). The augmented route holds ATOL absolute; the condensed one
    also gets RIC_RTOL, as `test_torch_pdipm_ric.test_plain_ric_matches_pure_jax`."""
    jopts = jpdipm.PdipmOptions(backend=backend, foot_split=False, refine_steps=1,
                                kkt_scale=kkt_scale, iterations=SHORT)
    ref = jax.jit(jax.vmap(lambda q: jpdipm.solve(q, jopts)))(batch)
    got = _solve(port_qp, backend=backend, foot_split=False, kkt_scale=kkt_scale,
                 iterations=SHORT)
    rtol = RIC_RTOL if backend == "ric" else 0.0
    for name in "xszy":
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=ATOL, err_msg=name)


def test_ric2_refuses_df_with_the_jax_message(batch, port_qp):  # noqa: F811
    """ric2 is condensed: the compensated residual refines the augmented
    system only. Every entry point refuses it before any launch, with the
    JAX package's message."""
    with pytest.raises(ValueError) as jax_err:
        jpdipm.solve(jax.tree.map(lambda a: a[0], batch),
                     jpdipm.PdipmOptions(backend="ric2", refine_residual="df"))
    opts = port_opts(backend="ric2", refine_residual="df")
    before = dict(pdipm_cuda.launches)
    for solve in (tpdipm.solve, pdipm_cuda.solve, pdipm_cuda.solve_adaptive,
                  tpdipm.solve_adaptive_batch):
        with pytest.raises(ValueError) as err:
            solve(port_qp, opts)
        assert str(err.value) == str(jax_err.value)
    assert pdipm_cuda.launches == before


def test_unknown_kkt_scale_raises(port_qp):
    for solve in (tpdipm.solve, pdipm_cuda.solve):
        with pytest.raises(ValueError, match="unknown kkt_scale 'ruiz'"):
            solve(port_qp, port_opts(kkt_scale="ruiz"))


@pytest.mark.parametrize("opts, key", [
    (port_opts(), "ric_aug"), (port_opts(foot_split=False), "ric_aug_dense"),
    (port_opts(backend="ric"), "ric"),
    (port_opts(backend="ric", foot_split=False), "ric_dense"),
    (port_opts(backend="ric2", foot_split=False), "ric2"),
    (port_opts(backend="tridiag", foot_split=False), "tridiag"),
    (port_opts(backend="tridiag_aug", kkt_scale="jacobi"), "tridiag_aug")])
def test_route_picks_the_kernel_of_backend_and_split(opts, key):
    """One kernel per (backend, foot_split): the split matters on "ric" and
    "ric_aug" only, as in the JAX package."""
    assert pdipm_cuda.route(opts) == key
    assert key in pdipm_cuda.SOURCES


def test_cpu_dispatch_is_the_plain_version(port_qp):
    before = dict(pdipm_cuda.launches)
    for kw in ROUTES.values():
        opts = port_opts(iterations=2, kkt_scale="jacobi", **kw)
        _assert_state_close(pdipm_cuda.solve(port_qp, opts), tpdipm.solve(port_qp, opts), atol=0.0)
    assert pdipm_cuda.launches == before


def test_nopivot_inverse_is_the_plain_jordan_elimination():
    """gauss_jordan_inverse(pivot=False) on a quasi-definite block (SPD then
    negative definite, as the condensed stage blocks) equals the inverse,
    and takes its pivots in natural order where the pivoted form swaps."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((3, 6, 4))
    k = np.zeros((3, 6, 6))
    k[:, :4, :4] = g[:, :4].transpose(0, 2, 1) @ g[:, :4] + np.eye(4) * 1e-3
    k[:, :4, 4:] = g[:, 4:].transpose(0, 2, 1)
    k[:, 4:, :4] = g[:, 4:]
    k[:, 4:, 4:] = -np.eye(2) * 1e-2
    inv = gauss_jordan_inverse(torch.tensor(k), pivot=False).numpy()
    np.testing.assert_allclose(inv @ k, np.broadcast_to(np.eye(6), k.shape), atol=1e-9)
    pivoted = gauss_jordan_inverse(torch.tensor(k)).numpy()
    assert not np.array_equal(inv, pivoted)
    np.testing.assert_allclose(inv, pivoted, rtol=1e-9, atol=1e-9)

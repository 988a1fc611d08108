"""The torch port's plain PDIPM on the condensed route (`backend="ric"`, foot
split) and its `kkt_error` vs the JAX package: the pure-JAX route and the
Pallas kernel run by the Pallas interpreter. Float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import biped_pympc_tpu.ops.pdipm_pallas as pp
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm
from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_torch_pdipm import ATOL, _assert_state_close, batch, port_opts  # noqa: F401 (fixture)

torch.set_num_threads(1)
JAX_RIC = jpdipm.PdipmOptions(backend="ric", foot_split=True, refine_steps=1)
PORT_RIC = port_opts(backend="ric")
# The interpreted Pallas kernel is slow on the CPU: a few Newton steps cover
# every phase of the route.
INTERP_ITERS = 3
# Over 20 steps the condensed route amplifies f64 roundoff by the 1e8 scale of
# its W^-1 blocks on envs still far from converged (mu ~ 1e-3 here): the port
# and XLA sum in different orders and part at ~2e-10 relative (1e-7 on a dual
# of 441), where the augmented route holds 1e-8 absolute. The JAX package
# measures the same drift between two exact factorizations of this route
# (`tests/test_pdipm.py::test_jacobi_kkt_scale_is_exact_preconditioning`).
RIC_RTOL = 1e-9


@pytest.fixture(scope="module")
def port_qp(batch):  # noqa: F811
    return stage_qp_from_numpy(jax.tree.map(np.asarray, batch))


@pytest.fixture(scope="module")
def port_ric(port_qp):
    return tpdipm.solve(port_qp, PORT_RIC)


def test_plain_ric_matches_pure_jax(batch, port_ric):  # noqa: F811
    ref = jax.jit(jax.vmap(lambda q: jpdipm.solve(q, JAX_RIC)))(batch)
    for name in "xszy":
        np.testing.assert_allclose(getattr(port_ric, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=RIC_RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(port_ric.residuals.numpy(), np.asarray(ref.residuals),
                               rtol=1e-6, atol=1e-13)


def test_plain_ric_matches_pallas_kernel_interpreted(batch, port_qp, monkeypatch):  # noqa: F811
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pp.pl, "pallas_call", interpreted)
    ref = pp.solve(batch, JAX_RIC._replace(iterations=INTERP_ITERS), tile=4)
    got = tpdipm.solve(port_qp, port_opts(backend="ric", iterations=INTERP_ITERS))
    _assert_state_close(got, ref)
    np.testing.assert_allclose(got.residuals.numpy(), np.asarray(ref.residuals),
                               rtol=1e-6, atol=1e-13)


@pytest.mark.parametrize("backend", ["ric", "ric_aug"])
def test_kkt_error_matches_jax(batch, port_qp, backend):  # noqa: F811
    res = tpdipm.solve(port_qp, port_opts(backend=backend, iterations=5))
    jres = jpdipm.PdipmResult(*(jnp.asarray(getattr(res, n).numpy())
                                for n in ("x", "s", "z", "y", "residuals")))
    want = jax.vmap(jpdipm.kkt_error)(batch, jres)
    np.testing.assert_allclose(tpdipm.kkt_error(port_qp, res).numpy(), np.asarray(want),
                               rtol=1e-10, atol=1e-10)


def test_routes_agree_where_converged(port_qp, port_ric):
    """Condensed and augmented routes are two factorizations of one Newton
    step: at f64 they reach the same solution."""
    aug = tpdipm.solve(port_qp, port_opts())
    np.testing.assert_allclose(port_ric.x.numpy(), aug.x.numpy(), rtol=0, atol=1e-6)


def test_cpu_ric_solve_dispatches_to_plain(port_qp, port_ric):
    before = dict(pdipm_cuda.launches)
    res = pdipm_cuda.solve(port_qp, PORT_RIC)
    assert pdipm_cuda.launches == before
    _assert_state_close(res, port_ric, atol=0.0)


def test_unknown_backend_raises(port_qp):
    with pytest.raises(ValueError, match="unknown PDIPM backend"):
        tpdipm.solve(port_qp, port_opts(backend="bcr"))

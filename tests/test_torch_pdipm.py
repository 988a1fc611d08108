"""The torch port's plain PDIPM (ric_aug, foot split) vs the JAX package:
the pure-JAX route, the Pallas kernel run by the Pallas interpreter, and the
numpy golden solver. Float64 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import biped_pympc_tpu.ops.pdipm_pallas as pp
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu.ops import qp as jqp
from biped_pympc_tpu.ops import reference_pdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm
from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_pdipm import T, _make_qp

torch.set_num_threads(1)
JAX_OPTS = jpdipm.PdipmOptions(backend="ric_aug", foot_split=True, refine_steps=1)
ATOL = 1e-8


def port_opts(**kw):
    """The port's PdipmOptions on the controller's defaults (MPCConf: the
    split "ric_aug" route, one refinement pass), `kw` over them."""
    return tpdipm.PdipmOptions(**{"backend": "ric_aug", "refine_steps": 1, "foot_split": True, **kw})


def _swing_contact():
    contact = np.ones((T, 2))
    contact[2:6, 0] = 0.0
    contact[6:9, 1] = 0.0
    return contact


@pytest.fixture(scope="module")
def batch():
    """B=4 QPs of the `_make_qp` pattern, two with swing stages."""
    qs = [_make_qp(seed=s, vx=0.1 * s, contact=_swing_contact() if s % 2 else None)
          for s in range(4)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qs)


@pytest.fixture(scope="module")
def port_result(batch):
    return tpdipm.solve(stage_qp_from_numpy(jax.tree.map(np.asarray, batch)), port_opts())


def _assert_state_close(res, ref, atol=ATOL):
    for name in ("x", "s", "z", "y"):
        np.testing.assert_allclose(getattr(res, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=atol, err_msg=name)


def test_plain_matches_pure_jax(batch, port_result):
    ref = jax.jit(jax.vmap(lambda q: jpdipm.solve(q, JAX_OPTS)))(batch)
    _assert_state_close(port_result, ref)
    np.testing.assert_allclose(port_result.residuals.numpy(), np.asarray(ref.residuals),
                               rtol=1e-6, atol=1e-13)


def test_plain_matches_pallas_kernel_interpreted(batch, port_result, monkeypatch):
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pp.pl, "pallas_call", interpreted)
    ref = pp.solve(batch, JAX_OPTS, tile=4)
    _assert_state_close(port_result, ref)


def test_plain_matches_golden(batch, port_result):
    """The two-tier bound of `test_pdipm_matches_golden`."""
    for i in range(batch.f.shape[0]):
        qp = jax.tree.map(lambda a: a[i], batch)
        H, f, A, b, G, d = jqp.dense_matrices(qp)
        gx, gs, gz, gy, gres = reference_pdipm.solve(
            H, f, A, b, G, d, *reference_pdipm.initialize_variables(G, d, A.shape[0]),
            iterations=20)
        for name, want in zip("xszy", (gx, gs, gz, gy)):
            err = np.abs(getattr(port_result, name)[i].numpy() - want)
            assert np.median(err) < 3e-7, (i, name, np.sort(err)[-5:])
            assert err.max() < 1e-5, (i, name, np.sort(err)[-5:])
        np.testing.assert_allclose(port_result.residuals[i].numpy(), gres, rtol=1e-6, atol=1e-13)


@pytest.mark.parametrize("seed", range(4))
def test_plain_float32_grf_tracks_golden(seed):
    qp = _make_qp(seed=seed)
    H, f, A, b, G, d = jqp.dense_matrices(qp)
    gx, *_ = reference_pdipm.solve(
        H, f, A, b, G, d, *reference_pdipm.initialize_variables(G, d, A.shape[0]), iterations=20)
    qp32 = stage_qp_from_numpy(jax.tree.map(np.asarray, qp), dtype=torch.float32)
    res = tpdipm.solve(qp32, port_opts())
    u0 = res.x[0, 12 * T:12 * T + 12].double().numpy()
    np.testing.assert_allclose(u0, gx[12 * T:12 * T + 12], rtol=0, atol=0.05)


def test_cpu_solve_dispatches_to_plain_and_leaves_counter(batch, port_result):
    before = dict(pdipm_cuda.launches)
    res = pdipm_cuda.solve(stage_qp_from_numpy(jax.tree.map(np.asarray, batch)), port_opts())
    assert pdipm_cuda.launches == before == {"ric_aug": 0, "ric": 0, "tridiag_aug": 0, "tridiag": 0,
                                              "ric2": 0, "ric_dense": 0, "ric_aug_dense": 0,
                                              "ric_pack": 0, "ric_aug_pack": 0}
    _assert_state_close(res, port_result, atol=0.0)

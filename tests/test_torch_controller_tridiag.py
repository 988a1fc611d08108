"""The port's `MPCController` on the block-Thomas routes vs the JAX package's,
float64: `solver="tridiag_aug"` and `solver="tridiag"` against the JAX
controller with the same name (its pure-JAX routes), over a walk of three
solves; and `pallas_aug` / `pallas`, the names of the same routes, against
them in the port."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import biped_pympc_tpu as jpkg
import biped_pympc_tpu_torch as tpkg

from test_torch_controller import B
from test_torch_controller_hybrid import _assert_trace_close, _drive

torch.set_num_threads(1)


def _port(solver):
    return tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(solver=solver, verbose=False),
                              num_envs=B, gait_id=2, dtype=torch.float64, device="cpu")


@functools.lru_cache(maxsize=None)
def _walk(solver):
    jc = jpkg.MPCController(jpkg.ControllerConf(), jpkg.MPCConf(solver=solver, verbose=False),
                            num_envs=B, gait_id=2, dtype=jnp.float64)
    return _drive(jc, _port(solver))


@pytest.mark.parametrize("solver", ["tridiag_aug", "tridiag"])
def test_thomas_controller_matches_jax(solver):
    """tau and wrench within 1e-6 N(m), plus 1e-8 relative (the condensed
    route's f64 roundoff, `_assert_trace_close`); the first solve's wrench
    within 1e-6 absolute on both routes."""
    trace = _walk(solver)
    _assert_trace_close(trace)
    (_, jw), (_, tw) = trace[0]
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
    # the walk is not trivial: the right foot swings and the left carries load
    assert (np.abs(tw[:, 1, 2]) < 1.0).all()
    assert (tw[:, 0, 2] < -50.0).all()


@pytest.mark.parametrize("pallas, route", [("pallas_aug", "tridiag_aug"), ("pallas", "tridiag")])
def test_pallas_names_run_the_thomas_routes(pallas, route):
    """On the CPU `pallas_aug` / `pallas` are the plain versions of the
    routes `tridiag_aug` / `tridiag`: the same walk, bit for bit."""
    ctrl = _port(pallas)
    assert ctrl.core.opts.backend == route
    for (pt, pw), (rt, rw) in _drive(ctrl, _port(route)):
        np.testing.assert_array_equal(pt, rt)
        np.testing.assert_array_equal(pw, rw)

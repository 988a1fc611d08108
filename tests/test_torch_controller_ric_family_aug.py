"""The port's `MPCController` on the augmented Riccati routes beyond the
default vs the JAX package's, float64, the JAX Pallas kernels run by the
interpreter on the CPU: `solver="pallas_ric_aug"` with
`solver_foot_split=False` (the unsplit 30-wide stage blocks, K5d-a) and with
`solver_kkt_scale="jacobi"`; over the first two solves of the walk."""

import numpy as np
import pytest
import torch

from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_torch_controller import B
from test_torch_controller_ric_family import _drive

torch.set_num_threads(1)


@pytest.mark.parametrize("kw, route", [
    (dict(solver="pallas_ric_aug", solver_foot_split=False), "ric_aug_dense"),
    (dict(solver="pallas_ric_aug", solver_kkt_scale="jacobi"), "ric_aug")])
def test_augmented_controller_matches_jax(kw, route):
    """The augmented routes: tau and wrench within 1e-6 N(m), as
    `test_torch_controller.test_port_controller_matches_jax`."""
    trace, tc = _drive(kw)
    assert pdipm_cuda.route(tc.core.opts) == route
    for step, ((jt, jw, _), (tt, tw, _)) in enumerate(trace):
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6, err_msg=f"tau, tick {step}")
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6, err_msg=f"wrench, tick {step}")
    # the walk is not trivial: the right foot swings and the left carries load
    assert (np.abs(trace[0][1][1][:, 1, 2]) < 1.0).all()
    assert (trace[0][1][1][:, 0, 2] < -50.0).all()


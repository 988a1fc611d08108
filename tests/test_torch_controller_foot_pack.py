"""The port's `MPCController` with the foot packing (`solver_foot_pack`,
K5e: PERF.md section 6, its K5e rows) vs the JAX package's, float64, the
JAX Pallas kernels run by the interpreter on the CPU:
`solver="pallas_ric_aug"` with the packing True and "apply", the first
solve of the walk. The condensed
and hybrid paths are in `test_torch_controller_foot_pack_ric.py` and
`test_torch_controller_foot_pack_hybrid.py` (the interpreted Pallas traces
take most of each file's time)."""

import numpy as np
import pytest
import torch

from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_torch_controller_ric_family import _drive

torch.set_num_threads(1)


def drive_packed(solver, pack, **kw):
    """One tick (the first solve) of both controllers with the packing on;
    returns the trace and the port controller, after checking that the
    options map as JAX maps them onto the packed route."""
    trace, tc = _drive(dict(solver=solver, solver_foot_pack=pack, **kw), ticks=1)
    assert tc.core.opts.foot_pack == pack
    assert pdipm_cuda.route(tc.core.opts) == f"{tc.core.opts.backend}_pack"
    return trace, tc


@pytest.mark.parametrize("pack", [True, "apply"])
def test_packed_augmented_controller_matches_jax(pack):
    """tau and wrench within 1e-6 N(m), as the unpacked augmented routes."""
    trace, _ = drive_packed("pallas_ric_aug", pack)
    (jt, jw, _), (tt, tw, _) = trace[0]
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6, err_msg="tau")
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6, err_msg="wrench")
    # the walk is not trivial: the right foot swings and the left carries load
    assert (np.abs(tw[:, 1, 2]) < 1.0).all()
    assert (tw[:, 0, 2] < -50.0).all()

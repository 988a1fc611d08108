"""The port's `MPCController` in the hybrid mode with
`solver_foot_split=False` (unsplit 14-wide condensed pass, unsplit 30-wide
augmented re-solve) vs the JAX package's, float64, the JAX Pallas kernels
run by the interpreter on the CPU; over the first two solves of the walk."""

import torch

from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_torch_controller import B
from test_torch_controller_hybrid import _assert_trace_close
from test_torch_controller_ric_family import _drive

torch.set_num_threads(1)


def test_unsplit_hybrid_controller_matches_jax():
    """The hybrid keeps the split off on its augmented re-solve
    (`pdipm_pallas.py:1826-1828`): tau and wrench within the condensed
    bounds (`_assert_trace_close`), and its counters equal the JAX
    controller's on every solve."""
    trace, tc = _drive(dict(solver="pallas_hybrid", solver_foot_split=False, hybrid_budget=2,
                            hybrid_flag_tol=-1.0))
    assert pdipm_cuda.route(tc.core.opts) == "ric_dense"
    _assert_trace_close([[(jt, jw), (tt, tw)] for (jt, jw, _), (tt, tw, _) in trace])
    for (_, _, jstats), (_, _, tstats) in trace:
        assert tstats == jstats
    assert trace[0][1][2] == {"flagged": B, "nonfinite": 0, "resolved": 2, "dropped_nonfinite": 0}

"""The port's `MPCController` in the hybrid mode with the foot packing
(`solver_foot_pack` True and "apply": the packed condensed pass and the
packed augmented re-solve, `replace(opts, backend="ric_aug", aug_pivot=True)`)
vs the JAX package's, float64, the JAX Pallas kernels run by the interpreter
on the CPU: the first solve of the walk, every env re-solved."""

import pytest
import torch

from test_torch_controller import B
from test_torch_controller_foot_pack import drive_packed
from test_torch_controller_hybrid import _assert_trace_close

torch.set_num_threads(1)


@pytest.mark.parametrize("pack", [True, "apply"])
def test_packed_hybrid_controller_matches_jax(pack):
    """tau and wrench within the condensed bounds (`_assert_trace_close`),
    and the counters equal the JAX controller's."""
    trace, _ = drive_packed("pallas_hybrid", pack, hybrid_budget=B, hybrid_flag_tol=-1.0)
    _assert_trace_close([[(jt, jw), (tt, tw)] for (jt, jw, _), (tt, tw, _) in trace])
    (_, _, jstats), (_, _, tstats) = trace[0]
    assert tstats == jstats == {"flagged": B, "nonfinite": 0, "resolved": B,
                                "dropped_nonfinite": 0}

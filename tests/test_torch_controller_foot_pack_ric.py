"""The port's `MPCController` with `solver="pallas_ric"` and the foot
packing (`solver_foot_pack` True and "apply", the packed condensed route
K5e-c) vs the JAX package's, float64, the JAX Pallas kernel run by the
interpreter on the CPU: the first solve of the walk."""

import pytest
import torch

from test_torch_controller_foot_pack import drive_packed
from test_torch_controller_hybrid import _assert_trace_close

torch.set_num_threads(1)


@pytest.mark.parametrize("pack", [True, "apply"])
def test_packed_condensed_controller_matches_jax(pack):
    """tau and wrench within the condensed bounds (`_assert_trace_close`)."""
    trace, _ = drive_packed("pallas_ric", pack)
    _assert_trace_close([[(jt, jw), (tt, tw)] for (jt, jw, _), (tt, tw, _) in trace])

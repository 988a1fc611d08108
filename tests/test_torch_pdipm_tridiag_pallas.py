"""The torch port's plain PDIPM on the block-Thomas routes vs the JAX
package's Pallas kernel on the same routes (`factor` / `thomas_solve`,
`factor_aug` / `thomas_solve_aug`), run by the Pallas interpreter on the CPU:
the same algorithm, so the bound is tight. Float64."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import biped_pympc_tpu.ops.pdipm_pallas as pp
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm

from test_torch_pdipm import _assert_state_close, batch, port_opts  # noqa: F401 (fixture)
from test_torch_pdipm_ric import INTERP_ITERS

torch.set_num_threads(1)
# The interpreted Pallas kernel runs the same eliminations in the same order
# (same pivots, same closed-form x elimination); only the summation order of
# the small matvecs differs, ~1e-13 on these values.
PALLAS_ATOL = 1e-10


@pytest.mark.parametrize("backend", ["tridiag_aug", "tridiag"])
def test_plain_matches_pallas_kernel_interpreted(batch, backend, monkeypatch):  # noqa: F811
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pp.pl, "pallas_call", interpreted)
    jopts = jpdipm.PdipmOptions(backend=backend, refine_steps=1, iterations=INTERP_ITERS)
    ref = pp.solve(batch, jopts, tile=4)
    got = tpdipm.solve(stage_qp_from_numpy(jax.tree.map(np.asarray, batch)),
                       port_opts(backend=backend, iterations=INTERP_ITERS))
    _assert_state_close(got, ref, atol=PALLAS_ATOL)
    np.testing.assert_allclose(got.residuals.numpy(), np.asarray(ref.residuals),
                               rtol=1e-9, atol=1e-13)

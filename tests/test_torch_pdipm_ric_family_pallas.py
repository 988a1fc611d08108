"""The torch port's plain PDIPM on the rest of the Riccati family vs the JAX
package's Pallas kernel on the same routes, run by the Pallas interpreter on
the CPU: `factor_ric2` / `_kinv2_apply` (backend="ric2"), the unsplit
`factor_ric` and `factor_ric_aug` (foot_split=False), and `jacobi_scaled`
around the split ric_aug and the unsplit ric stage inverses. The same
eliminations in the same order, so the bound is tight. Float64."""

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
from test_torch_pdipm_tridiag_pallas import PALLAS_ATOL

torch.set_num_threads(1)


@pytest.mark.parametrize("backend, foot_split, kkt_scale", [
    ("ric2", True, "none"), ("ric", False, "none"), ("ric_aug", False, "none"),
    ("ric_aug", True, "jacobi"), ("ric", False, "jacobi")])
def test_plain_matches_pallas_kernel_interpreted(batch, backend, foot_split, kkt_scale,  # noqa: F811
                                                 monkeypatch):
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pp.pl, "pallas_call", interpreted)
    kw = dict(backend=backend, foot_split=foot_split, kkt_scale=kkt_scale,
              iterations=INTERP_ITERS)
    ref = pp.solve(batch, jpdipm.PdipmOptions(refine_steps=1, **kw), tile=4)
    got = tpdipm.solve(stage_qp_from_numpy(jax.tree.map(np.asarray, batch)),
                       port_opts(**kw))
    _assert_state_close(got, ref, atol=PALLAS_ATOL)
    np.testing.assert_allclose(got.residuals.numpy(), np.asarray(ref.residuals),
                               rtol=1e-9, atol=1e-13)

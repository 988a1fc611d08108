"""The torch port's plain PDIPM with the foot packing (`foot_pack` True and
"apply" on the split "ric" and "ric_aug" routes) vs the JAX package's Pallas
kernel on the same options, run by the Pallas interpreter on the CPU: the
paired eliminations `_gj_pair_inplace` / `_gj_pair_pivot`, the packed K^-1
apply and the packed Bd K^-1 Bd^T (`pdipm_pallas.py:630-709`, `:791-823`).
The JAX kernel ignores `kkt_scale` under the packing, and so does the port.
Float64."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import biped_pympc_tpu.ops.pdipm_pallas as pp
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm

from test_torch_pdipm import _assert_state_close, batch  # noqa: F401 (fixture)
from test_torch_pdipm_ric import INTERP_ITERS
from test_torch_pdipm_tridiag_pallas import PALLAS_ATOL

torch.set_num_threads(1)


def interpreted_vs_plain(batch, monkeypatch, **kw):  # noqa: F811
    """(plain port result, interpreted Pallas result) on `batch` with the
    options `kw` (foot split on, one refinement pass, INTERP_ITERS steps)."""
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pp.pl, "pallas_call", interpreted)
    kw = {"foot_split": True, "refine_steps": 1, "iterations": INTERP_ITERS, **kw}
    ref = pp.solve(batch, jpdipm.PdipmOptions(**kw), tile=4)
    got = tpdipm.solve(stage_qp_from_numpy(jax.tree.map(np.asarray, batch)),
                       tpdipm.PdipmOptions(**kw))
    return got, ref


def assert_matches(got, ref):
    _assert_state_close(got, ref, atol=PALLAS_ATOL)
    np.testing.assert_allclose(got.residuals.numpy(), np.asarray(ref.residuals),
                               rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("backend, foot_pack, extra", [
    ("ric", True, {}), ("ric", "apply", {}), ("ric_aug", True, {}), ("ric_aug", "apply", {}),
    ("ric_aug", True, {"aug_pivot": False}), ("ric_aug", True, {"kkt_scale": "jacobi"})],
    ids=["ric-pair", "ric-apply", "ric_aug-pair", "ric_aug-apply", "ric_aug-pair-nopivot",
         "ric_aug-pair-jacobi"])
def test_packed_plain_matches_pallas_kernel_interpreted(batch, monkeypatch, backend,  # noqa: F811
                                                        foot_pack, extra):
    assert_matches(*interpreted_vs_plain(batch, monkeypatch, backend=backend,
                                         foot_pack=foot_pack, **extra))

"""The torch port's plain PDIPM with the refinement schedule
(`refine_skip_iters`, `pdipm_pallas.py:1499-1517`), the sigma cap
(`:1248-1249`) and a non-default step rule (`frac_to_boundary`, `:412`) vs
the JAX package's Pallas kernel on the same options, run by the Pallas
interpreter on the CPU; and the schedule under the adaptive solve's chunks,
which counts it per launch as JAX's `solve_adaptive` does. Float64."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import biped_pympc_tpu.ops.pdipm_pallas as pp
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm

from test_torch_pdipm import batch  # noqa: F401 (fixture)
from test_torch_pdipm_foot_pack_pallas import assert_matches, interpreted_vs_plain
from test_torch_pdipm_ric import INTERP_ITERS

torch.set_num_threads(1)
# In the INTERP_ITERS (3) interpreted steps z / s stays below 1e4 on this
# batch, so the cap that bites there is 1e2 (the JAX package's own
# diagnostic value is 1e6).
SIGMA_CAP = 1e2


@pytest.mark.parametrize("options", [
    dict(backend="ric_aug", refine_skip_iters=2),
    dict(backend="ric_aug", sigma_cap=SIGMA_CAP), dict(backend="ric", sigma_cap=SIGMA_CAP),
    dict(backend="ric_aug", frac_to_boundary=0.95)],
    ids=["ric_aug-skip2", "ric_aug-sigma_cap", "ric-sigma_cap", "ric_aug-frac0.95"])
def test_step_options_plain_match_pallas_kernel_interpreted(batch, monkeypatch,  # noqa: F811
                                                           options):
    got, ref = interpreted_vs_plain(batch, monkeypatch, **options)
    assert_matches(got, ref)
    # the option acts: the default options give another solve (in f64 a
    # skipped refinement moves it by ~1e-11 only)
    default = tpdipm.solve(stage_qp_from_numpy(jax.tree.map(np.asarray, batch)),
                           tpdipm.PdipmOptions(foot_split=True, refine_steps=1,
                                               iterations=INTERP_ITERS,
                                               backend=options["backend"]))
    assert not torch.equal(default.x, got.x)


def test_skip_counts_per_chunk_as_jax_adaptive(batch, monkeypatch):  # noqa: F811
    """`solve_adaptive_batch` with refine_skip_iters=1 and chunks of 2 (tol 0,
    4 steps) vs the JAX kernel's `solve_adaptive`: each launch runs its first
    step unrefined, so the chunked solve is not the fixed 4-step one."""
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pp.pl, "pallas_call", interpreted)
    kw = dict(backend="ric_aug", foot_split=True, refine_steps=1, refine_skip_iters=1,
              iterations=4, iterations_per_launch=2)
    ref = pp.solve_adaptive(batch, jpdipm.PdipmOptions(**kw), 0.0, tile=4)
    qp = stage_qp_from_numpy(jax.tree.map(np.asarray, batch))
    got = tpdipm.solve_adaptive_batch(qp, tpdipm.PdipmOptions(**kw), 0.0)
    assert_matches(got, ref)
    fixed = tpdipm.solve(qp, tpdipm.PdipmOptions(**kw))
    assert not torch.equal(fixed.x, got.x)

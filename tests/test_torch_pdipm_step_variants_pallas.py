"""The torch port's plain PDIPM with the corrector forms of the Newton step
(`corrector_form`: "combined", "sum_refine", "aff_ref"; `iteration_base`,
`pdipm_pallas.py:1402-1467`) vs the JAX package's Pallas kernel on the same
options, run by the Pallas interpreter on the CPU: on the split "ric_aug"
route and, "combined", on the condensed block-Thomas route. The schedule,
cap and step-rule options are in `test_torch_pdipm_step_schedule_pallas.py`.
Float64."""

import pytest
import torch

from test_torch_pdipm import batch  # noqa: F401 (fixture)
from test_torch_pdipm_foot_pack_pallas import assert_matches, interpreted_vs_plain

torch.set_num_threads(1)


@pytest.mark.parametrize("options", [
    dict(backend="ric_aug", corrector_form="combined"),
    dict(backend="ric_aug", corrector_form="sum_refine"),
    dict(backend="ric_aug", corrector_form="aff_ref"),
    dict(backend="tridiag", corrector_form="combined")],
    ids=["ric_aug-combined", "ric_aug-sum_refine", "ric_aug-aff_ref", "tridiag-combined"])
def test_corrector_forms_plain_match_pallas_kernel_interpreted(batch, monkeypatch,  # noqa: F811
                                                              options):
    assert_matches(*interpreted_vs_plain(batch, monkeypatch, **options))

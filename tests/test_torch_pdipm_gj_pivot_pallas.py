"""The torch port's plain PDIPM with the Gauss-Jordan form and pivot knobs
vs the JAX package's Pallas kernel on the same options, run by the Pallas
interpreter on the CPU: `gj_form="tableau"` (`_gj_inverse_nopivot`, in every
no-pivot inverse) on the split "ric" route and on "ric2", `k_pivot=True` on
the unsplit "ric" route (`:921`) and `aug_pivot=False` on the split and
unsplit "ric_aug" routes (`:825`, `:1037`). Float64."""

import pytest
import torch

from test_torch_pdipm import batch  # noqa: F401 (fixture)
from test_torch_pdipm_foot_pack_pallas import assert_matches, interpreted_vs_plain

torch.set_num_threads(1)


@pytest.mark.parametrize("options", [
    dict(backend="ric", gj_form="tableau"), dict(backend="ric2", gj_form="tableau"),
    dict(backend="ric", foot_split=False, k_pivot=True),
    dict(backend="ric_aug", aug_pivot=False),
    dict(backend="ric_aug", foot_split=False, aug_pivot=False)],
    ids=["ric-tableau", "ric2-tableau", "ric-unsplit-k_pivot", "ric_aug-nopivot",
         "ric_aug-unsplit-nopivot"])
def test_gj_knobs_plain_match_pallas_kernel_interpreted(batch, monkeypatch, options):  # noqa: F811
    assert_matches(*interpreted_vs_plain(batch, monkeypatch, **options))

"""The port's `PdipmOptions` against the JAX package's: every field the Pallas
kernel reads, with JAX's names, defaults and refusals; the two forms of the
no-pivot Gauss-Jordan inverse against the JAX functions, bit for bit; the
hybrid's re-solve options; the packed routes' names; and the options as the
kernels' C interface carries them."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import biped_pympc_tpu.ops.pdipm_pallas as pp
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm
from biped_pympc_tpu_torch.ops import pdipm_cuda
from biped_pympc_tpu_torch.ops.linalg import gauss_jordan_inverse

from test_torch_pdipm import batch, port_opts  # noqa: F401 (fixture)

torch.set_num_threads(1)
# JAX fields the port leaves out: a Pallas lowering switch, and the stage
# inverse of the pure-JAX block routes (the port's follow the Pallas kernel).
LEFT_OUT = {"interpret", "inv_impl"}


def test_fields_and_defaults_are_jax_s():
    port = {f.name: f.default for f in dataclasses.fields(tpdipm.PdipmOptions)}
    jax_defaults = jpdipm.PdipmOptions()._asdict()
    assert set(port) == set(jax_defaults) - LEFT_OUT
    for name, value in port.items():
        assert value == jax_defaults[name] and type(value) is type(jax_defaults[name]), name
    assert all(f"`{name}`" in tpdipm.PdipmOptions.__doc__ for name in LEFT_OUT)


def _spd_blocks(n, dtype, seed=0, batch=256):
    """`batch` SPD n x n blocks from a seed, one pivot scaled by 1e8 (the
    condensed W^-1 scale)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((batch, n, n))
    a = m @ m.transpose(0, 2, 1) + n * np.eye(n)
    a[:, n // 2, n // 2] *= 1e8
    return a.astype(dtype)


@pytest.mark.parametrize("n", [4, 12])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("form, jax_fn", [("inplace", pp._gj_inverse_nopivot_inplace),
                                          ("tableau", pp._gj_inverse_nopivot)],
                         ids=["inplace", "tableau"])
def test_gj_form_is_jax_s_bit_for_bit(n, dtype, form, jax_fn):
    """`gauss_jordan_inverse(pivot=False, form=...)` against the JAX function
    of that form, called directly (no Pallas) op by op: every entry equal.
    The two forms round differently, so each must be the JAX one."""
    a = _spd_blocks(n, dtype)
    want = np.asarray(jax_fn(jnp.asarray(a.transpose(1, 2, 0)))).transpose(2, 0, 1)
    got = gauss_jordan_inverse(torch.tensor(a), pivot=False, form=form).numpy()
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    other = "tableau" if form == "inplace" else "inplace"
    assert not np.array_equal(gauss_jordan_inverse(torch.tensor(a), pivot=False,
                                                   form=other).numpy(), want)


@pytest.mark.parametrize("kw, match", [
    (dict(backend="ric_aug", refine_residual="df", corrector_form="sum_refine"), "sum_refine"),
    (dict(gj_form="lu"), "gj_form"), (dict(corrector_form="mehrotra"), "corrector_form"),
    (dict(foot_pack="pair"), "foot_pack"), (dict(foot_pack=1), "foot_pack")],
    ids=["df-sum_refine", "gj_form", "corrector_form", "foot_pack-str", "foot_pack-int"])
def test_refusals(kw, match):
    qp = stage_qp_from_numpy(jax.tree.map(np.asarray, _small_batch()))
    for solve in (tpdipm.solve, pdipm_cuda.solve):
        with pytest.raises(ValueError, match=match):
            solve(qp, tpdipm.PdipmOptions(**kw))
    if "refine_residual" in kw:  # the JAX kernel's own refusal
        with pytest.raises(ValueError, match="sum_refine"):
            pp.solve(_small_batch(), jpdipm.PdipmOptions(**kw))


def _small_batch():
    from test_pdipm import _make_qp

    return jax.tree.map(lambda *xs: jnp.stack(xs), *[_make_qp(seed=s) for s in range(2)])


def test_hybrid_signature_is_jax_s():
    params = inspect.signature(pdipm_cuda.solve_hybrid).parameters
    assert params["opts"].default == tpdipm.PdipmOptions()
    assert params["aug_opts"].default is None
    jparams = inspect.signature(pp.solve_hybrid).parameters
    assert [p for p in params if p != "qp"] == [p for p in jparams if p not in ("qp", "tile")]


def test_hybrid_resolves_pivoted(batch, monkeypatch):  # noqa: F811
    """With aug_pivot=False in `opts`, the re-solve runs the augmented route
    with its pivot search (`pdipm_pallas.py:1826-1828`): the re-solved envs
    equal a "ric_aug" solve with aug_pivot=True; a given `aug_opts` is used
    as it is."""
    qp = stage_qp_from_numpy(jax.tree.map(np.asarray, batch))
    opts = port_opts(backend="ric", aug_pivot=False, iterations=4)
    seen = []
    solve = pdipm_cuda.solve
    monkeypatch.setattr(pdipm_cuda, "solve", lambda q, o, *a: seen.append(o) or solve(q, o, *a))
    got = pdipm_cuda.solve_hybrid(qp, opts, budget=4, flag_tol=-1.0)
    want = tpdipm.solve(qp, dataclasses.replace(opts, backend="ric_aug", aug_pivot=True))
    assert seen == [opts, dataclasses.replace(opts, backend="ric_aug", aug_pivot=True)]
    for name in ("x", "s", "z", "y", "residuals"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-12)
    aug = port_opts(backend="ric_aug", foot_split=False, iterations=4)
    seen.clear()
    pdipm_cuda.solve_hybrid(qp, opts, budget=2, aug_opts=aug)
    assert seen == [opts, aug]


@pytest.mark.parametrize("kw, key", [
    (dict(backend="ric", foot_split=True, foot_pack=True), "ric_pack"),
    (dict(backend="ric", foot_split=True, foot_pack="apply"), "ric_pack"),
    (dict(backend="ric_aug", foot_split=True, foot_pack=True), "ric_aug_pack"),
    (dict(backend="ric_aug", foot_split=True, foot_pack="apply"), "ric_aug_pack"),
    (dict(backend="ric_aug", foot_split=False, foot_pack=True), "ric_aug_dense"),
    (dict(backend="ric2", foot_split=True, foot_pack=True), "ric2"),
    (dict(backend="tridiag", foot_split=True, foot_pack="apply"), "tridiag")])
def test_route_of_the_packing(kw, key):
    """The packed routes run only where the JAX kernel packs: the split "ric"
    / "ric_aug" routes; elsewhere the packing is ignored."""
    assert pdipm_cuda.route(tpdipm.PdipmOptions(**kw)) == key


def test_c_args_carry_every_option():
    """`PdipmArgs` is `struct PdipmArgs` (ten ints, then six doubles) and
    holds every option a kernel reads, the refinement schedule counted per
    launch (`pdipm.refine_schedule`)."""
    assert [name for name, _ in pdipm_cuda.PdipmArgs._fields_[:10]] == [
        "iterations", "refine_steps", "refine_skip", "refine_df", "kkt_jacobi", "gj_inplace",
        "aug_pivot", "k_pivot", "corrector_form", "foot_pack"]
    assert pdipm_cuda.PdipmArgs.beta.offset == 40
    opts = tpdipm.PdipmOptions(iterations=3, refine_steps=2, refine_skip_iters=5,
                               corrector_form="sum_refine", foot_pack="apply", gj_form="tableau",
                               aug_pivot=False, k_pivot=True, sigma_cap=1e6,
                               frac_to_boundary=0.95, alpha_min=1e-10, sz_floor=1e-9)
    a = pdipm_cuda.args(opts)
    assert (a.iterations, a.refine_steps, a.refine_skip, a.corrector_form, a.foot_pack,
            a.gj_inplace, a.aug_pivot, a.k_pivot) == (3, 2, 3, 2, 2, 0, 0, 1)
    assert (a.sigma_cap, a.frac_to_boundary, a.alpha_min, a.sz_floor) == (1e6, 0.95, 1e-10, 1e-9)
    assert pdipm_cuda.args(dataclasses.replace(opts, refine_steps=0)).refine_skip == 0

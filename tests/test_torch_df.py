"""The compensated (double-float) refinement residual in the torch port vs the
JAX package: `ops/df.residual_aug` against JAX's and against the f64 truth,
and the plain ric_aug solve with `refine_residual="df"` against the pure-JAX
one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu.ops import df as jdf
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu.ops import qp as jqp
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import df as tdf
from biped_pympc_tpu_torch.ops import pdipm as tpdipm
from biped_pympc_tpu_torch.ops import pdipm_cuda
from biped_pympc_tpu_torch.ops import qp as tqp

from test_pdipm import T, _make_qp
from test_torch_pdipm import port_opts

torch.set_num_threads(1)
BETA = DELTA = 1e-8
NB = 2


def _matvec(qp, hd, w, dx, dz, dy):
    """K d of the augmented reduced system, plain, in the port."""
    m1 = (hd + BETA) * dx + tqp.gT_matvec(qp, dz) + tqp.aT_matvec(qp, dy)
    mz = tqp.g_matvec(qp, dx) - w * dz
    m4 = tqp.a_matvec(qp, dx) - DELTA * dy
    return m1, mz, m4


@pytest.fixture(scope="module")
def cancellation_case():
    """The scenario of `tests/test_pdipm.py::test_df_residual_accuracy`, two
    envs: late-iteration scales (W over 1e-6..1e6, directions ~30) and
    r = K d + a 1e-4 true residual, so r - K d cancels nearly every digit."""
    qp32 = jax.tree.map(lambda a: a.astype(jnp.float32), _make_qp())
    jb32 = jax.tree.map(lambda *xs: jnp.stack(xs), *([qp32] * NB))
    rng = np.random.default_rng(3)
    w = (10.0 ** rng.uniform(-6, 6, (NB, 16 * T))).astype(np.float32)
    d = [(rng.standard_normal((NB, n * T)) * 30).astype(np.float32) for n in (24, 16, 14)]
    p64 = stage_qp_from_numpy(jax.tree.map(np.asarray, jb32), dtype=torch.float64)
    hd64 = tqp.h_diag(p64)
    t64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    m64 = _matvec(p64, hd64, t64(w), *(t64(v) for v in d))
    r = [(m.numpy() + rng.standard_normal(m.shape) * 1e-4).astype(np.float32) for m in m64]
    e_true = [np.asarray(ri, np.float64) - m.numpy() for ri, m in zip(r, m64)]
    return jb32, w, d, r, e_true


def test_residual_aug_matches_jax_and_f64_truth(cancellation_case):
    jb32, w, d, r, e_true = cancellation_case
    p32 = stage_qp_from_numpy(jax.tree.map(np.asarray, jb32), dtype=torch.float32)
    hd = tqp.h_diag(p32)
    t = torch.from_numpy
    got = tdf.residual_aug(p32, hd, t(w), BETA, DELTA, *(t(v) for v in d), *(t(v) for v in r))
    # JAX jitted with every operand an argument (constants would let XLA's
    # folder simplify the error-free transformations away).
    jf = jax.jit(jax.vmap(lambda q, hd, w, dx, dz, dy, r1, rz, r4: jdf.residual_aug(
        q, hd, w, BETA, DELTA, dx, dz, dy, r1, rz, r4)))
    want = jf(jb32, hd.numpy(), w, *d, *r)
    m32 = _matvec(p32, hd, t(w), *(t(v) for v in d))
    for name, g, wv, m, ri, et in zip(("e1", "ez", "e4"), got, want, m32, r, e_true):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=name)
        scale = np.abs(et).max() + 1e-30
        err_df = np.abs(g.numpy() - et).max() / scale
        err_f32 = np.abs((t(ri) - m).numpy() - et).max() / scale
        # The bounds of test_df_residual_accuracy: df ~f32-eps accurate
        # relative to the residual, f32 loses most digits.
        assert err_df < 1e-6, (name, err_df)
        assert err_df < err_f32 / 100, (name, err_f32, err_df)


def test_eft_primitives_are_exact():
    """two_sum / two_prod in f32 against exact f64 arithmetic."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy((rng.standard_normal(1000) * 10.0 ** rng.uniform(-3, 3, 1000))
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(1000) * 10.0 ** rng.uniform(-3, 3, 1000))
                         .astype(np.float32))
    s, e = tdf.two_sum(a, b)
    np.testing.assert_array_equal(s.double() + e.double(), a.double() + b.double())
    p, e = tdf.two_prod(a, b)
    np.testing.assert_array_equal(p.double() + e.double(), a.double() * b.double())


@pytest.fixture(scope="module")
def stress_batch():
    """The 4 QPs of `test_pallas_df_refine_residual`."""
    qs = [_make_qp(seed=s, dtype=jnp.float64, vx=0.1 * s) for s in range(4)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qs)


def test_plain_df_solve_matches_pure_jax_f64(stress_batch):
    qp = stage_qp_from_numpy(jax.tree.map(np.asarray, stress_batch))
    got = tpdipm.solve(qp, port_opts(iterations=6, refine_residual="df"))
    jopts = jpdipm.PdipmOptions(backend="ric_aug", foot_split=True, refine_steps=1,
                                iterations=6, refine_residual="df")
    ref = jax.jit(jax.vmap(lambda q: jpdipm.solve(q, jopts)))(stress_batch)
    for name in "xszy":
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    # At f64 the compensated residual changes the solve only at roundoff.
    plain = tpdipm.solve(qp, port_opts(iterations=6))
    np.testing.assert_allclose(got.x.numpy(), plain.x.numpy(), rtol=1e-9, atol=1e-9)


def test_plain_df_solve_f32_tracks_the_f64_anchor(stress_batch):
    """As `test_pallas_df_refine_residual`: at f32 the df solve stays finite
    and is at least as close to the f64 anchor as the plain-residual one
    (within 2x)."""
    opts = port_opts(iterations=6)
    df = port_opts(iterations=6, refine_residual="df")
    anchor = tpdipm.solve(stage_qp_from_numpy(jax.tree.map(np.asarray, stress_batch)), opts).x
    q32 = stage_qp_from_numpy(jax.tree.map(np.asarray, stress_batch), dtype=torch.float32)
    plain32, df32 = tpdipm.solve(q32, opts).x, tpdipm.solve(q32, df).x
    assert torch.isfinite(df32).all()
    e_plain = float((plain32.double() - anchor).abs().max())
    e_df = float((df32.double() - anchor).abs().max())
    assert e_df <= 2.0 * e_plain, (e_plain, e_df)


def test_df_on_the_condensed_route_raises(stress_batch):
    qp = stage_qp_from_numpy(jax.tree.map(np.asarray, stress_batch))
    opts = port_opts(backend="ric", refine_residual="df")
    for solve in (tpdipm.solve, pdipm_cuda.solve, pdipm_cuda.solve_hybrid,
                  tpdipm.solve_adaptive_batch):
        with pytest.raises(ValueError, match="aug"):
            solve(qp, opts)
    with pytest.raises(ValueError, match="refine_residual"):
        tpdipm.solve(qp, port_opts(refine_residual="f64"))

"""The torch port's hybrid speed mode (`pdipm_cuda.solve_hybrid`) vs the JAX
package's `pdipm_pallas.solve_hybrid`, whose Pallas kernels run by the Pallas
interpreter. Float64, B = 4, a few Newton steps (the interpreter is slow).
The settings and the poisoned fast paths mirror
`tests/test_pdipm_pallas.py::test_pallas_hybrid_merge_logic`,
`test_pallas_hybrid_nan_rescue` and `test_hybrid_stats_and_budget_exceeded`."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import biped_pympc_tpu.ops.pdipm_pallas as pp
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm
from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_torch_pdipm import _assert_state_close, batch, port_opts  # noqa: F401 (fixture)

torch.set_num_threads(1)
ITERS = 3
JAX_OPTS = jpdipm.PdipmOptions(backend="ric", foot_split=True, refine_steps=1, iterations=ITERS)
PORT_OPTS = port_opts(backend="ric", iterations=ITERS)
AUG_OPTS = dataclasses.replace(PORT_OPTS, backend="ric_aug")
STATS = ("flagged", "nonfinite", "resolved", "dropped_nonfinite")


@pytest.fixture(scope="module")
def interpreted():
    """The JAX kernels under the Pallas interpreter. `pp.solve` is jitted with
    its options static, so the hybrid's fast pass and each re-solve size are
    traced once for the module (an interpreted trace takes ~9 s on a CPU)."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pp.pl, "pallas_call", patched)
        mp.setattr(pp, "solve", jax.jit(pp.solve, static_argnums=(1, 2)))
        yield mp


@pytest.fixture(scope="module")
def port_qp(batch):  # noqa: F811
    return stage_qp_from_numpy(jax.tree.map(np.asarray, batch))


@pytest.fixture(scope="module")
def fast(port_qp):
    return tpdipm.solve(port_qp, PORT_OPTS)


@pytest.fixture(scope="module")
def robust(port_qp):
    return tpdipm.solve(port_qp, AUG_OPTS)


def _stats(st):
    return tuple(int(getattr(st, n)) for n in STATS)


def _poison(monkeypatch, module, solve_name, envs_x=(), envs_res=()):
    """Make the fast pass of `module`'s hybrid return NaN in x of envs_x and
    in the residuals of envs_res (the two failure shapes of the fast path)."""
    orig = getattr(module, solve_name)

    def poisoned(qp, opts, *args, **kwargs):
        res = orig(qp, opts, *args, **kwargs)
        if qp.f.shape[0] != 4 or opts.backend != "ric":
            return res
        if module is pp:
            for i in envs_x:
                res = res._replace(x=res.x.at[i].set(jnp.nan))
            for i in envs_res:
                res = res._replace(residuals=res.residuals.at[i].set(jnp.nan))
        else:
            res.x[list(envs_x)] = math.nan
            res.residuals[list(envs_res)] = math.nan
        return res

    monkeypatch.setattr(module, solve_name, poisoned)


@pytest.mark.parametrize("budget, flag_tol, flag", [
    (4, math.inf, "resid"), (4, -1.0, "resid"), (2, -1.0, "resid"), (2, -1.0, "kkt")])
def test_hybrid_matches_jax(batch, port_qp, fast, robust, interpreted,  # noqa: F811
                            budget, flag_tol, flag):
    want, want_st = pp.solve_hybrid(batch, JAX_OPTS, budget=budget, flag_tol=flag_tol, tile=4,
                                    flag=flag, with_stats=True)
    got, got_st = pdipm_cuda.solve_hybrid(port_qp, PORT_OPTS, budget=budget, flag_tol=flag_tol,
                                          flag=flag, with_stats=True)
    _assert_state_close(got, want)
    np.testing.assert_allclose(got.residuals.numpy(), np.asarray(want.residuals),
                               rtol=1e-6, atol=1e-13)
    assert _stats(got_st) == _stats(want_st)
    assert all(getattr(got_st, n).dtype == torch.int32 for n in STATS)

    # Within the port: unflagged envs keep the fast pass bitwise, re-solved
    # envs carry the augmented route's solution.
    crit = (tpdipm.kkt_error(port_qp, fast) if flag == "kkt" else fast.residuals).amax(1)
    redone = set() if flag_tol == math.inf else set(torch.argsort(crit)[-budget:].tolist())
    assert int(got_st.resolved) == len(redone)
    for i in range(4):
        if i in redone:
            torch.testing.assert_close(got.x[i], robust.x[i], rtol=0, atol=1e-12)
        else:
            assert torch.equal(got.x[i], fast.x[i]) and torch.equal(got.z[i], fast.z[i])


def test_nan_rescue(batch, port_qp, fast, robust, interpreted, monkeypatch):  # noqa: F811
    """A NaN solution under a finite criterion (env 1) and a NaN criterion
    (env 2) are re-solved even with the tolerance gate off."""
    _poison(monkeypatch, pdipm_cuda, "solve", envs_x=(1,), envs_res=(2,))
    _poison(monkeypatch, pp, "solve", envs_x=(1,), envs_res=(2,))
    got, st = pdipm_cuda.solve_hybrid(port_qp, PORT_OPTS, budget=2, flag_tol=math.inf,
                                      with_stats=True)
    _, want_st = pp.solve_hybrid(batch, JAX_OPTS, budget=2, flag_tol=np.inf, tile=4,
                                 with_stats=True)
    assert torch.isfinite(got.x).all()
    for i in (1, 2):
        torch.testing.assert_close(got.x[i], robust.x[i], rtol=0, atol=1e-12)
    for i in (0, 3):
        assert torch.equal(got.x[i], fast.x[i])
    assert _stats(st) == _stats(want_st) == (2, 2, 2, 0)


def test_auto_budget_resolves_every_env_of_a_small_batch(port_qp, robust):
    """budget <= 0 is max(64, B // 32), clamped to B: at flag_tol = -1 every
    env takes the augmented solution."""
    got = pdipm_cuda.solve_hybrid(port_qp, PORT_OPTS, budget=0, flag_tol=-1.0)
    _assert_state_close(got, robust, atol=1e-12)


def test_budget_exceeded_is_counted_and_ties_rescue_the_lower_index(
        batch, port_qp, interpreted, monkeypatch):  # noqa: F811
    """Three non-finite envs and a budget of two: the guarantee lapses on one
    env and `dropped_nonfinite` says so. All three rank +inf; as in
    jax.lax.top_k the lower indices take the slots, so env 3 stays NaN in
    both packages."""
    _poison(monkeypatch, pdipm_cuda, "solve", envs_x=(3, 1, 2))
    _poison(monkeypatch, pp, "solve", envs_x=(3, 1, 2))
    got, st = pdipm_cuda.solve_hybrid(port_qp, PORT_OPTS, budget=2, flag_tol=math.inf,
                                      with_stats=True)
    want, want_st = pp.solve_hybrid(batch, JAX_OPTS, budget=2, flag_tol=np.inf, tile=4,
                                    with_stats=True)
    assert _stats(st) == _stats(want_st) == (3, 3, 2, 1)
    bad = (~torch.isfinite(got.x).all(1)).nonzero().flatten().tolist()
    want_bad = np.flatnonzero(~np.isfinite(np.asarray(want.x)).all(1)).tolist()
    assert bad == want_bad == [3]


def test_unknown_flag_raises(port_qp):
    with pytest.raises(ValueError, match="hybrid flag"):
        pdipm_cuda.solve_hybrid(port_qp, PORT_OPTS, flag="max")

"""The adaptive-iteration solve in the torch port vs the JAX package: the
warm-started plain solve (`solve(state=)`), `solve_adaptive_batch` with its
exact loop semantics (the stop test, the remainder chunk, NaN ending the
loop), and `MPCController` with `MPCConf.adaptive_tol`. Float64, both ported
routes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import biped_pympc_tpu as jpkg
import biped_pympc_tpu_torch as tpkg
from biped_pympc_tpu.ops import pdipm as jpdipm
from biped_pympc_tpu_torch.convert import stage_qp_from_numpy
from biped_pympc_tpu_torch.ops import pdipm as tpdipm
from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_torch_controller import _obs
from test_torch_pdipm import ATOL, batch, port_opts  # noqa: F401 (fixture)
from test_torch_pdipm_ric import RIC_RTOL

torch.set_num_threads(1)
BACKENDS = ["ric_aug", "ric"]
# The route tolerances of tests/test_torch_pdipm.py and test_torch_pdipm_ric.py.
RTOL = {"ric_aug": 0.0, "ric": RIC_RTOL}
FIELDS = ("x", "s", "z", "y", "residuals")


def _jax_opts(backend, **kw):
    return jpdipm.PdipmOptions(backend=backend, foot_split=True, refine_steps=1, **kw)


def _port_qp(batch):  # noqa: F811
    return stage_qp_from_numpy(jax.tree.map(np.asarray, batch))


def _assert_bit_equal(a, b):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(a, name).numpy(), getattr(b, name).numpy(),
                                      err_msg=name)


def _assert_close_to_jax(res, ref, backend):
    for name in "xszy":
        np.testing.assert_allclose(getattr(res, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=RTOL[backend], atol=ATOL, err_msg=name)
    np.testing.assert_allclose(res.residuals.numpy(), np.asarray(ref.residuals),
                               rtol=1e-6, atol=1e-13)


@pytest.mark.parametrize("backend", BACKENDS)
def test_plain_warm_chunks_bit_equal_fixed(batch, backend):  # noqa: F811
    """1 + 1 iterations, the second from the first's returned state, are the
    2-iteration solve bit for bit: the loop carries only (x, s, z, y)."""
    qp = _port_qp(batch)
    one = port_opts(backend=backend, iterations=1)
    r1 = tpdipm.solve(qp, one)
    r2 = tpdipm.solve(qp, one, tpdipm.PdipmState(r1.x, r1.s, r1.z, r1.y))
    _assert_bit_equal(r2, tpdipm.solve(qp, port_opts(backend=backend, iterations=2)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_solve_matches_jax(batch, backend):  # noqa: F811
    """Port `solve(state=)` vs JAX `pdipm.solve(q, opts, state)`, vmapped,
    from the state of a 3-iteration solve."""
    qp = _port_qp(batch)
    start = tpdipm.solve(qp, port_opts(backend=backend, iterations=3))
    st = tpdipm.PdipmState(start.x, start.s, start.z, start.y)
    got = tpdipm.solve(qp, port_opts(backend=backend, iterations=2), st)
    jst = jpdipm.PdipmState(*(jnp.asarray(getattr(st, n).numpy()) for n in "xszy"))
    opts = _jax_opts(backend, iterations=2)
    ref = jax.jit(jax.vmap(lambda q, s: jpdipm.solve(q, opts, s)))(batch, jst)
    _assert_close_to_jax(got, ref, backend)


# (iterations, iterations_per_launch, tol, Newton steps run): the full cap,
# one chunk, and a cap of 3 = one chunk of 2 + a remainder of 1.
ADAPTIVE_CASES = [(4, 2, 0.0, 4), (4, 2, 1e12, 2), (3, 2, 0.0, 3)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("iterations, per_launch, tol, steps", ADAPTIVE_CASES,
                         ids=["tol0", "tol1e12", "remainder"])
def test_solve_adaptive_batch_matches_jax(batch, backend, iterations, per_launch, tol,  # noqa: F811
                                          steps):
    qp = _port_qp(batch)
    opts = port_opts(backend=backend, iterations=iterations,
                               iterations_per_launch=per_launch)
    got = tpdipm.solve_adaptive_batch(qp, opts, tol)
    # The chunks are the fixed solve of as many steps, bit for bit.
    _assert_bit_equal(got, tpdipm.solve(qp, port_opts(backend=backend,
                                                                iterations=steps)))
    ref = jpdipm.solve_adaptive_batch(
        batch, _jax_opts(backend, iterations=iterations, iterations_per_launch=per_launch), tol)
    _assert_close_to_jax(got, ref, backend)
    # The CPU dispatch of the kernel wrapper runs the plain loop.
    before = dict(pdipm_cuda.launches)
    _assert_bit_equal(pdipm_cuda.solve_adaptive(qp, opts, tol), got)
    assert pdipm_cuda.launches == before


@pytest.mark.parametrize("backend", BACKENDS)
def test_nan_ends_the_loop_for_the_whole_batch(batch, backend):  # noqa: F811
    """A NaN in one env's residuals makes max(res) > tol false after the
    first chunk, so no env gets a second one, on both sides (ROADMAP,
    Queue 3: mirrored for parity, not fixed)."""
    f = np.asarray(batch.f).copy()
    f[1, 0] = np.nan
    bad = batch._replace(f=jnp.asarray(f))
    qp = _port_qp(bad)
    opts = port_opts(backend=backend, iterations=4, iterations_per_launch=2)
    got = tpdipm.solve_adaptive_batch(qp, opts, 0.0)
    first = tpdipm.solve(qp, port_opts(backend=backend, iterations=2))
    assert torch.isnan(got.residuals[1]).all() and torch.isfinite(got.residuals[[0, 2, 3]]).all()
    _assert_bit_equal(got, first)
    jopts = _jax_opts(backend, iterations=4, iterations_per_launch=2)
    ref = jpdipm.solve_adaptive_batch(bad, jopts, 0.0)
    jfirst = jax.vmap(lambda q: jpdipm.solve(q, jopts._replace(iterations=2)))(bad)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      np.asarray(getattr(jfirst, name)), err_msg=name)
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=max(RTOL[backend], 1e-6 if name == "residuals" else 0.0),
                                   atol=ATOL, err_msg=name)


def test_warm_state_on_the_cpu_dispatch(batch):  # noqa: F811
    qp = _port_qp(batch)
    start = tpdipm.solve(qp, port_opts(iterations=1))
    st = tpdipm.PdipmState(start.x, start.s, start.z, start.y)
    opts = port_opts(iterations=2)
    _assert_bit_equal(pdipm_cuda.solve(qp, opts, st), tpdipm.solve(qp, opts, st))


def test_adaptive_options_are_checked(batch):  # noqa: F811
    qp = _port_qp(batch)
    with pytest.raises(ValueError, match="iterations_per_launch"):
        tpdipm.solve_adaptive_batch(qp, port_opts(iterations_per_launch=0))
    with pytest.raises(ValueError, match="unknown PDIPM backend"):
        pdipm_cuda.solve_adaptive(qp, port_opts(backend="bcr"))


# --- MPCController with MPCConf.adaptive_tol, port vs JAX ---------------------

B = 8
TICKS = 30
# On this walk every chunk's max(res) lies in [10.9, 70.2] (f64, chunks of
# 5): 1e3 stops every solve after its first chunk, 0.5 never stops. Both are
# over 10x from every value, so roundoff cannot flip the discrete stop; the
# test checks that margin on the values it records.
ADAPTIVE_TOLS = {"one_chunk": (1e3, 1), "full_cap": (0.5, 4)}


@functools.lru_cache(maxsize=None)
def _drive_adaptive(tol):
    rng = np.random.default_rng(0)
    obs = _obs(B, rng)
    twist = np.zeros((B, 3))
    twist[:, 0] = rng.uniform(0.0, 0.4, B)
    height = np.full(B, 0.55)
    jc = jpkg.MPCController(
        jpkg.ControllerConf(), jpkg.MPCConf(solver="ric_aug", adaptive_tol=tol, verbose=False),
        num_envs=B, gait_id=2, dtype=jnp.float64)
    tc = tpkg.MPCController(
        tpkg.ControllerConf(), tpkg.MPCConf(solver="ric_aug", adaptive_tol=tol, verbose=False),
        num_envs=B, gait_id=2, dtype=torch.float64, device="cpu")
    plain_solve = tpdipm.solve
    chunk_max = []  # per port solve: max(res) after each chunk that ran

    def recording_solve(qp, opts=port_opts(), state=None):
        r = plain_solve(qp, opts, state)
        chunk_max[-1].append(float(r.residuals.amax()))
        return r

    for c in (jc, tc):
        c.set_command(twist, height)
    trace = []
    mp = pytest.MonkeyPatch()
    mp.setattr(tpdipm, "solve", recording_solve)
    try:
        for step in range(TICKS):
            for c in (jc, tc):
                c.update_state(obs)
                if step % 10 == 0:
                    if c is tc:
                        chunk_max.append([])
                    c.run_mpc()
                c.run_lowlevel()
            trace.append([(np.asarray(c.get_action()), np.asarray(c.ground_reaction_wrench))
                          for c in (jc, tc)])
    finally:
        mp.undo()
    return jc, tc, trace, chunk_max


@pytest.mark.parametrize("case", list(ADAPTIVE_TOLS))
def test_adaptive_controller_matches_jax(case):
    tol, chunks = ADAPTIVE_TOLS[case]
    jc, tc, trace, chunk_max = _drive_adaptive(tol)
    seen = [v for solve in chunk_max for v in solve]
    assert all(v >= 10 * tol or v <= tol / 10 for v in seen), (tol, chunk_max)
    assert [len(solve) for solve in chunk_max] == [chunks] * (TICKS // 10), (tol, chunk_max)
    for step, ((jt, jw), (tt, tw)) in enumerate(trace):
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6, err_msg=f"tau, tick {step}")
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6, err_msg=f"wrench, tick {step}")
    np.testing.assert_allclose(np.asarray(tc.solver_residuals), np.asarray(jc.solver_residuals),
                               rtol=1e-6, atol=1e-12)


def test_full_cap_equals_the_fixed_controller():
    """Chunked to the cap, the adaptive controller is the fixed one bit for bit."""
    _, tc, trace, _ = _drive_adaptive(ADAPTIVE_TOLS["full_cap"][0])
    fixed = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(solver="ric_aug", verbose=False),
                               num_envs=B, gait_id=2, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    obs = _obs(B, rng)
    twist = np.zeros((B, 3))
    twist[:, 0] = rng.uniform(0.0, 0.4, B)
    fixed.set_command(twist, np.full(B, 0.55))
    fixed.update_state(obs)
    fixed.run_mpc()
    np.testing.assert_array_equal(fixed.ground_reaction_wrench.numpy(), trace[0][1][1])


def test_hybrid_ignores_adaptive_tol():
    obs = _obs(4, np.random.default_rng(3))
    wrenches = []
    for tol in (0.0, 1e3):
        c = tpkg.MPCController(tpkg.ControllerConf(),
                               tpkg.MPCConf(solver="pallas_hybrid", adaptive_tol=tol,
                                            verbose=False),
                               num_envs=4, gait_id=2, dtype=torch.float64, device="cpu")
        c.set_command(np.tile([0.2, 0.0, 0.0], (4, 1)), np.full(4, 0.55))
        c.update_state(obs)
        c.run_mpc()
        wrenches.append(c.ground_reaction_wrench.numpy())
    np.testing.assert_array_equal(wrenches[0], wrenches[1])

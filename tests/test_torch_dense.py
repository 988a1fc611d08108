"""solver="dense" in the port (a batched LU of the whole condensed reduced KKT,
`ops/pdipm.py`) against the JAX package's pure-JAX "dense" route (XLA's LU),
float64: the solver alone and the controller over a few ticks."""

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

from test_pdipm import _make_qp
from test_torch_controller import _obs

torch.set_num_threads(1)
B = 4
RTOL = 1e-8  # relative to max(1, |v|)


@pytest.fixture(scope="module")
def batch():
    contact = np.ones((10, 2))
    contact[2:6, 0] = 0.0
    qs = [_make_qp(seed=s, vx=0.1 * s, contact=contact if s % 2 else None) for s in range(B)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qs)


# The controller's options (one refinement pass) over the whole solve, and
# the unrefined route over 8 Newton steps: without refinement two correct
# factorizations part by ~1e-8 relative over the late, non-converged steps of
# this batch (the port's "ric" route reads 7.1e-8 against JAX's "dense"
# after 20 unrefined steps, 4.2e-9 after 8), as the tests of the other
# routes count them (tests/test_torch_port_rules.py).
@pytest.mark.parametrize("refine_steps, iterations", [(1, 20), (0, 8)])
def test_dense_solve_matches_jax(batch, refine_steps, iterations):
    ref = jax.jit(jax.vmap(lambda q: jpdipm.solve(q, jpdipm.PdipmOptions(
        backend="dense", refine_steps=refine_steps, iterations=iterations))))(batch)
    qp = stage_qp_from_numpy(jax.tree.map(np.asarray, batch))
    opts = tpdipm.PdipmOptions(backend="dense", refine_steps=refine_steps, iterations=iterations)
    for res in (tpdipm.solve(qp, opts), pdipm_cuda.solve(qp, opts)):
        for name in ("x", "s", "z", "y"):
            got, want = getattr(res, name).numpy(), np.asarray(getattr(ref, name))
            assert (np.abs(got - want) / np.maximum(1.0, np.abs(want))).max() <= RTOL, name
        np.testing.assert_allclose(res.residuals.numpy(), np.asarray(ref.residuals), rtol=1e-6,
                                   atol=1e-12)


def test_dense_refuses_the_df_residual():
    with pytest.raises(ValueError, match="aug backends only"):
        tpdipm.check_options(tpdipm.PdipmOptions(backend="dense", refine_residual="df"))


def test_dense_controller_matches_jax():
    """30 ticks, 3 solves, of `MPCController(solver="dense")` on both sides."""
    n = 3
    rng = np.random.default_rng(4)
    obs = _obs(n, rng)
    twist = np.zeros((n, 3))
    twist[:, 0] = rng.uniform(0.0, 0.4, n)
    jc = jpkg.MPCController(jpkg.ControllerConf(), jpkg.MPCConf(solver="dense", verbose=False),
                            num_envs=n, gait_id=2, dtype=jnp.float64)
    tc = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(solver="dense", verbose=False),
                            num_envs=n, gait_id=2, dtype=torch.float64, device="cpu")
    for c in (jc, tc):
        c.set_command(twist, np.full(n, 0.55))
    for step in range(30):
        for c in (jc, tc):
            c.update_state(obs)
            if step % 10 == 0:
                c.run_mpc()
            c.run_lowlevel()
        np.testing.assert_allclose(np.asarray(tc.get_action()), np.asarray(jc.get_action()),
                                   rtol=0, atol=1e-6, err_msg=f"tau, tick {step}")
        np.testing.assert_allclose(np.asarray(tc.ground_reaction_wrench),
                                   np.asarray(jc.ground_reaction_wrench), rtol=0, atol=1e-6,
                                   err_msg=f"wrench, tick {step}")
    assert (np.asarray(tc.ground_reaction_wrench)[:, 0, 2] < -50.0).all()

"""The port's `MPCController` on the rest of the Riccati family vs the JAX
package's, float64, the JAX Pallas kernels run by the interpreter on the CPU:
`solver="pallas_ric2"`, `solver_foot_split=False` on `pallas_ric`, and
`solver_kkt_scale="jacobi"` on `pallas_ric`; over the first two solves of
the walk. Also the options the port maps and refuses as the JAX controller
does. The routes that run the augmented kernels are in
`test_torch_controller_ric_family_aug.py`, the unsplit hybrid in
`test_torch_controller_ric_family_hybrid.py` (the interpreted Pallas traces
take most of each file's time)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import biped_pympc_tpu as jpkg
import biped_pympc_tpu_torch as tpkg
from biped_pympc_tpu_torch.ops import pdipm_cuda

from test_torch_controller import B, _obs
from test_torch_controller_hybrid import _assert_trace_close

torch.set_num_threads(1)
TICKS = 11  # two solves, every 10 ticks


def _drive(kw, ticks=TICKS):
    """Walk the JAX and the port controller in lockstep from the same
    perturbed standing pose and command for `ticks` ticks; returns per tick
    [(tau, wrench, hybrid_stats) x 2] and the port controller."""
    kw = dict(kw, verbose=False)
    jc = jpkg.MPCController(jpkg.ControllerConf(), jpkg.MPCConf(**kw), num_envs=B, gait_id=2,
                            dtype=jnp.float64)
    tc = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(**kw), num_envs=B, gait_id=2,
                            dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    obs = _obs(B, rng)
    twist = np.zeros((B, 3))
    twist[:, 0] = rng.uniform(0.0, 0.4, B)
    twist[:, 2] = rng.uniform(-0.2, 0.2, B)
    mu = rng.uniform(0.6, 1.0, B)
    for c in (jc, tc):
        c.set_command(twist, np.full(B, 0.55))
        c.set_contact_parameters(mu=mu)
    trace = []
    for step in range(ticks):
        for c in (jc, tc):
            c.update_state(obs)
            if step % 10 == 0:
                c.run_mpc()
            c.run_lowlevel()
        trace.append([(np.asarray(c.get_action()), np.asarray(c.ground_reaction_wrench),
                       dict(c.hybrid_stats)) for c in (jc, tc)])
    return trace, tc


@pytest.mark.parametrize("kw", [
    dict(solver="pallas_ric2"), dict(solver="pallas_ric", solver_foot_split=False),
    dict(solver="pallas_ric", solver_kkt_scale="jacobi")],
    ids=["ric2", "ric_unsplit", "ric_jacobi"])
def test_condensed_controller_matches_jax(kw):
    """The condensed routes: tau and wrench within 1e-6 N(m) plus 1e-8
    relative (`_assert_trace_close`)."""
    trace, _ = _drive(kw)
    _assert_trace_close([[(jt, jw), (tt, tw)] for (jt, jw, _), (tt, tw, _) in trace])


@pytest.mark.parametrize("kw, backend, split, scale", [
    (dict(solver="pallas_ric2"), "ric2", False, "none"),
    (dict(solver="pallas_ric2", solver_foot_split=True), "ric2", False, "none"),
    (dict(solver="ric", solver_foot_split=False), "ric", False, "none"),
    (dict(solver="pallas_hybrid", solver_kkt_scale="jacobi"), "ric", True, "jacobi"),
    (dict(solver="pallas_aug", solver_foot_split=True, solver_kkt_scale="jacobi"),
     "tridiag_aug", False, "jacobi"),
    (dict(solver="tridiag", solver_foot_pack=True), "tridiag", False, "none"),
    (dict(solver="ric_aug", solver_foot_pack=True), "ric_aug", True, "none"),
    (dict(solver="pallas_ric", solver_foot_split=False, solver_foot_pack="apply"), "ric", False,
     "none")])
def test_options_map_as_the_jax_controller(kw, backend, split, scale):
    """`foot_split = solver_foot_split and backend in ("ric", "ric_aug")`,
    the KKT scaling as given (`biped_pympc_tpu/control/controller.py:121-147`);
    a foot packing JAX would ignore (no split, a pure route name, a
    block-Thomas route) is ignored."""
    ctrl = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(verbose=False, **kw),
                              num_envs=1, device="cpu")
    opts = ctrl.core.opts
    assert (opts.backend, opts.foot_split, opts.kkt_scale) == (backend, split, scale)
    jc = jpkg.MPCController(jpkg.ControllerConf(), jpkg.MPCConf(verbose=False, **kw),
                            num_envs=1)
    assert (jc.core.opts.backend, jc.core.opts.foot_split, jc.core.opts.kkt_scale) == \
        (backend, split, scale)
    assert not jc.core.opts.foot_pack


@pytest.mark.parametrize("solver, pack", [("pallas_ric_aug", True), ("pallas_ric", "apply"),
                                          ("pallas_hybrid", True)])
def test_foot_pack_raises_where_jax_packs(solver, pack):
    """Where the JAX controller packs the feet (K5e: PERF.md section 6, its
    K5e rows), the port maps every option as it does, the packing's value
    included, onto the packed route, and runs it (its plain version here;
    the wrench against JAX's is in test_torch_controller_foot_pack*.py)."""
    conf = dict(solver=solver, solver_foot_pack=pack, verbose=False)
    tc = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(**conf), num_envs=1,
                            device="cpu")
    jc = jpkg.MPCController(jpkg.ControllerConf(), jpkg.MPCConf(**conf), num_envs=1)
    jopts = jc.core.opts._asdict()
    assert jopts["foot_pack"] == pack
    assert dataclasses.asdict(tc.core.opts) == {
        k: v for k, v in jopts.items() if k not in ("interpret", "inv_impl")}
    assert pdipm_cuda.route(tc.core.opts) == f"{tc.core.opts.backend}_pack"
    tc.update_state(_obs(1, np.random.default_rng(0)))
    tc.run_mpc()
    assert np.isfinite(np.asarray(tc.ground_reaction_wrench)).all()

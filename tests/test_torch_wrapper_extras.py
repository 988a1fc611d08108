"""The wrapper methods of `biped_pympc_tpu/wrapper.py` that the torch port's
`MPCController` gained with the adaptive slice: `set_srbd_residual` (port vs
JAX, f64), `save_state` / `load_state`, `to_numpy`, and the residual state
carried over by `convert.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import biped_pympc_tpu as jpkg
import biped_pympc_tpu_torch as tpkg
from biped_pympc_tpu_torch.convert import controller_state_from_numpy

from test_torch_controller import _obs

torch.set_num_threads(1)
B = 4


def _residuals(seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.05, 0.05, (B, 12, 12)), rng.uniform(-0.02, 0.02, (B, 12, 12))


def _port(num_envs=B, dtype=torch.float64):
    c = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(verbose=False), num_envs=num_envs,
                           gait_id=2, dtype=dtype, device="cpu")
    c.set_command(np.tile([0.2, 0.0, 0.1], (num_envs, 1)), np.full(num_envs, 0.55))
    return c


def _ticks(c, obs, n, start=0):
    for step in range(start, start + n):
        c.update_state(obs)
        if step % 10 == 0:
            c.run_mpc()
        c.run_lowlevel()


def test_srbd_residual_controller_matches_jax():
    a_res, b_res = _residuals()
    obs = _obs(B, np.random.default_rng(4))
    jc = jpkg.MPCController(jpkg.ControllerConf(),
                            jpkg.MPCConf(solver="ric_aug", verbose=False),
                            num_envs=B, gait_id=2, dtype=jnp.float64)
    tc = tpkg.MPCController(tpkg.ControllerConf(),
                            tpkg.MPCConf(solver="ric_aug", verbose=False),
                            num_envs=B, gait_id=2, dtype=torch.float64, device="cpu")
    free = _port()
    for c in (jc, tc, free):
        c.set_command(np.tile([0.2, 0.0, 0.1], (B, 1)), np.full(B, 0.55))
    for c in (jc, tc):
        c.set_srbd_residual(a_res, b_res)
    for step in range(11):
        for c in (jc, tc, free):
            _ticks(c, obs, 1, step)
        np.testing.assert_allclose(np.asarray(tc.get_action()), np.asarray(jc.get_action()),
                                   rtol=0, atol=1e-6, err_msg=f"tau, tick {step}")
        np.testing.assert_allclose(np.asarray(tc.ground_reaction_wrench),
                                   np.asarray(jc.ground_reaction_wrench), rtol=0, atol=1e-6,
                                   err_msg=f"wrench, tick {step}")
    # the residuals reach the QP: the residual-free controller differs
    assert np.abs(free.ground_reaction_wrench.numpy()
                  - tc.ground_reaction_wrench.numpy()).max() > 1e-3


def test_srbd_residual_none_handling_and_shape_check():
    c = _port(dtype=torch.float32)
    a_res, _ = _residuals()
    c.set_srbd_residual(a_res, None)
    assert c.state.residual_B.dtype == torch.float32
    assert torch.equal(c.state.residual_B, torch.zeros(B, 12, 12))
    assert torch.equal(c.state.residual_A, torch.as_tensor(a_res, dtype=torch.float32))
    c.set_srbd_residual(None, a_res)
    assert torch.equal(c.state.residual_A, torch.zeros(B, 12, 12))
    c.set_srbd_residual(None, None)
    assert c.state.residual_A is None and c.state.residual_B is None
    with pytest.raises(ValueError, match="expects shapes"):
        c.set_srbd_residual(np.zeros((B, 12, 11)), np.zeros((B, 12, 12)))
    with pytest.raises(ValueError, match="expects shapes"):
        c.set_srbd_residual(np.zeros((B + 1, 12, 12)), None)
    assert c.state.residual_A is None


def _leaves(c):
    from biped_pympc_tpu_torch.wrapper import _state_leaves
    return dict(_state_leaves(c.state))


@pytest.mark.parametrize("with_residual", [False, True])
def test_save_load_round_trip_bit_exact(tmp_path, with_residual):
    obs = _obs(B, np.random.default_rng(6))
    src = _port()
    if with_residual:
        src.set_srbd_residual(*_residuals())
    _ticks(src, obs, 13)
    path = tmp_path / "ctrl.npz"
    src.save_state(str(path))
    dst = _port()
    if with_residual:
        dst.set_srbd_residual(*_residuals(seed=9))
    dst.load_state(str(path))
    want, got = _leaves(src), _leaves(dst)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    # and the loaded controller continues as the saved one does
    for c in (src, dst):
        _ticks(c, obs, 8, start=13)
    assert torch.equal(src.get_action(), dst.get_action())
    assert torch.equal(src.ground_reaction_wrench, dst.ground_reaction_wrench)


def test_load_state_refuses_a_mismatched_checkpoint(tmp_path):
    path = tmp_path / "ctrl.npz"
    with_res = _port()
    with_res.set_srbd_residual(*_residuals())
    with_res.save_state(str(path))
    plain = _port()
    before = {k: v.clone() for k, v in _leaves(plain).items()}
    with pytest.raises(ValueError, match="residual_A"):
        plain.load_state(str(path))
    assert all(torch.equal(v, before[k]) for k, v in _leaves(plain).items())
    # and the other way round
    plain.save_state(str(path))
    with pytest.raises(ValueError, match="structure"):
        with_res.load_state(str(path))
    # a batch of another size
    _port(num_envs=B + 1).save_state(str(path))
    with pytest.raises(ValueError, match="shape"):
        plain.load_state(str(path))


def test_to_numpy():
    c = _port()
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3).requires_grad_(True)
    out = c.to_numpy(x)
    assert isinstance(out, np.ndarray) and out.dtype == np.float64
    np.testing.assert_array_equal(out, np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(c.to_numpy([1.0, 2.0]), np.array([1.0, 2.0]))
    assert c.to_numpy(c.state.gait_phase).shape == (B,)


def test_convert_carries_the_residuals():
    jc = jpkg.MPCController(jpkg.ControllerConf(), jpkg.MPCConf(verbose=False), num_envs=B,
                            gait_id=2, dtype=jnp.float64)
    a_res, b_res = _residuals()
    jc.set_srbd_residual(a_res, b_res)
    st = controller_state_from_numpy(jax.tree.map(np.asarray, jc.state), torch.float64)
    np.testing.assert_array_equal(st.residual_A.numpy(), a_res)
    np.testing.assert_array_equal(st.residual_B.numpy(), b_res)
    jc.set_srbd_residual(None, None)
    st = controller_state_from_numpy(jax.tree.map(np.asarray, jc.state), torch.float64)
    assert st.residual_A is None and st.residual_B is None

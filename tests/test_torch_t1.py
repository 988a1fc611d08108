"""The port's Booster T1 models (`models/chain.py`, `models/urdf.py`,
`models/t1.py`, the registry) against the JAX package's, float64: FK, the
Jacobian, the closed-form and the Gauss-Newton IK, the URDF reader and its
refusals, and the JAX tests' own pins (`tests/test_robots.py:76-200`)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu.models import chain as jchain
from biped_pympc_tpu.models import t1 as jt1
from biped_pympc_tpu.models import urdf as jurdf
from biped_pympc_tpu_torch.models import chain as tchain
from biped_pympc_tpu_torch.models import robot as trobot
from biped_pympc_tpu_torch.models import t1 as tt1
from biped_pympc_tpu_torch.models import urdf as turdf

from test_robots import _T1_IK, _T1_P

torch.set_num_threads(1)
B = 16
_TIPS = ("left_foot_sole_link", "right_foot_sole_link")


def _close(t, j, atol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=atol)


def _vmap(fn, leg, x):
    return jax.vmap(lambda v: fn(v, leg))(jnp.asarray(x))


def _stance_q(seed, n=B):
    """Joint angles about the standing pose, where the Gauss-Newton IK
    converges to the same branch in both packages (far from it the seed can
    be ~1 rad off, the steps jump by ~2 pi and f64 roundoff is amplified to
    ~1e-6; `models/t1.analytical_ik_newton`)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((n, 6))
    q[:, 0] = rng.uniform(-0.5, 0.0, n)
    q[:, 1] = rng.uniform(-0.1, 0.1, n)
    q[:, 3] = rng.uniform(0.2, 0.9, n)
    q[:, 4] = -(q[:, 0] + q[:, 3])
    return q


@pytest.mark.parametrize("leg", [0, 1])
def test_t1_fk_jacobian_and_chain_match_jax(leg):
    q = np.random.default_rng(leg).uniform(-0.8, 0.8, (B, 6))
    tq = torch.tensor(q)
    p_t, (o_t, a_t) = tt1.forward_kinematics(tq, leg)
    p_j, (o_j, a_j) = _vmap(jt1.forward_kinematics, leg, q)
    for a, b in ((p_t, p_j), (o_t, o_j), (a_t, a_j)):
        _close(a, b, 1e-12)
    _close(tt1.foot_position(tq, leg), p_j, 1e-12)
    _close(tt1.contact_jacobian(tq, leg), _vmap(jt1.contact_jacobian, leg, q), 1e-12)
    chain_t, chain_j = tt1._CHAINS[leg], jt1._CHAINS[leg]
    _close(tchain.tip_position(chain_t, tq),
           jax.vmap(lambda v: jchain.tip_position(chain_j, v))(jnp.asarray(q)), 1e-12)
    _close(tchain.geometric_jacobian(chain_t, tq),
           jax.vmap(lambda v: jchain.geometric_jacobian(chain_j, v))(jnp.asarray(q)), 1e-12)
    _close(tt1.hip_horizontal_location(leg, torch.float64),
           jt1.hip_horizontal_location(leg, jnp.float64), 0.0)


@pytest.mark.parametrize("leg", [0, 1])
def test_t1_ik_matches_jax(leg):
    """The closed form at 1e-12, the Gauss-Newton IK (10 steps) at 1e-10, on
    feet about the standing pose and, for the closed form, off it too."""
    p = _vmap(jt1.foot_position, leg, _stance_q(2 + leg))
    p_off = p + np.random.default_rng(7 + leg).uniform(-0.05, 0.05, p.shape)
    for x in (p, p_off):
        _close(tt1.analytical_ik(torch.tensor(np.asarray(x)), leg),
               _vmap(jt1.analytical_ik, leg, x), 1e-12)
    _close(tt1.analytical_ik_newton(torch.tensor(np.asarray(p)), leg),
           _vmap(jt1.analytical_ik_newton, leg, p), 1e-10)


@pytest.mark.parametrize("leg", [0, 1])
def test_t1_reference_ik_table(leg):
    """The JAX tests' reference-IK table (`test_robots.py:83`)."""
    _close(tt1.analytical_ik(torch.tensor(_T1_P), leg), _T1_IK[leg], 2e-6)


@pytest.mark.parametrize("leg", [0, 1])
def test_t1_fk_zero_pose_and_roundtrips(leg):
    """Zero pose: the sole under the hip at the stacked offsets; the closed
    form undoes it within 1e-2 (`test_robots.py:144-169`); the Gauss-Newton
    IK's FK(IK(p)) within 1e-5 m at bent poses (`:193-207`)."""
    side = 1.0 if leg == 0 else -1.0
    p0 = tt1.foot_position(torch.zeros(1, 6, dtype=torch.float64), leg)
    want = [0.0625 - 0.014, side * (0.106 + 0.00025),
            -0.1155 - 0.02 - 0.081854 - 0.134 - 0.28 - 0.012
            - (0.035192 if leg == 0 else 0.03519)]
    _close(p0[0], want, 1e-12)
    _close(tt1.analytical_ik(p0, leg), np.zeros((1, 6)), 1e-2)
    rng = np.random.default_rng(11 + leg)
    q = np.zeros((6, 6))
    q[:, 0] = rng.uniform(-0.6, 0.1, 6)
    q[:, 1] = rng.uniform(-0.2, 0.2, 6)
    q[:, 3] = rng.uniform(0.3, 1.1, 6)
    q[:, 4] = -(q[:, 0] + q[:, 3])
    p = tt1.foot_position(torch.tensor(q), leg)
    _close(tt1.foot_position(tt1.analytical_ik_newton(p, leg), leg), p, 1e-5)


def test_t1_left_right_symmetry():
    """Mirrored joint angles give y-mirrored feet (`test_robots.py:181`); the
    soles' offsets differ by 2e-6 in the URDF."""
    q = torch.tensor([[0.3, 0.1, 0.0, 0.8, -0.4, 0.05]], dtype=torch.float64)
    q_mir = torch.tensor([[0.3, -0.1, 0.0, 0.8, -0.4, -0.05]], dtype=torch.float64)
    pl, pr = tt1.foot_position(q, 0), tt1.foot_position(q_mir, 1)
    _close(pl * torch.tensor([1.0, -1.0, 1.0], dtype=torch.float64), pr, 1e-5)


@pytest.mark.parametrize("leg", [0, 1])
def test_t1_jacobian_matches_finite_difference(leg):
    q = np.random.default_rng(42 + leg).uniform(-0.5, 0.5, 6)
    jac = tt1.contact_jacobian(torch.tensor(q[None]), leg)[0].numpy()
    eps = 1e-7
    for i in range(6):
        dq = np.zeros(6)
        dq[i] = eps
        d = (tt1.foot_position(torch.tensor((q + dq)[None]), leg)
             - tt1.foot_position(torch.tensor((q - dq)[None]), leg))[0].numpy() / (2 * eps)
        np.testing.assert_allclose(jac[:3, i], d, atol=1e-6)


@pytest.mark.parametrize("leg", [0, 1])
def test_urdf_chain_equals_jax(leg):
    """`chain_from_urdf` of the port's asset gives the JAX reader's chain of
    the JAX asset, array for array, and the hand constants of `models/t1`."""
    got = turdf.chain_from_urdf(turdf.T1_FIXTURE_URDF, "Trunk", _TIPS[leg], locked=("Waist",))
    want = jurdf.chain_from_urdf(jurdf.T1_FIXTURE_URDF, "Trunk", _TIPS[leg], locked=("Waist",))
    assert got.axes == want.axes == tt1._CHAINS[leg].axes == "yxzyyx"
    for name in ("base_offset", "joint_offsets", "tip_offset"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        np.testing.assert_array_equal(getattr(got, name), getattr(tt1._CHAINS[leg], name))


def test_urdf_asset_is_the_jax_one_and_the_port_reads_its_own():
    port, jax_ = pathlib.Path(turdf.T1_FIXTURE_URDF), pathlib.Path(jurdf.T1_FIXTURE_URDF)
    assert port.read_bytes() == jax_.read_bytes()
    assert "biped_pympc_tpu_torch" in port.parts and "biped_pympc_tpu" not in port.parts


@pytest.mark.parametrize("root, tip, match", [
    ("Trunk", "left_hand_link", "rpy"),
    ("left_hand_link", "right_foot_sole_link", "no joint chain"),
])
def test_urdf_refuses_what_jax_refuses(root, tip, match):
    """Out-of-class chains raise the JAX reader's errors (`test_urdf.py:66-76`)."""
    for mod in (turdf, jurdf):
        with pytest.raises(ValueError, match=match):
            mod.chain_from_urdf(mod.T1_FIXTURE_URDF, root, tip)


@pytest.mark.parametrize("name", ["T1", "T1-newton"])
def test_registry_t1_entries(name):
    spec = trobot.get_robot(name)
    want = jt1
    assert (spec.name, spec.num_dof, spec.mass, spec.mu, spec.lt, spec.lh) == \
        (name, 6, want.MASS, want.MU, want.LT, want.LH)
    assert spec.kp == want.KP and spec.kd == want.KD and spec.torque_limit == want.TORQUE_LIMIT
    np.testing.assert_array_equal(spec.i_body, want.I_BODY)
    assert spec.analytical_ik is (tt1.analytical_ik_newton if name == "T1-newton"
                                  else tt1.analytical_ik)

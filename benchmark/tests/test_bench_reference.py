"""The benchmark's float64 reference held against the program's CPU path
(`device="cpu"`, float64) and against the numpy golden PDIPM of the JAX
package, at small batches on the CPU. Tests may import both; the
reference itself imports neither."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from benchmark import port
from benchmark.common import env_gap, load_json
from benchmark.reference import robots
from benchmark.reference.control import Reference
from benchmark.reference.qpsolve import solve_qp

REPO = pathlib.Path(__file__).resolve().parents[2]
F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    # A batched CPU LU under several threads can stall (ROADMAP, the port's notes).
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden():
    path = REPO / "biped_pympc_tpu" / "ops" / "reference_pdipm.py"
    spec = importlib.util.spec_from_file_location("golden_pdipm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # numpy only; the JAX package's __init__ is not run
    return mod


def _inputs(cfg, batch, seed):
    mix = load_json("benchmark/traffic/solve.json")
    gen = torch.Generator().manual_seed(seed)
    obs = port.draw_observations(cfg, mix, gen, 11, batch, "cpu").to(F64)
    twist = port.uniform(gen, (batch, 3), -0.3, 0.3, "cpu").to(F64)
    phase = port.uniform(gen, (batch,), 0.0, 1.0, "cpu").to(F64)
    return obs, twist, phase


def test_solve_and_ticks_match_the_program_in_float64():
    from biped_pympc_tpu_torch.wrapper import MPCController

    cfg = load_json("benchmark/configs/hector_walk.json")
    B = 16
    obs, twist, phase = _inputs(cfg, B, 7)
    ccfg, mcfg, gait_id, _ = port.confs(cfg)
    ctrl = MPCController(ccfg, mcfg, B, gait_id=gait_id, dtype=F64, device="cpu")
    height = torch.full((B,), 0.55, dtype=F64)
    ctrl.set_command(twist, height)
    ctrl.update_state(obs[0])
    ctrl.state.gait_phase.copy_(phase)
    ref = Reference(cfg)
    st = ref.init_state(B)
    ref.set_command(st, twist, height)
    st["gait_phase"] = phase.clone()
    ref.ingest(st, obs[0])
    ctrl.run_mpc()
    w_ref, _, _ = ref.run_mpc(st)
    assert env_gap(ctrl.state.leg_cmd.wrench_ff, w_ref).max() < 1e-3
    for tick in range(10):
        ctrl.update_state(obs[1 + tick])
        ref.ingest(st, obs[1 + tick])
        ctrl.run_lowlevel()
        ref.run_lowlevel(st)
        assert env_gap(ctrl.get_action(), ref.joint_torque(st)).max() < 1e-6
    assert env_gap(ctrl.state.gait_phase[:, None], st["gait_phase"][:, None]).max() < 1e-12


@pytest.mark.parametrize("name", ["hector_walk", "t1_walk"])
def test_closed_loop_cycles_match_the_program_in_float64(name):
    """Three cycles of the closed loop from standing. The first QPs of a walk
    do not converge in 20 Newton steps, and there the two sides' roundoff
    parts the iterates (~1e-2 N for HECTOR, ~6e-2 N for the T1); at 40 steps
    both reach the solution."""
    from biped_pympc_tpu_torch.control.controller import BipedControllerCore
    from biped_pympc_tpu_torch.examples import srbd_plant, tpu_rollout

    cfg = dict(load_json(f"benchmark/configs/{name}.json"), newton_iterations=40)
    B = 8
    ccfg, mcfg, gait_id, _ = port.confs(cfg)
    core = BipedControllerCore(ccfg, mcfg, gait_id=gait_id, dtype=F64, device="cpu")
    vx = torch.linspace(0.0, 0.3, B, dtype=F64)
    state = core.init_state(B)
    twist = torch.zeros(B, 3, dtype=F64)
    twist[:, 0] = vx
    core.set_command(state, twist, torch.full((B,), cfg["height"], dtype=F64))
    x = torch.zeros(B, 12, dtype=F64)
    x[:, 5] = cfg["height"]
    feet = srbd_plant.nominal_feet(core.robot, B, F64, "cpu")
    cycle = tpu_rollout.make_cycle(core, tpu_rollout.make_affine_rk4_step(core.robot, mcfg.dt))
    ref = Reference(cfg)
    st = ref.init_state(B, vx, cfg["height"])
    rx, rfeet = ref.init_plant(B, cfg["height"])
    for _ in range(3):
        x, feet = cycle(state, x, feet)
        rx, rfeet, _ = ref.cycle_step(st, rx, rfeet)
        assert env_gap(state.leg_cmd.wrench_ff, st["leg_cmd.wrench_ff"]).max() < 1e-3
        assert env_gap(x, rx).max() < 1e-5
        assert env_gap(feet, rfeet).max() < 1e-7


def test_qp_solve_follows_the_golden_step_for_step():
    golden = _golden()
    cfg = load_json("benchmark/configs/hector_walk.json")
    B = 3
    obs, twist, phase = _inputs(cfg, B, 11)
    ref = Reference(cfg)
    st = ref.init_state(B)
    ref.set_command(st, twist, torch.full((B,), 0.55, dtype=F64))
    st["gait_phase"] = phase
    ref.ingest(st, obs[0])
    (H, f, A, b, G, d), _ = ref.assemble(st)
    for iters in (1, 5, 20):
        x, mu = solve_qp(H, f, A, b, G, d, iterations=iters)
        for e in range(B):
            Ge, de, Ae = G[e].numpy(), d[e].numpy(), A[e].numpy()
            x0, s0, z0, y0 = golden.initialize_variables(Ge, de, Ae.shape[0])
            xg, *_, res = golden.solve(np.diag(H[e].numpy()), f[e].numpy(), Ae, b[e].numpy(),
                                       Ge, de, x0, s0, z0, y0, iterations=iters)
            np.testing.assert_allclose(x[e].numpy(), xg, atol=1e-6, rtol=0)
            assert float(mu[e]) == pytest.approx(res[3], rel=1e-5, abs=1e-12)


@pytest.mark.parametrize("leg", [0, 1])
def test_t1_chain_read_from_the_urdf_is_the_programs(leg):
    from biped_pympc_tpu_torch.models import hector, t1

    q = torch.rand(32, 6, dtype=F64, generator=torch.Generator().manual_seed(leg)) - 0.5
    p, origins, axes = robots.T1.frames(q, leg)
    pp, (po, pa) = t1.forward_kinematics(q, leg)
    torch.testing.assert_close(p, pp, atol=1e-14, rtol=0)
    torch.testing.assert_close(axes, pa, atol=1e-14, rtol=0)
    torch.testing.assert_close(robots.T1.jacobian(q, leg), t1.contact_jacobian(q, leg),
                               atol=1e-13, rtol=0)
    target = pp + 0.01
    torch.testing.assert_close(robots.T1.ik(target, leg), t1.analytical_ik(target, leg),
                               atol=1e-12, rtol=0)
    qh = q[:, :5]
    torch.testing.assert_close(robots.HECTOR.jacobian(qh, leg), hector.contact_jacobian(qh, leg),
                               atol=1e-13, rtol=0)
    ph = hector.foot_position(qh, leg)
    torch.testing.assert_close(robots.HECTOR.ik(ph, leg), hector.analytical_ik(ph, leg),
                               atol=1e-12, rtol=0)

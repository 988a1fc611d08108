"""The check that decides `correct`, driven through the rest of a run on the
CPU at a small batch (the harness's look for a card skipped): a sound run
of each cell comes out correct; the same run with the timed path broken
underneath, and the control (the reference in bfloat16 in the program's
place), come out not correct."""

import pytest
import torch

import benchmark.run as bench_run
from benchmark import control

CELLS = ("hector_walk.solve", "t1_walk.rollout", "hector_walk.period", "hector_walk.rollout")
SEED = 2 ** 33 + 5  # wider than 32 bits: a run's seed may be


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """Every cell at 32 envs and, for the rollouts, 4-cycle episodes."""
    torch.set_num_threads(1)  # a batched CPU LU under several threads can stall
    spec = bench_run.cell_spec

    def small_spec(name):
        cell, cfg, mix, limits, layers = spec(name)
        mix = dict(mix, episode_cycles=4) if "episode_cycles" in mix else mix
        return cell, dict(cfg, num_envs=32), mix, limits, layers

    monkeypatch.setattr(bench_run, "cell_spec", small_spec)


def run(cell):
    return bench_run.run(cell, SEED, 0.3, False, device=torch.device("cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


def _half_batch(monkeypatch):
    """run_mpc solves the first half of the batch; the rest get its mean."""
    from biped_pympc_tpu_torch.control.controller import BipedControllerCore

    solve = BipedControllerCore.run_mpc

    def half(self, state):
        out = solve(self, state)
        w = state.leg_cmd.wrench_ff
        n = w.shape[0] // 2
        state.leg_cmd.wrench_ff = torch.cat([w[:n], w[:n].mean(0, keepdim=True).expand_as(w[n:])])
        out.grf_world = torch.cat([out.grf_world[:n],
                                   out.grf_world[:n].mean(0, keepdim=True).expand(
                                       w.shape[0] - n, -1)])
        return out

    monkeypatch.setattr(BipedControllerCore, "run_mpc", half)


def _altered_answer(monkeypatch):
    """Every wrench the solve produces is a quarter too large."""
    from biped_pympc_tpu_torch.control.controller import BipedControllerCore

    solve = BipedControllerCore.run_mpc

    def altered(self, state):
        out = solve(self, state)
        state.leg_cmd.wrench_ff = 1.25 * state.leg_cmd.wrench_ff
        out.grf_world = 1.25 * out.grf_world
        return out

    monkeypatch.setattr(BipedControllerCore, "run_mpc", altered)


def _state_unchanged(monkeypatch):
    """The plant's step returns the state it was given."""
    from biped_pympc_tpu_torch.examples import tpu_rollout

    monkeypatch.setattr(tpu_rollout, "make_affine_rk4_step",
                        lambda robot, dt: (lambda x, u, foot_w, rot: x.clone()))


def _tick_unchanged(monkeypatch):
    """The low level leaves the controller's state as it was."""
    from biped_pympc_tpu_torch.control.controller import BipedControllerCore

    monkeypatch.setattr(BipedControllerCore, "run_lowlevel", lambda self, state: None)


FAULTS = [("hector_walk.solve", _half_batch), ("hector_walk.solve", _altered_answer),
          ("t1_walk.rollout", _state_unchanged), ("t1_walk.rollout", _altered_answer),
          ("hector_walk.rollout", _state_unchanged), ("hector_walk.rollout", _half_batch),
          ("hector_walk.period", _half_batch), ("hector_walk.period", _tick_unchanged),
          ("hector_walk.period", _altered_answer)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_is_not_correct(cell):
    from benchmark.common import load_json

    limits = load_json(f"benchmark/limits/{cell}.json")
    rows = list(control.readings(cell, [], [SEED], 0.3, "bfloat16", torch.device("cpu")))
    failed = [k for k, v in rows[0]["checks"].items() if v > limits.get(k, 0.0)]
    assert failed, rows[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell, monkeypatch):
    """The cell at its own size on the card, a one-second window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.undo()  # the full size, not the fixture's 32 envs
    out = bench_run.run(cell, SEED, 1.0, False)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"

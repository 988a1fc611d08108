"""The port's opt-in extras on the CPU: `utils/profiling.py` (`device_timer`,
`trace`) and `utils/viz.py` (`log_rollout_frame` from the port's controller,
`animate_srbd` where matplotlib imports, as `tests/test_viz.py`)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import biped_pympc_tpu_torch as tpkg
from biped_pympc_tpu_torch.utils import profiling, viz

from test_viz import _synthetic_frames

torch.set_num_threads(1)


def test_device_timer_chains_the_step():
    calls = []

    def step(state):
        calls.append(1)
        return {"x": state["x"] + 1.0, "n": state["n"]}

    sec = profiling.device_timer(step, {"x": torch.zeros(4), "n": 3}, chain_len=5, reps=2)
    assert sec >= 0.0 and np.isfinite(sec)
    assert len(calls) == 5 * 3  # the warm-up chain and two timed ones


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        torch.ones(8).cumsum(0)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_log_rollout_frame_shapes():
    ctrl = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(verbose=False), num_envs=2,
                              gait_id=1, device="cpu")
    pose, foot, grf, grm = viz.log_rollout_frame(ctrl, env=1)
    assert pose.shape == (6,) and foot.shape == (2, 3)
    assert grf.shape == (2, 3) and grm.shape == (2, 3)
    assert all(isinstance(a, np.ndarray) for a in (pose, foot, grf, grm))
    frames = viz.SrbdFrames(*map(np.stack, zip(*[(pose, foot, grf, grm)] * 3)))
    assert frames.pose.shape == (3, 6)


def test_viz_imports_matplotlib_only_to_animate():
    code = ("import sys, biped_pympc_tpu_torch.utils.viz, biped_pympc_tpu_torch.utils.profiling; "
            "assert 'matplotlib' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__)))))


def test_animate_srbd_renders_gif(tmp_path):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / "walk.gif")
    viz.animate_srbd(viz.SrbdFrames(*_synthetic_frames()), save_path=path, interval_ms=100)
    assert os.path.exists(path) and os.path.getsize(path) > 1000

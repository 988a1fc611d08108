"""The port's own tracing (`utils/tracing.py`): spans at the wrapper's calls
and the graphs' captures and replays, recorded only while a profiler runs,
and the phase marks captured into the closed loop's cycle. On the CPU the
wrapper's calls are captured through stand-ins for the CUDA graph calls
(`graph_fakes.py`); the test marked `cuda` reads the marks of a replayed
cycle on the card (`python -m pytest tests/test_torch_tracing.py -m cuda
--noconftest`: this file imports no jax)."""

import ctypes
import pathlib
import re
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import biped_pympc_tpu_torch as tpkg
from biped_pympc_tpu_torch import wrapper
from biped_pympc_tpu_torch.utils import cuda_graph, tracing

from graph_fakes import _fake_cuda

torch.set_num_threads(1)
B = 2
DECIM = 10
CALLS = ("set_command", "update_state", "run_mpc", "run_lowlevel", "get_action")
# The phases of one closed-loop cycle: tick 0 solves, ticks 1-9 do not.
CYCLE_MARKS = (["obs", "ingest", "assembly", "lowlevel", "plant"]
               + ["obs", "ingest", "lowlevel", "plant"] * 9 + ["carry"])


def _controller(**mpc):
    """HECTOR walking on the CPU; one Newton step a solve, since a profiler
    that records the plain solve's every operation takes seconds to read."""
    conf = {"solver": "ric_aug", "newton_iterations": 1, "solver_refine_steps": 0,
            "verbose": False, **mpc}
    return tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(**conf), num_envs=B, gait_id=2,
                              dtype=torch.float64, device="cpu")


def _obs():
    """HECTOR standing at 0.55 m, level, at rest: (B, 43)."""
    obs = np.zeros((B, 43))
    obs[:, 2], obs[:, 3] = 0.55, 1.0
    obs[:, 13:18] = obs[:, 18:23] = [0.0, 0.0, 0.45, -0.9, 0.45]
    return obs


def _period(c, obs, ticks=DECIM):
    c.set_command(np.tile([0.2, 0.0, 0.0], (B, 1)), np.full(B, 0.55))
    for tick in range(ticks):
        c.update_state(obs)
        if tick == 0:
            c.run_mpc()
        c.run_lowlevel()
        c.get_action()


@pytest.fixture
def captured(monkeypatch):
    """The wrapper's calls captured on the CPU: every LoopStep the wrapper
    makes captures through the stand-ins (their replays run nothing)."""
    with _fake_cuda(monkeypatch):
        monkeypatch.setattr(wrapper, "LoopStep", lambda step, carry, graph=None: cuda_graph.LoopStep(
            step, carry, True if graph is None else graph))
        yield


def _spans(prof):
    """[(name, parent name, start)] of the port's spans, in time order."""
    out = [(e.name, e.cpu_parent.name if e.cpu_parent is not None else None,
            e.time_range.start) for e in prof.events()
           if e.name.startswith(("wrapper.", "graph."))]
    return sorted(out, key=lambda s: s[2])


def _children(spans, parent):
    """The spans under each span named `parent`, one list per call."""
    calls, out = [], {}
    for name, up, start in spans:
        if name == parent:
            calls.append(start)
            out[start] = []
    for name, up, start in spans:
        if up == parent:
            owner = max(s for s in calls if s <= start)
            out[owner].append(name)
    return [out[s] for s in calls]


def test_a_period_of_calls_yields_the_named_spans_nested(captured):
    """Each public call is a top-level `wrapper.<call>` span; inside it the
    inputs' copy, then the capture at the call's first use and a replay at
    every use, then `get_action`'s copy out."""
    c = _controller()
    obs = _obs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _period(c, obs, 2)
        _period(c, obs, 2)
    spans = _spans(prof)
    assert {up for name, up, _ in spans if name.startswith("wrapper.") and name not in (
        "wrapper.copy_in", "wrapper.copy_out")} == {None}
    first, later = ["graph.capture", "graph.replay"], ["graph.replay"]
    assert _children(spans, "wrapper.set_command") == [["wrapper.copy_in", *first],
                                                      ["wrapper.copy_in", *later]]
    updates = _children(spans, "wrapper.update_state")
    assert updates == [["wrapper.copy_in", *first]] + [["wrapper.copy_in", *later]] * 3
    assert _children(spans, "wrapper.run_mpc") == [first, later]
    assert _children(spans, "wrapper.run_lowlevel") == [first] + [later] * 3
    assert _children(spans, "wrapper.get_action") == (
        [[*first, "wrapper.copy_out"]] + [[*later, "wrapper.copy_out"]] * 3)
    assert {up for name, up, _ in spans if name.startswith("graph.")} == {
        f"wrapper.{call}" for call in CALLS}


def test_eager_calls_yield_graph_eager_spans():
    """On the CPU without the stand-ins each call runs its step eagerly, in
    a `graph.eager` span; `reset` copies its mask in."""
    c = _controller()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _period(c, _obs(), 2)
        c.reset([1])
    spans = _spans(prof)
    assert _children(spans, "wrapper.reset") == [["wrapper.copy_in", "graph.eager"]]
    assert _children(spans, "wrapper.run_mpc") == [["graph.eager"]]
    assert not [name for name, _, _ in spans if name in ("graph.capture", "graph.replay")]


def test_no_profiler_enters_no_range(monkeypatch, captured):
    """With no profiler running a span site enters no profiler range (and
    makes none); under one, every span does."""
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "_RecordFunctionFast", Counting)
    c = _controller()
    obs = _obs()
    _period(c, obs)
    c.reset([0])
    assert entered == []
    assert tracing.span("wrapper.run_mpc") is tracing.span("graph.replay")
    with profile(activities=[ProfilerActivity.CPU]):
        _period(c, obs)
    assert entered.count("wrapper.update_state") == DECIM
    assert entered.count("graph.replay") == 1 + 3 * DECIM + 1


def test_capture_count_follows_the_structure_changes(captured):
    """`graph.capture` once a call until `set_srbd_residual` switches between
    None and a tensor (each call captured once more), not when a tensor
    is copied over a tensor; assigning the state captures once more too."""
    c = _controller()
    obs = _obs()
    res = np.full((B, 12, 12), 0.01)

    def captures(prof):
        return sorted(up for name, up, _ in _spans(prof) if name == "graph.capture")

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _period(c, obs, 1)
        _period(c, obs, 1)
    assert captures(prof) == sorted(f"wrapper.{call}" for call in CALLS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c.set_srbd_residual(res, res)
        _period(c, obs, 1)
        c.set_srbd_residual(2 * res, res)
        _period(c, obs, 1)
    assert captures(prof) == sorted(f"wrapper.{call}" for call in CALLS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c.set_srbd_residual(None, None)
        _period(c, obs, 1)
        c.state = c.state
        _period(c, obs, 1)
    assert captures(prof) == sorted([f"wrapper.{call}" for call in CALLS] * 2)


def test_print_solve_time_prints_the_timed_calls(capsys):
    """`print_solve_time` prints `run_mpc`'s and `run_lowlevel`'s times, the
    lines it always printed, and nothing for the other calls."""
    c = _controller(print_solve_time=True)
    _period(c, _obs())
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 + DECIM
    assert re.fullmatch(r"MPC solve time took:  \d+\.\d{3} ms", lines[0])
    assert all(re.fullmatch(r"low level control took:  \d+\.\d{3} ms", x) for x in lines[1:])


def test_marks_do_nothing_off_the_card(monkeypatch):
    monkeypatch.setattr(tracing, "build", lambda: pytest.fail("built the mark library"))
    for phase in tracing.PHASES:
        tracing.mark(phase, torch.zeros(1))


class _FakeMarks:
    def __init__(self):
        self.launched = []

    def trace_mark(self, phase, stream):
        self.launched.append(tracing.PHASES[phase])
        return 0


def _card_stand_ins(monkeypatch, lib, capturing):
    monkeypatch.setattr(tracing, "_lib", [lib] if lib is not None else [])
    monkeypatch.setattr(tracing, "_ready", set())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _NullDevice())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    return types.SimpleNamespace(device=torch.device("cuda", 0))


class _NullDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_first_mark_launches_every_phase_once(monkeypatch):
    """The first mark on a device launches every phase's kernel outside any
    capture, so none is first launched inside one; later marks launch their
    own kernel only."""
    lib = _FakeMarks()
    like = _card_stand_ins(monkeypatch, lib, capturing=False)
    tracing.mark("plant", like)
    tracing.mark("carry", like)
    assert lib.launched == [*tracing.PHASES, "plant", "carry"]
    assert tracing._ready == {0}


def test_first_mark_inside_a_capture_raises(monkeypatch):
    lib = _FakeMarks()
    like = _card_stand_ins(monkeypatch, lib, capturing=True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        tracing.mark("ingest", like)
    assert lib.launched == [] and tracing._ready == set()


def test_mark_library_interface_matches_the_source(monkeypatch):
    """One kernel `trace_mark_<phase>` per phase, in `PHASES`' order (the
    index `trace_mark` takes), and the C entries declared with the source's
    types."""
    source = pathlib.Path(tracing.SOURCE).read_text()
    kernels = re.findall(r"__global__ void trace_mark_(\w+)\(\) \{\}", source)
    assert tuple(kernels) == tracing.PHASES
    table = re.search(r"marks\[\]\)\(\) = \{(.*?)\};", source, flags=re.S).group(1)
    assert [k.strip() for k in table.split(",")] == [f"trace_mark_{p}" for p in tracing.PHASES]
    assert re.search(r"\bint trace_mark\(int phase, void\* stream\)", source)
    assert re.search(r"const char\* trace_mark_error_string\(int err\)", source)
    fake = types.SimpleNamespace(trace_mark=types.SimpleNamespace(),
                                 trace_mark_error_string=types.SimpleNamespace())
    monkeypatch.setattr(tracing.ctypes, "CDLL", lambda path: fake)
    lib = tracing.load_library("unused.so")
    assert lib.trace_mark.argtypes == [ctypes.c_int, ctypes.c_void_p]
    assert lib.trace_mark.restype is ctypes.c_int
    assert lib.trace_mark_error_string.argtypes == [ctypes.c_int]


def test_mark_library_is_built_apart_from_the_pdipm_ones():
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    path = tracing.library_path()
    assert pathlib.Path(path).name.startswith("libtrace_mark_")
    assert pathlib.Path(path).parent == pathlib.Path(pdipm_cuda.BUILD_DIR)
    assert tracing.SOURCE not in pdipm_cuda.SOURCES.values()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
def test_captured_cycle_marks_its_phases_in_order_on_card():
    """A replayed closed-loop cycle's device trace holds 42 marks in phase
    order (tick 0 with the solve, 9 ticks without, the carry), and K1 runs
    between the `assembly` mark and the first `lowlevel` one."""
    _card()
    from biped_pympc_tpu_torch.examples import tpu_rollout

    core = tpu_rollout.make_core("pallas_ric_aug", device="cuda", verbose=False)
    rollout, cycles = tpu_rollout.make_rollout(core, 0.0101)
    assert cycles == 1
    rollout(tpu_rollout.init_carry(core, 64, 0.3, 0.55))
    rollout.loop.carry.index.zero_()  # the next cycle's snapshot goes to row 0 again
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rollout.loop()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    device = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    marks = [(t, m.group(1)) for t, name in device
             if (m := re.search(r"trace_mark_([a-z]+)", name))]
    assert [p for _, p in marks] == CYCLE_MARKS
    k1 = [t for t, name in device if "pdipm_kernel" in name]
    assert len(k1) == 1
    assembly = next(t for t, p in marks if p == "assembly")
    lowlevel = next(t for t, p in marks if p == "lowlevel")
    assert assembly < k1[0] < lowlevel
    # The spans are host operations: nothing of theirs on the device.
    assert [e.name for e in prof.events() if e.name == "graph.replay"] == ["graph.replay"]
    assert not [name for _, name in device if name.startswith(("graph.", "wrapper."))]

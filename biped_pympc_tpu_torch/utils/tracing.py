"""Spans on the host and phase marks on the device, on the profiler's clock.

The port's one tracing system is `torch.profiler`: `utils/profiling.trace()`
writes its Chrome trace, and any other profiler that records (a benchmark's
traced window) sees the same events. This module adds the program's own
events to it.

  * `span(name)`: a `torch.profiler` range around a block while a profiler
    records. With no profiler running it is one shared no-op context: a
    span site then allocates nothing and enters no range. Nesting gives
    parent and child (the profiler records it). The range is a host
    operation (`RecordFunctionFast`), not `record_function`'s user
    annotation: the CUDA profiler mirrors a user annotation onto the
    device's timeline as an event of the same name over the kernels
    launched inside it, which every reader of device events would count as
    device work. The spans: `wrapper.<call>` for each public call of
    `MPCController`, with the children `wrapper.copy_in` and
    `wrapper.copy_out`; `graph.capture`, `graph.replay` and `graph.eager`
    in `utils/cuda_graph.LoopStep`.
  * `timed(name, label, device)`: `span(name)`, and the block's wall time
    between two synchronizations printed as "<label> took:  <ms> ms"
    (`MPCConf.print_solve_time`).
  * `mark(phase, like)`: on the card, one empty kernel named
    `trace_mark_<phase>` launched on the current stream (`csrc/
    trace_mark.cu`, its own small library built by `ops/cuda_build.py`).
    Captured into a CUDA graph it is a node like any other, so a device
    trace of a replay says where each phase starts; it changes no bits. On
    the CPU it does nothing. The phases (`PHASES`): `obs` (the
    observation assembled, `examples/tpu_rollout.make_cycle`), `ingest`
    (`BipedControllerCore.ingest_state`), `assembly` (the start of
    `run_mpc`: assembly, the solve, postprocess), `lowlevel`
    (`run_lowlevel`), `plant` (the feet pinned, the wrench gated, the plant
    stepped) and `carry` (`tpu_rollout.Rollout`'s trajectory copy and the
    carry copied back); inside the hybrid speed mode's solve
    (`ops/pdipm_cuda.solve_hybrid`, solver="pallas_hybrid" only; within
    `assembly`), `hybrid_condensed` (the condensed route on every env),
    `hybrid_rank` (the criterion, the finiteness test, the sort and the
    gather of the worst envs' QPs), `hybrid_resolve` (the augmented
    route's re-solve of those envs), `hybrid_merge` (the merge and the
    counters) and `hybrid_done` (the postprocess that follows the solve).
    New phases are appended, so every phase keeps its index.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

from biped_pympc_tpu_torch.ops import cuda_build

PHASES = ("obs", "ingest", "assembly", "lowlevel", "plant", "carry", "hybrid_condensed",
          "hybrid_rank", "hybrid_resolve", "hybrid_merge", "hybrid_done")
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "trace_mark.cu")

_INDEX = {phase: i for i, phase in enumerate(PHASES)}
_OFF = contextlib.nullcontext()
_lib: list = []
# Devices (index) on which every mark has been launched once outside a capture.
_ready: set = set()


def span(name: str):
    """A profiler range named `name` while a profiler records, else a shared
    no-op context."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


class timed:
    """`span(name)` around a block, the device's queue drained before and
    after it (`device` on the card), and the block's wall time printed as
    "<label> took:  <ms> ms" once it ends without an exception."""

    def __init__(self, name: str, label: str, device: torch.device):
        self.name, self.label = name, label
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def __enter__(self):
        self.sync()
        self.t0 = time.perf_counter()
        self.span = span(self.name)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        self.span.__exit__(*exc)
        if exc[0] is None:
            self.sync()
            print(f"{self.label} took:  {1e3 * (time.perf_counter() - self.t0):.3f} ms")
        return False


def library_path() -> str:
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    return cuda_build.library_path("trace_mark", SOURCE, (), pdipm_cuda.BUILD_DIR)


def build() -> str:
    """Compile csrc/trace_mark.cu if it is not built yet; return the library's path."""
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    return cuda_build.build({"trace_mark": SOURCE}, {"trace_mark": library_path()},
                            pdipm_cuda.BUILD_DIR)["trace_mark"]


def load_library(path: str) -> ctypes.CDLL:
    """Load the built mark library and declare its C interface."""
    lib = ctypes.CDLL(path)
    lib.trace_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.trace_mark.restype = ctypes.c_int
    lib.trace_mark_error_string.argtypes = [ctypes.c_int]
    lib.trace_mark_error_string.restype = ctypes.c_char_p
    return lib


def _launch(lib: ctypes.CDLL, phase: str, stream: int) -> None:
    err = lib.trace_mark(_INDEX[phase], stream)
    if err != 0:
        raise RuntimeError(f"phase mark {phase!r} launch failed: "
                           f"{lib.trace_mark_error_string(err).decode()} ({err})")


def mark(phase: str, like: torch.Tensor) -> None:
    """Mark the start of `phase` on the current stream of `like`'s device;
    nothing off the card. The first mark on a device launches every phase's
    kernel once, so that none is first launched inside a CUDA graph's
    capture (the kernels load at their first launch); that first mark may
    not itself be inside a capture: a captured step warms up first
    (`utils/cuda_graph.py`)."""
    dev = like.device
    if dev.type != "cuda":
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dev.index not in _ready:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"the first phase mark ({phase!r}) on {dev} is inside a CUDA "
                                   "graph capture: run the step once eagerly first")
            if not _lib:
                _lib.append(load_library(build()))
            for p in PHASES:
                _launch(_lib[0], p, stream)
            _ready.add(dev.index)
        _launch(_lib[0], phase, stream)

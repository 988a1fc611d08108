"""One step over a carry, run eagerly or replayed as a CUDA graph.

The port's step functions (`BipedControllerCore.ingest_state`, `run_mpc`,
`run_lowlevel`, ...) replace the leaves of the state they are given with new
tensors. A captured CUDA graph, though, reads and writes fixed addresses. So
`LoopStep` owns a carry (a tree of dataclasses and tuples of tensors), runs
the step on a working copy of its structure that shares its tensors, and
ends by copying every replaced leaf back into the carry's own tensors: the
next step, eager or replayed, reads the last one's output where it left it.

On CUDA the step is captured once, after a warm-up on a side stream (which
builds and loads the kernel libraries and fills the constant caches, so
that nothing in the capture copies from the host or waits for the device),
and each call replays it. A failed capture raises; it never falls back to
the eager step.

Launch counts. A kernel wrapper adds one to its host count where it issues a
launch (`pdipm_cuda.launches`): the warm-up's launches and the capture's,
which records them into the graph, count so; a replay issues none. The
PDIPM kernels also count themselves on the device (`pdipm_cuda.runs`), and
those counts read every launch that ran: the warm-up's and each replay's.

A step that is itself captured at its own first call
(`BipedControllerCore.control_step`) runs inline when `capturing()`: inside
a LoopStep's warm-up or capture, or any CUDA graph capture, it is recorded
into the graph being built, as a jitted function called inside another jit
is traced into it.

Spans (`utils/tracing.span`, while a profiler records): `graph.capture`
around the warm-up and the capture, `graph.replay` around a replay and
`graph.eager` around an eager run. A call that is captured again (a new
LoopStep for it) shows a second `graph.capture`.
"""

from __future__ import annotations

import gc

import torch

from biped_pympc_tpu_torch.utils.tracing import span
from biped_pympc_tpu_torch.utils.tree import leaves, tree_map

__all__ = ["LoopStep", "capturing", "copy_into", "leaves", "tree_map"]

# LoopSteps warming up or capturing their step (`capturing`).
_building = 0


def capturing() -> bool:
    """Whether a LoopStep is warming up or capturing its step, or a CUDA
    graph is being captured on the current stream: a call then runs inline,
    into the graph being built."""
    return _building > 0 or (torch.cuda.is_available()
                             and torch.cuda.is_current_stream_capturing())


def copy_into(dst, src) -> None:
    """Copy every leaf of `src` into the same leaf of `dst` (same structure,
    shapes and dtypes); leaves that are the same tensor are skipped. A
    replaced leaf of `src` must not share memory with a leaf of `dst`, or an
    earlier copy could overwrite what a later one reads: that raises."""
    dl, sl = list(leaves(dst)), list(leaves(src))
    if [p for p, _ in dl] != [p for p, _ in sl]:
        raise ValueError(f"carry structure changed: {[p for p, _ in dl]} -> "
                         f"{[p for p, _ in sl]}")
    ptrs = {t.untyped_storage().data_ptr() for _, t in dl}
    pairs = []
    for (path, d), (_, s) in zip(dl, sl):
        if s is d:
            continue
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"carry leaf {path}: {tuple(d.shape)} {d.dtype} -> "
                             f"{tuple(s.shape)} {s.dtype}")
        if s.untyped_storage().data_ptr() in ptrs:
            raise ValueError(f"carry leaf {path} was replaced by another leaf's memory")
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)


class LoopStep:
    """`step(work)` on a working copy of `carry` (the same tensors; the step
    replaces leaves of the copy), then the replaced leaves copied back into
    `carry`; `out` is what the step returned. `graph` None captures the step
    as a CUDA graph when the carry lies on the card and runs it eagerly on
    the CPU; False always runs it eagerly. Captured, `out` is the graph's
    own output, which the next replay overwrites in place. Tensors the step
    reads besides the carry (input buffers it is filled through, policies)
    must keep their addresses between calls. Each graph has its own memory
    pool (`pool_bytes`), so no replay writes into another graph's output: a
    shared pool would let a later capture lay its output over memory an
    earlier graph frees at the end of its capture and writes again at every
    replay."""

    def __init__(self, step, carry, graph: bool | None = None):
        self.step = step
        self.carry = carry
        self.out = None
        device = next(t for _, t in leaves(carry)).device
        self.graph = None
        if graph is None:
            graph = device.type == "cuda"
        if graph:
            self._capture(device)

    def _run(self) -> None:
        work = tree_map(lambda t: t, self.carry)
        self.out = self.step(work)
        copy_into(self.carry, work)

    def _capture(self, device) -> None:
        """Warm up on a side stream, put the carry back as it was, capture."""
        global _building
        _building += 1
        try:
            with span("graph.capture"):
                self._warm_up_and_capture(device)
        finally:
            _building -= 1

    def _warm_up_and_capture(self, device) -> None:
        saved = tree_map(torch.clone, self.carry)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(device).wait_stream(side)
        copy_into(self.carry, saved)
        self.graph = torch.cuda.CUDAGraph()
        # A dead reference cycle that holds another graph (a dropped rollout,
        # say) must not be collected inside the capture: destroying a graph
        # is an operation a capture refuses, and the refusal invalidates it.
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self._run()
        finally:
            if enabled:
                gc.enable()

    @property
    def pool_bytes(self) -> int:
        """Bytes of the card's memory that the graph's private pool holds
        (its segments in the caching allocator's snapshot); 0 eager."""
        if self.graph is None:
            return 0
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def __call__(self) -> None:
        if self.graph is None:
            with span("graph.eager"):
                self._run()
        else:
            with span("graph.replay"):
                self.graph.replay()

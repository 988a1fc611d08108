"""Profiling and tracing helpers (twin of `biped_pympc_tpu/utils/profiling.py`).

  * `device_timer`: seconds per call of a chained step, timed on the
    device's clock where the state lies on the card (CUDA events around the
    chain, one synchronization), on the host's otherwise.
  * `trace`: a `torch.profiler` context that writes a Chrome trace of the
    host and device activity of a block (load it in chrome://tracing or
    Perfetto).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch


def _device_of(tree):
    """The device of the first tensor of a tree of dataclasses, tuples,
    lists and dicts, or None."""
    if torch.is_tensor(tree):
        return tree.device
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    for v in tree if isinstance(tree, (list, tuple)) else ():
        dev = _device_of(v)
        if dev is not None:
            return dev
    return None


def device_timer(step_fn: Callable, state, chain_len: int = 10, reps: int = 3) -> float:
    """Median seconds per call of `step_fn(state) -> state`, chained
    `chain_len` times (each call takes the last one's output, so every step
    runs, in order), over `reps` chains after one warm-up chain. On the card
    each chain is timed between two CUDA events and waited for once; on the
    CPU with `time.perf_counter`."""
    dev = _device_of(state)
    cuda = dev is not None and dev.type == "cuda"

    def chain():
        st = state
        for _ in range(chain_len):
            st = step_fn(st)
        return st

    chain()  # warm-up: builds and loads kernels, fills caches
    times = []
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3 / chain_len)
        else:
            t0 = time.perf_counter()
            chain()
            times.append((time.perf_counter() - t0) / chain_len)
    return float(np.median(times))


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile a block: `with trace() as d: ctrl.run_mpc()` writes
    `d/trace.json`, a Chrome trace of the block's host calls and, where a
    card is visible, its kernels and copies. `log_dir` None is a directory
    under the temporary directory (`tempfile.gettempdir()`)."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "biped_pympc_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

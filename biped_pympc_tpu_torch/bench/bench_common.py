"""Shared workload and timing of the port's measurement scripts (twin of
`bench/bench_common.py`).

`make_qp_batch` builds the walking-class stress QPs (8 variants with
contact-chattering tables, tiled to the batch) through the port's
`build_qp`; `make_chained` chains dependent solves; `device_ms` times a
call on the card with CUDA events; `make_emitter` prints JSON lines.
Nothing here writes a file.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from biped_pympc_tpu_torch.models.srbd import SrbdLin
from biped_pympc_tpu_torch.ops import qp as qps

Q_DIAG = [150, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1]
R_DIAG = [1e-5] * 6 + [1e-4] * 6


def make_qp_batch(batch: int, horizon: int = 10, dtype=torch.float32,
                  device="cuda") -> qps.StageQP:
    """The 8 walking-class stress QPs (`bench_common.make_qp_batch`: seed 0,
    the draws rounded to float32 as there), tiled max(1, batch // 8) times
    and cut to `batch` envs, in `dtype` on `device`. As there, a batch that
    is not a multiple of 8 (over 8) gets the multiple of 8 below it."""
    rng = np.random.default_rng(0)
    x0 = np.stack([np.concatenate([rng.uniform(-0.05, 0.05, 3), [0, 0, 0.55],
                                   rng.uniform(-0.1, 0.1, 3), [0.05 * s, 0, 0]])
                   for s in range(8)]).astype(np.float32)
    contact = np.stack([(np.arange(horizon * 2).reshape(horizon, 2) + s) % 2
                        for s in range(8)]).astype(np.float32)
    x_ref = np.tile(np.asarray([0, 0, 0, 0, 0, 0.55, 0, 0, 0, 0.3, 0, 0], np.float32),
                    (8, horizon, 1))
    feet = x0[:, None, 3:6] + np.asarray([[0.02, 0.06, -0.55], [0.02, -0.06, -0.55]],
                                         np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
    eye = torch.eye(3, dtype=dtype, device=device).expand(8, 3, 3)
    lin = SrbdLin(rot_body=eye, inertia_world=t(np.diag([0.5413, 0.52, 0.0691])).expand(8, 3, 3),
                  body_pos=t(x0[:, 3:6]), foot_pos=t(feet), mass=t(np.full(8, 13.856)),
                  residual_lin_accel=t(np.zeros((8, 3))), residual_ang_accel=t(np.zeros((8, 3))))
    one = qps.build_qp(lin, t(x0), t(x_ref), t(contact), t(0.025), t(1.0), t(Q_DIAG), t(R_DIAG),
                       horizon)
    idx = torch.arange(8, device=device).repeat(max(1, batch // 8))[:batch]
    return qps.take(one, idx)


def make_chained(solve_fn, chain: int):
    """`chain` dependent solves (`bench_common.make_chained`): each solve's x
    feeds a 1e-12 perturbation of the next problem's f, so the solves run one
    after another on the device and none can be skipped. Returns a function
    of the QP batch giving the sum of the last solve's first column."""
    def chained(qp: qps.StageQP) -> torch.Tensor:
        x = torch.zeros_like(qp.f)
        for _ in range(chain):
            x = solve_fn(dataclasses.replace(qp, f=qp.f + 1e-12 * x)).x
        return x[:, 0].sum()
    return chained


def device_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Median over `reps` of the device time of `calls` calls of fn, per
    call, in ms, from CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def host_ms(fn, calls: int = 1, reps: int = 3) -> float:
    """Median over `reps` of the host time of `calls` calls of fn, per call,
    in ms, after one warm-up call (for CPU tensors: no device runs)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return float(np.median(times))


def require_card() -> str:
    """The name of CUDA device 0; raises when there is none, since a
    measurement of the card must not run elsewhere."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this measurement runs on the card")
    return torch.cuda.get_device_name(0)


def make_emitter(harness: str, params: dict | None = None):
    """JSON-line sink (`bench_common.make_emitter`, without its file): the
    first record is preceded by one header line {"run": harness, "utc": ...,
    "params": ...}; every record is printed as one JSON line."""
    header = {"run": harness, "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
              "params": dict(params or {})}
    printed = []

    def emit(obj: dict) -> None:
        if not printed:
            print(json.dumps(header), flush=True)
            printed.append(True)
        print(json.dumps(obj), flush=True)

    return emit

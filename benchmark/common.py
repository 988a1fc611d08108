"""What every cell of the benchmark shares: the measured window, the reading
of a profiler trace, the statistics, the gaps the checks compare, and the
result line.

Nothing here imports the program under test; the loops under `loops/`
do, and only inside their functions.
"""

from __future__ import annotations

import collections
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
# Top-level module names that may not be loaded in a benchmark process.
FORBIDDEN = ("jax", "jaxlib", "flax", "biped_pympc_tpu")


def load_json(path: str) -> dict:
    with open(path if os.path.isabs(path) else os.path.join(REPO, path)) as fh:
        return json.load(fh)


def forbidden_modules() -> list[str]:
    """The forbidden top-level modules loaded in this process, compared by
    whole top-level name (`biped_pympc_tpu_torch` is not `biped_pympc_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rate_window(issue, seconds: float, in_flight: int, device: torch.device):
    """Issue units of work back to back, `issue(i)` for i = 0, 1, ..., until
    `seconds` of host time have passed, keeping at most `in_flight` units
    unfinished on the device (an event recorded after each; the host waits
    for the oldest, so the device never runs dry and the host never runs
    ahead), then wait for all of them. Returns (units issued and finished,
    seconds from the first issue to the end of the last unit)."""
    sync(device)
    pending = collections.deque()
    t0 = time.perf_counter()
    n = 0
    while True:
        issue(n)
        n += 1
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) >= in_flight:
                pending.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return n, time.perf_counter() - t0


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between order
    statistics (numpy's default), over the whole list."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Reservoir:
    """A uniform sample of k items of a stream of unknown length, drawn from
    `seed`: `take(i)` says, before item i is produced, whether to keep it
    and which slot it replaces (None: not kept)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.gen = torch.Generator().manual_seed(seed)

    def take(self, i: int):
        if i < self.k:
            return i
        j = int(torch.randint(0, i + 1, (1,), generator=self.gen))
        return j if j < self.k else None


def env_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) per env the largest |a - b| over its other axes, in float64;
    inf where either side is not finite."""
    d = (a.double() - b.double()).abs().flatten(1)
    bad = ~(torch.isfinite(a).flatten(1).all(1) & torch.isfinite(b).flatten(1).all(1))
    return torch.where(bad, torch.full_like(d[:, 0], math.inf), d.amax(1))


def quantile(x: torch.Tensor, q: float) -> float:
    """The q-quantile (0-1) of a (B,) tensor of gaps, inf counted as inf."""
    return float(torch.quantile(x.double().cpu(), q))


@dataclass
class Check:
    """One compared number and the limit it may not exceed."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Trace:
    """A traced window: device intervals [(name, start_us, end_us)], host
    operations [(name, start_us, end_us)], the window's bounds in the same
    clock, the units of work it ran, and what the metric readers need of the
    cell (`info`: the configuration, the units' sizes)."""

    device: list
    host: list
    start: float
    end: float
    units: int
    info: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)  # {name: [ms]} of the loop's CUDA events

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_us(self) -> float:
        """Microseconds of the window in which some device operation ran
        (the union of the intervals, clipped to the window)."""
        busy, reach = 0.0, self.start
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            s, e = max(s, reach), min(e, self.end)
            if e > s:
                busy += e - s
                reach = e
        return busy

    def gaps(self):
        """[(start_us, end_us)] of the window's idle stretches, the ends of
        the window included."""
        out, reach = [], self.start
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if s > reach:
                out.append((reach, min(s, self.end)))
            reach = max(reach, e)
            if reach >= self.end:
                break
        if reach < self.end:
            out.append((reach, self.end))
        return [(s, e) for s, e in out if e > s]

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_us() / (self.end - self.start))

    def breakdown(self) -> dict:
        """The ten device operations that took the most time, and the ten
        longest idle gaps, each named by the innermost host operation that
        overlaps its middle."""
        by_name = collections.Counter()
        for name, s, e in self.device:
            by_name[name] += (e - s) * 1e-6
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:10]

        def host_at(t):
            inside = [(e - s, n) for n, s, e in self.host if s <= t <= e]
            return min(inside)[1] if inside else "(no host operation)"

        return {"device_ops": [[n, v] for n, v in by_name.most_common(10)],
                "idle_gaps": [[host_at((s + e) / 2), (e - s) * 1e-6] for s, e in gaps]}


def trace_window(run_units, units: int, device: torch.device, info: dict) -> Trace:
    """Run `run_units(units)` under torch.profiler (CUPTI) and read it: the
    window runs from the first operation the host issues to the end of a
    synchronize after the last, as the profiler's own clock has them.
    `run_units` may return {span name: [(start, end) CUDA events]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("benchmark.window"):
            spans = run_units(units) or {}
            sync(device)
    dev, host, start, end = [], [], None, None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            if e.name != "benchmark.window":  # the window's own span, mirrored on the device
                dev.append((e.name, s, t))
        else:
            host.append((e.name, s, t))
            if e.name == "benchmark.window":
                start, end = s, t
    if start is None:
        raise RuntimeError("the profiler lost the window's own span")
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans.items()}
    return Trace(dev, host, start, end, units, info, ms)


def device_description(device: torch.device, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}

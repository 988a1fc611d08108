"""What the per-layer metric readers share: which device operations belong
to which layer of the program, read from their names in a trace."""

from __future__ import annotations


def is_pdipm(name: str) -> bool:
    """The PDIPM kernels (`pdipm_kernel<Route, Scalar, Group>`, every route)."""
    return "pdipm_kernel" in name


def device_ms(trace, pred) -> float | None:
    """Device milliseconds a unit of the operations whose names satisfy
    `pred` (their durations summed), or None where none ran."""
    durs = [e - s for name, s, e in trace.device if pred(name)]
    if not durs or not trace.units:
        return None
    return sum(durs) * 1e-3 / trace.units


def count(trace, pred) -> float | None:
    """Device operations a unit whose names satisfy `pred`, or None."""
    n = sum(1 for name, _, _ in trace.device if pred(name))
    return n / trace.units if n and trace.units else None


def idle_pct(trace) -> float | None:
    return trace.idle_pct() if trace.device else None


def mean_span_ms(trace, name: str) -> float | None:
    ms = trace.spans.get(name)
    return sum(ms) / len(ms) if ms else None

"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration (its file
under `benchmark/configs/`) and a traffic mix (`benchmark/traffic/<mix>.json`,
whose `loop` names the module of `benchmark/loops/` that runs it); its
limits are `benchmark/limits/<cell>.json` and its per-layer metrics are the
readers `benchmark/metrics/<metric>.py`. Set-up builds and warms everything
the cell uses; the window then measures for `--seconds`; with `--trace 1` a
short profiled run of the same work follows and the per-layer metrics are
printed instead of the end-to-end ones. After the window the program's state
is freed and the float64 reference checks what the window produced.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH)
sys.path.insert(0, REPO)


def cell_spec(name: str):
    """(cell, configuration, traffic mix, limits, per-layer metrics) of a cell."""
    from benchmark.common import load_json

    bench = load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the cells are {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = {m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])} - {"setup_s"}
    layers = [m for m in bench["per_layer"]
              if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
    return (cell, load_json(conf["file"]), load_json(f"benchmark/traffic/{cell['traffic']}.json"),
            load_json(f"benchmark/limits/{name}.json"), layers)


def read_metric(name: str, trace):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def run(workload: str, seed: int, seconds: float, trace: bool, device=None) -> dict:
    """One run of a cell; returns the result object. `device` None is the
    card, which must be there; tests pass the CPU."""
    import torch

    from benchmark.common import device_description, sync, trace_window

    cell, cfg, mix, limits, layers = cell_spec(workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{workload} needs {cell['chips']} CUDA device(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                             "visible")
        device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = importlib.import_module(f"benchmark.loops.{mix['loop']}")
    run_loop = loop.Loop(cfg, mix, seed, device)
    sync(device)
    setup_s = time.perf_counter() - T0
    res = run_loop.window(seconds)
    out = {"attempted": res["attempted"], "failed": res["failed"]}
    if trace:
        tr = trace_window(run_loop.run_units, mix["trace_units"], device, run_loop.trace_info())
        values = {m["name"]: read_metric(m["name"], tr) for m in layers}
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in layers if values[m["name"]] is not None}
        busy = tr.busy_us() * 1e-6
    else:
        out["metrics"] = {loop.METRIC: {"value": res["value"], "unit": loop.UNIT},
                          "setup_s": {"value": setup_s, "unit": "s"}}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run_loop.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = run_loop.checks(limits, device)
    out["correct"] = all(c.ok for c in checks)
    out["device"] = (device_description(device, cell["chips"]) if device.type == "cuda"
                     else {"platform": "cpu", "kind": "cpu", "count": 1})
    out["device"]["memory_peak_bytes"] = peak
    if trace:
        out["device"].update(busy_s=busy, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))

    from benchmark.common import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the benchmark process: {found}", file=sys.stderr)
        return 3
    order = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
    line = {k: out[k] for k in order if k in out}
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

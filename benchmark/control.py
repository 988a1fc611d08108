"""Readings that the limits of `benchmark/limits/<cell>.json` are set from,
taken on the card at the cell's own size, all seeds in one process:

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds 11,12,... --control-seeds 21,22,23 [--dtype bfloat16]

For each of `--seeds` a run of the program (set-up, a window of `--seconds`)
and its compared numbers; for each of `--control-seeds` the same run with
the reference computed in `--dtype` put in the program's place (the
control), which the limits must fail. One JSON line per run on standard
output. The benchmark's own runs never run this.
"""

import argparse
import gc
import importlib
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(BENCH))


def readings(workload: str, seeds, control_seeds, seconds: float, dtype: str, device=None):
    """Yield one dict per run: the seed, the side and the compared numbers."""
    import torch

    from benchmark.run import cell_spec

    _, cfg, mix, limits, _ = cell_spec(workload)
    device = device or torch.device("cuda", 0)
    loop = importlib.import_module(f"benchmark.loops.{mix['loop']}")
    for side, seed in [("program", s) for s in seeds] + [("control", s) for s in control_seeds]:
        run_loop = loop.Loop(cfg, mix, seed, device)
        res = run_loop.window(seconds)
        run_loop.release()
        gc.collect()
        if side == "control":
            run_loop.use_control(getattr(torch, dtype), device)
        checks = run_loop.checks(limits, device)
        yield {"workload": workload, "side": side, "seed": seed, "dtype": dtype,
               "failed": res["failed"], "checks": {c.name: c.value for c in checks}}
        del run_loop
        gc.collect()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--dtype", default="bfloat16")
    args = p.parse_args(argv)
    split = lambda s: [int(v) for v in s.split(",") if v]
    for row in readings(args.workload, split(args.seeds), split(args.control_seeds), args.seconds,
                        args.dtype):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""`MPCController.run_mpc` of another checkout against this one's, on the card.

    python -m biped_pympc_tpu_torch.bench.run_mpc_ab DIR [--batch 4096] [--rounds 1]
        [--paths default,hybrid]

DIR is the root of another checkout of this repo (for instance the parent
commit, `git archive <commit> | tar -x -C DIR`). Each turn is one process
started in a checkout's root, on its own package: it builds the
checkout's kernels (`pdipm_cuda.build`, into the checkout's build
directory), makes the controller of each of `--paths` (keys of `PATHS`: the
default solver, `solver="pallas_hybrid"`, `"pallas_ric2"`, `"pallas_ric"`
unsplit, and `"pallas_hybrid"` and `"pallas_ric"` with `solver_foot_pack`)
at `--batch` envs (HECTOR, walking gait, f32, the standing
observation) and times one `run_mpc` of each: device ms from CUDA events,
the mean of 10 calls after a warm-up call, the median of 3. With `--tick`
a turn also times the first path's 1 kHz tick (`update_state` +
`run_lowlevel` + `get_action`, the mean of 50; replayed CUDA graphs in a
checkout whose `MPCController` captures its calls) and counts the device's
events a tick and a `run_mpc` (kernels, copies and fills, from a
torch.profiler trace of 10 ticks and 3 solves; null where the trace holds no
device event). The turns run DIR, this, this, DIR (`--rounds` times), so
that a drift of the host's load shows as a drift and not as a difference.
The last line is one JSON object with every turn's times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# The controller paths a turn can time: name -> MPCConf keyword arguments.
PATHS = {"default": {}, "hybrid": {"solver": "pallas_hybrid"},
         "ric2": {"solver": "pallas_ric2"},
         "ric_dense": {"solver": "pallas_ric", "solver_foot_split": False},
         "hybrid_pack": {"solver": "pallas_hybrid", "solver_foot_pack": True},
         "ric_pack": {"solver": "pallas_ric", "solver_foot_pack": True}}

# The code of one turn, run by `python -c` in a checkout's root with its
# root, the batch and the paths' {name: MPCConf keywords} as arguments; it
# prints one JSON object.
TURN = r"""
import json, sys
root, batch, paths, tick = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3]), sys.argv[4]
sys.path.insert(0, root)
import numpy as np
import torch
from biped_pympc_tpu_torch import ControllerConf, MPCConf, MPCController
from biped_pympc_tpu_torch.ops import pdipm_cuda

pdipm_cuda.build()
obs = np.zeros((batch, 43), np.float32)
obs[:, 2], obs[:, 3] = 0.55, 1.0
obs[:, 13:18] = obs[:, 18:23] = (0.0, 0.0, 0.45, -0.9, 0.45)
obs = torch.tensor(obs, device="cuda")
twist = torch.zeros(batch, 3, device="cuda")
twist[:, 0] = 0.3
height = torch.full((batch,), 0.55, device="cuda")


def device_ms(fn, calls=10, reps=3):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return float(np.median(out))


def device_events(fn, reps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(getattr(e, "device_type", None) == DeviceType.CUDA for e in prof.events())
    return n / reps if n else None


times, ctrls = {}, {}
for name, kw in paths.items():
    conf = MPCConf(verbose=False, **kw)
    ctrl = ctrls[name] = MPCController(ControllerConf(), conf, num_envs=batch, gait_id=2,
                                       device="cuda")
    ctrl.set_command(twist, height)
    ctrl.update_state(obs)
    times[name] = device_ms(ctrl.run_mpc)
if tick == "1":
    ctrl = ctrls[next(iter(paths))]

    def one_tick():
        ctrl.update_state(obs)
        ctrl.run_lowlevel()
        ctrl.get_action()

    times["tick"] = device_ms(one_tick, calls=50)
    times["tick_events"] = device_events(one_tick, 10)
    times["run_mpc_events"] = device_events(ctrl.run_mpc, 3)
print(json.dumps(times))
"""


def turn(root: str, batch: int, paths, tick: bool = False) -> dict:
    """{path: ms} of one turn in the checkout at `root`, for each of `paths`
    (keys of PATHS), with the tick's ms and the device events a tick and a
    run_mpc when `tick`."""
    root = os.path.abspath(root)
    out = subprocess.run([sys.executable, "-c", TURN, root, str(batch),
                          json.dumps({p: PATHS[p] for p in paths}), str(int(tick))],
                         capture_output=True, text=True, cwd=root, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--paths", default="default,hybrid",
                    help=f"comma-separated keys of {sorted(PATHS)}")
    ap.add_argument("--tick", action="store_true",
                    help="also time the first path's tick and count device events")
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    unknown = set(paths) - set(PATHS)
    if unknown:
        ap.error(f"unknown paths {sorted(unknown)}; known: {sorted(PATHS)}")
    label = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.strip()
    print(label)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tag = os.path.basename(os.path.normpath(args.other))
    order = [(tag, args.other), ("this", here), ("this", here), (tag, args.other)]
    runs = []
    for _ in range(args.rounds):
        for name, root in order:
            runs.append({"checkout": name, **turn(root, args.batch, paths, args.tick)})
            print(f"[run_mpc ab] {label}: b{args.batch} f32 {name}: run_mpc "
                  + ", ".join(f"{p} {runs[-1][p]:.3f} ms" for p in paths)
                  + ("" if not args.tick else f"; tick {runs[-1]['tick']:.3f} ms, device events "
                     f"a tick {runs[-1]['tick_events']}, a run_mpc "
                     f"{runs[-1]['run_mpc_events']}"), flush=True)
    for key in paths + ["tick"] * args.tick:
        mean = {n: sum(r[key] for r in runs if r["checkout"] == n)
                / sum(r["checkout"] == n for r in runs) for n in (tag, "this")}
        print(f"[run_mpc ab] {label}: {key} mean over turns, {tag} {mean[tag]:.3f} ms / this "
              f"{mean['this']:.3f} ms ({mean['this'] / mean[tag] - 1:+.2%})")
    print(json.dumps({"device": label, "batch": args.batch, "turns": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

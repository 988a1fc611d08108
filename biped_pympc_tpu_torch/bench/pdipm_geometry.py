"""The PDIPM routes, each with a warp group (K1, K2, K5b, K5d-a, K5a, K5e-a,
K5c, K5d-c, K5e-c: `ROUTES`), in their launch geometries on the card: where a Newton step's
cycles go, how many envs reside on an SM, and the solve times of the block
group and the warp group in turns.

The breakdown runs a build of the route with `-DPDIPM_PROFILE`
(`build_profile`): each group's first thread reads clock64() at the
phase marks of csrc/pdipm_common.cuh (`PH_*`, `PHASES` here) and books the
cycles since the previous mark to that phase; the kernel writes each env's
totals at its end. The production libraries have no marks. `chip_smoke.py`
runs these functions on its b4096 batch; run alone,

    python -m biped_pympc_tpu_torch.bench.pdipm_geometry [ROUTE ...]

prints the same lines for the 8 stress QPs of `bench_common.make_qp_batch`
tiled to b4096, for the named routes (keys of `ROUTES`) or all of them
(needs the card).
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import torch

from biped_pympc_tpu_torch.bench import bench_common
from biped_pympc_tpu_torch.ops import cuda_build, pdipm, pdipm_cuda

PHASES = ("load", "resid", "reduce", "foot", "pt", "ychain", "stage", "sweep", "refine",
          "update", "store")
PER_LAUNCH = ("load", "store")  # booked once per launch; the rest per Newton step
PROFILE_FLAGS = ("-DPDIPM_PROFILE",)
# The routes with a breakdown and a warp group, and their options on top of
# the controller's (`BASE`): K1, K2, K5b, K5d-a, K5a, K5e-a (its paired form,
# foot_pack True), K5c, K5d-c and K5e-c (its paired form).
BASE = pdipm.PdipmOptions(backend="ric_aug", foot_split=True, refine_steps=1)
ROUTES = {"ric_aug": {}, "ric": {"backend": "ric"},
          "tridiag_aug": {"backend": "tridiag_aug", "foot_split": False},
          "ric_aug_dense": {"foot_split": False},
          "tridiag": {"backend": "tridiag", "foot_split": False},
          "ric_aug_pack": {"foot_pack": True},
          "ric2": {"backend": "ric2", "foot_split": False},
          "ric_dense": {"backend": "ric", "foot_split": False},
          "ric_pack": {"backend": "ric", "foot_pack": True}}


def route_opts(route: str, base: pdipm.PdipmOptions = BASE) -> pdipm.PdipmOptions:
    """`base` on route `route` (a key of ROUTES)."""
    return dataclasses.replace(base, **ROUTES[route])

_prof_libs: dict = {}


def profile_paths() -> dict:
    """{route: .so path} of the PDIPM_PROFILE builds of the ROUTES."""
    return {r: cuda_build.library_path(f"pdipm_{r}_profile", pdipm_cuda.SOURCES[r],
                                       pdipm_cuda.HEADERS, pdipm_cuda.BUILD_DIR, PROFILE_FLAGS)
            for r in ROUTES}


def build_profile() -> dict:
    """Build the profile libraries of the ROUTES (one nvcc each, together)."""
    return cuda_build.build({r: pdipm_cuda.SOURCES[r] for r in ROUTES},
                            profile_paths(), pdipm_cuda.BUILD_DIR, flags=PROFILE_FLAGS)


def _profile_library(route: str):
    if route not in _prof_libs:
        _prof_libs[route] = pdipm_cuda.load_library(build_profile()[route], route)
    return _prof_libs[route]


def sass_sizes(path: str) -> dict:
    """{kernel: SASS instructions} of the Newton-step kernels in the library
    at `path` (cuobjdump, the toolkit's)."""
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split()[0]
        m = re.match(r"_Z\d+pdipm_kernelI\d+(\w+?)([fd])(\d+)(BlockGroup|WarpGroup)(?:ILi(\d)EE)?",
                     name)
        if m:
            group = m.group(4) + (f"<{m.group(5)}>" if m.group(5) else "")
            key = f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'f64'} {group}"
            out[key] = len(re.findall(r"/\*[0-9a-f]{4,}\*/", chunk))
    return out


def breakdown(qp, opts, geom) -> dict:
    """{phase: cycles} of one launch of `opts` on `qp` in `geom` through the
    profile build, the mean over envs: per Newton step, but `PER_LAUNCH`
    phases per launch; and "step", the sum of the per-step phases."""
    route = pdipm_cuda.route(opts)
    lib = _profile_library(route)
    nb = min(qp.f.shape[0], 4096)
    read = getattr(lib, f"pdipm_{route}_profile_read")
    out = np.zeros((nb, len(PHASES)), np.uint64)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):  # the first launch warms up; each read clears the table
        pdipm_cuda.run_kernel(lib, qp, opts, stream, geom=geom)
        torch.cuda.synchronize()
        err = read(out.ctypes.data, nb)
        if err != 0:
            raise RuntimeError(f"profile read failed ({err})")
    mean = out.astype(np.float64).mean(axis=0)
    res = {ph: float(mean[i]) / (1 if ph in PER_LAUNCH else opts.iterations)
           for i, ph in enumerate(PHASES)}
    res["step"] = sum(v for ph, v in res.items() if ph not in PER_LAUNCH)
    return res


def breakdown_line(tag: str, res: dict) -> str:
    """One line of a breakdown: cycles per Newton step and share by phase."""
    step = res["step"]
    parts = ", ".join(f"{ph} {res[ph]:.0f} ({res[ph] / step:.1%})" for ph in PHASES
                      if ph not in PER_LAUNCH)
    return (f"{tag}: {step:.0f} cycles per Newton step of one env: {parts}; per launch load "
            f"{res['load']:.0f}, store {res['store']:.0f}")


def envs_per_sm(route: str, horizon: int, dtype, geom, workspace: bool = False) -> int:
    """Resident envs per SM of `route` in `geom` (the block group or the
    route's warp group as it launches; with `workspace`, a WORK_ROUTES warp
    group with its stored inverses in the workspace), from the CUDA
    occupancy calculator (`pdipm_<route>_envs_per_sm`)."""
    lib = pdipm_cuda._library(route)
    size = torch.empty((), dtype=dtype).element_size()
    mode = 2 if workspace else int(geom.lean)
    n = getattr(lib, f"pdipm_{route}_envs_per_sm")(horizon, size, mode)
    if n < 0:
        raise RuntimeError(f"occupancy query failed ({-n})")
    return n


def solve_in(qp, opts, geom, force_workspace: bool | None = None):
    """One solve of `opts` on `qp` (CUDA tensors) in `geom`: the block group
    (`pdipm_cuda.BLOCK`) or the route's own geometry (`force_workspace` as
    in `pdipm_cuda.run_kernel`)."""
    lib = pdipm_cuda._library(pdipm_cuda.route(opts))
    return pdipm_cuda.run_kernel(lib, qp, opts, torch.cuda.current_stream().cuda_stream,
                                 geom=geom, force_workspace=force_workspace)


def turns(qp, opts, old, new, calls: int = 10) -> list:
    """Device ms of one solve in geometry `old` and `new`, in turns: old,
    new, new, old (`bench_common.device_ms`, median of 3)."""
    run = lambda g: bench_common.device_ms(lambda: solve_in(qp, opts, g), calls, 3)
    return [run(old), run(new), run(new), run(old)]


def workspace_turns(qp, opts, calls: int = 3) -> list:
    """A WORK_ROUTES warp group with its stored inverses in shared memory
    and in the workspace, in turns: shared, workspace, workspace, shared
    (device ms as `turns`). The shared-memory layout must fit."""
    geom = pdipm_cuda.geometry(pdipm_cuda.route(opts))
    run = lambda w: bench_common.device_ms(lambda: solve_in(qp, opts, geom, w), calls, 3)
    return [run(False), run(True), run(True), run(False)]


def main(argv=()) -> int:
    routes = list(argv) or list(ROUTES)
    unknown = set(routes) - set(ROUTES)
    if unknown:
        print(f"unknown routes {sorted(unknown)}; known: {list(ROUTES)}", file=sys.stderr)
        return 2
    bench_common.require_card()
    pdipm_cuda.build()
    for dtype in (torch.float32, torch.float64):
        qp = bench_common.make_qp_batch(4096, dtype=dtype)
        for route in routes:
            opts = route_opts(route)
            new = pdipm_cuda.geometry(route)
            for tag, geom in (("block", pdipm_cuda.BLOCK), ("new", new)):
                print(breakdown_line(f"[breakdown] {route} {dtype} b4096 {tag} {geom}",
                                     breakdown(qp, opts, geom)))
                print(f"[occupancy] {route} {dtype} {tag}: "
                      f"{envs_per_sm(route, qp.horizon, dtype, geom)} envs per SM")
            print(f"[turns] {route} {dtype} b4096 block / new / new / block ms: "
                  f"{turns(qp, opts, pdipm_cuda.BLOCK, new, 3)}")
            if route in pdipm_cuda.WORK_ROUTES:
                print(f"[workspace] {route} {dtype} b4096 shared / workspace / workspace / "
                      f"shared ms: {workspace_turns(qp, opts)}; envs per SM "
                      f"{envs_per_sm(route, qp.horizon, dtype, new)} as it launches, "
                      f"{envs_per_sm(route, qp.horizon, dtype, new, True)} with the workspace")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

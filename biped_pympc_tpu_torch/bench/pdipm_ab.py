"""The PDIPM kernels of other checkouts against this one's, on the card.

    python -m biped_pympc_tpu_torch.bench.pdipm_ab DIR [DIR ...]

Each DIR is the root of another checkout of this repo (for instance the
parent commit, `git archive <commit> | tar -x -C DIR`). Its libraries of the
routes in `ROUTES` are built by its own `ops/pdipm_cuda.py`, and loaded
here through their block-group entries, whose C interface every build
shares (`pdipm_<route>_f32` / `_f64`, `_smem_bytes`, `_error_string`). The
script prints, per build, the SASS instructions, registers and stack of
each Newton-step kernel (cuobjdump); then each block-group route's b4096
solve (`bench_common.make_qp_batch`, cold, 20 steps, one refinement step)
in f32 and f64, timed in turns (this build, the others, the others in
reverse, this build; `bench_common.device_ms`, median of 3), with whether
every build gives the same bits; then this build's warp groups (K1, K2,
K5b, K5d-a, K5a, K5e-a, K5c, K5d-c, K5e-c), each in turns with the first other build's block
group, and with each other build's warp group of the same route where that
build has one (its warp entries share this build's C interface).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from biped_pympc_tpu_torch.bench import bench_common
from biped_pympc_tpu_torch.bench import pdipm_geometry as pg
from biped_pympc_tpu_torch.ops import cuda_build, pdipm, pdipm_cuda

BASE = pg.BASE
# The block-group routes compared: tag -> options.
ROUTES = {"K1": BASE, "K2": dataclasses.replace(BASE, backend="ric"),
          "K5a": dataclasses.replace(BASE, backend="tridiag", foot_split=False),
          "K5b": pg.route_opts("tridiag_aug"),
          "K5c": dataclasses.replace(BASE, backend="ric2", foot_split=False),
          "K5d-c": dataclasses.replace(BASE, backend="ric", foot_split=False),
          "K5d-a": pg.route_opts("ric_aug_dense"),
          "K5e-c": dataclasses.replace(BASE, backend="ric", foot_pack=True),
          "K5e-a": pg.route_opts("ric_aug_pack")}
KEYS = sorted({pdipm_cuda.route(o) for o in ROUTES.values()})


def build_checkout(root: str) -> dict:
    """{route: .so path} of KEYS built in the checkout at `root` by its own
    pdipm_cuda (into its own build directory)."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]);"
            "from biped_pympc_tpu_torch.ops import cuda_build as c, pdipm_cuda as p;"
            "keys = json.loads(sys.argv[2]);"
            "paths = {k: p.library_path(k) for k in keys};"
            "c.build({k: p.SOURCES[k] for k in keys}, paths, p.BUILD_DIR, nvcc=c.find_nvcc);"
            "print(json.dumps(paths))")
    out = subprocess.run([sys.executable, "-c", code, os.path.abspath(root), json.dumps(KEYS)],
                         capture_output=True, text=True, cwd=root, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"build in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def load_block(path: str, route: str) -> ctypes.CDLL:
    """A library of any build, with only its block-group entries declared."""
    lib = ctypes.CDLL(path)
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"pdipm_{route}_{suffix}")
        fn.argtypes, fn.restype = pdipm_cuda.ENTRY_ARGTYPES, ctypes.c_int
    fn = getattr(lib, f"pdipm_{route}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_size_t
    fn = getattr(lib, f"pdipm_{route}_error_string")
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def kernel_sizes(path: str) -> list:
    """'<policy> <f32|f64> <group>: N instructions, registers / stack B R / S'
    of every Newton-step kernel in the library at `path`."""
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    res = subprocess.run([tool, "-res-usage", path], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    usage = dict(re.findall(r"Function (\S+):\s*\n\s*(REG:\d+ STACK:\d+)", res))
    out = []
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        m = re.match(r"_Z\d+pdipm_kernelI\d+(\w+?)([fd])(?:\d+(BlockGroup|WarpGroup)"
                     r"(?:ILi(\d)EE)?)?", name)
        if not m:
            continue
        n = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?[A-Z]", chunk))
        group = (m.group(3) or "BlockGroup") + (f"<{m.group(4)}>" if m.group(4) else "")
        regs = usage.get(name, "REG:? STACK:?").replace("REG:", "").replace(" STACK:", " / ")
        out.append(f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'f64'} {group}: {n} "
                   f"instructions, registers / stack B {regs}")
    return out


def digest(res) -> str:
    h = hashlib.sha256()
    for t in (res.x, res.s, res.z, res.y, res.residuals):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv) -> int:
    bench_common.require_card()
    label = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.strip()
    print(label)
    others = list(argv)
    if not others:
        print("usage: python -m biped_pympc_tpu_torch.bench.pdipm_ab DIR [DIR ...]",
              file=sys.stderr)
        return 2
    tags = ["this"] + [os.path.basename(os.path.normpath(d)) for d in others]
    this = {k: pdipm_cuda.library_path(k) for k in KEYS}
    with ThreadPoolExecutor(len(tags)) as pool:  # every build's nvcc runs at once
        jobs = [pool.submit(cuda_build.build, {k: pdipm_cuda.SOURCES[k] for k in KEYS}, this,
                            pdipm_cuda.BUILD_DIR)]
        jobs += [pool.submit(build_checkout, root) for root in others]
        paths = dict(zip(tags, (j.result() for j in jobs)))
    libs = {tag: {k: load_block(p, k) for k, p in ps.items()} for tag, ps in paths.items()}
    for tag, ps in paths.items():
        for k, p in ps.items():
            print(f"[ab sass] {tag} {k}: " + "; ".join(kernel_sizes(p)))
    stream = lambda: torch.cuda.current_stream().cuda_stream
    order = tags + tags[:0:-1] + ["this"]
    for dtype in (torch.float32, torch.float64):
        qp = bench_common.make_qp_batch(4096, dtype=dtype)
        dt = str(dtype)[6:]
        for name, o in ROUTES.items():
            key = pdipm_cuda.route(o)
            run = lambda t: pdipm_cuda.run_kernel(libs[t][key], qp, o, stream(),
                                                  geom=pdipm_cuda.BLOCK)
            ms = [(t, bench_common.device_ms(lambda: run(t), 5, 3)) for t in order]
            same = len({digest(run(t)) for t in tags}) == 1
            print(f"[ab block] {label}: {name} {dt} b4096 ms: "
                  + " / ".join(f"{t} {v:.3f}" for t, v in ms) + f"; same bits: {same}")
        for key in pdipm_cuda.LEAN_ROUTES:
            o = pg.route_opts(key)
            geom = pdipm_cuda.geometry(key)
            lib = pdipm_cuda.load_library(this[key], key)
            warp = lambda: pdipm_cuda.run_kernel(lib, qp, o, stream(), geom=geom)
            old = lambda: pdipm_cuda.run_kernel(libs[tags[1]][key], qp, o, stream(),
                                                geom=pdipm_cuda.BLOCK)
            ms = [bench_common.device_ms(fn, 5, 3) for fn in (old, warp, warp, old)]
            print(f"[ab warp] {label}: {key} {dt} b4096, {tags[1]} block group / this build's "
                  f"{geom} / the same / {tags[1]} block group: "
                  + " / ".join(f"{v:.3f}" for v in ms) + " ms")
            for tag in tags[1:]:
                if not hasattr(libs[tag][key], f"pdipm_{key}_warp_f32"):
                    continue
                other = pdipm_cuda.load_library(paths[tag][key], key)
                owarp = lambda: pdipm_cuda.run_kernel(other, qp, o, stream(), geom=geom)
                ms = [bench_common.device_ms(fn, 5, 3) for fn in (owarp, warp, warp, owarp)]
                print(f"[ab warp same] {label}: {key} {dt} b4096, {tag} / this / this / {tag} "
                      f"{geom}: " + " / ".join(f"{v:.3f}" for v in ms)
                      + f" ms; same bits: {digest(owarp()) == digest(warp())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

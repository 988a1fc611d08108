"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

Every library is compiled with nvcc for sm_90a (`NVCC_FLAGS`; never with
`--use_fast_math`) at first use into a git-ignored build directory. Its file
name carries a hash of its source, the headers it includes and the flags
(`library_path`), so an edit to any of them builds anew, and `build` starts
one nvcc per library not built yet, all together.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# -Xptxas -v: ptxas reports each kernel's registers and spills into the
# compiler output, which `build` keeps beside the library (`build_log`); it
# does not change the code.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


# Seconds each library's nvcc ran, {library path: seconds}, for the builds of
# this process (the wall time of its own process, beside the others built
# with it).
build_seconds: dict = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "toolkit is needed to build the kernels")


def library_path(name: str, source: str, headers, build_dir: str, flags=()) -> str:
    """Where library `name` of `source` is built: lib<name>_<hash>.so in
    `build_dir`, the hash over the flags (NVCC_FLAGS and the extra `flags`),
    the source and `headers`."""
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *flags]).encode())
    for path in (source, *headers):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(build_dir, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_log(path: str) -> str | None:
    """The compiler's output of the build of the library at `path`, kept
    beside it as lib<name>_<hash>.log; None when there is none."""
    log = os.path.splitext(path)[0] + ".log"
    if not os.path.exists(log):
        return None
    with open(log) as fh:
        return fh.read()


def build(sources: dict, paths: dict, build_dir: str, nvcc=find_nvcc, flags=(),
          nice: int = 0) -> dict:
    """Compile every library of `sources` ({key: .cu path}) whose file in
    `paths` ({key: .so path}) does not exist yet, one nvcc each with
    NVCC_FLAGS and the extra `flags`, all started together (under `nice -n
    nice` when `nice`, so that a build in the background leaves the CPU to
    the caller's other work); return `paths`.
    `nvcc` is called for the compiler's path only when something is to be
    built. Raises RuntimeError with the compiler's output if any nvcc fails;
    a library is moved into place only once whole, its compiler output
    written beside it first (`build_log`); each nvcc's seconds go to
    `build_seconds`."""
    todo = [key for key, path in paths.items() if not os.path.exists(path)]
    if not todo:
        return paths
    compiler = nvcc()
    os.makedirs(build_dir, exist_ok=True)
    jobs, failed = [], []

    def wait(job):
        """(stdout, stderr, seconds) of one job's nvcc, read as it runs."""
        out, err = job[4].communicate()
        return out, err, time.perf_counter() - job[3]

    try:
        for key in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
            os.close(fd)
            cmd = [compiler, *NVCC_FLAGS, *flags, "-o", tmp, sources[key]]
            run = ["nice", "-n", str(nice), *cmd] if nice else cmd
            jobs.append((key, cmd, tmp, time.perf_counter(), subprocess.Popen(
                run, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        with ThreadPoolExecutor(len(jobs)) as pool:
            done = list(pool.map(wait, jobs))
        for (key, cmd, tmp, _, proc), (out, err, seconds) in zip(jobs, done):
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
            else:
                with open(os.path.splitext(paths[key])[0] + ".log", "w") as fh:
                    fh.write(out + err)
                os.replace(tmp, paths[key])  # atomic: a concurrent build never loads a partial file
                build_seconds[paths[key]] = seconds
    finally:
        for _, _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths

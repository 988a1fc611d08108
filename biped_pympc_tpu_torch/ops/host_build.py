"""Build a kernel library of the port for the host CPU, with g++ and
`ops/host_shim.h` in place of the CUDA runtime, so that a test can run the
kernels' device code without a card.

The source and the headers it includes are copied into a scratch directory
with the two pieces of CUDA syntax g++ cannot read rewritten: the `extern
__shared__` array becomes the shim's block buffer, and a launch
`kernel<<<grid, threads, smem, stream>>>(args)` becomes
`shim_launch(grid, threads, smem, stream, kernel, args)`. The library has
the C interface of the CUDA build; load it with `pdipm_cuda.load_library`
and call it on CPU tensors (`pdipm_cuda.run_kernel`). Every CUDA thread is a
host thread, so only small batches and horizons are practical.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host_shim.h")
GXX_FLAGS = ["-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
             "-w", "-x", "c++"]

_SHARED = re.compile(r"extern __shared__ __align__\(\d+\) unsigned char (\w+)\[\];")
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.+?)>>>\(", re.S)


def find_gxx() -> str | None:
    """Path of g++, or None when there is none."""
    return shutil.which("g++")


def host_source(text: str) -> str:
    """CUDA source text rewritten for g++ with the shim."""
    text = _SHARED.sub(r"unsigned char* \1 = shim_smem();", text)
    return _LAUNCH.sub(lambda m: f"shim_launch({m.group(2)}, {m.group(1)}, ", text)


def build(source: str, out: str, defines=()) -> str:
    """Compile `source` (a .cu of csrc/, or a generated one that includes
    only system headers and csrc/'s) into the shared library `out` for the
    host; return `out`. Raises RuntimeError with the compiler's output if
    g++ fails or is missing."""
    gxx = find_gxx()
    if gxx is None:
        raise RuntimeError("g++ not found: the host build of the kernels needs it")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {os.path.join(_CSRC, name) for name in os.listdir(_CSRC)
                 if name.endswith((".cu", ".cuh"))}
        for path in paths | {os.path.abspath(source)}:
            with open(path) as fh:
                text = host_source(fh.read())
            with open(os.path.join(tmp, os.path.basename(path)), "w") as fh:
                fh.write(text)
        open(os.path.join(tmp, "cuda_runtime.h"), "w").close()
        cmd = [gxx, *GXX_FLAGS, "-include", SHIM, "-I", tmp,
               *[f"-D{d}" for d in defines], "-o", out,
               os.path.join(tmp, os.path.basename(source))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return out

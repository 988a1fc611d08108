"""K8 as straight-line CUDA kernels generated from the tape.

The kernel of `pallas_fn` (`bench/bench_synthetic.py:154`) is not an
interpreter: Pallas unrolls `apply_tape_rows` while it traces the kernel,
and the reference's CusADi writes one straight-line kernel per function.
This module does the same for the card. For a tape and a dtype it writes a
CUDA C++ source (`source`): one thread per env, the 16 state rows in
registers (loaded coalesced from the batch-last (16, B) input and stored at
the end), and the tape unrolled in order as one statement an op with its
roundings written out, each constant an exact hex-float literal. A tape
longer than `SEGMENT_OPS` is cut into segments, one kernel each, launched
one after another with the 16 values of each env passed through device
memory (64 B an env in float), so that no single nvcc process compiles
more than `SEGMENT_OPS` ops (one nvcc of a whole 1e5-op tape ran past 600
s) and the segments compile in parallel.

Each segment's library is built by `ops/cuda_build.py` (nvcc, sm_90a, its
NVCC_FLAGS: never --use_fast_math) at first use into the git-ignored
`_build/` beside the package, its name a hash of the generated source (the
encoded tape, its dtype and the generator's output) and the flags, so a
changed tape builds anew. `bench_synthetic.run_tape` launches it for CUDA
tensors; there is no fallback to the interpreter of `csrc/tape.cu`.

What bounds it on an H100: each op is a few instructions that run once, so
the kernel streams its own code through the SM's instruction caches, at
~35 cycles an op whatever the batch (PERF.md, Findings); below that lie
the tape's chain of dependent ops (its critical path, `critical_path`)
and the instructions a warp issues. The state is read and written once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from dataclasses import dataclass

import numpy as np
import torch

from biped_pympc_tpu_torch.ops import cuda_build

N_STATE = 16
OPS = ("fma", "mul", "add", "sub", "div1p")
# Ops a generated kernel holds at most: a longer tape runs as consecutive
# kernels, one nvcc process each (PERF.md, Findings: nvcc seconds by length).
SEGMENT_OPS = 10_000
# Threads per block of a launch (a multiple of 32, at most MAX_THREADS):
# PERF.md, Findings, times 32-, 64- and 128-thread blocks.
THREADS = 64
MAX_THREADS = 128
# The latency model of `critical_path`, in cycles of an H100 SM: a dependent
# FP32 / FP64 add, multiply or fused multiply-add, and the IEEE division
# (a reciprocal estimate and its Newton refinement, no --use_fast_math).
LATENCY = {torch.float32: {"op": 4, "div": 40}, torch.float64: {"op": 8, "div": 80}}


def literal(c: float, dtype: torch.dtype) -> str:
    """`c` rounded to `dtype` as an exact C hex-float literal (with the f
    suffix in float32)."""
    v = float(np.float32(c)) if dtype == torch.float32 else float(c)
    text = v.hex()  # [-]0x1.<13 hex digits>p<exp>: exact for a float and a double
    mant, exp = text.split("p")
    if "." in mant:
        mant = mant.rstrip("0").rstrip(".")
    return f"{mant}p{exp}{'f' if dtype == torch.float32 else ''}"


def _statement(op, dst, a, b, c, dtype) -> str:
    """One op and its blend with every rounding written out, so that nvcc
    has no product left to contract and a tape gives the same bits however
    it is cut into kernels: fma fused, y y + 1 fused (as the interpreter of
    csrc/tape.cu writes it), the division IEEE, and the blend s / 2 + r / 2
    one fused multiply-add of exact halves (one rounding, as the plain
    version's)."""
    fma = "fmaf" if dtype == torch.float32 else "fma"
    x, y = f"s{a}", f"s{b}"
    if op == "fma":
        r = f"{fma}({x}, {y}, {literal(c, dtype)})"
    elif op == "mul":
        r = f"{x} * {y}"
    elif op == "add":
        r = f"{x} + {y}"
    elif op == "sub":
        r = f"{x} - {y}"
    elif op == "div1p":
        r = f"{x} / {fma}({y}, {y}, T(1))"
    else:
        raise ValueError(f"unknown tape op {op!r}; the ops are {OPS}")
    return f"  s{dst} = {fma}(T(0.5), {r}, T(0.5) * s{dst});"


def source(ops, dtype: torch.dtype, first: int = 0) -> str:
    """The CUDA C++ source of one kernel evaluating `ops` (a list of (op,
    dst, a, b, c), tape positions `first`.. on) in `dtype` for every env,
    with the C entries `tape_gen_run` and `tape_gen_error_string`."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tape kernel takes float32 or float64, got {dtype}")
    for i, (op, dst, a, b, _) in enumerate(ops):
        if op not in OPS or not all(0 <= v < N_STATE for v in (dst, a, b)):
            raise ValueError(f"tape op {first + i}: {ops[i]!r} is not one of {OPS} over rows "
                             f"0..{N_STATE - 1}")
    ctype = "float" if dtype == torch.float32 else "double"
    rows = range(N_STATE)
    lines = [
        f"// Generated by biped_pympc_tpu_torch/bench/tape_codegen.py: tape ops {first}.."
        f"{first + len(ops) - 1} in {ctype}, one thread per env, the state in registers.",
        "#include <cuda_runtime.h>",
        "",
        f"typedef {ctype} T;",
        "",
        f"__global__ void __launch_bounds__({MAX_THREADS})",
        "tape_gen_kernel(const T* __restrict__ s_in, T* __restrict__ s_out, int batch) {",
        "  const int env = blockIdx.x * blockDim.x + threadIdx.x;",
        "  if (env >= batch) return;",
        *[f"  T s{r} = s_in[{r} * batch + env];" for r in rows],
        *[_statement(*op, dtype) for op in ops],
        *[f"  s_out[{r} * batch + env] = s{r};" for r in rows],
        "}",
        "",
        'extern "C" {',
        "",
        "// The kernel on `stream` over the (16, batch) batch-last state, `threads`",
        f"// a block (a multiple of 32, at most {MAX_THREADS}); a cudaError_t.",
        "int tape_gen_run(const void* s_in, void* s_out, int batch, int threads, void* stream) {",
        f"  if (batch < 0 || threads <= 0 || threads > {MAX_THREADS} || threads % 32 != 0)",
        "    return (int)cudaErrorInvalidValue;",
        "  if (batch == 0) return 0;",
        "  tape_gen_kernel<<<(batch + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(",
        "      (const T*)s_in, (T*)s_out, batch);",
        "  return (int)cudaGetLastError();",
        "}",
        "",
        "const char* tape_gen_error_string(int err) {",
        "  return cudaGetErrorString((cudaError_t)err);",
        "}",
        "",
        '}  // extern "C"',
        "",
    ]
    return "\n".join(lines)


def segment_sources(ops, dtype: torch.dtype, segment: int = SEGMENT_OPS) -> list:
    """The sources of the consecutive kernels of a tape: `segment` ops each
    (the last the rest), one kernel for a tape of at most `segment` ops (and
    for the empty tape)."""
    starts = range(0, max(len(ops), 1), segment)
    return [source(ops[i:i + segment], dtype, i) for i in starts]


def library_path(text: str, build_dir: str) -> str:
    """Where the library of the generated source `text` is built:
    libtape_gen_<hash>.so in `build_dir`, the hash over the flags and the
    text, so a changed tape, dtype or generator output builds anew."""
    digest = hashlib.sha256(" ".join(cuda_build.NVCC_FLAGS).encode() + b"\n" + text.encode())
    return os.path.join(build_dir, f"libtape_gen_{digest.hexdigest()[:16]}.so")


def plan(tapes, build_dir: str, segment: int = SEGMENT_OPS) -> tuple:
    """({key: source path}, {key: library path}, [[library paths] per tape])
    of the (ops, dtype) pairs in `tapes`, cut into kernels of `segment` ops,
    each source written into `build_dir` (beside its library) if it is not
    there yet."""
    sources, paths, per_tape = {}, {}, []
    os.makedirs(build_dir, exist_ok=True)
    for ops, dtype in tapes:
        libs = []
        for text in segment_sources(ops, dtype, segment):
            path = library_path(text, build_dir)
            key = os.path.basename(path)[len("lib"):-len(".so")]
            src = os.path.join(build_dir, f"{key}.cu")
            if not os.path.exists(path) and not os.path.exists(src):
                tmp = f"{src}.{os.getpid()}.tmp"
                with open(tmp, "w") as fh:
                    fh.write(text)
                os.replace(tmp, src)  # atomic: a concurrent build never reads a partial file
            sources[key], paths[key] = src, path
            libs.append(path)
        per_tape.append(libs)
    return sources, paths, per_tape


_loaded: dict = {}


def load(path: str) -> ctypes.CDLL:
    """The library of one generated kernel, its C interface declared."""
    if path not in _loaded:
        lib = ctypes.CDLL(path)
        lib.tape_gen_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
        lib.tape_gen_run.restype = ctypes.c_int
        lib.tape_gen_error_string.argtypes = [ctypes.c_int]
        lib.tape_gen_error_string.restype = ctypes.c_char_p
        _loaded[path] = lib
    return _loaded[path]


@dataclass
class Kernel:
    """The generated kernels of one tape in one dtype, in launch order."""

    dtype: torch.dtype
    libs: list

    def __call__(self, s: torch.Tensor, threads: int = THREADS, stream=None,
                 on_launch=None) -> torch.Tensor:
        """The tape on the (16, B) contiguous state `s` (on the card, or on
        the CPU for a host build), into a new tensor; `stream` a raw stream
        handle or None; `on_launch()` is called after each launch. Raises
        RuntimeError when a launch fails."""
        if s.dtype != self.dtype or s.dim() != 2 or s.shape[0] != N_STATE \
                or not s.is_contiguous():
            raise ValueError(f"tape kernel of {self.dtype} takes a contiguous ({N_STATE}, B) "
                             f"state of that dtype, got {tuple(s.shape)} {s.dtype}")
        out = torch.empty_like(s)
        tmp = [torch.empty_like(s) for _ in range(min(len(self.libs) - 1, 2))]
        src = s
        for i, lib in enumerate(self.libs):
            dst = out if i == len(self.libs) - 1 else tmp[i % 2]
            err = lib.tape_gen_run(src.data_ptr(), dst.data_ptr(), s.shape[1], threads, stream)
            if err != 0:
                raise RuntimeError(f"generated tape kernel launch failed: "
                                   f"{lib.tape_gen_error_string(err).decode()} ({err})")
            if on_launch is not None:
                on_launch()
            src = dst
        return out


def critical_path(ops, dtype: torch.dtype = torch.float32) -> dict:
    """The tape's dependency depth and its critical path in cycles under
    LATENCY: each op's result waits for its inputs x = s[a], y = s[b]
    (div1p's y y + 1, then the division) and the blend for the op and the
    old s[dst] (one multiply-add after the halved old value). Returns
    {"depth": ops on the longest chain, "cycles": the longest weighted
    chain}."""
    lat = LATENCY[dtype]
    depth = [0] * N_STATE
    ready = [0.0] * N_STATE  # cycle at which each row's current value exists
    for op, dst, a, b, _ in ops:
        if op == "div1p":
            r = max(ready[a], ready[b] + lat["op"]) + lat["div"]
        else:
            r = max(ready[a], ready[b]) + lat["op"]
        # 0.5 * old (off the chain) then fma(0.5, r, that)
        new = max(r, ready[dst] + lat["op"]) + lat["op"]
        depth[dst] = max(depth[a], depth[b], depth[dst]) + 1
        ready[dst] = new
    return {"depth": max(depth), "cycles": max(ready)}

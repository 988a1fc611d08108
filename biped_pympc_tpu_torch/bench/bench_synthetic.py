"""Synthetic batched evaluation of a straight-line instruction tape (twin of
`bench/bench_synthetic.py`: the reference's CusADi role).

CusADi turns a CasADi function's tape into one CUDA kernel with one thread
per env, benchmarked on synthetic functions of 1e1..1e5 instructions over
batches up to 32768. The same experiment here:

  workload: `make_tape`, a deterministic pseudo-random tape of n_ops scalar
  instructions (fma / mul / add / sub / div1p) over a 16-row state, each
  result blended into its destination row, evaluated per env on a (16, B)
  state (batch last).

  methods
    cuda   - `run_tape` on the card: the hand-written interpreter kernel of
             `csrc/tape.cu` (K8), one thread per env
    plain  - `apply_tape_rows` in eager torch on the same device, where
             n_ops x chain <= PLAIN_MAX_OPS_CHAIN (it launches ~5 kernels
             per instruction)
    cpu    - `eval_cpu`, NumPy float64 serial evaluation (with --cpu, where
             n_ops x batch <= 1e7)

Prints one JSON line per (method, n_ops, batch): ms per evaluation (the
mean over `chain` dependent evaluations, the median of `reps`) and the
instruction rate. On the card the times come from CUDA events; with
--device cpu from the host clock, and only `plain` and `cpu` run.

    python -m biped_pympc_tpu_torch.bench.bench_synthetic [--ops 1e1,1e2,1e3,1e4,1e5]
        [--batches 256,4096,32768] [--chain 10] [--reps 3] [--cpu] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from biped_pympc_tpu_torch.bench.bench_common import device_ms, host_ms, require_card
from biped_pympc_tpu_torch.ops import cuda_build, pdipm_cuda

N_STATE = 16
OPS = ("fma", "mul", "add", "sub", "div1p")  # the op codes of csrc/tape.cu, in order
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "tape.cu")
PLAIN_MAX_OPS_CHAIN = 10_000
CPU_MAX_OPS_BATCH = 10_000_000

# Kernel launches in this process; chip_smoke.py reads them.
launches = {"tape": 0}
_lib: list = []


def make_tape(n_ops: int, seed: int = 0):
    """Deterministic SSA tape: list of (op, dst, a, b, const)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        op = rng.choice(("fma", "mul", "add", "sub", "div1p"))
        dst = int(rng.integers(0, N_STATE))
        a = int(rng.integers(0, N_STATE))
        b = int(rng.integers(0, N_STATE))
        c = float(rng.uniform(-0.01, 0.01))
        ops.append((op, dst, a, b, c))
    return ops


def apply_tape_rows(tape, s: torch.Tensor) -> torch.Tensor:
    """The plain version of `run_tape`: the tape on a (N_STATE, ...) tensor
    of state rows, one torch operation at a time (`apply_tape_rows` of the
    JAX script); a Python constant rounds to the state's dtype as JAX's weak
    type does."""
    rows = [s[i:i + 1] for i in range(N_STATE)]
    for op, dst, a, b, c in tape:
        x, y = rows[a], rows[b]
        if op == "fma":
            r = x * y + c
        elif op == "mul":
            r = x * y
        elif op == "add":
            r = x + y
        elif op == "sub":
            r = x - y
        else:  # div1p: rational op, bounded denominator
            r = x / (1.0 + y * y)
        rows[dst] = 0.5 * rows[dst] + 0.5 * r  # keep magnitudes bounded
    return torch.cat(rows, dim=0)


def eval_cpu(tape, state):  # (B, N_STATE) f64 serial NumPy
    out = state.copy()
    for env in range(state.shape[0]):
        s = list(out[env])
        for op, dst, a, b, c in tape:
            x, y = s[a], s[b]
            if op == "fma":
                r = x * y + c
            elif op == "mul":
                r = x * y
            elif op == "add":
                r = x + y
            elif op == "sub":
                r = x - y
            else:
                r = x / (1.0 + y * y)
            s[dst] = 0.5 * s[dst] + 0.5 * r
        out[env] = s
    return out


@dataclass
class EncodedTape:
    """A tape as the kernel reads it: `code` int32 (n_ops, 4) rows (op index
    in OPS, dst, a, b), `c` (n_ops,) constants in the state's dtype, and the
    tape as given (`ops`) for the plain version."""

    ops: list
    code: torch.Tensor
    c: torch.Tensor


def encode_tape(tape, dtype=torch.float32, device="cpu") -> EncodedTape:
    """`tape` as int32 (op, dst, a, b) rows and a constant column rounded to
    `dtype`, on `device`. Raises ValueError on an unknown op or a row index
    outside [0, N_STATE)."""
    code = np.zeros((len(tape), 4), np.int32)
    for i, (op, dst, a, b, _) in enumerate(tape):
        if op not in OPS or not all(0 <= v < N_STATE for v in (dst, a, b)):
            raise ValueError(f"tape op {i}: {tape[i]!r} is not one of {OPS} over rows "
                             f"0..{N_STATE - 1}")
        code[i] = (OPS.index(op), dst, a, b)
    c = torch.tensor([op[4] for op in tape], dtype=torch.float64).to(dtype)
    return EncodedTape(list(tape), torch.from_numpy(code).to(device), c.to(device))


def decode_tape(enc: EncodedTape) -> list:
    """The (op, dst, a, b, c) list of an encoded tape, c as rounded there."""
    return [(OPS[op], dst, a, b, c) for (op, dst, a, b), c in
            zip(enc.code.cpu().tolist(), enc.c.cpu().double().tolist())]


def library_path() -> str:
    return cuda_build.library_path("tape", SOURCE, (), pdipm_cuda.BUILD_DIR)


def build() -> str:
    """Compile csrc/tape.cu if it is not built yet; return the library's path."""
    return cuda_build.build({"tape": SOURCE}, {"tape": library_path()},
                            pdipm_cuda.BUILD_DIR)["tape"]


def _library() -> ctypes.CDLL:
    if not _lib:
        lib = ctypes.CDLL(build())
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"tape_run_{suffix}")
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                           + [ctypes.c_int] + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.tape_error_string.argtypes = [ctypes.c_int]
        lib.tape_error_string.restype = ctypes.c_char_p
        _lib.append(lib)
    return _lib[0]


def run_tape(tape, s: torch.Tensor) -> torch.Tensor:
    """K8, the kernel of `pallas_fn`: the tape (a list of (op, dst, a, b, c)
    or an `EncodedTape`) on a (N_STATE, B) float32 or float64 state. CUDA
    tensors launch the kernel of csrc/tape.cu, one thread per env (a list is
    encoded first); CPU tensors run `apply_tape_rows`."""
    if s.dim() != 2 or s.shape[0] != N_STATE:
        raise ValueError(f"tape state must be ({N_STATE}, B), got {tuple(s.shape)}")
    if s.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tape kernel takes float32 or float64, got {s.dtype}")
    ops = tape.ops if isinstance(tape, EncodedTape) else tape
    if s.device.type == "cpu":
        return apply_tape_rows(ops, s)
    enc = tape if isinstance(tape, EncodedTape) else encode_tape(tape, s.dtype, s.device)
    if enc.c.dtype != s.dtype or enc.code.device != s.device or enc.c.device != s.device:
        raise ValueError(f"encoded tape {enc.c.dtype} on {enc.code.device} does not match the "
                         f"state's {s.dtype} on {s.device}")
    if not enc.code.is_contiguous() or enc.code.data_ptr() % 16:
        raise ValueError("encoded tape rows must be contiguous and 16-byte aligned")
    s = s.contiguous()
    out = torch.empty_like(s)
    lib = _library()
    fn = lib.tape_run_f32 if s.dtype == torch.float32 else lib.tape_run_f64
    with torch.cuda.device(s.device):
        err = fn(enc.code.data_ptr(), enc.c.contiguous().data_ptr(), enc.code.shape[0],
                 s.data_ptr(), out.data_ptr(), s.shape[1],
                 torch.cuda.current_stream(s.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tape kernel launch failed: {lib.tape_error_string(err).decode()} "
                           f"({err})")
    launches["tape"] += 1
    return out


def tape_flops(tape) -> int:
    """Floating-point operations of one env's evaluation, counted as the
    tape is written: fma 2, mul / add / sub 1, div1p 3 (y y, 1 +, the
    division), plus 3 for each blend (two halves and their sum)."""
    cost = {"fma": 2, "mul": 1, "add": 1, "sub": 1, "div1p": 3}
    return sum(cost[op[0]] + 3 for op in tape)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ops", default="1e1,1e2,1e3,1e4,1e5")
    p.add_argument("--batches", default="256,4096,32768")
    p.add_argument("--chain", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cpu", action="store_true",
                   help="also run the serial NumPy baseline (slow)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    on_card = args.device == "cuda"
    dev = require_card() if on_card else "cpu"

    def timed(fn, x):
        """(ms per evaluation, seconds of the first chained call)."""
        def chained():
            s = x
            for _ in range(args.chain):
                s = fn(s)
            return s

        t0 = time.perf_counter()
        chained()
        if on_card:
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        ms = (device_ms(chained, calls=1, reps=args.reps) if on_card
              else host_ms(chained, calls=1, reps=args.reps))
        return ms / args.chain, first_s

    for n_ops_s in args.ops.split(","):
        n_ops = int(float(n_ops_s))
        tape = make_tape(n_ops)
        for batch in [int(b) for b in args.batches.split(",")]:
            rng = np.random.default_rng(1)
            x_np = rng.uniform(0.5, 1.5, (N_STATE, batch)).astype(np.float32)
            x = torch.as_tensor(x_np, device=args.device)
            methods = []
            if on_card:
                enc = encode_tape(tape, x.dtype, x.device)
                methods.append(("cuda", lambda s, e=enc: run_tape(e, s)))
            if n_ops * args.chain <= PLAIN_MAX_OPS_CHAIN:
                methods.append(("plain", lambda s: apply_tape_rows(tape, s)))
            for name, fn in methods:
                ms, first_s = timed(fn, x)
                print(json.dumps({
                    "method": name, "n_ops": n_ops, "batch": batch, "ms_per_eval": ms,
                    "giga_instr_per_sec": n_ops * batch / ms / 1e6,
                    "compile_s": first_s, "device": dev}), flush=True)
            if args.cpu and n_ops * batch <= CPU_MAX_OPS_BATCH:
                xs = x_np.T.astype(np.float64)
                t0 = time.perf_counter()
                eval_cpu(tape, xs)
                t = time.perf_counter() - t0
                print(json.dumps({
                    "method": "cpu", "n_ops": n_ops, "batch": batch,
                    "ms_per_eval": 1e3 * t, "giga_instr_per_sec": n_ops * batch / t / 1e9,
                    "device": "cpu"}), flush=True)


if __name__ == "__main__":
    main()

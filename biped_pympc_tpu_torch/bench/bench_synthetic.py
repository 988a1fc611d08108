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
    cuda   - `run_tape` on the card: a straight-line kernel generated from
             the tape (`bench/tape_codegen.py`, K8), one thread per env
    interp - `run_tape_interpreted`: the interpreter of `csrc/tape.cu`, the
             kernel K8 replaced, kept as the comparison build and timed in
             turns with `cuda` (cuda, interp, interp, cuda)
    plain  - `apply_tape_rows` in eager torch on the same device, where
             n_ops x chain <= PLAIN_MAX_OPS_CHAIN (it launches ~5 kernels
             per instruction)
    cpu    - `eval_cpu`, NumPy float64 serial evaluation (with --cpu, where
             n_ops x batch <= 1e7)

Prints one JSON line per (method, n_ops, batch): ms per evaluation (the
mean over `chain` dependent evaluations, the median of `reps`; `cuda` and
`interp` the mean of their two turns) and the instruction rate; `cuda`
also the seconds its libraries' nvcc ran (`build_s`; every tape's kernels
are built together before the first timing). On the card the times come
from CUDA events; with --device cpu from the host clock, and only `plain`
and `cpu` run.

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

from biped_pympc_tpu_torch.bench import tape_codegen
from biped_pympc_tpu_torch.bench.bench_common import device_ms, host_ms, require_card
from biped_pympc_tpu_torch.ops import cuda_build, pdipm_cuda

N_STATE = tape_codegen.N_STATE
OPS = tape_codegen.OPS  # the op codes of csrc/tape.cu, in order
# The interpreter K8 replaced, kept to compare (`run_tape_interpreted`).
INTERP_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "csrc", "tape.cu")
PLAIN_MAX_OPS_CHAIN = 10_000
CPU_MAX_OPS_BATCH = 10_000_000

# Kernel launches in this process, one per kernel launched (a generated
# tape's segments each count): the generated kernels ("tape") and the
# interpreter ("tape_interp"); chip_smoke.py reads them.
launches = {"tape": 0, "tape_interp": 0}
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
    """A tape as the interpreter reads it: `code` int32 (n_ops, 4) rows (op
    index in OPS, dst, a, b), `c` (n_ops,) constants in the state's dtype,
    and the tape as given (`ops`) for the plain version and the generated
    kernel, which `run_tape` keeps in `kernel` once built."""

    ops: list
    code: torch.Tensor
    c: torch.Tensor
    kernel: tape_codegen.Kernel | None = None


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


def interp_path() -> str:
    """Where the interpreter's library is built."""
    return cuda_build.library_path("tape", INTERP_SOURCE, (), pdipm_cuda.BUILD_DIR)


def build(tapes=()) -> dict:
    """Compile the interpreter and the generated kernels of `tapes`, (ops,
    dtype) pairs cut into kernels of `tape_codegen.SEGMENT_OPS` ops, that
    are not built yet: one nvcc per library, all started together. Returns
    {"interp": path, "tapes": [[segment library paths] per tape]}."""
    sources, paths, per_tape = tape_codegen.plan(tapes, pdipm_cuda.BUILD_DIR)
    sources["tape"], paths["tape"] = INTERP_SOURCE, interp_path()
    cuda_build.build(sources, paths, pdipm_cuda.BUILD_DIR)
    return {"interp": paths["tape"], "tapes": per_tape}


def kernel(tape, dtype: torch.dtype) -> tape_codegen.Kernel:
    """The generated kernels of `tape` (a list of (op, dst, a, b, c)) in
    `dtype`, built if they are not yet."""
    paths = build([(tape, dtype)])["tapes"][0]
    return tape_codegen.Kernel(dtype, [tape_codegen.load(p) for p in paths])


def _library() -> ctypes.CDLL:
    """The interpreter's library, built if it is not yet."""
    if not _lib:
        build()
        lib = ctypes.CDLL(interp_path())
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"tape_run_{suffix}")
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                           + [ctypes.c_int] + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.tape_error_string.argtypes = [ctypes.c_int]
        lib.tape_error_string.restype = ctypes.c_char_p
        _lib.append(lib)
    return _lib[0]


def _checked_state(s: torch.Tensor) -> torch.Tensor:
    if s.dim() != 2 or s.shape[0] != N_STATE:
        raise ValueError(f"tape state must be ({N_STATE}, B), got {tuple(s.shape)}")
    if s.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tape kernel takes float32 or float64, got {s.dtype}")
    return s


def run_tape(tape, s: torch.Tensor) -> torch.Tensor:
    """K8, the kernel of `pallas_fn`: the tape (a list of (op, dst, a, b, c)
    or an `EncodedTape`) on a (N_STATE, B) float32 or float64 state. CUDA
    tensors launch the straight-line kernel generated from the tape
    (`tape_codegen`; built at first use, kept on an EncodedTape), one
    thread per env; CPU tensors run `apply_tape_rows`. A failed build or
    launch raises."""
    _checked_state(s)
    ops = tape.ops if isinstance(tape, EncodedTape) else tape
    if s.device.type == "cpu":
        return apply_tape_rows(ops, s)
    if isinstance(tape, EncodedTape):
        if tape.kernel is None or tape.kernel.dtype != s.dtype:
            tape.kernel = kernel(ops, s.dtype)
        kern = tape.kernel
    else:
        kern = kernel(ops, s.dtype)

    def count():
        launches["tape"] += 1

    with torch.cuda.device(s.device):
        return kern(s.contiguous(), stream=torch.cuda.current_stream(s.device).cuda_stream,
                    on_launch=count)


def run_tape_interpreted(tape, s: torch.Tensor) -> torch.Tensor:
    """The interpreter of csrc/tape.cu that K8 replaced, one thread per env,
    kept as the comparison build: CUDA tensors launch it (a list is encoded
    first), CPU tensors run `apply_tape_rows`."""
    _checked_state(s)
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
        raise RuntimeError(f"tape interpreter launch failed: "
                           f"{lib.tape_error_string(err).decode()} ({err})")
    launches["tape_interp"] += 1
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

    tapes = {int(float(n)): make_tape(int(float(n))) for n in args.ops.split(",")}
    built = (build([(t, torch.float32) for t in tapes.values()])["tapes"]
             if on_card else [])
    build_s = [sum(cuda_build.build_seconds.get(p, 0.0) for p in paths) for paths in built]
    for k, (n_ops, tape) in enumerate(tapes.items()):
        for batch in [int(b) for b in args.batches.split(",")]:
            rng = np.random.default_rng(1)
            x_np = rng.uniform(0.5, 1.5, (N_STATE, batch)).astype(np.float32)
            x = torch.as_tensor(x_np, device=args.device)
            rows = []
            if on_card:
                enc = encode_tape(tape, x.dtype, x.device)
                enc.kernel = tape_codegen.Kernel(x.dtype, [tape_codegen.load(p) for p in built[k]])
                gen = lambda s, e=enc: run_tape(e, s)
                interp = lambda s, e=enc: run_tape_interpreted(e, s)
                turns = [(name, timed(fn, x)) for name, fn in
                         (("cuda", gen), ("interp", interp), ("interp", interp), ("cuda", gen))]
                for name in ("cuda", "interp"):
                    mine = [t for n, t in turns if n == name]
                    rows.append((name, float(np.mean([t[0] for t in mine])), mine[0][1]))
            if n_ops * args.chain <= PLAIN_MAX_OPS_CHAIN:
                rows.append(("plain", *timed(lambda s: apply_tape_rows(tape, s), x)))
            for name, ms, first_s in rows:
                extra = {"build_s": build_s[k]} if name == "cuda" else {}
                print(json.dumps({
                    "method": name, "n_ops": n_ops, "batch": batch, "ms_per_eval": ms,
                    "giga_instr_per_sec": n_ops * batch / ms / 1e6,
                    "compile_s": first_s, **extra, "device": dev}), flush=True)
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

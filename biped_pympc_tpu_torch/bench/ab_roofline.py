"""Roofline of one card and the PDIPM routes against it (twin of
`bench/ab_roofline.py`).

1. Two measured ceilings of multiply-add throughput (`measure_roofline`,
   the twin of `measure_vpu_roofline`), each a hand-written CUDA kernel of
   `csrc/roofline.cu`:
   * "fma_peak" (K6, `fma_peak`): independent chains x <- x a + 1e-7 with
     their operands in registers, 100,000 steps, over JAX's shapes (8 nacc,
     128) for nacc in 16..128, each swept over the card's own knobs (chains
     per thread, threads per block); the best rate is the peak.
   * "stream" (K7, `stream`): x <- x a + b over a (256, 512) array, 20,000
     passes, every operand read from shared memory and the result written
     back: the all-traffic ceiling.
   Both in float32 and float64.
2. The analytic flop count of one Newton step per env of each route
   (`flop_model`, as in JAX).
3. The sustained rate of six PDIPM routes at b4096 through
   `pdipm_cuda.solve` (chained dependent solves, CUDA events), against both
   float32 ceilings.

CUDA tensors launch the kernels (built with nvcc at first use into
`_build/`, `ops/cuda_build.py`); CPU tensors run the plain versions, which
repeat the kernels' arithmetic in torch. A build or launch failure raises.

    python -m biped_pympc_tpu_torch.bench.ab_roofline [--ceil-only]

needs the card; it prints JSON lines.
"""

from __future__ import annotations

import argparse
import ctypes
import os

import numpy as np
import torch

from biped_pympc_tpu_torch.bench.bench_common import (device_ms, make_chained, make_emitter,
                                                      make_qp_batch, require_card)
from biped_pympc_tpu_torch.ops import cuda_build, pdipm_cuda
from biped_pympc_tpu_torch.ops.pdipm import PdipmOptions

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                      "roofline.cu")
PEAK_ITERS = 100_000  # `K1` of measure_vpu_roofline
STREAM_ITERS = 20_000  # `K2`
STREAM_SHAPE = (256, 512)
NACCS = (16, 32, 64, 128)
FMA_C = 1e-7
# The H100's knobs of the peak sweep: independent chains per thread, threads per block.
CHAINS = (1, 2, 4, 8)
THREADS = (128, 256)

# Kernel launches in this process, per kernel; chip_smoke.py reads them.
launches = {"fma_peak": 0, "stream": 0}
_lib: list = []


def library_path() -> str:
    return cuda_build.library_path("roofline", SOURCE, (), pdipm_cuda.BUILD_DIR)


def build() -> str:
    """Compile csrc/roofline.cu if it is not built yet; return the library's path."""
    return cuda_build.build({"roofline": SOURCE}, {"roofline": library_path()},
                            pdipm_cuda.BUILD_DIR)["roofline"]


def _library() -> ctypes.CDLL:
    if not _lib:
        lib = ctypes.CDLL(build())
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"roofline_fma_peak_{suffix}")
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_double]
                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"roofline_stream_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.roofline_error_string.argtypes = [ctypes.c_int]
        lib.roofline_error_string.restype = ctypes.c_char_p
        _lib.append(lib)
    return _lib[0]


def _checked(tensors, shapes) -> list:
    """`tensors` contiguous, after checking each shape and that all share one
    float dtype and device."""
    like = tensors[0]
    if like.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"roofline kernels take float32 or float64, got {like.dtype}")
    for t, shape in zip(tensors, shapes):
        if tuple(t.shape) != tuple(shape) or t.dtype != like.dtype or t.device != like.device:
            raise ValueError(f"roofline input {tuple(t.shape)} {t.dtype} {t.device}, expected "
                             f"{tuple(shape)} {like.dtype} {like.device}")
    return [t.contiguous() for t in tensors]


def _run(name: str, kernel: str, x: torch.Tensor, *args) -> None:
    lib = _library()
    fn = getattr(lib, f"roofline_{name}_{'f32' if x.dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roofline kernel {name} launch failed: "
                           f"{lib.roofline_error_string(err).decode()} ({err})")
    launches[kernel] += 1


def fma_steps(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` times x <- x a + b, each step rounded once to x's dtype as the
    kernels' fused multiply-add is: float32 through float64, where the
    product of two float32 values is exact (the float64 sum then rounds to
    float32; the two roundings differ from one only on a float32 midpoint);
    float64 in two roundings, since torch has no wider type (one rounding
    per step apart from the kernel)."""
    if x.dtype == torch.float32:
        a64, b64 = a.double(), b.double()
        for _ in range(iters):
            x = torch.addcmul(b64, x.double(), a64).float()
        return x
    for _ in range(iters):
        x = x * a + b
    return x


def fma_peak_plain(a: torch.Tensor, x: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of `fma_peak`: every chain, one step at a time."""
    c = torch.tensor(FMA_C, dtype=x.dtype, device=x.device)
    return fma_steps(x, a.repeat(x.shape[0] // 8, 1), c, iters)


def fma_peak(a: torch.Tensor, x: torch.Tensor, iters: int = PEAK_ITERS, chains: int = 1,
             threads: int = 128) -> torch.Tensor:
    """K6, `peak_kernel`: out[8 i + r, c] is the `iters`-fold
    x <- x a[r, c] + 1e-7 from x[8 i + r, c] (the constant rounded to x's
    dtype, as JAX rounds a Python float), for a (8, 128) and x (8 n, 128)
    of one float dtype. CUDA tensors launch the kernel with `chains` (1, 2,
    4, 8) chains per thread and `threads` per block; CPU tensors run
    `fma_peak_plain`."""
    if x.dim() != 2 or x.shape[0] % 8 or x.shape[1] != 128:
        raise ValueError(f"fma_peak takes x of shape (8 n, 128), got {tuple(x.shape)}")
    a, x = _checked([a, x], [(8, 128), x.shape])
    if x.device.type == "cpu":
        return fma_peak_plain(a, x, iters)
    out = torch.empty_like(x)
    _run("fma_peak", "fma_peak", x, a.data_ptr(), x.data_ptr(), out.data_ptr(), x.numel(), iters,
         FMA_C, chains, threads)
    return out


def stream_plain(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of `stream`: one pass at a time."""
    return fma_steps(x, a, b, iters)


def stream(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
           iters: int = STREAM_ITERS) -> torch.Tensor:
    """K7, `stream_kernel`: the `iters`-fold x <- x a + b over arrays of one
    shape and float dtype. CUDA tensors launch the kernel (every pass
    through shared memory); CPU tensors run `stream_plain`."""
    a, b, x = _checked([a, b, x], [x.shape] * 3)
    if x.device.type == "cpu":
        return stream_plain(a, b, x, iters)
    out = torch.empty_like(x)
    _run("stream", "stream", x, a.data_ptr(), b.data_ptr(), x.data_ptr(), out.data_ptr(),
         x.numel(), iters)
    return out


def roofline_inputs(seed: int = 0):
    """The numpy float32 inputs of `measure_vpu_roofline`, drawn in its
    order: ({nacc: (a (8, 128), x (8 nacc, 128))}, (a, b, x) (256, 512))."""
    rng = np.random.default_rng(seed)
    peak = {}
    for nacc in NACCS:
        a = rng.uniform(0.999, 1.001, (8, 128)).astype(np.float32)
        peak[nacc] = (a, rng.uniform(0.5, 1.5, (8 * nacc, 128)).astype(np.float32))
    shape = STREAM_SHAPE
    a2 = rng.uniform(0.999, 1.001, shape).astype(np.float32)
    b2 = rng.uniform(-1e-6, 1e-6, shape).astype(np.float32)
    return peak, (a2, b2, rng.uniform(0.5, 1.5, shape).astype(np.float32))


def measure_roofline(dtype=torch.float32, emit=None) -> dict:
    """The two ceilings of the card in `dtype` (`measure_vpu_roofline`), in
    flop/s (a multiply-add counts 2), each launch timed as there: 10 calls
    per sample, the median of 5. "fma_peak" is the best rate over NACCS,
    CHAINS and THREADS; `emit` gets one record per nacc with its best knobs.
    Returns {"fma_peak", "stream", "best": the peak's knobs}."""
    dev = torch.device("cuda")
    peak_in, stream_in = roofline_inputs()
    to = lambda arr: torch.as_tensor(arr, device=dev).to(dtype)
    best = (0.0, None)
    for nacc, (a, x) in peak_in.items():
        a_t, x_t = to(a), to(x)
        flops = 2.0 * x.size * PEAK_ITERS
        rates = {(chains, threads): flops / (1e-3 * device_ms(
                     lambda: fma_peak(a_t, x_t, PEAK_ITERS, chains, threads)))
                 for chains in CHAINS for threads in THREADS}
        knobs = max(rates, key=rates.get)
        if emit is not None:
            emit({"dtype": str(dtype).removeprefix("torch."), "nacc": nacc, "chains": knobs[0],
                  "threads": knobs[1], "tflops": rates[knobs] / 1e12})
        if rates[knobs] > best[0]:
            best = (rates[knobs], {"nacc": nacc, "chains": knobs[0], "threads": knobs[1]})
    a2, b2, x2 = (to(v) for v in stream_in)
    ms = device_ms(lambda: stream(a2, b2, x2, STREAM_ITERS))
    return {"fma_peak": best[0], "stream": 2.0 * x2.numel() * STREAM_ITERS / (1e-3 * ms),
            "best": best[1]}


def flop_model(T=10, refine=1):
    """Per-env per-iteration fma counts from the kernel op inventory.

    Counts one fma as 2 flops; mask/select arithmetic of the in-place GJ
    counted at ~1 extra mul per updated element (measured form). Returns a
    dict per variant.
    """
    NI, NUv, NXv = 16, 12, 12

    def gj(n, stages):  # in-place no-pivot GJ: n steps x (n*n fma + n*n mask)
        return stages * n * (n * n * 2)

    def gj_piv(n, stages):  # pivoted tableau GJ: (n, 2n) tableau + search
        return stages * n * (n * 2 * n * 2 + 3 * n)

    def mm(m, k, n):
        return m * k * n

    def mv(m, n):
        return m * n

    # shared: residuals + operators (g/a/gT/aT/hd) per application set
    resid = 240 + T * (mv(NI, NUv) * 2 + mv(NXv, NXv) * 4) + 3 * T * NI
    op_apply = 240 + T * (mv(NI, NUv) * 2 + mv(NXv, NXv) * 4)

    def tail(kuu_cost_included):  # y-chain build + inverses
        coup = (T - 1) * 2 * mm(12, 12, 12) + mm(12, 12, 12)  # S^T M S + adqad
        return coup + gj(12, T)

    def solve_cost(kinv_apply):
        # fold + 2 sweeps + backsub + x recovery
        sweeps = 2 * T * mv(12, 12) * 2
        return 2 * kinv_apply + sweeps + 2 * T * mv(12, 12) + 4 * T * 12

    out = {}
    # --- ric dense ---
    gtwg = T * NI * mv(12, 12)  # 16 rank-1 (12x12) updates per stage
    bkb = 2 * T * mm(12, 12, 12)
    kfac = gj(14, T)
    kapp = T * mv(14, 14)
    per_solve = solve_cost(kapp)
    n_solves = 2 * (1 + refine)
    n_applies = 2 * refine
    out["ric_dense"] = (resid + gtwg + kfac + bkb + tail(True)
                        + n_solves * per_solve + n_applies * op_apply)
    # --- ric foot-split ---
    gtwg_s = T * (8 * mv(4, 4) * 2)  # per-foot 8 rank-1 (4x4)
    kfac_s = gj(4, 2 * T)
    bkb_s = 2 * T * (mm(12, 4, 4) + mm(12, 4, 12)) + 4 * mv(12, 12)
    kapp_s = 2 * T * mv(4, 4) + 10 * T  # two 4-wide mv + pairs/singles
    out["ric_split"] = (resid + gtwg_s + kfac_s + bkb_s + tail(True)
                        + n_solves * solve_cost(kapp_s)
                        + n_applies * op_apply)
    # --- ric_aug dense (30-wide pivoted) ---
    kfac_a = gj_piv(30, T)
    kapp_a = T * mv(30, 30)
    bkb_a = 2 * T * mm(12, 12, 12)
    out["ricaug_dense"] = (resid + kfac_a + bkb_a + tail(True)
                           + n_solves * solve_cost(kapp_a)
                           + n_applies * op_apply)
    # --- ric_aug foot-split (two 12-wide pivoted) ---
    kfac_as = gj_piv(12, 2 * T)
    kapp_as = 2 * T * mv(12, 12) + 10 * T
    bkb_as = 2 * T * (mm(12, 4, 4) + mm(12, 4, 12)) + 4 * mv(12, 12)
    out["ricaug_split"] = (resid + kfac_as + bkb_as + tail(True)
                           + n_solves * solve_cost(kapp_as)
                           + n_applies * op_apply)
    # Packed forms: identical arithmetic (layout-only change), so the same
    # flop model — their occupancy, not their flops, is what moves.
    out["ric_split_pack"] = out["ric_split"]
    out["ricaug_split_pack"] = out["ricaug_split"]
    return {k: 2 * v for k, v in out.items()}  # fma -> flops


# The six routes of `main` (ab_roofline.py:227-242), with JAX's defaults
# for every other field (`PdipmOptions` has them).
VARIANTS = {
    "ric_dense": PdipmOptions(backend="ric", refine_steps=1),
    "ric_split": PdipmOptions(backend="ric", refine_steps=1, foot_split=True),
    "ricaug_dense": PdipmOptions(backend="ric_aug", refine_steps=1),
    "ricaug_split": PdipmOptions(backend="ric_aug", refine_steps=1, foot_split=True),
    "ric_split_pack": PdipmOptions(backend="ric", refine_steps=1, foot_split=True,
                                   foot_pack=True),
    "ricaug_split_pack": PdipmOptions(backend="ric_aug", refine_steps=1, foot_split=True,
                                      foot_pack=True),
}


def main(argv=None) -> dict:
    """Print the ceilings (and without --ceil-only each route's rate) as JSON
    lines; return {"ceil": {dtype: measure_roofline's dict}, "variants":
    the routes' records}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ceil-only", action="store_true", help="measure the two ceilings only")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--chain", type=int, default=10, help="dependent solves per timed call")
    p.add_argument("--reps", type=int, default=4, help="timed calls (the median is kept)")
    args = p.parse_args(argv)
    kind = require_card()
    emit = make_emitter("ab_roofline", {"argv": list(argv or []), "device": kind})
    ceil = {}
    for dtype in (torch.float32, torch.float64):
        ceil[dtype] = measure_roofline(dtype, emit)
        emit({"dtype": str(dtype).removeprefix("torch."),
              "fma_peak_tflops": ceil[dtype]["fma_peak"] / 1e12,
              "stream_tflops": ceil[dtype]["stream"] / 1e12, "best": ceil[dtype]["best"],
              "device": kind})
    records = []
    if args.ceil_only:
        return {"ceil": ceil, "variants": records}
    peak, stream_rate = ceil[torch.float32]["fma_peak"], ceil[torch.float32]["stream"]
    model = flop_model()
    qp = make_qp_batch(args.batch, device="cuda")
    for name, opts in VARIANTS.items():
        fn = make_chained(lambda q, o=opts: pdipm_cuda.solve(q, o), args.chain)
        t = device_ms(lambda: fn(qp), calls=1, reps=args.reps) / args.chain / 1e3
        flops = model[name] * opts.iterations * args.batch
        records.append({"variant": name, "route": pdipm_cuda.route(opts),
                        "ms_per_20iter_b4096": 1e3 * t, "batch": args.batch,
                        "model_flops_per_env_iter": model[name],
                        "sustained_tflops": flops / t / 1e12, "util_vs_fma_peak": flops / t / peak,
                        "util_vs_stream": flops / t / stream_rate, "device": kind})
        emit(records[-1])
    return {"ceil": ceil, "variants": records}


if __name__ == "__main__":
    main()

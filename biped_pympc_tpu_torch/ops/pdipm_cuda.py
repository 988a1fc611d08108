"""The PDIPM as hand-written CUDA kernels, and the hybrid speed mode (twin of
`biped_pympc_tpu/ops/pdipm_pallas.py`, routes `backend="ric_aug"` and
`backend="ric"`, `foot_split=True`).

`solve(qp, opts)` dispatches on where the QP lies: CUDA tensors launch the
kernel of `opts.backend` (`csrc/pdipm_ric_aug.cu` or `csrc/pdipm_ric.cu`, one
thread block per env), CPU tensors run the plain version `ops/pdipm.py`.
There is no fallback between the two: a failed build or launch raises.

`solve_hybrid` runs the condensed route on every env and re-solves the
worst-criterion envs with the augmented route (`pdipm_pallas.solve_hybrid`).

The kernels are compiled with nvcc for sm_90a at first use into `_build/`
beside this package, one library per source, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass

import torch

from biped_pympc_tpu_torch.ops import pdipm
from biped_pympc_tpu_torch.ops import qp as qps
from biped_pympc_tpu_torch.ops.pdipm import PdipmOptions, PdipmResult
from biped_pympc_tpu_torch.ops.qp import StageQP

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
# Kernel source of each route; every source includes HEADERS.
SOURCES = {"ric_aug": os.path.join(_CSRC, "pdipm_ric_aug.cu"),
           "ric": os.path.join(_CSRC, "pdipm_ric.cu")}
HEADERS = (os.path.join(_CSRC, "pdipm_common.cuh"),)
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
MAX_SMEM_PER_BLOCK = 232448  # bytes of shared memory an H100 gives one block

# Kernel launches in this process, per route; chip_smoke.py reads them to
# show that the controller's main path went through the kernels.
launches = {backend: 0 for backend in SOURCES}

_libs: dict = {}


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
        "toolkit is needed to build the PDIPM kernels")


def library_path(backend: str) -> str:
    """Where the library of a route is built. The name carries a hash of its
    source, the shared headers and the flags, so an edit to any of them
    builds anew."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (SOURCES[backend], *HEADERS):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"libpdipm_{backend}_{digest.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile every kernel library not built yet, one nvcc per source, all
    started together; return {backend: .so path}. Raises RuntimeError with
    the compiler's output if any nvcc fails."""
    paths = {backend: library_path(backend) for backend in SOURCES}
    todo = [backend for backend, path in paths.items() if not os.path.exists(path)]
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs, failed = [], []
    try:
        for backend in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[backend]]
            jobs.append((backend, cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for backend, cmd, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
            else:
                os.replace(tmp, paths[backend])  # atomic: a concurrent build never loads a partial file
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_library(path: str, backend: str) -> ctypes.CDLL:
    """Load the built kernel library of a route and declare its C interface."""
    lib = ctypes.CDLL(path)
    ptrs = [ctypes.c_void_p] * 12
    ints = [ctypes.c_int] * 4
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"pdipm_{backend}_{suffix}")
        fn.argtypes = ptrs + ints + [ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    smem = getattr(lib, f"pdipm_{backend}_smem_bytes")
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_size_t
    errs = getattr(lib, f"pdipm_{backend}_error_string")
    errs.argtypes = [ctypes.c_int]
    errs.restype = ctypes.c_char_p
    return lib


def _library(backend: str) -> ctypes.CDLL:
    if backend not in _libs:
        _libs[backend] = load_library(build()[backend], backend)
    return _libs[backend]


def run_kernel(lib: ctypes.CDLL, qp: StageQP, opts: PdipmOptions, stream) -> PdipmResult:
    """Launch the kernel of route `opts.backend` from `lib` on `qp`'s tensors;
    `stream` is a raw stream handle (int) or None. Checks shapes and types,
    allocates the outputs."""
    dtype = qp.f.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"PDIPM kernel takes float32 or float64, got {dtype}")
    if opts.iterations < 0 or opts.refine_steps < 0:
        raise ValueError(f"iterations and refine_steps must be >= 0: {opts}")
    T = qp.horizon
    nb = qp.f.shape[0]
    ins = [t.contiguous() for t in (  # batch-first: hd, f, Ad, Bd, b, G_u, d
        qps.h_diag(qp), qp.f, qp.dyn.A, qp.dyn.B, qps.b_vec(qp), qp.g_u, qps.d_vec(qp))]
    want = [(nb, qp.nz), (nb, qp.nz), (nb, 12, 12), (nb, 12, 12), (nb, qp.n_eq),
            (nb, 16, 12), (nb, qp.n_ineq)]
    for t, shape in zip(ins, want):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != qp.f.device:
            raise ValueError(f"kernel input {tuple(t.shape)} {t.dtype} {t.device}, "
                             f"expected {shape} {dtype} {qp.f.device}")
    name = f"pdipm_{opts.backend}"
    smem = getattr(lib, f"{name}_smem_bytes")(T, qp.f.element_size())
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"horizon {T} needs {smem} B of shared memory per env; "
                         f"the H100 gives a block at most {MAX_SMEM_PER_BLOCK} B")
    new = lambda n: torch.empty(nb, n, dtype=dtype, device=qp.f.device)
    x, s, z, y, res = new(qp.nz), new(qp.n_ineq), new(qp.n_ineq), new(qp.n_eq), new(4)
    fn = getattr(lib, f"{name}_f32" if dtype == torch.float32 else f"{name}_f64")
    err = fn(*[t.data_ptr() for t in (*ins, x, s, z, y, res)], nb, T, opts.iterations,
             opts.refine_steps, opts.beta, opts.delta, stream)
    if err != 0:
        raise RuntimeError(f"PDIPM kernel {name} launch failed: "
                           f"{getattr(lib, f'{name}_error_string')(err).decode()} ({err})")
    return PdipmResult(x, s, z, y, res)


def solve(qp: StageQP, opts: PdipmOptions = PdipmOptions()) -> PdipmResult:
    """Batched PDIPM on route `opts.backend`: its CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if opts.backend not in SOURCES:
        raise ValueError(f"unknown PDIPM backend {opts.backend!r}; expected one of "
                         f"{tuple(SOURCES)}")
    dev = qp.f.device
    if dev.type == "cpu":
        return pdipm.solve(qp, opts)
    if dev.type != "cuda":
        raise ValueError(f"PDIPM solve supports CPU and CUDA tensors, got {dev}")
    lib = _library(opts.backend)
    with torch.cuda.device(dev):
        res = run_kernel(lib, qp, opts, torch.cuda.current_stream(dev).cuda_stream)
    launches[opts.backend] += 1
    return res


@dataclass
class HybridStats:
    """Per-solve hybrid counters, int32 scalar tensors on the solve's device
    (`pdipm_pallas.HybridStats`). `dropped_nonfinite > 0` means the
    finiteness guarantee lapsed on that solve: more non-finite envs than the
    re-solve budget."""

    flagged: torch.Tensor  # envs over flag_tol or non-finite (whole batch)
    nonfinite: torch.Tensor  # envs with a non-finite criterion or solution
    resolved: torch.Tensor  # envs re-solved and merged (<= budget)
    dropped_nonfinite: torch.Tensor  # non-finite envs not rescued


def solve_hybrid(qp: StageQP, opts: PdipmOptions = PdipmOptions(backend="ric"),
                 budget: int = 0, flag_tol: float = 1.0, flag: str = "resid",
                 with_stats: bool = False):
    """Fast solve on every env, then a robust re-solve of the flagged envs.

    Runs route `opts.backend` (the condensed "ric" in the speed mode) on the
    whole batch, ranks each env by its criterion (the largest final
    residual, or with flag="kkt" the largest `pdipm.kkt_error`), and
    re-solves the `budget` worst with the augmented route at the same
    iterations, refinement, beta and delta, from the cold start. An env with
    a non-finite criterion or any non-finite value in x, s, z or y ranks
    +inf. Re-solved envs whose criterion exceeds `flag_tol`, or is +inf, take
    the augmented result. budget <= 0 selects max(64, B // 32); the budget
    is clamped to B. The size of the re-solve is fixed by B and the budget,
    so nothing here waits for the device.

    Returns the merged PdipmResult, or (PdipmResult, HybridStats) when
    with_stats.
    """
    if flag not in ("resid", "kkt"):
        raise ValueError(f"hybrid flag must be 'resid' or 'kkt', got {flag!r}")
    nb = qp.f.shape[0]
    if budget <= 0:
        budget = max(64, nb // 32)
    res = solve(qp, opts)
    crit = (pdipm.kkt_error(qp, res) if flag == "kkt" else res.residuals).amax(dim=1)
    finite = lambda v: torch.isfinite(v).all(dim=1)
    sol_ok = finite(res.x) & finite(res.s) & finite(res.z) & finite(res.y)
    crit = torch.where(torch.isfinite(crit) & sol_ok, crit, torch.full_like(crit, float("inf")))
    k = min(budget, nb)
    # Stable descending order: on ties (every non-finite env ranks +inf) the
    # lower index comes first, as in jax.lax.top_k, so both rescue the same envs.
    vals, idx = torch.sort(crit, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    res_aug = solve(qps.take(qp, idx), dataclasses.replace(opts, backend="ric_aug"))
    need = (vals > flag_tol) | torch.isinf(vals)  # (k,)

    def merge(a, b):
        sel = need.view(k, *([1] * (b.dim() - 1)))
        return a.index_copy(0, idx, torch.where(sel, b, a[idx]))

    merged = PdipmResult(*(merge(getattr(res, f.name), getattr(res_aug, f.name))
                           for f in dataclasses.fields(PdipmResult)))
    if not with_stats:
        return merged
    inf_crit = torch.isinf(crit)
    nonfinite = inf_crit.sum(dtype=torch.int32)
    return merged, HybridStats(
        flagged=((crit > flag_tol) | inf_crit).sum(dtype=torch.int32),
        nonfinite=nonfinite,
        resolved=need.sum(dtype=torch.int32),
        # Non-finite envs rank +inf and so take budget slots first; the
        # excess over the budget is returned unmerged.
        dropped_nonfinite=nonfinite - torch.isinf(vals).sum(dtype=torch.int32),
    )

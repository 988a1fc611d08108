"""The PDIPM as a hand-written CUDA kernel (twin of
`biped_pympc_tpu/ops/pdipm_pallas.py`, route `backend="ric_aug"`,
`foot_split=True`).

`solve(qp, opts)` dispatches on where the QP lies: CUDA tensors launch
`csrc/pdipm_ric_aug.cu` (one thread block per env), CPU tensors run the plain
version `ops/pdipm.py`. There is no fallback between the two: a failed build
or launch raises.

The kernel is compiled with nvcc for sm_90a at first use into `_build/`
beside this package and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from biped_pympc_tpu_torch.ops import pdipm
from biped_pympc_tpu_torch.ops import qp as qps
from biped_pympc_tpu_torch.ops.pdipm import PdipmOptions, PdipmResult
from biped_pympc_tpu_torch.ops.qp import StageQP

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "pdipm_ric_aug.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches in this process; chip_smoke.py reads it to show that the
# controller's main path went through the kernel.
launches = 0

_lib = None


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
        "toolkit is needed to build the PDIPM kernel")


def build() -> str:
    """Compile the kernel (if this source is not built yet); return the .so path.

    The library name carries a hash of the source and flags, so an edited
    source builds anew. Raises RuntimeError with the compiler's output if
    nvcc fails.
    """
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libpdipm_ric_aug_{digest}.so")
    if os.path.exists(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def load_library(path: str) -> ctypes.CDLL:
    """Load a built kernel library and declare its C interface."""
    lib = ctypes.CDLL(path)
    ptrs = [ctypes.c_void_p] * 12
    ints = [ctypes.c_int] * 4
    for name in ("pdipm_ric_aug_f32", "pdipm_ric_aug_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ptrs + ints + [ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.pdipm_ric_aug_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pdipm_ric_aug_smem_bytes.restype = ctypes.c_size_t
    lib.pdipm_ric_aug_error_string.argtypes = [ctypes.c_int]
    lib.pdipm_ric_aug_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = load_library(build())
    return _lib


def run_kernel(lib: ctypes.CDLL, qp: StageQP, opts: PdipmOptions, stream) -> PdipmResult:
    """Launch the kernel of `lib` on `qp`'s tensors; `stream` is a raw stream
    handle (int) or None. Checks shapes and types, allocates the outputs."""
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
    smem = lib.pdipm_ric_aug_smem_bytes(T, qp.f.element_size())
    if smem > 232448:
        raise ValueError(f"horizon {T} needs {smem} B of shared memory per env; "
                         "the H100 gives a block at most 232448 B")
    new = lambda n: torch.empty(nb, n, dtype=dtype, device=qp.f.device)
    x, s, z, y, res = new(qp.nz), new(qp.n_ineq), new(qp.n_ineq), new(qp.n_eq), new(4)
    fn = lib.pdipm_ric_aug_f32 if dtype == torch.float32 else lib.pdipm_ric_aug_f64
    err = fn(*[t.data_ptr() for t in (*ins, x, s, z, y, res)], nb, T, opts.iterations,
             opts.refine_steps, opts.beta, opts.delta, stream)
    if err != 0:
        raise RuntimeError(
            f"PDIPM kernel launch failed: {lib.pdipm_ric_aug_error_string(err).decode()} ({err})")
    return PdipmResult(x, s, z, y, res)


def solve(qp: StageQP, opts: PdipmOptions = PdipmOptions()) -> PdipmResult:
    """Batched PDIPM: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global launches
    dev = qp.f.device
    if dev.type == "cpu":
        return pdipm.solve(qp, opts)
    if dev.type != "cuda":
        raise ValueError(f"PDIPM solve supports CPU and CUDA tensors, got {dev}")
    lib = _library()
    with torch.cuda.device(dev):
        res = run_kernel(lib, qp, opts, torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return res

"""The PDIPM as hand-written CUDA kernels, and the hybrid speed mode (twin of
`biped_pympc_tpu/ops/pdipm_pallas.py`: every route and option of
`_pdipm_kernel`).

`solve(qp, opts, state)` dispatches on where the QP lies: CUDA tensors launch
the kernel of the route (`route(opts)`: `opts.backend`, and for "ric" /
"ric_aug" also `opts.foot_split` and `opts.foot_pack`; one library per source
in `SOURCES`) in the launch geometry of `geometry` (every route a warp
group per env in its lean layout; K5a's, K5b's, K5c's, K5d-a's and K5d-c's
stored stage inverses in a device-memory workspace that `_launch` allocates
where the library asks for one; one env per 128-thread block, the block
group, when a caller asks for it to compare),
CPU tensors run the plain version `ops/pdipm.py`. There is no fallback
between the two: a failed build, allocation or launch raises, and so does a
horizon and dtype whose layout does not fit in a block's shared memory. A
given `state` is the warm start; every other field
of `PdipmOptions` reaches the kernel through `PdipmArgs` (the refinement and
its schedule, the residual's precision, the KKT scaling, the Gauss-Jordan
form and pivot knobs, the corrector form, the sigma cap and the step rule's
constants). `refine_residual` runs the compensated residual alone, through
the same device code, as a check of it.

`solve_adaptive` runs the solve in warm-started chunks with an early stop
(`pdipm_pallas.solve_adaptive`). On the card every chunk is issued at once;
each launch reads a device flag computed from the previous chunk's residuals
and returns at once when it is 0, so the loop never waits for the device.

`solve_hybrid` runs the condensed route on every env and re-solves the
worst-criterion envs with the augmented route, pivoted
(`pdipm_pallas.solve_hybrid`).

The kernels are compiled with nvcc for sm_90a at first use into `_build/`
beside this package, one library per source (`ops/cuda_build.py`), and
loaded with ctypes. Every source instantiates the one Newton-step kernel of
`csrc/pdipm_common.cuh` with its route's factorization.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from dataclasses import dataclass

import torch

from biped_pympc_tpu_torch.ops import cuda_build, pdipm
from biped_pympc_tpu_torch.ops import qp as qps
from biped_pympc_tpu_torch.ops.cuda_build import find_nvcc
from biped_pympc_tpu_torch.ops.pdipm import PdipmOptions, PdipmResult
from biped_pympc_tpu_torch.ops.qp import StageQP
from biped_pympc_tpu_torch.utils.tracing import mark

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
# Kernel source of each route (`route`); every source includes HEADERS: the
# Riccati routes `pdipm_riccati.cuh` (the foot-split ones, packed or not,
# through `pdipm_split.cuh`), the block-Thomas routes one width each of
# `pdipm_tridiag.cuh`, all of them `pdipm_common.cuh`.
SOURCES = {"ric_aug": os.path.join(_CSRC, "pdipm_ric_aug.cu"),              # K1
           "ric": os.path.join(_CSRC, "pdipm_ric.cu"),                      # K2
           "tridiag_aug": os.path.join(_CSRC, "pdipm_tridiag_aug.cu"),      # K5b
           "tridiag": os.path.join(_CSRC, "pdipm_tridiag.cu"),              # K5a
           "ric2": os.path.join(_CSRC, "pdipm_ric2.cu"),                    # K5c
           "ric_dense": os.path.join(_CSRC, "pdipm_ric_dense.cu"),          # K5d-c
           "ric_aug_dense": os.path.join(_CSRC, "pdipm_ric_aug_dense.cu"),  # K5d-a
           "ric_pack": os.path.join(_CSRC, "pdipm_ric_pack.cu"),            # K5e-c
           "ric_aug_pack": os.path.join(_CSRC, "pdipm_ric_aug_pack.cu")}    # K5e-a
HEADERS = tuple(os.path.join(_CSRC, name) for name in
                ("pdipm_common.cuh", "pdipm_riccati.cuh", "pdipm_split.cuh",
                 "pdipm_tridiag.cuh"))
BUILD_DIR = os.path.join(_PKG, "_build")
MAX_SMEM_PER_BLOCK = 232448  # bytes of shared memory an H100 gives one block

# Launch geometry (`geometry`). Every route (LEAN_ROUTES, all of SOURCES)
# runs in its warp group (`WarpGroup`, csrc/pdipm_common.cuh),
# WARP_THREADS[route] threads per env and one env per block, in its lean
# layout; each also keeps the block group, one env per block of
# BLOCK_THREADS threads (`BlockGroup`) in its block layout, which a caller
# asks for (`BLOCK`) to compare. K1's and K2's warp groups finish first at
# every batch measured, from b128 (one env per SM, where one env's latency
# decides) to b4096 (PERF.md, Findings), and so do the others' at b128 and
# b4096 (chip_smoke.py's turns), so the choice does not depend on the
# batch. K5b, K5d-a, K5a, K5c and K5d-c (WORK_ROUTES) keep their T
# stored stage inverses in shared memory, or in a workspace of device
# memory, `pdipm_<route>_work_bytes` per env, where they do not fit or where
# that puts more envs on an SM (the library asks the occupancy calculator;
# at h10 K5b in f32 runs 8 envs an SM with it against 2 without, PERF.md).
BLOCK_THREADS = 128
WARP_THREADS = {"ric_aug": 64, "ric": 32, "tridiag_aug": 32, "ric_aug_dense": 128,
                "tridiag": 32, "ric_aug_pack": 64, "ric2": 32, "ric_dense": 32, "ric_pack": 32}
LEAN_ROUTES = ("ric_aug", "ric", "tridiag_aug", "ric_aug_dense", "tridiag", "ric_aug_pack",
               "ric2", "ric_dense", "ric_pack")
WORK_ROUTES = ("tridiag_aug", "ric_aug_dense", "tridiag", "ric2", "ric_dense")

# Kernel launches issued from the host in this process: solves per route
# (`route`), and launches of the refinement-residual entry. A CUDA graph's
# capture issues its launches into the graph, once; its replays issue none.
launches = {backend: 0 for backend in SOURCES}
# Of those, the launches in a warp group (the rest of each route's count ran
# in the block group).
warp_launches = {backend: 0 for backend in LEAN_ROUTES}
residual_launches = {"ric_aug": 0}
# Solves that ran on the device, per (route, warp group or not, device): one
# int32 each, added to by the kernel itself (block 0, `gate_open` in
# csrc/pdipm_common.cuh), eager or replayed in a CUDA graph, so a replay
# counts as an eager launch does (`runs`; chip_smoke.py reads them to show
# that each path went through the kernels). The adaptive solve's launches
# count in `_ran`, the rest in `_runs`.
_runs: dict = {}
_ran: dict = {}


class PdipmArgs(ctypes.Structure):
    """The options of one launch, `struct PdipmArgs` of csrc/pdipm_common.cuh
    field for field (`args`): ints, then doubles."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "iterations", "refine_steps", "refine_skip", "refine_df", "kkt_jacobi", "gj_inplace",
        "aug_pivot", "k_pivot", "corrector_form", "foot_pack")] + [
        (name, ctypes.c_double) for name in (
            "beta", "delta", "sigma_cap", "frac_to_boundary", "alpha_min", "sz_floor")]


@dataclass(frozen=True)
class Geometry:
    """How one launch lays envs on the card: threads per env (BLOCK_THREADS
    for the block group, WARP_THREADS for a warp group), envs per block (one
    in either), and whether it is the route's warp group in its lean layout
    (`lean`; K5d-a's four warps have the block group's 128 threads)."""

    threads_per_env: int
    envs_per_block: int
    lean: bool = False


BLOCK = Geometry(BLOCK_THREADS, 1)


def geometry(backend: str) -> Geometry:
    """The launch geometry of route `backend`: its warp group of
    WARP_THREADS[backend] threads, one env per block. Whether the route's
    layout fits a block at the launch's horizon and dtype, `_launch` asks
    the library."""
    return Geometry(WARP_THREADS[backend], 1, lean=True)


def args(opts: PdipmOptions) -> PdipmArgs:
    """`opts` as the kernels read them: the refinement schedule as the count
    of leading steps at refine 0 (`pdipm.refine_schedule`), the corrector form
    as its index in `pdipm.CORRECTOR_FORMS`, foot_pack as 0 / 1 (True) / 2
    ("apply")."""
    return PdipmArgs(
        iterations=opts.iterations, refine_steps=opts.refine_steps,
        refine_skip=pdipm.refine_schedule(opts), refine_df=int(opts.refine_residual == "df"),
        kkt_jacobi=int(opts.kkt_scale == "jacobi"), gj_inplace=int(opts.gj_form == "inplace"),
        aug_pivot=int(opts.aug_pivot), k_pivot=int(opts.k_pivot),
        corrector_form=pdipm.CORRECTOR_FORMS.index(opts.corrector_form),
        foot_pack={False: 0, True: 1, "apply": 2}[opts.foot_pack], beta=opts.beta,
        delta=opts.delta, sigma_cap=opts.sigma_cap, frac_to_boundary=opts.frac_to_boundary,
        alpha_min=opts.alpha_min, sz_floor=opts.sz_floor)


# C interface of `pdipm_<route>_<f32|f64>` in every library: the QP inputs
# hd, f, Ad, Bd, b, G_u, d; the warm start x0, s0, z0, y0 (null: cold start);
# the outputs x, s, z, y, res; the gate go and the counter ran (null: always
# run, no count); then batch, T, a pointer to the options (`PdipmArgs`) and
# the stream. The condensed routes take the same arguments; their refine_df
# must be 0, which `pdipm.check_options` ensures before any launch. Each
# route reads the options that apply to it, as the JAX kernel does.
ENTRY_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
# The warp entries of WORK_ROUTES take one more pointer: the workspace (null:
# the stored inverses in shared memory).
WORK_ENTRY_ARGTYPES = ENTRY_ARGTYPES + [ctypes.c_void_p]
# C interface of `pdipm_ric_aug_residual_<f32|f64>`: hd, Ad, Bd, G_u, W, dx,
# dz, dy, r1, rz, r4; the outputs e1, ez, e4; then batch, T, refine_df, beta,
# delta and the stream.
RESIDUAL_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_double] * 2
                     + [ctypes.c_void_p])

_libs: dict = {}


def route(opts: PdipmOptions) -> str:
    """The kernel (key of `SOURCES`) that runs `opts`: `opts.backend`, with
    "_dense" for "ric" / "ric_aug" when `opts.foot_split` is off (the unsplit
    14- / 30-wide stage blocks, `pdipm_pallas.py:896`, `:1007`) and "_pack"
    when it is on and `opts.foot_pack` is True or "apply" (the packed stage
    pairs, `:675-709`, `:791-823`)."""
    if opts.backend in ("ric", "ric_aug"):
        if not opts.foot_split:
            return f"{opts.backend}_dense"
        if opts.foot_pack:
            return f"{opts.backend}_pack"
    return opts.backend


def library_path(backend: str) -> str:
    """Where the library of a route is built. The name carries a hash of its
    source, the shared headers and the flags, so an edit to any of them
    builds anew."""
    return cuda_build.library_path(f"pdipm_{backend}", SOURCES[backend], HEADERS, BUILD_DIR)


def build() -> dict:
    """Compile every kernel library not built yet, one nvcc per source, all
    started together; return {backend: .so path}. Raises RuntimeError with
    the compiler's output if any nvcc fails."""
    return cuda_build.build(SOURCES, {backend: library_path(backend) for backend in SOURCES},
                            BUILD_DIR, nvcc=find_nvcc)


def load_library(path: str, backend: str) -> ctypes.CDLL:
    """Load the built kernel library of a route and declare its C interface."""
    lib = ctypes.CDLL(path)
    for suffix in ("f32", "f64"):
        entries = [(f"pdipm_{backend}_{suffix}", ENTRY_ARGTYPES),
                   (f"pdipm_{backend}_warp_{suffix}", WORK_ENTRY_ARGTYPES
                    if backend in WORK_ROUTES else ENTRY_ARGTYPES)]
        if backend == "ric_aug":
            entries.append((f"pdipm_ric_aug_residual_{suffix}", RESIDUAL_ARGTYPES))
        for name, argtypes in entries:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    smem = getattr(lib, f"pdipm_{backend}_smem_bytes")
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_size_t
    # The warp group's lean layout and occupancy, and the WORK_ROUTES'
    # workspace.
    extras = [(f"pdipm_{backend}_lean_bytes", [ctypes.c_int] * 2, ctypes.c_size_t),
              (f"pdipm_{backend}_envs_per_sm", [ctypes.c_int] * 3, ctypes.c_int)]
    if backend in WORK_ROUTES:
        extras.append((f"pdipm_{backend}_work_bytes", [ctypes.c_int] * 3, ctypes.c_size_t))
    if hasattr(lib, f"pdipm_{backend}_profile_read"):
        # A profile build's breakdown (`bench/pdipm_geometry.py`).
        extras.append((f"pdipm_{backend}_profile_read", [ctypes.c_void_p, ctypes.c_int],
                       ctypes.c_int))
    for name, argtypes, restype in extras:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    errs = getattr(lib, f"pdipm_{backend}_error_string")
    errs.argtypes = [ctypes.c_int]
    errs.restype = ctypes.c_char_p
    return lib


def _library(backend: str) -> ctypes.CDLL:
    if backend not in _libs:
        _libs[backend] = load_library(build()[backend], backend)
    return _libs[backend]


def smem_bytes(backend: str, horizon: int, dtype: torch.dtype, geom: Geometry = BLOCK) -> int:
    """Bytes of shared memory one env of route `backend` needs at `horizon`
    in `dtype` in `geom` (the block layout, or the route's warp group's lean
    layout as it launches), from the kernel library's own layout (builds
    it)."""
    size = torch.empty((), dtype=dtype).element_size()
    kind = "lean" if geom.lean else "smem"
    return getattr(_library(backend), f"pdipm_{backend}_{kind}_bytes")(horizon, size)


def _inputs(qp: StageQP) -> list:
    """The kernel's QP inputs, batch-first and contiguous: hd, f, Ad, Bd, b,
    G_u, d. Checks their shapes and types."""
    dtype = qp.f.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"PDIPM kernel takes float32 or float64, got {dtype}")
    nb = qp.f.shape[0]
    ins = [t.contiguous() for t in (
        qps.h_diag(qp), qp.f, qp.dyn.A, qp.dyn.B, qps.b_vec(qp), qp.g_u, qps.d_vec(qp))]
    want = [(nb, qp.nz), (nb, qp.nz), (nb, 12, 12), (nb, 12, 12), (nb, qp.n_eq),
            (nb, 16, 12), (nb, qp.n_ineq)]
    for t, shape in zip(ins, want):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != qp.f.device:
            raise ValueError(f"kernel input {tuple(t.shape)} {t.dtype} {t.device}, "
                             f"expected {shape} {dtype} {qp.f.device}")
    return ins


def _checked(kind: str, tensors, shapes, like: torch.Tensor) -> list:
    """`tensors` made contiguous, after checking each against its shape and
    `like`'s dtype and device."""
    for t, shape in zip(tensors, shapes):
        if tuple(t.shape) != shape or t.dtype != like.dtype or t.device != like.device:
            raise ValueError(f"{kind} {tuple(t.shape)} {t.dtype} {t.device}, expected {shape} "
                             f"{like.dtype} {like.device}")
    return [t.contiguous() for t in tensors]


def _state_tensors(qp: StageQP, state: pdipm.PdipmState) -> list:
    """x, s, z, y of a warm start, checked against the QP, contiguous."""
    nb = qp.f.shape[0]
    return _checked("warm state", [state.x, state.s, state.z, state.y],
                    [(nb, qp.nz), (nb, qp.n_ineq), (nb, qp.n_ineq), (nb, qp.n_eq)], qp.f)


def workspace(lib, backend: str, horizon: int, dtype: torch.dtype, batch: int, device,
              force: bool | None = None) -> torch.Tensor | None:
    """The device-memory workspace of a WORK_ROUTES warp launch: batch x
    `pdipm_<route>_work_bytes` bytes, or None where the stored inverses stay
    in shared memory (the library decides: where they fit and the workspace
    does not let more envs reside on an SM). `force` True or False overrides
    the choice, a measurement of the other layout (False: the launch fails
    where they do not fit). Allocated before the launch, so a failed
    allocation raises before it."""
    if force is False:
        return None
    size = torch.empty((), dtype=dtype).element_size()
    per_env = getattr(lib, f"pdipm_{backend}_work_bytes")(horizon, size, int(bool(force)))
    if per_env == 0:
        return None
    return torch.empty(batch * per_env, dtype=torch.uint8, device=device)


def _launch(lib, qp: StageQP, ins, opts: PdipmOptions, stream, warm, outs, go=None, ran=None,
            geom: Geometry | None = None, force_workspace: bool | None = None):
    """One launch of route `route(opts)` from `lib` in `geom` (None: the
    route's `geometry`; `BLOCK` runs a warp-group route in the block group,
    as chip_smoke.py does to compare): warm (x0, s0, z0, y0) or None for the
    cold start; outs (x, s, z, y, res), which may be the warm tensors
    themselves; go the gate flag (an int32 device tensor) or None; ran the
    counter the kernel adds one to (None: the route's in `_runs`);
    `force_workspace` (WORK_ROUTES in their warp group)
    True or False puts the stored inverses in the workspace or in shared
    memory whatever the library's choice (`workspace`), None leaves it."""
    if opts.iterations < 0 or opts.refine_steps < 0:
        raise ValueError(f"iterations and refine_steps must be >= 0: {opts}")
    T = qp.horizon
    key = route(opts)
    name = f"pdipm_{key}"
    if geom is None:
        geom = geometry(key)
    if geom not in (BLOCK, geometry(key)):
        raise ValueError(f"route {key!r} runs in {BLOCK} or {geometry(key)}, not in {geom}")
    smem = getattr(lib, f"{name}_{'lean' if geom.lean else 'smem'}_bytes")(
        T, qp.f.element_size())
    if smem > MAX_SMEM_PER_BLOCK:
        raise ValueError(f"route {key!r} at horizon {T} in {qp.f.dtype} needs {smem} B "
                         f"of shared memory per block ({geom}); an H100 block has at most "
                         f"{MAX_SMEM_PER_BLOCK} B")
    ptr = lambda t: None if t is None else t.data_ptr()
    entry = f"{name}_warp" if geom.lean else name
    fn = getattr(lib, f"{entry}_f32" if qp.f.dtype == torch.float32 else f"{entry}_f64")
    options = args(opts)
    # The workspace lives until the launch is queued; the stream orders its
    # reuse by the caching allocator after the kernel.
    work = [workspace(lib, key, T, qp.f.dtype, qp.f.shape[0], qp.f.device, force_workspace)
            ] if geom.lean and key in WORK_ROUTES else []
    if ran is None:
        ran = _counter(_runs, key, geom, qp.f.device)
    err = fn(*[t.data_ptr() for t in ins], *[ptr(t) for t in (warm or [None] * 4)],
             *[t.data_ptr() for t in outs], ptr(go), ptr(ran), qp.f.shape[0], T,
             ctypes.addressof(options), stream, *[ptr(t) for t in work])
    del work
    if err != 0:
        raise RuntimeError(f"PDIPM kernel {name} launch failed: "
                           f"{getattr(lib, f'{name}_error_string')(err).decode()} ({err})")
    launches[key] += 1
    if geom.lean:
        warp_launches[key] += 1


def _counter(table: dict, key: str, geom: Geometry, device) -> torch.Tensor:
    """The int32 counter of `table` that a launch of route `key` in `geom`
    on `device` adds to, made (zeroed) at the first such launch. That
    launch may not be inside a CUDA graph's capture, which would zero it at
    every replay: a captured step warms up first (`utils/cuda_graph.py`)."""
    index = (key, geom.lean, device)
    count = table.get(index)
    if count is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the first launch of route {key!r} is inside a CUDA graph "
                               f"capture: run it once eagerly first")
        count = table[index] = torch.zeros(1, dtype=torch.int32, device=device)
    return count


def run_kernel(lib: ctypes.CDLL, qp: StageQP, opts: PdipmOptions, stream,
               state: pdipm.PdipmState | None = None,
               geom: Geometry | None = None,
               force_workspace: bool | None = None) -> PdipmResult:
    """Launch the kernel of route `route(opts)` from `lib` on `qp`'s tensors
    in `geom` (None: `geometry`), from `state` (warm) or the cold start;
    `stream` is a raw stream handle (int) or None; `force_workspace` as in
    `_launch`. Checks shapes and types, allocates the outputs (and the
    workspace)."""
    ins = _inputs(qp)
    warm = None if state is None else _state_tensors(qp, state)
    new = lambda n: torch.empty(qp.f.shape[0], n, dtype=qp.f.dtype, device=qp.f.device)
    outs = [new(qp.nz), new(qp.n_ineq), new(qp.n_ineq), new(qp.n_eq), new(4)]
    _launch(lib, qp, ins, opts, stream, warm, outs, geom=geom, force_workspace=force_workspace)
    return PdipmResult(*outs)


def _device(qp: StageQP, opts: PdipmOptions) -> torch.device:
    """Check the options and where the QP lies: CPU or CUDA."""
    pdipm.check_options(opts)
    dev = qp.f.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"PDIPM solve supports CPU and CUDA tensors, got {dev}")
    return dev


def solve(qp: StageQP, opts: PdipmOptions = PdipmOptions(),
          state: pdipm.PdipmState | None = None) -> PdipmResult:
    """Batched PDIPM on route `route(opts)`, from `state` (a batch-first
    PdipmState, the warm start) or the cold start: its CUDA kernel for CUDA
    tensors, in `geometry`, the plain version for CPU tensors. The routes of
    `pdipm.PLAIN_BACKENDS` have no kernel, as in JAX, where they reach no
    Pallas kernel: the plain version runs them on both devices, "dense" (a
    batched LU, `pdipm._factor_dense`) and "ric_aug_core" (the scaled
    Riccati core, `pdipm._factor_core`)."""
    dev = _device(qp, opts)
    if dev.type == "cpu" or opts.backend in pdipm.PLAIN_BACKENDS:
        return pdipm.solve(qp, opts, state)
    lib = _library(route(opts))
    with torch.cuda.device(dev):
        return run_kernel(lib, qp, opts, torch.cuda.current_stream(dev).cuda_stream, state)


def refine_residual(qp: StageQP, w_diag, dx, dz, dy, r1, r_z, r4,
                    opts: PdipmOptions = PdipmOptions()):
    """Refinement residual (e1, ez, e4) of the augmented reduced system at W =
    diag(w_diag) (`pdipm.refine_residual_aug`), compensated when
    `opts.refine_residual == "df"`: on CUDA tensors through K1's own device
    code (`refine_residual` in csrc/pdipm_ric_aug.cu, one block per env), on
    CPU tensors through the plain version. No solve calls it; it checks the
    arithmetic of K4 where the residual cancels."""
    dev = _device(qp, opts)
    if dev.type == "cpu":
        return pdipm.refine_residual_aug(qp, qps.h_diag(qp), w_diag, opts, dx, dz, dy, r1, r_z, r4)
    lib = _library("ric_aug")
    nb, nz, ni, ne = qp.f.shape[0], qp.nz, qp.n_ineq, qp.n_eq
    ins = _inputs(qp)
    vecs = _checked("residual input", [w_diag, dx, dz, dy, r1, r_z, r4],
                    [(nb, ni), (nb, nz), (nb, ni), (nb, ne), (nb, nz), (nb, ni), (nb, ne)], qp.f)
    outs = [torch.empty(nb, n, dtype=qp.f.dtype, device=qp.f.device) for n in (nz, ni, ne)]
    fn = getattr(lib, "pdipm_ric_aug_residual_f32" if qp.f.dtype == torch.float32
                 else "pdipm_ric_aug_residual_f64")
    with torch.cuda.device(dev):
        err = fn(*[t.data_ptr() for t in (ins[0], ins[2], ins[3], ins[5], *vecs, *outs)], nb,
                 qp.horizon, int(opts.refine_residual == "df"), opts.beta, opts.delta,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"refinement residual kernel launch failed: "
                           f"{lib.pdipm_ric_aug_error_string(err).decode()} ({err})")
    residual_launches["ric_aug"] += 1
    return tuple(outs)


def solve_adaptive(qp: StageQP, opts: PdipmOptions = PdipmOptions(),
                   tol: float = 1e-2) -> PdipmResult:
    """Adaptive-iteration solve (`pdipm_pallas.solve_adaptive`): chunks of
    `opts.iterations_per_launch` Newton steps, each warm-started from the
    last, while fewer than n_full chunks ran and max(||rx||, ||rs||, ||re||,
    mu) over the whole batch is above `tol`, then a remainder of
    `iterations % chunk` steps if it still is. See
    `pdipm.solve_adaptive_batch`, which CPU tensors run, and the routes of
    `pdipm.PLAIN_BACKENDS` on both devices.

    On the card the n_full launches (and the remainder's) are all issued.
    Before each, a device reduction writes go = max(res) > tol, with res = +inf
    before the first; a launch whose go is 0 leaves the state and res as they
    are, so every later gate stays shut, as the JAX loop's exit does. Each
    launch continues in place in the same state buffers. Nothing waits for
    the device; `chunks_ran` reads how many launches ran.
    """
    dev = _device(qp, opts)
    if dev.type == "cpu" or opts.backend in pdipm.PLAIN_BACKENDS:
        return pdipm.solve_adaptive_batch(qp, opts, tol)
    chunk, n_full, rem = pdipm.chunks(opts)
    lib = _library(route(opts))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ins = _inputs(qp)
        st = pdipm.init_state(qp)
        state = [t.contiguous() for t in (st.x, st.s, st.z, st.y)]
        res = torch.full((qp.f.shape[0], 4), float("inf"), dtype=qp.f.dtype, device=qp.f.device)
        ran = _counter(_ran, route(opts), geometry(route(opts)), dev)
        for iters in [chunk] * n_full + [rem] * (rem > 0):
            go = (res.amax() > tol).to(torch.int32)
            _launch(lib, qp, ins, dataclasses.replace(opts, iterations=iters), stream, state,
                    state + [res], go=go, ran=ran)
    return PdipmResult(*state, res)


def _sum(tables, warp: bool | None) -> dict:
    out = {backend: 0 for backend in SOURCES}
    for table in tables:
        for (backend, lean, _), count in table.items():
            if warp is None or lean == warp:
                out[backend] += int(count.item())
    return out


def runs(warp: bool | None = None) -> dict:
    """{route: solves that ran on the device} in this process, summed over
    devices, as the kernels counted them: eager launches and launches
    replayed in a CUDA graph, and of the adaptive solve's the ones whose
    gate was open. `warp` True / False: those in the route's warp group /
    the block group. Reads the device counters, so it waits for the
    device."""
    return _sum((_runs, _ran), warp)


def chunks_ran() -> dict:
    """{route: launches of `solve_adaptive` that ran} in this process, summed
    over devices. Reads the device counters, so it waits for the device."""
    return _sum((_ran,), None)


def reset_counts() -> None:
    """Set the host launch counts and the device counters to 0. The device
    counters are zeroed in place: a captured graph adds to the ones it was
    captured with."""
    for counts in (launches, warp_launches, residual_launches):
        for key in counts:
            counts[key] = 0
    for table in (_runs, _ran):
        for count in table.values():
            count.zero_()


@dataclass
class HybridStats:
    """Per-solve hybrid counters, int32 scalar tensors on the solve's device
    (`pdipm_pallas.HybridStats`), and the mask of the envs merged.
    `dropped_nonfinite > 0` means the finiteness guarantee lapsed on that
    solve: more non-finite envs than the re-solve budget."""

    flagged: torch.Tensor  # envs over flag_tol or non-finite (whole batch)
    nonfinite: torch.Tensor  # envs with a non-finite criterion or solution
    resolved: torch.Tensor  # envs re-solved and merged (<= budget)
    dropped_nonfinite: torch.Tensor  # non-finite envs not rescued
    merged: torch.Tensor  # (B,) bool: the envs that took the re-solve's answer


def solve_hybrid(qp: StageQP, opts: PdipmOptions = PdipmOptions(), budget: int = 0,
                 flag_tol: float = 1.0, aug_opts: PdipmOptions | None = None,
                 flag: str = "resid", with_stats: bool = False):
    """Fast solve on every env, then a robust re-solve of the flagged envs.

    Runs `opts` (the condensed "ric" in the speed mode) on the whole batch,
    ranks each env by its criterion (the largest final residual, or with
    flag="kkt" the largest `pdipm.kkt_error`), and re-solves the `budget`
    worst from the cold start with `aug_opts` or, when None, with `opts` on
    the augmented route with its pivot search (`opts._replace(backend=
    "ric_aug", aug_pivot=True)`, `pdipm_pallas.py:1826-1828`): the same
    iterations, refinement, foot split and packing, KKT scaling and step
    options. An env with a non-finite criterion or any
    non-finite value in x, s, z or y ranks +inf. Re-solved envs whose
    criterion exceeds `flag_tol`, or is +inf, take the augmented result.
    budget <= 0 selects max(64, B // 32); the budget
    is clamped to B. The size of the re-solve is fixed by B and the budget,
    so nothing here waits for the device.

    On the card each phase starts with its mark (`utils/tracing.mark`):
    `hybrid_condensed` before the condensed pass, `hybrid_rank` before the
    criterion, `hybrid_resolve` before the re-solve, `hybrid_merge` before
    the merge and the counters, `hybrid_done` where the caller takes over.

    Returns the merged PdipmResult, or (PdipmResult, HybridStats) when
    with_stats.
    """
    if flag not in ("resid", "kkt"):
        raise ValueError(f"hybrid flag must be 'resid' or 'kkt', got {flag!r}")
    nb = qp.f.shape[0]
    if budget <= 0:
        budget = max(64, nb // 32)
    mark("hybrid_condensed", qp.f)
    res = solve(qp, opts)
    mark("hybrid_rank", qp.f)
    crit = (pdipm.kkt_error(qp, res) if flag == "kkt" else res.residuals).amax(dim=1)
    finite = lambda v: torch.isfinite(v).all(dim=1)
    sol_ok = finite(res.x) & finite(res.s) & finite(res.z) & finite(res.y)
    crit = torch.where(torch.isfinite(crit) & sol_ok, crit, torch.full_like(crit, float("inf")))
    k = min(budget, nb)
    # Stable descending order: on ties (every non-finite env ranks +inf) the
    # lower index comes first, as in jax.lax.top_k, so both rescue the same envs.
    vals, idx = torch.sort(crit, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    if aug_opts is None:
        aug_opts = dataclasses.replace(opts, backend="ric_aug", aug_pivot=True)
    taken = qps.take(qp, idx)
    mark("hybrid_resolve", qp.f)
    res_aug = solve(taken, aug_opts)
    mark("hybrid_merge", qp.f)
    need = (vals > flag_tol) | torch.isinf(vals)  # (k,)

    def merge(a, b):
        sel = need.view(k, *([1] * (b.dim() - 1)))
        return a.index_copy(0, idx, torch.where(sel, b, a[idx]))

    merged = PdipmResult(*(merge(getattr(res, f.name), getattr(res_aug, f.name))
                           for f in dataclasses.fields(PdipmResult)))
    if not with_stats:
        mark("hybrid_done", qp.f)
        return merged
    inf_crit = torch.isinf(crit)
    nonfinite = inf_crit.sum(dtype=torch.int32)
    stats = HybridStats(
        flagged=((crit > flag_tol) | inf_crit).sum(dtype=torch.int32),
        nonfinite=nonfinite,
        resolved=need.sum(dtype=torch.int32),
        # Non-finite envs rank +inf and so take budget slots first; the
        # excess over the budget is returned unmerged.
        dropped_nonfinite=nonfinite - torch.isinf(vals).sum(dtype=torch.int32),
        merged=torch.zeros_like(inf_crit).index_copy(0, idx, need),
    )
    mark("hybrid_done", qp.f)
    return merged, stats

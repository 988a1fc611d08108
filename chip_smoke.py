#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. It builds the nine PDIPM kernels, the
roofline probes K6 / K7 (`csrc/roofline.cu`), the synthetic tape's K8 (one
straight-line kernel generated from each tape it runs,
`bench/tape_codegen.py`, a tape of 1e5 ops as ten consecutive kernels) and
the tape interpreter K8 replaced (`csrc/tape.cu`, kept to compare) with
nvcc, one process per source, all at once, the PDIPM kernels each one
route's factorization in the
one Newton-step kernel of `biped_pympc_tpu_torch/csrc/pdipm_common.cuh`: the
augmented Riccati route K1 (`csrc/pdipm_ric_aug.cu`), the condensed Riccati
route K2 (`csrc/pdipm_ric.cu`), the condensed block-Thomas route K5a
(`csrc/pdipm_tridiag.cu`), the augmented one K5b (`csrc/pdipm_tridiag_aug.cu`),
the rank-2 condensed route K5c (`csrc/pdipm_ric2.cu`), the unsplit
Riccati routes K5d-c (`csrc/pdipm_ric_dense.cu`, 14-wide) and K5d-a
(`csrc/pdipm_ric_aug_dense.cu`, 30-wide), and the packed foot-split routes
K5e-c (`csrc/pdipm_ric_pack.cu`) and K5e-a (`csrc/pdipm_ric_aug_pack.cu`),
all with the warm entry K3, the augmented ones with the compensated
refinement residual K4, the Riccati ones with the Jacobi equilibration, the
Gauss-Jordan form and pivot knobs (K5f), and every one with the step
variants of the Newton step (K5g: the corrector forms, the refinement
schedule, the sigma cap). It holds each against its plain PyTorch version on
a randomized b4096 QP batch (K4 also alone, on residuals that cancel nearly
every digit, with the f32 residual as a control that must miss the bound),
prints how far the packed routes and the two Gauss-Jordan forms part from
the routes and form they replace, checks that warm-started chunks reproduce
the fixed solve bit for bit, that the adaptive solve stops where the JAX
loop does without waiting for the device, that a layout over a block's
shared memory raises before any launch, and prints whether K1 and K2 (in
their former Gauss-Jordan form), K5a and K5b still give the bits their
builds gave before the Newton step was shared. Every route runs in its warp
group (`pdipm_cuda.geometry`: K1 and K5e-a two warps per env, K2, K5b, K5a,
K5c, K5d-c and K5e-c one, K5d-a four, in their lean layouts; K5b's, K5d-a's,
K5a's, K5c's and K5d-c's stored stage inverses in shared memory or in a
device-memory workspace); the script checks every route's bits in the block
group against the build before the warp groups (BEFORE_WARP_DIGESTS), holds
the block group against the plain version too, and times both geometries in
turns beside a clock64() breakdown of a Newton step and the resident envs
per SM, with the two places for the inverses in turns (`geometry_phase`;
`python3 chip_smoke.py --geometry` runs that phase alone with a sweep of
batch sizes, `--digests` prints the digests; no other argument is taken).
It holds K5b, K5d-a, K5a, K5c and K5d-c at horizons 20 and 40 against the
f64 plain version (HORIZONS), which their block layouts refused in f64 (K5a
at 40).
It drives `MPCController`
(HECTOR, walking gait, 4096 envs) on the card with the default solver for 200
ticks, with the hybrid speed mode (K2 everywhere, K1 re-solves) for 100
ticks, with the adaptive solve for 100 ticks, with `solver="pallas_aug"`
(K5b) for 100 ticks and, for 50 ticks each, with `"pallas"` (K5a),
`"pallas_ric2"` (K5c), `"pallas_ric"` unsplit (K5d-c), `"pallas_ric_aug"`
unsplit (K5d-a), `"pallas_ric_aug"` with Jacobi scaling (K1), and with the
foot packing: `"pallas_ric_aug"` and `"pallas_hybrid"` with
`solver_foot_pack=True` and `"pallas_ric"` with `"apply"` (K5e). It checks
that every solve went through the kernels, as the kernels count their own
launches on the device (`pdipm_cuda.runs`: a launch replayed in a CUDA
graph counts, and so does a capture's warm-up; the profiler's trace of the
default and hybrid walks agrees), and that the outputs are sane, and
times the kernels, the plain versions, the hybrid and adaptive solves,
`run_mpc` and one 1 kHz tick, each kernel beside its bound. It checks in
the SASS that the roofline kernels' loops are multiply-adds and passes
through shared memory, holds K6 (every nacc and knob of the sweep, 100,000
steps), K7 (20,000 passes) and K8 (1e1..1e5 ops) against their plain
versions in float32 and float64, times K8 against the interpreter in turns
beside each length's nvcc seconds and critical path, and drives the two
bench paths that
launch them, `ab_roofline.main` (the ceilings and six PDIPM routes at
b4096) and `bench_synthetic.main` (the tape sweep). Each phase prints
one line of findings; any failure raises and the script exits non-zero.
`MPCController` captures each call as a CUDA graph at its first use and
replays it after; every phase above drives it so. The wrapper's own phase
(`wrapper_phase`, `[wrapper graph]`; `--wrapper` runs it alone after the
build) holds two 100 Hz periods through the captured controller bit for bit
against `ctrl.core`'s eager methods on a cloned state (default, hybrid,
adaptive and the T1), checks that a replayed `run_mpc` runs K1 once as the
kernel counts it and as the profiler sees it, and issues nothing from the
host, and that a result the caller holds does not change,
and prints the device events, idle share and ms of a tick, `run_mpc` and a
period captured and eager in turns, the graphs' pool bytes, the T1-newton
tick and the `dense` mode, whose `run_mpc` is captured with its LU under
cuSOLVER. `BipedControllerCore.control_step`, the whole tick with the solve,
is one CUDA graph captured at its first call (`control_step_phase`,
`[control_step graph]`, also in `--wrapper`): ten calls, each on a new state
cloned from a rolling eager run, bit for bit the eager step for HECTOR on
K1, the hybrid and the T1, K1 once a replay as the kernel counts it and as
the profiler sees it, the ms captured and eager in turns, the device events,
idle share and pool bytes.
The closed loop (`biped_pympc_tpu_torch/examples/`, `closed_loop_phases`;
`--closed-loop` runs it alone after the build): 4096 HECTOR bipeds walking
with K1, one MPC cycle captured as a CUDA graph and replayed for 120 cycles
(its first 3 bit for bit the eager cycles', every env within JAX's walk
criteria, K1 once a replayed cycle by the profiler, ms a cycle graph and
eager, the device's idle share), the RL device env's captured step against
its eager one and an ARS update, `simulate` on K5b against the rollout's
first cycle, and `solver="dense"` (plain torch, its LU under cuSOLVER)
against the CPU at f64, with its LU timed under torch's default and under
cuSOLVER in turns;
one eager tick with the solve runs under the sync debug mode. The Booster
T1 (`t1_phases`; `--t1-extras` runs it and the next phases alone after the
build): `MPCController` with `recommended_conf("T1")` on K1 at b4096 against
the CPU f64 controller, and the closed loop of "T1-newton" and of "T1" with
the exact observation IK, one cycle captured and replayed for 2.5 s (its
first cycles bit for bit the eager ones, JAX's T1 walk criteria on every
env, the device events and K1 a replayed cycle). Then (`extras_phases`)
`ric_aug_core` (plain torch on the card) against the CPU at f64, a one-rank
NCCL mesh (`parallel/mesh.py`: the sharded step, each a replay of the core's
captured control_step, its metrics and one sharded training iteration bit
for bit the unsharded ones) and the planar
drone's region of attraction and sweeps. It exits non-zero without a
result when no CUDA device is visible. The last line is a JSON object
naming the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import re
import subprocess
import sys
import time

import numpy as np

B = 4096
TICKS = 200
HYBRID_TICKS = 100
ADAPTIVE_TICKS = 100
PATH_TICKS = 50  # each main path of a route beyond the default's, but pallas_aug's 100
WALK_TOL = 1e-2  # MPCConf.adaptive_tol of the adaptive main path
# Envs whose f64 reference ends with mu = s.z / ni at or below this are the
# ones the fixed 20-step Mehrotra rule has converged on. On the rest it is
# still moving (the f64 20- and 40-step solutions differ by up to tens of N),
# so two correct implementations that round differently part ways there;
# the agreement bounds apply to the converged envs and the tail is printed.
MU_CONVERGED = 1e-5
F64_ATOL = 1e-6
# The condensed routes with W^-1 (up to 1e8) inside a pivoted or dense stage
# block amplify f64 roundoff in the duals by their own scale. K5a (26-wide
# block-Thomas): on the converged envs of this batch two roundings of its
# plain version (on the card and on the CPU) differ by 8.3e-7 at a dual of
# 1687 (9.2e-9 relative), and the kernel reads 1.084e-6 there (1.546e-8
# relative), over F64_ATOL. K5c (rank 2) and K5d-c (unsplit 14-wide) read
# 1.3e-6 and 1.8e-6 against their own roundings' 1.5e-6 and 1.1e-6 (PERF.md,
# Findings). Their f64 bound is relative to max(1, |v|), about twice
# K5a's reading; the absolute is printed, with each route's roundoff witness.
# K2 joins the class under the reciprocal Gauss-Jordan form (gj_form
# "inplace"): 9.949e-7 absolute, 4.360e-9 relative (PERF.md, Findings).
CONDENSED_F64_RTOL = 3e-8
RES_RTOL = 1e-6
F32_U0_ATOL = 0.5  # N
# df vs the plain residual at f64, after DF_ITERS steps: the bound and the
# step count of tests/test_pdipm_pallas.py::test_pallas_df_refine_residual.
DF_F64_ATOL = 1e-9
DF_ITERS = 6
# The refinement residual alone on the cancellation case (`cancellation_case`):
# K1's compensated residual vs its plain version, max |difference| over each
# component relative to the largest float64 residual of that component. The
# f32-residual control must exceed the bound: it loses most digits there.
DF_RES_RTOL = {"f32": 1e-6, "f64": 1e-9}
F32_FINITE_SHARE = 0.999
# Newton steps after which the unpivoted augmented solves (4o) and the
# sigma-capped ones (4p) are held, on every env both sides keep finite.
SHORT_STEPS = 8
# The step variants (4p) may part from their plain versions this many times
# as far as two roundings of the plain version part from each other.
WITNESS_FACTOR = 4
# Before K1, K2, K5a and K5b shared one Newton-step kernel: `digest` of their
# solves of this script's b4096 batch (cold, 20 steps) and of the batch's
# kernel inputs, from their own builds on the H100 (PERF.md, Findings), and
# those builds' f32 times here (ms, NVIDIA H100 80GB HBM3, 700 W).
PARENT_DIGESTS = {
    ("inputs", "f32"): "05629153b7e71eb1", ("inputs", "f64"): "3fc20ad8fe8070e3",
    ("K1", "f32"): "e543b119adb31b23", ("K1", "f64"): "cef4d2fd5ec4e055",
    ("K2", "f32"): "66f7c8cd4f532621", ("K2", "f64"): "10614b834db20089",
    ("K5a", "f32"): "e67af260dc43ddee", ("K5a", "f64"): "33349eaf5fa2d05a",
    ("K5b", "f32"): "35fefd1d16af3dbf", ("K5b", "f64"): "d96756e2a481a2dc"}
PARENT_MS = {"K1": 43.063, "K2": 29.921, "K5a": 79.702, "K5b": 347.991}
# K1 and K2 f32 before the Gauss-Jordan form was an option, when every
# no-pivot inverse ran "tableau" (ms, NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md, Findings).
TABLEAU_MS = {"K1": 43.180, "K2": 28.864}
# HECTOR's standing pose, walking command (tests/test_controller.py:12-19).
Q0 = (0.0, 0.0, 0.45, -0.9, 0.45)
# `digest` of every route's b4096 solve of this script's batch (cold, 20
# steps, the controller's options; `digest_routes`), f32 and f64, from the
# build before K1 and K2 had warp groups (`python3 chip_smoke.py --digests`
# in a checkout of it on the H100; PERF.md, Findings). K1 and K2 are held to
# them in the block group.
BEFORE_WARP_DIGESTS = {
    "K1 f32": "c6646c560e92a670",
    "K1 f64": "0501b912b699e5a2",
    "K2 f32": "5d0a0509a4086592",
    "K2 f64": "0fcb2a1099c1833e",
    "K5a f32": "e67af260dc43ddee",
    "K5a f64": "33349eaf5fa2d05a",
    "K5b f32": "35fefd1d16af3dbf",
    "K5b f64": "d96756e2a481a2dc",
    "K5c f32": "eb94c45789da2787",
    "K5c f64": "eca3a3ae29d3e6ec",
    "K5d-c f32": "1741c38284af148a",
    "K5d-c f64": "ad366165fbc8f28b",
    "K5d-a f32": "097336486f495192",
    "K5d-a f64": "de22b9d0649609bb",
    "K5e-c pair f32": "5d0a0509a4086592",
    "K5e-c pair f64": "0fcb2a1099c1833e",
    "K5e-c apply f32": "5d0a0509a4086592",
    "K5e-c apply f64": "0fcb2a1099c1833e",
    "K5e-a pair f32": "f1dbcef938fc1c32",
    "K5e-a pair f64": "f0e5ea6d87e8a5bd",
    "K5e-a apply f32": "e6cc71621c5b6437",
    "K5e-a apply f64": "8d9709ad5b18f328",
}
# The hybrid's re-solve batch at b4096, max(64, B // 32).
RESOLVE_BATCH = 128
# The warp-group routes `geometry_phase` times once a turn and not at the
# re-solve batch: K5b, K5d-a and K5a, 0.02-0.74 s a solve in the block group.
SLOW_ROUTES = ("tridiag_aug", "ric_aug_dense", "tridiag")
# The horizons K5b, K5d-a, K5a, K5c and K5d-c are held at beyond the
# controller's 10: the JAX package's horizon table (bench/ab_round4.py:389);
# their block layouts refused T = 20 (K5a: 40) in f64 (ROADMAP Queue 3 item
# 5). The condensed K5a, K5c and K5d-c are held on the first HORIZON_ENVS
# envs of the batch, which keeps the plain version's f64 solves at h40 short.
HORIZONS = (20, 40)
HORIZON_ENVS = 1024
# The converged envs of a long-horizon batch on which the f64 roundoff
# witness of K5b and K5d-a is taken: those where the kernel parts most.
WITNESS_ENVS = 64


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): FP32
# outside the tensor cores, FP64 on them (DMMA), HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def k8_tapes() -> list:
    """(n_ops, dtype) of every tape whose generated kernels this script
    launches: K8_OPS in float32 and float64, and K8_LONG's in float32 (the
    lengths of `bench_synthetic.main` among them)."""
    import torch

    return [(n, dt) for n in K8_OPS for dt in (torch.float32, torch.float64)] + [
        (K8_LONG[0], torch.float32)]


def build_all() -> tuple:
    """Build the nine PDIPM libraries, the profile builds of the routes
    (`pdipm_geometry.build_profile`), the roofline probes' and the tape
    interpreter's at once (each build function starts its nvcc processes
    together); then start the kernels generated from every tape of
    `k8_tapes` and K8_SEGMENTED's segments, all at once in the background at
    the lowest CPU priority: only the bench twins, the last phase, launch
    them, and the phases before it keep one core busy driving the card.
    Return (the production libraries' paths, the roofline's and the
    interpreter's last; a future of {(n_ops, dtype): [the generated kernels'
    library paths], "segmented": [K8_SEGMENTED's]})."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from biped_pympc_tpu_torch.bench import ab_roofline, bench_synthetic, tape_codegen
    from biped_pympc_tpu_torch.bench import pdipm_geometry as pg
    from biped_pympc_tpu_torch.ops import cuda_build, pdipm_cuda

    with ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(fn) for fn in (pdipm_cuda.build, ab_roofline.build,
                                              bench_synthetic.build, pg.build_profile)]
        pdipm_paths, roofline, tape, _ = (f.result() for f in futures)
    tapes = k8_tapes()
    sources, paths, per_tape = tape_codegen.plan(
        [(bench_synthetic.make_tape(n), dt) for n, dt in tapes], pdipm_cuda.BUILD_DIR)
    n_seg, per = K8_SEGMENTED
    seg_sources, seg_paths, seg_libs = tape_codegen.plan(
        [(bench_synthetic.make_tape(n_seg), torch.float32)], pdipm_cuda.BUILD_DIR, segment=per)

    def k8_build():
        cuda_build.build({**sources, **seg_sources}, {**paths, **seg_paths}, pdipm_cuda.BUILD_DIR,
                         nice=19)
        return {**dict(zip(tapes, per_tape)), "segmented": seg_libs[0]}

    background = ThreadPoolExecutor(1)
    k8 = background.submit(k8_build)
    background.shutdown(wait=False)  # the build runs on; the interpreter joins it at exit
    return sorted(pdipm_paths.values()) + [roofline, tape["interp"]], k8


def sm_clock_mhz() -> float:
    """The card's largest SM clock, MHz, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip())


def ptxas_report(lib_paths) -> str:
    """Registers and spill stores of every kernel entry, as ptxas reported
    them when each library was built (`cuda_build.build_log`, kept beside
    the library, so a library built before this run reports too); raises if
    a library has no report. The Newton-step kernel is named by its route
    policy and group, `pdipm_kernel<RicAugLean, f32, WarpGroup<2>>`."""
    from biped_pympc_tpu_torch.ops import cuda_build

    out = []
    for path in lib_paths:
        text = cuda_build.build_log(path)
        check(text is not None and "Used" in text, f"no ptxas report for {path}")
        name = None
        for line in text.splitlines():
            m = re.search(r"entry function '_Z\d+(\w+?_kernel)I(\w+)'", line)
            if m:
                args, policy = m.group(2), ""
                n = re.match(r"\d+", args)
                if n:  # a route policy's mangled name: its length, then the name
                    end = n.end() + int(n.group())
                    policy, args = args[n.end():end] + ", ", args[end:]
                chains = re.match(r"[fd]Li(\d+)E", args)  # fma_peak_kernel<T, CHAINS>
                group = re.match(r"(\d+)", args[1:])  # pdipm_kernel<P, S, G>
                if group:
                    gname = args[1 + group.end():1 + group.end() + int(group.group())]
                    warps = re.match(r"ILi(\d+)EE", args[1 + group.end() + len(gname):])
                    group = f", {gname}{f'<{warps.group(1)}>' if warps else ''}"
                name = (f"{m.group(1)}<{policy}{'f32' if args[0] == 'f' else 'f64'}"
                        f"{', ' + chains.group(1) if chains else ''}{group or ''}>")
            spill = re.search(r"(\d+) bytes spill stores", line)
            if spill and name:
                stores = spill.group(1)
            regs = re.search(r"Used (\d+) registers", line)
            if regs and name:
                out.append(f"{name} {regs.group(1)} registers, {stores} B spill stores")
                name = None
    return "; ".join(out)


def walking_draws(batch, seed, T=10):
    """The numpy draws of `make_qp_batch`: small random attitude, position,
    twist; forward command in [-0.2, 0.4] m/s; contact tables of the 5-step
    walking gait at random phase (swing stages in every env); per-env
    friction in [0.4, 1.0]. Returns (x0 (B, 12), x_ref (B, T, 12), contact
    (B, T, 2), feet (B, 2, 3), mu (B,)), float64; the draws do not depend on
    the horizon T."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((batch, 12))
    x0[:, 0:3] = rng.uniform(-0.03, 0.03, (batch, 3))
    x0[:, 3:6] = rng.uniform(-0.02, 0.02, (batch, 3)) + [0.0, 0.0, 0.55]
    x0[:, 6:9] = rng.uniform(-0.1, 0.1, (batch, 3))
    x0[:, 9:12] = rng.uniform(-0.1, 0.1, (batch, 3))
    x_ref = np.zeros((batch, T, 12))
    x_ref[:, :, 5] = 0.55
    x_ref[:, :, 9] = rng.uniform(-0.2, 0.4, (batch, 1))
    steps = (rng.integers(0, 10, (batch, 1)) + np.arange(T)) % 10
    contact = np.stack([steps < 5, steps >= 5], axis=2).astype(np.float64)
    pos = x0[:, 3:6]
    feet = np.stack([pos + [0.0, 0.1, 0.0], pos + [0.0, -0.1, 0.0]], axis=1)
    feet[:, :, 2] = 0.0
    return x0, x_ref, contact, feet, rng.uniform(0.4, 1.0, batch)


def make_qp_batch(batch, seed, dtype, device, T=10, stance=False):
    """Randomized HECTOR walking QPs (`walking_draws`, horizon T) through the
    port's `build_qp`; `stance` puts both feet in contact at every stage."""
    import torch
    from biped_pympc_tpu_torch.models import hector
    from biped_pympc_tpu_torch.models.srbd import SrbdLin
    from biped_pympc_tpu_torch.ops import qp as qps
    from biped_pympc_tpu_torch.utils.maths import rot_x, rot_y, rot_z

    x0, x_ref, contact, feet, mu = walking_draws(batch, seed, T)
    if stance:
        contact = np.ones_like(contact)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    rot = rot_z(t(x0[:, 2])) @ rot_y(t(x0[:, 1])) @ rot_x(t(x0[:, 0]))
    lin = SrbdLin(
        rot_body=rot, inertia_world=rot @ t(hector.I_BODY) @ rot.transpose(-1, -2),
        body_pos=t(x0[:, 3:6]), foot_pos=t(feet), mass=t(np.full(batch, hector.MASS)),
        residual_lin_accel=t(np.zeros((batch, 3))), residual_ang_accel=t(np.zeros((batch, 3))))
    q = t([150.0, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1])
    r = t([1e-5] * 6 + [1e-4] * 6)
    return qps.build_qp(lin, t(x0), t(x_ref), t(contact), 0.025, t(mu), q, r, x_ref.shape[1])


def refined_solves(corrector_form: str) -> int:
    """Reduced solves per Newton step that refinement passes follow: both in
    the "delta" form, one in the others (the combined solve, the summed
    direction, the affine solve; `pdipm_pallas.py:1402-1467`)."""
    return 2 if corrector_form == "delta" else 1


def needed_flops(T: int, refine_steps: int, df: bool = False, corrector_form: str = "delta") -> float:
    """The least floating-point operations of one Newton step of one env (a
    multiply-add counts 2), whichever route: every route computes the same
    direction up to rounding. Per stage, with nx = nu = 12 and 16
    inequalities: the factor as one structured elimination, with -W
    diagonal, the nu rows a selector beside -delta I and every symmetric
    product counted once (Ad M Ad^T; U = R + beta + G^T W^-1 G + e^T e /
    delta; U's Cholesky factor L and L^-1 Bd^T; the y Schur complement, its
    inverse and M_t); per reduced solve, z and nu into the u rhs and out
    again once, and one two-sweep solve on [u, y]; per refinement pass one
    more solve (z carried through it only with df, which refines the
    augmented system, and with sum_refine, whose passes solve a general rhs)
    and one refinement residual (the compensated ones ~25 flops a term),
    `refine_steps` passes after each of the form's refined solves
    (`refined_solves`); the KKT residuals, rhs, step rule and update."""
    nx, nu, nc = 12, 12, 16
    factor = (2 * nx ** 3 + nx * (nx + 1) * nx
              + nu * nc + nu * (nu + 1) * nc + 2 * nu
              + nu ** 3 // 3 + nu ** 2 * nx
              + nx * (nx + 1) * nu + 2 * nx + nx ** 3
              + nx * (nx + 1) + nx)
    core = 2 * nu ** 2 + 4 * nx * nu + 8 * nx ** 2 + 9 * nx
    z_in_out = 4 * nc * nu + 3 * nc + 8
    residual = 26250 if df else 2090
    carried = z_in_out if df or corrector_form == "sum_refine" else 0
    passes = refined_solves(corrector_form) * refine_steps
    return T * (factor + 2 * (z_in_out + core) + passes * (core + carried + residual) + 2850)


def kernel_flops(route: str, T: int, refine_steps: int, df: bool = False,
                 corrector_form: str = "delta") -> float:
    """What `route`'s kernel does now in one Newton step of one env, counted
    from its loops (leading terms), for comparison with `needed_flops`: the
    block-Thomas routes invert T pivoted n-wide blocks by Gauss-Jordan in
    full (2 n^3 + n^2 each), K1 and K2 (and their packed twins K5e) their
    foot blocks, K5c its 12-wide Ru blocks, K5d its dense 14- / 30-wide
    blocks (each Riccati route then the y-chain's folding and 12-wide
    inverses, ~17k per stage), and each reduced solve multiplies by the
    stored inverses (K5c's warp group forms the two rows of E Ru^-1 r once a
    stage, as many flops a solve as K5d-c's 14-wide rows); two solves per
    step and one more per refinement pass."""
    n = {"tridiag_aug": 42, "tridiag": 26}.get(route)
    condensed = route in ("ric", "tridiag", "ric2", "ric_dense", "ric_pack")
    if n is not None:
        factor = T * (2 * n ** 3 + n ** 2 + 7344 + (6912 if condensed else 0))
        solve = T * (2 * n ** 2 + 25 * n + 684)
    else:
        factor, solve = {"ric_aug": (22600 * T, 3500 * T), "ric": (15200 * T, 2700 * T),
                         "ric2": (28800 * T, 2900 * T), "ric_dense": (30000 * T, 2900 * T),
                         "ric_aug_dense": (72300 * T, 4500 * T),
                         "ric_pack": (15200 * T, 2700 * T),
                         "ric_aug_pack": (22600 * T, 3500 * T)}[route]
    residual = (26250 if df else 2090) * T
    extra = 1760 * T if condensed else 0  # r1_hat and the dz, ds recovery
    passes = refined_solves(corrector_form) * refine_steps
    return factor + (2 + passes) * solve + passes * residual + 2850 * T + extra


def step_refines(opts) -> list:
    """The refinement passes of each Newton step of one launch of `opts`:
    0 for the first `refine_skip_iters` (`pdipm.refine_schedule`)."""
    from biped_pympc_tpu_torch.ops import pdipm

    skip = pdipm.refine_schedule(opts)
    return [0 if it < skip else opts.refine_steps for it in range(opts.iterations)]


def bound(qp, opts) -> tuple:
    """(ms, "operations" or "bytes"): the least time an H100 could take for
    `opts.iterations` Newton steps of every env of `qp`: the larger of the
    operations (`needed_flops` of each step, at its refinement passes and in
    its corrector form) over the peak rate of the dtype and the bytes over
    the memory rate, each input (the QP) read once and each output (x, s, z,
    y, the residuals) written once."""
    T, nb, size = qp.horizon, qp.f.shape[0], qp.f.element_size()
    flops = nb * sum(needed_flops(T, r, opts.refine_residual == "df", opts.corrector_form)
                     for r in step_refines(opts))
    nz, ni, ne = qp.nz, qp.n_ineq, qp.n_eq
    values = 2 * nz + 288 + ne + 192 + ni + (nz + 2 * ni + ne + 4)
    t_ops = flops / PEAK_FLOPS[str(qp.f.dtype).removeprefix("torch.")]
    t_bytes = nb * values * size / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def route_counts(**counts) -> dict:
    """Launch counts of every route: the given ones, 0 for the rest."""
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    return {route: counts.get(route, 0) for route in pdipm_cuda.SOURCES}


# A captured step (`MPCController`'s run_mpc at its first call, a rollout's
# cycle) runs once in its warm-up before its capture (`utils/cuda_graph.py`),
# and the kernels count that run (`pdipm_cuda.runs`): a walk from a new
# controller runs each kernel of its solve once more than it calls run_mpc.
# The host issues each launch twice, in the warm-up and into the capture,
# and a replay issues none (`pdipm_cuda.launches`).
WARM_UP = 1
ISSUED_CAPTURED = 2


def hector_obs(batch):
    obs = np.zeros((batch, 43), np.float32)
    obs[:, 2] = 0.55
    obs[:, 3] = 1.0
    obs[:, 13:18] = Q0
    obs[:, 18:23] = Q0
    return obs


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def quantiles(v) -> str:
    q = np.quantile(v, [0.5, 0.9, 0.99, 0.999]) if len(v) else [np.nan] * 4
    return (f"max {np.max(v) if len(v) else np.nan:.3e} p50 {q[0]:.3e} p90 {q[1]:.3e} "
            f"p99 {q[2]:.3e} p99.9 {q[3]:.3e}")


def qp_map(qp, fn):
    """`qp` with `fn` applied to every tensor, those of its dynamics too."""
    def apply(obj):
        return dataclasses.replace(obj, **{
            fld.name: apply(v) if dataclasses.is_dataclass(v) else fn(v)
            for fld in dataclasses.fields(obj) for v in (getattr(obj, fld.name),)})
    return apply(qp)


def cancellation_case(qp, seed):
    """Refinement-residual inputs on `qp`'s envs at late-iteration scales
    (tests/test_pdipm.py::test_df_residual_accuracy): W over 1e-6..1e6,
    directions ~30, and r = K d plus a true residual of 1e-4, so r - K d
    cancels nearly every digit. Returns (w, (dx, dz, dy), (r1, rz, r4), the
    residual computed in float64 from the inputs as rounded)."""
    import torch
    from biped_pympc_tpu_torch.ops import pdipm
    from biped_pympc_tpu_torch.ops import qp as qps

    rng = np.random.default_rng(seed)
    nb, dtype, dev = qp.f.shape[0], qp.f.dtype, qp.f.device
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    w = t(10.0 ** rng.uniform(-6, 6, (nb, qp.n_ineq)))
    dirs = [t(rng.standard_normal((nb, n)) * 30) for n in (qp.nz, qp.n_ineq, qp.n_eq)]
    q64 = qp_map(qp, lambda v: v.double())
    zeros = [torch.zeros_like(v, dtype=torch.float64) for v in dirs]
    neg_kd = pdipm.refine_residual_aug(q64, qps.h_diag(q64), w.double(), pdipm.PdipmOptions(),
                                       *(v.double() for v in dirs), *zeros)
    rhs = [(-m + torch.tensor(rng.standard_normal(tuple(m.shape)) * 1e-4, dtype=torch.float64,
                              device=dev)).to(dtype) for m in neg_kd]
    exact = [r.double() + m for r, m in zip(rhs, neg_kd)]
    return w, dirs, rhs, exact


@contextlib.contextmanager
def no_host_sync():
    """Inside, any torch operation that waits for the device raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def digest(tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def digest_routes(opts) -> dict:
    """{tag: options} of every route whose bits `BEFORE_WARP_DIGESTS` records: K1
    (`opts`), K2, K5a-K5d and both packings of K5e."""
    rep = dataclasses.replace
    ric = rep(opts, backend="ric")
    return {"K1": opts, "K2": ric,
            "K5a": rep(opts, backend="tridiag", foot_split=False),
            "K5b": rep(opts, backend="tridiag_aug", foot_split=False),
            "K5c": rep(opts, backend="ric2", foot_split=False),
            "K5d-c": rep(opts, backend="ric", foot_split=False),
            "K5d-a": rep(opts, backend="ric_aug", foot_split=False),
            "K5e-c pair": rep(ric, foot_pack=True), "K5e-c apply": rep(ric, foot_pack="apply"),
            "K5e-a pair": rep(opts, foot_pack=True), "K5e-a apply": rep(opts, foot_pack="apply")}


def route_digests(qp32, qp64, opts) -> dict:
    """{"<tag> f32|f64": digest} of every route of `digest_routes` on the two
    batches, K1 and K2 in the block group."""
    from biped_pympc_tpu_torch.bench import pdipm_geometry as pg
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    return {f"{tag} {dt}": digest(results(pg.solve_in(qp, o, pdipm_cuda.BLOCK)))
            for tag, o in digest_routes(opts).items()
            for dt, qp in (("f32", qp32), ("f64", qp64))}


def results(res) -> list:
    """x, s, z, y and the residuals of a PdipmResult."""
    return [res.x, res.s, res.z, res.y, res.residuals]


def bit_diff(a, b):
    """(largest |difference| over x, s, z, y and the residuals, envs that
    differ in any bit) of two PdipmResults; NaN in both counts as equal."""
    import torch

    worst, differ = 0.0, None
    for name in ("x", "s", "z", "y", "residuals"):
        u, v = getattr(a, name), getattr(b, name)
        ints = torch.int32 if u.dtype == torch.float32 else torch.int64
        env = (u.view(ints) != v.view(ints)).any(1)
        differ = env if differ is None else differ | env
        d = (u.double() - v.double()).abs()
        worst = max(worst, float(torch.where(torch.isnan(d), 0.0, d).max()))
    return worst, int(differ.sum())


def walk(ctrl, obs, ticks, limit, on_solve=None):
    """Drive `ctrl` for `ticks` 1 kHz ticks from `obs`, solving every
    `decimation` ticks. Returns (run_mpc count, first-solve wrench, whether
    every tau was finite and within `limit`)."""
    import torch

    n_mpc = 0
    first_wrench = None
    tau_ok = True
    for step in range(ticks):
        ctrl.update_state(obs)
        if step % ctrl.core.mpc_cfg.decimation == 0:
            ctrl.run_mpc()
            n_mpc += 1
            if first_wrench is None:
                first_wrench = ctrl.ground_reaction_wrench.clone()
            if on_solve is not None:
                on_solve()
        ctrl.run_lowlevel()
        tau = ctrl.get_action()
        tau_ok = tau_ok and bool((torch.isfinite(tau).all() & (tau.abs() <= limit + 1e-5).all()).item())
    return n_mpc, first_wrench, tau_ok


def traced_walk(ctrl, obs, ticks, limit, on_solve=None):
    """`walk` under torch.profiler (`device_trace`): its returns and the
    trace, whose "k1" counts the PDIPM kernels the device ran in the walk.
    Fails where the trace holds no device event."""
    out = []
    trace = device_trace(lambda: out.append(walk(ctrl, obs, ticks, limit, on_solve)), 1)
    check(trace is not None, "the profiler saw no device event in a walk")
    return (*out[0], trace)


def sass_report(roofline_lib: str) -> str:
    """FFMA / DFMA, LDS and STS in the SASS of each roofline kernel, read
    with cuobjdump: the peak kernel's loop must be multiply-adds (CHAINS per
    step, the loop unrolled 16 times), the stream kernel's must load x, a
    and b from shared memory and store x back on every pass (4 entries a
    thread, unrolled). Raises if a kernel falls short."""
    import os

    from biped_pympc_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", roofline_lib], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out = []
    for chunk in text.split("Function : ")[1:]:
        m = re.match(r"_Z\d+(\w+?_kernel)I([fd])(?:Li(\d+)E)?", chunk.split()[0])
        if not m:
            continue
        kernel, fma_op = m.group(1), "FFMA" if m.group(2) == "f" else "DFMA"
        n = {op: len(re.findall(rf"\b{op}\b", chunk)) for op in (fma_op, "LDS", "STS")}
        name = (f"{kernel}<{'f32' if m.group(2) == 'f' else 'f64'}"
                f"{', ' + m.group(3) if m.group(3) else ''}>")
        if kernel == "fma_peak_kernel":
            check(n[fma_op] >= 16 * int(m.group(3)), f"{name}: {n[fma_op]} {fma_op} in its SASS")
        else:
            check(n["LDS"] >= 12 and n["STS"] >= 4 and n[fma_op] >= 4,
                  f"{name}: {n} in its SASS, not a pass through shared memory")
        out.append(f"{name} {n[fma_op]} {fma_op}, {n['LDS']} LDS, {n['STS']} STS")
    check(len(out) == 10, f"cuobjdump found {len(out)} of the 10 roofline kernels")
    return "; ".join(out)


def geometry_phase(label: str, qp32, qp64, opts, explore: bool = False) -> dict:
    """The routes with a warp group (K1, K2, K5b, K5d-a, K5a, K5e-a, K5c, K5d-c) in their
    launch geometries: the largest horizon each route and dtype runs in its warp
    group and in the block group (the libraries' `lean_bytes` /
    `smem_bytes` within a block's shared memory); the geometry
    `pdipm_cuda.geometry` picks and the resident envs per SM of it and of
    the block group (the WORK_ROUTES also with their stored inverses in the
    workspace); the clock64() breakdown of a Newton step in both
    (`pdipm_geometry`); the solve times of the block group (the build before
    the warp groups) and the warp group in turns (block, new, new, block),
    f32 and f64, at b4096 and, but for the wide-block routes (SLOW_ROUTES),
    at the hybrid's re-solve batch, each required faster in every turn; and the
    WORK_ROUTES' warp groups with the stored inverses in shared memory and in
    the workspace in turns, the one `pdipm_cuda` launches required no slower. With
    `explore`, also a sweep of batch sizes (K1, K2). Returns
    {"geo", "occ", "turns", "breakdown", "workspace"}."""
    import torch
    from biped_pympc_tpu_torch.bench import pdipm_geometry as pg
    from biped_pympc_tpu_torch.ops import pdipm_cuda
    from biped_pympc_tpu_torch.ops import qp as qps

    dts = {"f32": torch.float32, "f64": torch.float64}
    routes = pdipm_cuda.LEAN_ROUTES
    fits = {}
    for route in routes:
        lib = pdipm_cuda._library(route)
        for dt, dtype in dts.items():
            size = torch.empty((), dtype=dtype).element_size()
            for tag, kind in (("warp group", "lean"), ("block group", "smem")):
                fits[f"{route} {dt} {tag}"] = max(
                    T for T in range(1, 151)
                    if getattr(lib, f"pdipm_{route}_{kind}_bytes")(T, size)
                    <= pdipm_cuda.MAX_SMEM_PER_BLOCK)
    qps_ = {"f32": qp32, "f64": qp64}
    T = qp32.horizon
    geo = {r: pdipm_cuda.geometry(r) for r in routes}
    env_b = {(r, dt): getattr(pdipm_cuda._library(r), f"pdipm_{r}_lean_bytes")(
        T, torch.empty((), dtype=dts[dt]).element_size())
        for r in routes for dt in dts}
    work_b = {(r, dt): getattr(pdipm_cuda._library(r), f"pdipm_{r}_work_bytes")(
        T, torch.empty((), dtype=dts[dt]).element_size(), 0)
        for r in pdipm_cuda.WORK_ROUTES for dt in dts}
    occ = {(r, dt, tag): pg.envs_per_sm(r, T, dts[dt], g)
           for r in routes for dt in dts
           for tag, g in (("block", pdipm_cuda.BLOCK), ("new", geo[r]))}
    occ.update({(r, dt, "workspace"): pg.envs_per_sm(r, T, dts[dt], geo[r], True)
                for r in pdipm_cuda.WORK_ROUTES for dt in dts})
    print(f"[geometry] {label}: largest horizon per route and dtype: {fits}; picked: "
          + ", ".join(f"{r} {g.threads_per_env} threads x {g.envs_per_block} env per block"
                      for r, g in geo.items())
          + f"; lean bytes per env at h{T}: "
          + ", ".join(f"{r} {dt} {n}" for (r, dt), n in env_b.items())
          + f"; workspace bytes per env at h{T} (0: inverses in shared memory): "
          + ", ".join(f"{r} {dt} {n}" for (r, dt), n in work_b.items())
          + "; resident envs per SM (occupancy calculator): "
          + ", ".join(f"{r} {dt} {tag} {n}" for (r, dt, tag), n in occ.items()))
    for r in routes:
        for dt in dts:
            check(occ[r, dt, "new"] > occ[r, dt, "block"],
                  f"{r} {dt} holds {occ[r, dt, 'new']} envs per SM in its warp group, "
                  f"{occ[r, dt, 'block']} in the block group")
    base = {r: pg.route_opts(r, opts) for r in routes}
    out = {"geo": geo, "occ": occ, "turns": {}, "breakdown": {}, "workspace": {}}
    for r, o in base.items():
        for dt in dts:
            for tag, g in (("block", pdipm_cuda.BLOCK), ("new", geo[r])):
                res = pg.breakdown(qps_[dt], o, g)
                out["breakdown"][r, dt, tag] = res
                print(pg.breakdown_line(f"[breakdown] {label}: {r} {dt} b{B} {tag} "
                                        f"({g.threads_per_env} x {g.envs_per_block})", res))
    for r, o in base.items():
        calls = 1 if r in SLOW_ROUTES else 10
        for dt in dts:
            qp = qps_[dt]
            sub = qps.take(qp, torch.arange(RESOLVE_BATCH, device=qp.f.device))
            for nb, q in ((B, qp), (RESOLVE_BATCH, sub)):
                if nb == RESOLVE_BATCH and r in SLOW_ROUTES:
                    continue
                out["turns"][r, dt, nb] = pg.turns(q, o, pdipm_cuda.BLOCK, geo[r], calls)
    print(f"[geometry times] {label}: block group / warp group / warp group / block "
          f"group, ms: " + "; ".join(f"{r} {dt} b{nb} " + " / ".join(f"{v:.3f}" for v in t)
                                     for (r, dt, nb), t in out["turns"].items()))
    for (r, dt, nb), t in out["turns"].items():
        check(max(t[1], t[2]) < min(t[0], t[3]),
              f"{r} {dt} b{nb}: the warp group is not faster than the block group in every "
              f"turn: {t}")
    for r in pdipm_cuda.WORK_ROUTES:
        for dt in dts:
            out["workspace"][r, dt] = pg.workspace_turns(qps_[dt], base[r], 1)
    print(f"[workspace] {label}: warp group at h{T}, stored inverses in shared memory / "
          f"workspace / workspace / shared memory, ms: "
          + "; ".join(f"{r} {dt} " + " / ".join(f"{v:.3f}" for v in t)
                      for (r, dt), t in out["workspace"].items())
          + " (launched: " + ", ".join(f"{r} {dt} {'workspace' if n else 'shared memory'}"
                                       for (r, dt), n in work_b.items()) + ")")
    for (r, dt), t in out["workspace"].items():
        used, other = (t[1:3], t[0::3]) if work_b[r, dt] else (t[0::3], t[1:3])
        check(max(used) <= min(other) * 1.05,
              f"{r} {dt}: the layout pdipm_cuda launches is slower than the other: {t}")
    if explore:
        for r in pdipm_cuda.LEAN_ROUTES[:2]:
            qp = qps_["f32"]
            line = []
            for nb in (256, 512, 1024, 2048):
                q = qps.take(qp, torch.arange(nb, device=qp.f.device))
                tt = pg.turns(q, base[r], pdipm_cuda.BLOCK, geo[r])
                line.append(f"b{nb} block {tt[0]:.3f} / warp {tt[1]:.3f} ms")
            print(f"[geometry explore] {label}: {r} f32: " + "; ".join(line)
                  + f"; SASS instructions {pg.sass_sizes(pdipm_cuda.library_path(r))}")
    return out


# The bench twins' kernels against their plain versions (K6, K7, K8).
# K6 in float32 against the float64 plain version: where that is below
# K6_F32_FINITE in magnitude the float32 kernel must be finite and within
# K6_F32_RTOL relative (100,000 roundings of up to 6e-8 each: the chains
# grow up to e^100), above K6_F32_INF it must be inf (float32's largest is
# 3.4e38); between the two nothing is compared. Float64 within K6_F64_RTOL:
# the plain version rounds product and sum apart, 1e5 steps of 1.1e-16.
K6_F32_FINITE, K6_F32_INF, K6_F32_RTOL, K6_F64_RTOL = 3.0e38, 3.5e38, 1e-2, 1e-9
K7_F32_RTOL = 1e-5
# K8: absolute bounds against the plain version in the same dtype (the
# kernel fuses x y + c; the state contracts to ~1e-3 after 1e3 ops), at
# B = 4096 for n_ops 1e1..1e4, and 1e5 ops at B = 32768 held on a slice of
# the first 256 envs.
K8_ATOL = {"float32": 1e-6, "float64": 1e-12}
K8_OPS, K8_BATCH = (10, 100, 1000, 10000), 4096
K8_LONG = (100_000, 32768, 256)
# The 1e3-op tape also cut into kernels of 100 ops (float32), held bit for
# bit against its one kernel: its output still depends on each segment's
# input (a dropped segment moves it by ~1e-3), which at 1e4 ops and more it
# no longer does to the last bit.
K8_SEGMENTED = (1000, 100)


def timed_once(fn):
    """(fn(), its device ms) of one call, CUDA events around it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def k8_phase(label: str, k8_libs: dict, dev) -> dict:
    """K8's phase of `bench_twins`: the kernel generated from the tape at
    each length against the plain version and, bit for bit, the
    interpreter, timed in turns with it; the 1e3-op tape cut into segments
    against its one kernel; the builds and the critical-path bound. Returns
    {"err": {dtype name: [max |d| per length]}, "ms", "plain_ms", "flops",
    "tape_bytes" (f32, K8_OPS[-1] ops, b K8_BATCH), "turns"}."""
    import torch
    from biped_pympc_tpu_torch.bench import bench_synthetic as bs
    from biped_pympc_tpu_torch.bench import tape_codegen as tc
    from biped_pympc_tpu_torch.ops import cuda_build

    # K8: the kernel generated from the tape at each length, float32 and
    # float64, then 1e5 ops at b32768, against the plain version; the
    # interpreter it replaced (the same roundings written out) in turns
    # with it (generated, interpreter, interpreter, generated), and bit for
    # bit; each length's nvcc seconds and ptxas registers; the critical-path
    # bound.
    rng = np.random.default_rng(1)
    state = rng.uniform(0.5, 1.5, (bs.N_STATE, K8_LONG[1])).astype(np.float32)
    k8 = {"float32": [], "float64": []}
    k8_turns, k8_same = {}, {}
    for n_ops in K8_OPS:
        tape = bs.make_tape(n_ops)
        for dtype in (torch.float32, torch.float64):
            s = torch.from_numpy(state[:, :K8_BATCH]).to(dev, dtype)
            got = bs.run_tape(tape, s)
            want, plain_ms = timed_once(lambda: bs.apply_tape_rows(tape, s))
            k8[str(dtype).removeprefix("torch.")].append(float((got - want).abs().max()))
            enc = bs.encode_tape(tape, dtype, dev)
            fns = {"gen": lambda: bs.run_tape(enc, s),
                   "interp": lambda: bs.run_tape_interpreted(enc, s)}
            turns = [cuda_ms(fns[k], 10) for k in ("gen", "interp", "interp", "gen")]
            k8_turns[n_ops, dtype, K8_BATCH] = turns
            k8_same[n_ops, dtype, K8_BATCH] = bool(torch.equal(got, fns["interp"]()))
            if n_ops == K8_OPS[-1] and dtype == torch.float32:
                k8_ms, k8_plain_ms = (turns[0] + turns[3]) / 2, plain_ms
                k8_flops, k8_tape_bytes = bs.tape_flops(tape), n_ops * (16 + 4)
    n_long, b_long, b_slice = K8_LONG
    tape = bs.make_tape(n_long)
    s = torch.from_numpy(state).to(dev)
    got = bs.run_tape(tape, s)
    want = bs.apply_tape_rows(tape, s[:, :b_slice])
    long_err = float((got[:, :b_slice] - want).abs().max())
    long_enc = bs.encode_tape(tape, torch.float32, dev)
    fns = {"gen": lambda: bs.run_tape(long_enc, s),
           "interp": lambda: bs.run_tape_interpreted(long_enc, s)}
    k8_turns[n_long, torch.float32, b_long] = [cuda_ms(fns[k], 3)
                                               for k in ("gen", "interp", "interp", "gen")]
    k8_same[n_long, torch.float32, b_long] = bool(torch.equal(got, fns["interp"]()))
    print(f"[K8 vs plain] the generated kernels, b{K8_BATCH}, n_ops {list(K8_OPS)}: max |d| f32 "
          + ", ".join(f"{e:.3e}" for e in k8["float32"]) + f" (bound {K8_ATOL['float32']:g}), f64 "
          + ", ".join(f"{e:.3e}" for e in k8["float64"]) + f" (bound {K8_ATOL['float64']:g}); "
          f"{n_long} ops at b{b_long}, f32, first {b_slice} envs {long_err:.3e}; all finite "
          f"{bool(torch.isfinite(got).all())}")
    for dt, errs in k8.items():
        check(max(errs) <= K8_ATOL[dt], f"K8 {dt} differs from the plain version")
    check(long_err <= K8_ATOL["float32"] and bool(torch.isfinite(got).all()),
          "K8 at 1e5 ops differs from the plain version")
    print(f"[K8 turns] {label}: generated / interpreter / interpreter / generated, ms "
          f"(the interpreter's time over the generated kernel's; whether they give the same "
          f"bits): "
          + "; ".join(f"{n} ops {str(dt)[6:]} b{nb} " + " / ".join(f"{v:.4f}" for v in t)
                      + f" ({(t[1] + t[2]) / (t[0] + t[3]):.1f}x; same bits "
                        f"{k8_same[n, dt, nb]})"
                      for (n, dt, nb), t in k8_turns.items()))
    check(all(k8_same.values()), "the generated kernel and the interpreter give other bits")

    # The 1e3-op tape in kernels of 100 ops: the segments' chaining.
    n_seg, per = K8_SEGMENTED
    tape = bs.make_tape(n_seg)
    s = torch.from_numpy(state[:, :K8_BATCH]).to(dev)
    cut = tc.Kernel(torch.float32, [tc.load(p) for p in k8_libs["segmented"]])
    seen = []
    with torch.cuda.device(dev):
        got = cut(s, stream=torch.cuda.current_stream(dev).cuda_stream,
                  on_launch=lambda: seen.append(1))
    whole, plain = bs.run_tape(tape, s), bs.apply_tape_rows(tape, s)
    seg_err = float((got - plain).abs().max())
    drop = n_seg - 2 * per  # the next-to-last segment's first op
    moved = float((bs.apply_tape_rows(tape[:drop] + tape[drop + per:], s) - plain).abs().max())
    print(f"[K8 segments] {n_seg} ops f32 b{K8_BATCH} in {len(seen)} kernels of {per} ops: the "
          f"bits of its one kernel {bool(torch.equal(got, whole))}, max |d| vs plain "
          f"{seg_err:.3e} (bound {K8_ATOL['float32']:g}); the tape without its next-to-last "
          f"segment parts from it by {moved:.3e}")
    check(len(seen) == len(k8_libs["segmented"]) == -(-n_seg // per),
          "the segmented tape did not launch each kernel once")
    check(torch.equal(got, whole) and seg_err <= K8_ATOL["float32"],
          "the segmented tape differs from its one kernel or the plain version")
    check(moved > K8_ATOL["float32"], "the segmented tape's output does not depend on a segment")
    build = []
    for (n, dt), paths in ((k, v) for k, v in k8_libs.items() if k != "segmented"):
        logs = [cuda_build.build_log(p) or "" for p in paths]
        regs = max(int(m) for text in logs for m in re.findall(r"Used (\d+) registers", text))
        spill = max(int(m) for text in logs for m in re.findall(r"(\d+) bytes spill stores", text))
        secs = [cuda_build.build_seconds.get(p) for p in paths]
        build.append(f"{n} ops {str(dt)[6:]}: {len(paths)} kernel(s), nvcc "
                     + ("built before this run" if None in secs else
                        "+".join(f"{v:.1f}" for v in secs) + " s")
                     + f", {regs} registers, {spill} B spill stores")
    print("[K8 build] each length's generated kernels (one nvcc each, all built with the other "
          "libraries at once): " + "; ".join(build))
    clock = sm_clock_mhz()
    gen_ms = {n: (t[0] + t[3]) / 2 for (n, dt, nb), t in k8_turns.items()
              if dt == torch.float32 and nb == K8_BATCH}
    line = []
    for n in (*K8_OPS, n_long):
        c = tc.critical_path(bs.make_tape(n))
        line.append(f"{n} ops depth {c['depth']}, {c['cycles']:.0f} cycles, "
                    f"{c['cycles'] / clock / 1e3:.4f} ms"
                    + (f" (kernel {gen_ms[n]:.4f} ms)" if n in gen_ms else ""))
    print(f"[K8 bound] critical path of each tape (dependency depth, cycles under "
          f"{tc.LATENCY[torch.float32]}, ms at the largest SM clock {clock:g} MHz) against the "
          f"generated kernel's f32 time at b{K8_BATCH}: " + "; ".join(line))
    return {"err": k8, "ms": k8_ms, "plain_ms": k8_plain_ms, "flops": k8_flops,
            "tape_bytes": k8_tape_bytes, "turns": k8_turns}


def bench_twins(label: str, k8_libs: dict) -> list:
    """The phases of the bench twins: K6 and K7 against their plain versions
    at the script's shapes and step counts, K8 (the kernels generated from
    the tapes, `k8_libs` their libraries by (n_ops, dtype)) over the tape
    lengths, then the two bench paths (`ab_roofline.main` at b4096,
    `bench_synthetic.main`) with every count at 0 before them; returns the
    three kernels' entries of the kernels line."""
    import torch
    from biped_pympc_tpu_torch.bench import ab_roofline as ar
    from biped_pympc_tpu_torch.bench import bench_synthetic as bs
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    dev = torch.device("cuda")
    peak_in, stream_in = ar.roofline_inputs()
    knobs = [(c, t) for c in ar.CHAINS for t in ar.THREADS]

    # K6: every nacc, every knob of the sweep, float32 and float64, against
    # the float64 plain version of all naccs at once (one chain per entry).
    a_cat = torch.cat([torch.from_numpy(a).repeat(nacc, 1) for nacc, (a, _) in peak_in.items()])
    x_cat = torch.cat([torch.from_numpy(x) for _, x in peak_in.values()])
    c64 = torch.tensor(ar.FMA_C, dtype=torch.float64, device=dev)
    plain64 = ar.fma_steps(x_cat.to(dev, torch.float64), a_cat.to(dev, torch.float64), c64,
                           ar.PEAK_ITERS)
    worst = {"float32": 0.0, "float64": 0.0}
    compared, infs, row = 0, 0, 0
    for nacc, (a, x) in peak_in.items():
        want = plain64[row:row + 8 * nacc]
        row += 8 * nacc
        small, big = want.abs() < K6_F32_FINITE, want.abs() > K6_F32_INF
        for dtype in (torch.float32, torch.float64):
            a_t, x_t = (torch.from_numpy(v).to(dev, dtype) for v in (a, x))
            for chains, threads in knobs:
                got = ar.fma_peak(a_t, x_t, ar.PEAK_ITERS, chains, threads).double()
                rel = ((got - want).abs() / want.abs())
                tag = f"K6 nacc {nacc} {dtype} chains {chains} threads {threads}"
                if dtype == torch.float32:
                    check(bool(torch.isfinite(got[small]).all()), f"{tag}: non-finite below 3e38")
                    check(bool(torch.isinf(got[big]).all()), f"{tag}: finite above 3.5e38")
                    worst["float32"] = max(worst["float32"], float(rel[small].max()))
                    compared, infs = compared + int(small.sum()), infs + int(big.sum())
                else:
                    worst["float64"] = max(worst["float64"], float(rel.max()))
    print(f"[K6 vs plain f64] {ar.PEAK_ITERS} steps, nacc {list(peak_in)}, chains x threads "
          f"{knobs}: f32 max rel {worst['float32']:.3e} over {compared} finite entries (bound "
          f"{K6_F32_RTOL:g}), {infs} inf where the f64 value passes {K6_F32_INF:g}; f64 max rel "
          f"{worst['float64']:.3e} (bound {K6_F64_RTOL:g})")
    check(worst["float32"] <= K6_F32_RTOL, "K6 f32 differs from the plain version")
    check(worst["float64"] <= K6_F64_RTOL, "K6 f64 differs from the plain version")
    a128, x128 = (torch.from_numpy(v).to(dev) for v in peak_in[128])
    k6_ms = cuda_ms(lambda: ar.fma_peak(a128, x128, ar.PEAK_ITERS), 10)
    plain32, k6_plain_ms = timed_once(lambda: ar.fma_peak_plain(a128, x128, ar.PEAK_ITERS))
    got32 = ar.fma_peak(a128, x128, ar.PEAK_ITERS)
    both = torch.isfinite(got32) & torch.isfinite(plain32)
    k6_err = float((got32 - plain32)[both].abs().max())
    print(f"[K6 vs plain f32] nacc 128: max |d| {k6_err:.3e} over entries up to "
          f"{float(plain32[both].abs().max()):.3e}, max rel "
          f"{float(((got32 - plain32) / plain32)[both].abs().max()):.3e}, entries differing "
          f"{int((got32 != plain32)[both].sum())} of {int(both.sum())} finite "
          f"(the plain float64 detour rounds twice on a float32 midpoint)")
    check(bool((torch.isinf(got32) == torch.isinf(plain32)).all()), "K6 f32 infinities differ")

    # K7: the (256, 512) float32 array, 20,000 passes.
    a2, b2, x2 = (torch.from_numpy(v).to(dev) for v in stream_in)
    got = ar.stream(a2, b2, x2, ar.STREAM_ITERS)
    want, k7_plain_ms = timed_once(lambda: ar.stream_plain(a2, b2, x2, ar.STREAM_ITERS))
    k7_rel = float(((got - want).abs() / want.abs()).max())
    k7_err = float((got - want).abs().max())
    k7_ms = cuda_ms(lambda: ar.stream(a2, b2, x2, ar.STREAM_ITERS), 10)
    print(f"[K7 vs plain f32] {tuple(x2.shape)}, {ar.STREAM_ITERS} passes: max rel {k7_rel:.3e} "
          f"(bound {K7_F32_RTOL:g}), max abs {k7_err:.3e}")
    check(k7_rel <= K7_F32_RTOL, "K7 differs from the plain version")

    k8 = k8_phase(label, k8_libs, dev)

    # The two bench paths, every count at 0 just before them.
    for counts in (ar.launches, bs.launches):
        for key in counts:
            counts[key] = 0
    pdipm_cuda.reset_counts()
    t0 = time.perf_counter()
    roof = ar.main(["--reps", "2"])
    roof_s = time.perf_counter() - t0
    bs.main(["--reps", "2"])
    path_counts = {**ar.launches, **bs.launches}
    pdipm_counts = {k: v for k, v in pdipm_cuda.launches.items() if v}
    print(f"[bench paths] ab_roofline.main b4096 ({roof_s:.1f} s) and bench_synthetic.main: "
          f"kernel launches {path_counts}, PDIPM {pdipm_counts}")
    check(all(v > 0 for v in path_counts.values()), "a bench path did not launch its kernel")
    check(set(pdipm_counts) == {pdipm_cuda.route(o) for o in ar.VARIANTS.values()},
          "ab_roofline.main did not run every route through its kernel")
    for dtype, ceil in roof["ceil"].items():
        peak = PEAK_FLOPS[str(dtype).removeprefix("torch.")]
        print(f"[roofline] {label}: {dtype} FMA peak {ceil['fma_peak'] / 1e12:.3f} TFLOP/s at "
              f"{ceil['best']} ({ceil['fma_peak'] / peak:.1%} of the published {peak / 1e12:g}), "
              f"shared-memory stream {ceil['stream'] / 1e12:.3f} TFLOP/s")
    for rec in roof["variants"]:
        print(f"[roofline route] {label}: {rec['variant']} ({rec['route']}): "
              f"{rec['ms_per_20iter_b4096']:.3f} ms per 20-step b{rec['batch']} solve, "
              f"{rec['sustained_tflops']:.4f} TFLOP/s of the flop model, "
              f"{rec['util_vs_fma_peak']:.3%} of the measured f32 FMA peak, "
              f"{rec['util_vs_stream']:.3%} of the stream ceiling")

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
        return {"bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    n6, n7 = x128.numel(), x2.numel()
    print(f"[times] {label}: K6 f32 nacc 128 (1 chain per thread, 128 threads) {k6_ms:.3f} ms vs "
          f"plain {k6_plain_ms:.3f} ms; K7 f32 {k7_ms:.3f} ms vs plain {k7_plain_ms:.3f} ms; K8 "
          f"f32 {K8_OPS[-1]} ops b{K8_BATCH} {k8['ms']:.4f} ms (generated; the interpreter "
          f"{sum(k8['turns'][K8_OPS[-1], torch.float32, K8_BATCH][1:3]) / 2:.4f} ms) vs plain "
          f"{k8['plain_ms']:.3f} ms")

    # K7's own ceiling, the shared-memory pipe it measures: 3 loads and 1
    # store of 4 B an entry and pass, at 128 B a cycle an SM, on as many SMs
    # as its STREAM_TILE-entry blocks fill.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pipe = 128 * sms * sm_clock_mhz() * 1e6
    k7_bytes = 16 * n7 * ar.STREAM_ITERS
    pipe_ms = k7_bytes / pipe * 1e3
    blocks = -(-n7 // 1024)
    pipe_blocks_ms = pipe_ms * sms / min(blocks, sms)
    print(f"[K7 pipe] {label}: {n7} entries x {ar.STREAM_ITERS} passes x 16 B = "
          f"{k7_bytes / 1e9:.1f} GB through shared memory; the pipe 128 B a cycle an SM x {sms} "
          f"SMs at the largest SM clock = {pipe / 1e12:.1f} TB/s; bound {pipe_ms:.3f} ms, "
          f"{pipe_blocks_ms:.3f} ms on the {min(blocks, sms)} SMs its {blocks} blocks fill; K7 "
          f"{k7_ms:.3f} ms reaches {pipe_blocks_ms / k7_ms:.1%} of it")

    def entry(name, source, replaces, launches_, err, ms, plain_ms, bound_):
        return {"name": name, "route": "cuda", "source": f"biped_pympc_tpu_torch/{source}",
                "replaces": replaces, "launches": launches_, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, **bound_, "library_ms": None}

    return [
        entry("roofline_fma_peak", "csrc/roofline.cu", "bench/ab_roofline.py:77",
              path_counts["fma_peak"], k6_err, k6_ms, k6_plain_ms,
              bound(2.0 * n6 * ar.PEAK_ITERS, (1024 + 2 * n6) * 4)),
        entry("roofline_stream", "csrc/roofline.cu", "bench/ab_roofline.py:107",
              path_counts["stream"], k7_err, k7_ms, k7_plain_ms,
              bound(2.0 * n7 * ar.STREAM_ITERS, 4 * n7 * 4)),
        entry("synthetic_tape", "bench/tape_codegen.py", "bench/bench_synthetic.py:154",
              path_counts["tape"],
              k8["err"]["float32"][-1], k8["ms"], k8["plain_ms"],
              bound(k8["flops"] * K8_BATCH, 2 * bs.N_STATE * K8_BATCH * 4 + k8["tape_bytes"])),
    ]


# The closed loop's phases (`closed_loop_phases`): HECTOR, walking gait, b4096,
# f32, solver "pallas_ric_aug" (K1). The captured rollout replays
# ROLLOUT_SECONDS of 1 kHz ticks (int(seconds / dt) // 10 = 120 cycles) after
# EAGER_CYCLES eager cycles it must reproduce bit for bit; the RL population
# is RL_DIRS antithetic directions of RL_ENVS_PER envs, RL_STEPS steps, the
# first RL_EQUAL_STEPS held bit for bit against the eager env; `simulate`
# runs CLOSED_LOOP_SECONDS of its host loop; the dense route is held on
# DENSE_ENVS envs at f64 against its plain version on the CPU.
ROLLOUT_SECONDS = 1.205
EAGER_CYCLES = 3
PROFILED_CYCLES = 5
RL_DIRS, RL_ENVS_PER, RL_STEPS, RL_EQUAL_STEPS = 64, 32, 5, 2
CLOSED_LOOP_SECONDS = 0.1
DENSE_ENVS = 256
# JAX's walk criteria (tests/test_tpu_rollout.py:112-126): every env.
WALK = {"roll_pitch": 0.1, "height_dev": 0.05, "vx_late_dev": 0.12, "distance": 0.1}
# `simulate`'s first cycle (x after 10 ticks, literal RK4 plant in float32,
# solver "tridiag_aug" on K5b) against the eager rollout's (closed-form plant,
# same solver): float32 plant roundoff through one cycle of the loop. The
# two read 1.9e-9 on the CPU at b8 and 3.7e-9 on the H100 at b4096 (PERF.md,
# section 5); the bound is ~170 float32 roundings of a position of 0.5.
SIM_VS_ROLLOUT_ATOL = 1e-5


# The Booster T1 (`t1_phases`): MPCController with recommended_conf("T1") on
# K1 for T1_TICKS ticks, and the closed loop of the examples (their 5-step
# single support and 8 cm swing, 1450 N force cap, 0.62 m) for
# T1_ROLLOUT_SECONDS (250 cycles), "T1-newton" and "T1" with the exact
# observation IK, T1_TIMED_CYCLES of it timed. Their criteria are JAX's
# T1 closed-loop tests' (tests/test_closed_loop.py:47-78, :110-130), on
# every env: roll / pitch, |z - 0.62|, the last vx above T1_VX_LAST and
# still rising (within T1_WALK["rise"] of the middle's largest), distance.
T1_TICKS = 100
T1_HEIGHT = 0.62
T1_ROLLOUT_SECONDS = 2.505
T1_TIMED_CYCLES = 10
T1_WALK = {"roll_pitch": 0.1, "height_dev": 0.07, "distance": 0.1, "rise": 0.02}
T1_VX_LAST = {"T1-newton": 0.15, "T1 obs_ik=newton": 0.1}
# The 20-step rule does not converge on T1's first QP (the CPU f64 solve ends
# at mu ~4.5e-3 with ||rx|| ~32, and moves by ~52 N between 20 and 40 steps),
# so two roundings part there by tens of N; K1's first T1 wrench is held
# against the CPU f64 controller at this many steps, where it converges.
T1_CONVERGED_STEPS = 40
# `ric_aug_core` (plain torch on the card) against the CPU on CORE_ENVS envs.
CORE_ENVS = 256
# The planar drone on the card: the region of attraction at the example's
# full size, and both sweeps at its --quick size.
DRONE_ROA_ENVS, DRONE_ROA_SECONDS = 30000, 10.0


def t1_criteria(traj) -> dict:
    """The T1 walk criteria over every env of a (cycles, B, 12) trajectory."""
    n = traj.shape[0]
    vx = traj[:, :, 9]
    return {"roll_pitch": float(traj[:, :, :2].abs().max()),
            "height_dev": float((traj[:, :, 5] - T1_HEIGHT).abs().max()),
            "vx_last_min": float(vx[-1].min()),
            "vx_rise": float(vx[-1].min() - vx[n // 2].max()),
            "distance": float((traj[-1, :, 3] - traj[0, :, 3]).min())}


def t1_phases(label: str, dev) -> dict:
    """The Booster T1 on the card: `[T1]` the controller on K1 against the
    CPU f64 one, the hybrid and condensed paths' first wrench printed;
    `[T1 rollout]` the captured closed loop of "T1-newton" and of "T1" with
    the exact observation IK against its eager cycles and JAX's T1 criteria;
    `[T1 rollout QPs]` the walk's own QPs. Returns K1's launches on the
    controller path and the numbers the later lines use."""
    import torch
    from biped_pympc_tpu_torch import MPCConf, MPCController, recommended_conf
    from biped_pympc_tpu_torch.examples import srbd_plant, tpu_rollout
    from biped_pympc_tpu_torch.examples.cuda_graph import tree_map
    from biped_pympc_tpu_torch.models import robot as robots
    from biped_pympc_tpu_torch.models import t1
    from biped_pympc_tpu_torch.ops import pdipm_cuda

    out = {}
    robot = robots.get_robot("T1")
    cconf, kw = recommended_conf("T1")
    x0 = torch.zeros(B, 12, device=dev)
    x0[:, 5] = T1_HEIGHT
    obs, _ = srbd_plant.assemble_obs(robot, x0, srbd_plant.nominal_feet(robot, B, torch.float32,
                                                                        dev))
    twist = torch.zeros(B, 3, device=dev)
    twist[:, 0] = 0.3
    height = torch.full((B,), T1_HEIGHT, device=dev)
    limit = torch.tensor(t1.TORQUE_LIMIT, device=dev)
    mg = t1.MASS * 9.81

    def first_vs_cpu(solver, wrench, steps=20):
        """max |d| of the first-solve wrench on 8 envs against the CPU f64
        controller's, and the CPU solve's largest final mu."""
        conf = MPCConf(**{**kw, "solver": solver, "verbose": False, "newton_iterations": steps})
        ref = MPCController(cconf, conf, num_envs=8, gait_id=2, dtype=torch.float64, device="cpu")
        ref.set_command(twist[:8].cpu(), height[:8].cpu())
        ref.update_state(obs[:8].cpu())
        ref.run_mpc()
        return (float((wrench[:8].cpu().double() - ref.ground_reaction_wrench).abs().max()),
                float(ref.solver_residuals[:, 3].max()))

    conf = MPCConf(**{**kw, "solver": "pallas_ric_aug", "verbose": False})
    ctrl = MPCController(cconf, conf, num_envs=B, gait_id=2, device=dev)
    ctrl.set_command(twist, height)
    pdipm_cuda.reset_counts()
    n_mpc, first, tau_ok = walk(ctrl, obs, T1_TICKS, limit)
    launches, warp = pdipm_cuda.runs(), pdipm_cuda.runs(warp=True)
    fz_sum = -first[:, :, 2].sum(1)
    dw20, mu20 = first_vs_cpu("pallas_ric_aug", first)
    others = {}
    for solver, steps in (("pallas_hybrid", 20), ("pallas_ric", 20),
                          ("pallas_ric_aug", T1_CONVERGED_STEPS)):
        octrl = MPCController(cconf, MPCConf(**{**kw, "solver": solver, "verbose": False,
                                                "newton_iterations": steps}),
                              num_envs=B, gait_id=2, device=dev)
        octrl.set_command(twist, height)
        octrl.update_state(obs)
        pdipm_cuda.reset_counts()
        octrl.run_mpc()
        others[solver, steps] = first_vs_cpu(solver, octrl.ground_reaction_wrench, steps)
    torch.cuda.synchronize()
    check(pdipm_cuda.runs() == route_counts(ric_aug=1 + WARM_UP),
          "T1's 40-step solve did not run K1 in its warm-up and its replay")
    dw, mu = others["pallas_ric_aug", T1_CONVERGED_STEPS]

    def tick():
        ctrl.update_state(obs)
        ctrl.run_lowlevel()
        ctrl.get_action()

    mpc_ms, tick_ms = cuda_ms(ctrl.run_mpc, 10), cuda_ms(tick, 20)
    print(f"[T1] MPCController recommended_conf('T1') b{B} f32 pallas_ric_aug, {T1_TICKS} ticks: "
          f"run_mpc {n_mpc}, kernel launches that ran {launches} (in a warp group {warp}); tau finite and "
          f"within T1's limits: {tau_ok}; first solve sum of fz "
          f"[{float(fz_sum.min()):.2f}, {float(fz_sum.max()):.2f}] N (mg {mg:.2f}); first-solve "
          f"wrench vs CPU plain f64 on 8 envs, 20 steps: K1 {dw20:.3e} N, pallas_hybrid "
          f"{others['pallas_hybrid', 20][0]:.3e} N, pallas_ric {others['pallas_ric', 20][0]:.3e} "
          f"N (printed: the CPU's final mu {mu20:.3e}, the rule has not converged); K1 at "
          f"{T1_CONVERGED_STEPS} steps {dw:.3e} N (bound {F32_U0_ATOL}; the CPU's final mu "
          f"{mu:.3e}); ms (CUDA events around the host's calls, as [times]; the wrapper's "
          f"replayed graphs) run_mpc {mpc_ms:.3f}, one tick (update_state + run_lowlevel + get_action) {tick_ms:.3f}")
    check(launches == route_counts(ric_aug=n_mpc + WARM_UP),
          "the T1 path did not run K1 once a run_mpc and once in its warm-up")
    check(warp["ric_aug"] == n_mpc + WARM_UP, "the T1 path's K1 did not run in its warp group")
    check(tau_ok, "T1 joint torques not finite or beyond T1's limits")
    check(bool(((fz_sum > 0.5 * mg) & (fz_sum < 2.0 * mg)).all()),
          "T1's first solve does not carry its weight")
    check(mu <= MU_CONVERGED, f"T1's first QP did not converge in {T1_CONVERGED_STEPS} steps")
    check(dw <= F32_U0_ATOL, "T1's first wrench differs from the CPU reference")
    out.update(k1_launches=launches["ric_aug"], mpc_ms=mpc_ms, tick_ms=tick_ms)

    for robot_name, obs_ik in (("T1-newton", "robot"), ("T1", "newton")):
        tag = robot_name if obs_ik == "robot" else f"{robot_name} obs_ik={obs_ik}"
        core = tpu_rollout.make_core("pallas_ric_aug", robot_name, device=dev, verbose=False)
        carry0 = tree_map(torch.clone, tpu_rollout.init_carry(core, B, 0.3, T1_HEIGHT))
        eager, _ = tpu_rollout.make_rollout(core, EAGER_CYCLES * 0.01 + 1e-4, obs_ik, graph=False)
        pdipm_cuda.reset_counts()
        (_, traj_e), eager_ms = timed_once(lambda: eager(carry0))
        traj_e, eager_ms = traj_e.clone(), eager_ms / EAGER_CYCLES
        check(pdipm_cuda.launches == route_counts(ric_aug=EAGER_CYCLES),
              f"{tag}: the eager rollout did not launch K1 once a cycle")
        rollout, cycles = tpu_rollout.make_rollout(core, T1_ROLLOUT_SECONDS, obs_ik)
        pdipm_cuda.reset_counts()
        t0 = time.perf_counter()
        _, traj = rollout(carry0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        g_launches, g_runs = dict(pdipm_cuda.launches), pdipm_cuda.runs()
        same = [bool(torch.equal(traj[i], traj_e[i])) for i in range(EAGER_CYCLES)]
        crit = t1_criteria(traj)
        finite = bool(torch.isfinite(traj).all())
        walked = tree_map(torch.clone, rollout.loop.carry)
        rollout.cycles = T1_TIMED_CYCLES
        graph_ms = cuda_ms(lambda: rollout(carry0), 1) / T1_TIMED_CYCLES
        rollout.loop.carry.index.zero_()
        trace = device_trace(rollout.loop, 3)
        steps_s = B * 10 / (graph_ms * 1e-3)
        tr = ("profiler: no device events (not measured)" if trace is None else
              f"{trace['events']:.1f} device events a replayed cycle (HECTOR's: the [rollout] "
              f"line), K1 {trace['k1']:.2f} a cycle, device idle {trace['idle']:.2%}")
        print(f"[T1 rollout] {label}: {tag} b{B} f32 pallas_ric_aug, {cycles} cycles as replays "
              f"of one captured cycle: first {EAGER_CYCLES} cycles bitwise the eager ones: "
              f"{same}; finite {finite}; criteria over every env {crit} (bounds {T1_WALK}, the "
              f"last vx > {T1_VX_LAST[tag]}); K1 captured: issued {g_launches['ric_aug']} "
              f"(warm-up + capture), ran {g_runs['ric_aug']} (warm-up + once a replay); ms a cycle graph {graph_ms:.3f} / eager {eager_ms:.3f} "
              f"({eager_ms / graph_ms:.1f}x), env-steps/s graph {steps_s:.0f}; first call "
              f"(capture + {cycles} cycles) {first_s:.2f} s; {tr}")
        check(all(same), f"{tag}: the captured cycles differ from the eager ones")
        check(finite, f"{tag}: the rollout is not finite")
        check(g_launches == route_counts(ric_aug=ISSUED_CAPTURED),
              f"{tag}: K1 not issued in the warm-up and the capture alone: {g_launches}")
        check(g_runs == route_counts(ric_aug=cycles + WARM_UP),
              f"{tag}: K1 did not run in the warm-up and once a replayed cycle: {g_runs}")
        check(crit["roll_pitch"] < T1_WALK["roll_pitch"], f"{tag}: fell over (roll / pitch)")
        check(crit["height_dev"] < T1_WALK["height_dev"], f"{tag}: height not held")
        check(crit["vx_last_min"] > T1_VX_LAST[tag], f"{tag}: vx not ramping")
        check(crit["vx_rise"] > -T1_WALK["rise"], f"{tag}: vx stopped rising")
        check(crit["distance"] > T1_WALK["distance"], f"{tag}: did not walk forward")
        if trace is not None:
            check(trace["k1"] == 1.0, f"{tag}: K1 ran {trace['k1']} times a replayed cycle")
        out[tag] = {"ms": graph_ms, "eager_ms": eager_ms, "steps_s": steps_s, "trace": trace}

        # The walk's own QPs after its last cycle, solved by K1 (ROADMAP
        # Queue 3 item 1): T1's final mu beside HECTOR's [rollout QPs] line.
        st = walked.state
        ik = tpu_rollout.obs_ik_fn(obs_ik, robot_name)
        core.ingest_state(st, srbd_plant.assemble_obs(core.robot, walked.x, walked.foot_w, ik)[0])
        _, _, wqp = core.assemble_mpc(st)
        res = pdipm_cuda.solve(wqp, core.opts)
        mu = res.residuals[:, 3]
        print(f"[T1 rollout QPs] {label}: {tag}, the b{B} QPs of the walk's last state, K1: mu "
              f"<= {MU_CONVERGED:g} on {int((mu <= MU_CONVERGED).sum())} of {B} envs, mu "
              f"{quantiles(mu.double().cpu().numpy())}; finite {bool(torch.isfinite(res.x).all())}")
        check(bool(torch.isfinite(res.x).all()), f"{tag}: the walk's QPs are not finite in K1")
    return out


def extras_phases(label: str, dev, qp32, qp64) -> dict:
    """`[ric_aug_core]` the scaled Riccati core (plain torch on the card)
    against the CPU; `[mesh]` a one-rank NCCL group: the sharded control step
    (a replay of the core's captured control_step), the metrics and one
    sharded ARS iteration against the unsharded ones;
    `[drone]` the planar drone's region of attraction and sweeps. Returns the
    K1 launches of the mesh's controller steps and the times."""
    import tempfile

    import torch
    import torch.distributed as dist
    from biped_pympc_tpu_torch import ControllerConf, MPCConf
    from biped_pympc_tpu_torch.control.controller import BipedControllerCore
    from biped_pympc_tpu_torch.examples import planar_drone, train_rl_mpc_tpu
    from biped_pympc_tpu_torch.ops import pdipm, pdipm_cuda
    from biped_pympc_tpu_torch.ops import qp as qps
    from biped_pympc_tpu_torch.parallel import mesh as pmesh
    from biped_pympc_tpu_torch.utils.tree import leaves

    out = {}
    # ric_aug_core: no kernel, the plain version on the card, at f64 against
    # the same on the CPU. Its explicit S^-1 loses the solution on a
    # swinging foot (S rank-deficient): on this script's walking batch (a
    # swinging foot in every env) two roundings of it part as the stable
    # ric_aug route parts from it, printed; held on the same draws with both
    # feet in stance, as the CPU tests hold it against JAX.
    core_opts = pdipm.PdipmOptions(backend="ric_aug_core", refine_steps=1)
    idx = torch.arange(CORE_ENVS, device=dev)
    batches = {"stance": make_qp_batch(CORE_ENVS, 0, torch.float64, dev, stance=True),
               "walking": qps.take(qp64, idx)}
    rel = lambda a, b: torch.stack([((getattr(a, n).cpu() - getattr(b, n).cpu()).abs()
                                     / getattr(b, n).cpu().abs().clamp_min(1.0)).amax(1)
                                    for n in "xszy"]).amax(0).numpy()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gaps, c_launches = {}, 0
    try:
        for name, q in batches.items():
            pdipm_cuda.reset_counts()
            card = pdipm_cuda.solve(q, core_opts)
            torch.cuda.synchronize()
            c_launches += sum(pdipm_cuda.launches.values())
            cpu = pdipm.solve(qp_map(q, lambda v: v.cpu()), core_opts)
            aug = pdipm.solve(q, dataclasses.replace(core_opts, backend="ric_aug",
                                                     foot_split=True))
            gaps[name] = (rel(card, cpu), rel(aug, card),
                          (cpu.residuals[:, 3] <= MU_CONVERGED).numpy())
    finally:
        torch.set_num_threads(threads)
    _, core_ms = timed_once(lambda: pdipm_cuda.solve(qp32, core_opts))
    st_gap, st_wit, st_cv = gaps["stance"]
    print(f"[ric_aug_core] {label}: b{CORE_ENVS} f64 {core_opts.iterations} steps, plain torch "
          f"on the card vs the CPU, max |dx,ds,dz,dy| relative to max(1, |v|) per env: both "
          f"feet in stance, converged envs ({int(st_cv.sum())}) {quantiles(st_gap[st_cv])} "
          f"(bound {CONDENSED_F64_RTOL:g}), all {quantiles(st_gap)}, the ric_aug route vs it "
          f"{quantiles(st_wit)}; the walking batch "
          f"{quantiles(gaps['walking'][0])}, the ric_aug route vs it "
          f"{quantiles(gaps['walking'][1])} (printed: S^-1 on the swinging foot); kernel "
          f"launches {c_launches}; b{B} f32 one solve of the walking batch {core_ms:.1f} ms")
    check(int(st_cv.sum()) >= CORE_ENVS // 10, "ric_aug_core: too few converged envs")
    check(float(st_gap[st_cv].max()) <= CONDENSED_F64_RTOL,
          "ric_aug_core on the card differs from the CPU")
    check(c_launches == 0, "ric_aug_core launched a kernel")
    out["core_ms"] = core_ms

    # The mesh: one rank, NCCL, initialized from a file in a temporary
    # directory; the step, the metrics and a training iteration against the
    # same unsharded.
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init", rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh()
            core = BipedControllerCore(ControllerConf(), MPCConf(solver="pallas_ric_aug",
                                                                 verbose=False),
                                       gait_id=2, device=dev)
            inputs = (torch.tensor(hector_obs(B), device=dev),
                      torch.tensor([[0.3, 0.0, 0.0]], device=dev).expand(B, 3).contiguous(),
                      torch.full((B,), 0.55, device=dev))
            pdipm_cuda.reset_counts()
            full = core.init_state(B)
            tau_u, out_u = core._control_step(full, *inputs)
            same = {}
            for with_metrics in (False, True):
                state = pmesh.shard_state(core.init_state(B), mesh)
                ret = pmesh.controller_step(core, mesh, with_metrics)(
                    state, *pmesh.shard_state(inputs, mesh))
                same[f"tau {with_metrics}"] = same_bits(ret[0], tau_u)
                same[f"wrench {with_metrics}"] = same_bits(ret[1].wrench, out_u.wrench)
                same[f"state {with_metrics}"] = all(
                    same_bits(t, u) for (_, t), (_, u) in zip(leaves(state), leaves(full)))
                if with_metrics:
                    same["mean cost"] = same_bits(ret[2], out_u.cost.mean())
            torch.cuda.synchronize()
            # K1 as it counts itself on the device: the eager step, the
            # graph's warm-up and its two replays; the host issued the eager
            # step's, the warm-up's and the capture's.
            m_launches = pdipm_cuda.runs()["ric_aug"]
            m_issued = pdipm_cuda.launches["ric_aug"]
            graphs = list(core.graphs)
            summary = pmesh.metrics_summary(out_u.cost, mesh)
            for key, want in (("mean", out_u.cost.mean()), ("max", out_u.cost.amax()),
                              ("p50", torch.quantile(out_u.cost, 0.5))):
                same[f"summary {key}"] = bool(torch.equal(summary[key], want))
            kw = dict(iters=1, n_dirs=2, envs_per=4, steps=2, seed=0, solver="pallas_ric_aug",
                      verbose=False)
            w_mesh = train_rl_mpc_tpu.train(mesh=mesh, **kw)[0]
            w_ref = train_rl_mpc_tpu.train(device=dev, **kw)[0]
            same["train w"] = bool(np.array_equal(w_mesh, w_ref))
            print(f"[mesh] {label}: one NCCL rank on {mesh.device} (more ranks wait for a "
                  f"machine with more cards): controller_step b{B} pallas_ric_aug with and "
                  f"without metrics, each a replay of the core's captured control_step "
                  f"(graphs {graphs}; the metrics one all-reduce after it), metrics_summary "
                  f"(mean, max, quantile 0.5) and one train(mesh=..., iters=1) iteration "
                  f"bitwise the unsharded ones (the eager step): {same}; K1 ran {m_launches} "
                  f"(the kernel's count: the eager step, the warm-up, two replays), issued "
                  f"{m_issued}")
            check(all(same.values()), "the sharded runs differ from the unsharded ones")
            check(graphs == [(B, torch.float32)], f"the mesh's steps made graphs {graphs}")
            check(m_launches == 4 and m_issued == 3,
                  "the mesh's steps did not run K1 once each as one graph's replays")
            out["mesh_launches"] = m_launches
        finally:
            dist.destroy_process_group()

    # The planar drone, f32: the region of attraction at the example's size
    # (one shared gain), success share against F_lim; the sweeps and the
    # region at the --quick size.
    t0 = time.perf_counter()
    roa = planar_drone.region_of_attraction(DRONE_ROA_ENVS, DRONE_ROA_SECONDS, device=dev)
    roa_s = time.perf_counter() - t0
    quick_roa = planar_drone.region_of_attraction(n_envs=256, t_end=2.0, device=dev)
    sweeps = planar_drone.lqr_sweeps(n_per_init=4, t_end=2.0, device=dev)
    fracs = list(roa.values())
    n_steps = DRONE_ROA_ENVS * int(DRONE_ROA_SECONDS / planar_drone.DT) * len(roa)
    print(f"[drone] {label}: region_of_attraction {DRONE_ROA_ENVS} envs x "
          f"{DRONE_ROA_SECONDS} s x {len(roa)} F_lim, success share {roa} in {roa_s:.2f} s "
          f"({n_steps / roa_s:.3e} env-steps/s, the DARE gain on the host included); --quick "
          f"size: region {quick_roa}, sweeps {sweeps}")
    check(all(b >= a for a, b in zip(fracs, fracs[1:])) and fracs[-1] > fracs[0],
          "the drone's success share does not rise with thrust")
    check(all(np.isfinite(s["final_err_median"]) for s in sweeps.values()),
          "the drone's sweeps are not finite")
    out["drone_steps_s"] = n_steps / roa_s
    return out


def device_trace(fn, reps: int) -> dict:
    """Run fn `reps` times under torch.profiler (CUPTI) and read the device's
    side: {"events": device events (kernels, copies, fills) per rep, "k1":
    PDIPM kernel launches per rep, "idle": the device's idle share between
    its first event's start and its last event's end, "names": the kernels
    of a rep by count}, or None where the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not evs:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    names = {}
    for e in evs:
        names[e.name] = names.get(e.name, 0) + 1
    return {"events": len(evs) / reps, "k1": sum("pdipm_kernel" in e.name for e in evs) / reps,
            "idle": 1.0 - busy / (end - spans[0][0]),
            "names": {k: v / reps for k, v in sorted(names.items(), key=lambda kv: -kv[1])}}


def walk_criteria(traj) -> dict:
    """JAX's walk criteria over every env of a (cycles, B, 12) trajectory."""
    n = traj.shape[0]
    return {"roll_pitch": float(traj[:, :, :2].abs().max()),
            "height_dev": float((traj[:, :, 5] - 0.55).abs().max()),
            "vx_late_dev": float((traj[n // 2:, :, 9] - 0.3).abs().max()),
            "distance": float((traj[-1, :, 3] - traj[0, :, 3]).min())}


def closed_loop_phases(label: str, dev, qp32, qp64) -> dict:
    """The closed loop on the card (`biped_pympc_tpu_torch/examples/`): the
    captured rollout against its eager cycles, the RL population env, the
    host loop `simulate` and the dense route. Prints one line each; returns
    the numbers the later lines and the kernels' JSON use."""
    import torch
    from biped_pympc_tpu_torch.examples import (closed_loop_sim, rl_env_tpu, srbd_plant,
                                                tpu_rollout, train_rl_mpc)
    from biped_pympc_tpu_torch.examples.cuda_graph import tree_map
    from biped_pympc_tpu_torch.ops import pdipm, pdipm_cuda
    from biped_pympc_tpu_torch.ops import qp as qps

    out = {}
    core = tpu_rollout.make_core("pallas_ric_aug", device=dev, verbose=False)
    carry0 = tree_map(torch.clone, tpu_rollout.init_carry(core, B, 0.3, 0.55))
    decim = core.mpc_cfg.decimation

    # Rollout, eager: EAGER_CYCLES cycles (the first builds K1 and fills the
    # constant caches), then one more cycle under no_host_sync.
    eager, _ = tpu_rollout.make_rollout(core, EAGER_CYCLES * 0.01 + 1e-4, graph=False)
    pdipm_cuda.reset_counts()
    _, traj_e = eager(carry0)
    traj_e = traj_e.clone()
    torch.cuda.synchronize()
    e_launches = dict(pdipm_cuda.launches)
    check(e_launches == route_counts(ric_aug=EAGER_CYCLES),
          f"the eager rollout did not launch K1 once a cycle: {e_launches}")
    one, _ = tpu_rollout.make_rollout(core, 0.0101, graph=False)
    with no_host_sync():
        one(carry0)
    eager_ms = cuda_ms(lambda: eager(carry0), 2) / EAGER_CYCLES

    # Rollout, captured: the first call warms up on a side stream, captures
    # one cycle and replays it: the host issues K1 in the warm-up and the
    # capture, the kernel runs in the warm-up and once a replayed cycle.
    rollout, cycles = tpu_rollout.make_rollout(core, ROLLOUT_SECONDS)
    pdipm_cuda.reset_counts()
    t0 = time.perf_counter()
    _, traj = rollout(carry0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    g_launches, g_runs = dict(pdipm_cuda.launches), pdipm_cuda.runs()
    check(g_launches == route_counts(ric_aug=ISSUED_CAPTURED),
          f"the captured rollout did not issue K1 in its warm-up and capture alone: {g_launches}")
    check(g_runs == route_counts(ric_aug=cycles + WARM_UP),
          f"the captured rollout did not run K1 in its warm-up and once a cycle: {g_runs}")
    same = [bool(torch.equal(traj[i], traj_e[i])) for i in range(EAGER_CYCLES)]
    crit = walk_criteria(traj)
    finite = bool(torch.isfinite(traj).all())
    graph_ms = cuda_ms(lambda: rollout(carry0), 1) / cycles
    rollout.loop.carry.index.zero_()  # the profiled replays write traj[:PROFILED_CYCLES]
    trace = device_trace(rollout.loop, PROFILED_CYCLES)
    steps_s = B * decim / (graph_ms * 1e-3)
    tr_line = ("profiler: no device events (not measured)" if trace is None else
               f"profiler over {PROFILED_CYCLES} replays: {trace['events']:.1f} device events a "
               f"cycle, K1 {trace['k1']:.2f} a cycle, device idle {trace['idle']:.2%}; top kernels "
               + ", ".join(f"{k[:40]} {v:g}" for k, v in list(trace["names"].items())[:4]))
    print(f"[rollout] {label}: b{B} f32 pallas_ric_aug, {cycles} cycles ({cycles * decim} ticks) "
          f"as replays of one captured cycle: first {EAGER_CYCLES} cycles bitwise the eager "
          f"ones: {same}; finite {finite}; walk criteria over every env {crit} (bounds {WALK}); "
          f"K1 launches issued eager {e_launches['ric_aug']} for {EAGER_CYCLES} cycles, captured "
          f"{g_launches['ric_aug']} (warm-up + capture), ran {g_runs['ric_aug']} for {cycles} "
          f"cycles (warm-up + once a replay); one eager cycle under "
          f"no_host_sync: ok; "
          f"ms a cycle graph {graph_ms:.3f} / eager {eager_ms:.3f} "
          f"({eager_ms / graph_ms:.1f}x); env-steps/s graph {steps_s:.0f}, eager "
          f"{B * decim / (eager_ms * 1e-3):.0f}; first call (capture + {cycles} cycles) "
          f"{first_s:.2f} s; {tr_line}")
    check(all(same), "the captured cycles differ from the eager ones")
    check(finite, "the rollout is not finite")
    check(crit["roll_pitch"] < WALK["roll_pitch"], "rollout: fell over (roll / pitch)")
    check(crit["height_dev"] < WALK["height_dev"], "rollout: height not held")
    check(crit["vx_late_dev"] < WALK["vx_late_dev"], "rollout: vx tracking off")
    check(crit["distance"] > WALK["distance"], "rollout: did not walk forward")
    if trace is not None:
        check(trace["k1"] == 1.0, f"K1 ran {trace['k1']} times a replayed cycle")
    out.update(rollout_ms=graph_ms, rollout_eager_ms=eager_ms, rollout_steps_s=steps_s,
               rollout_trace=trace)

    # Do the walk's own QPs converge under the 20-step rule, and does the
    # adaptive stop fire on them (ROADMAP Queue 3 items 1 and 10)? The QPs
    # of the walk's last state, solved by K1, fixed and adaptive.
    walked = rollout.loop.carry
    st = tree_map(torch.clone, walked.state)
    core.ingest_state(st, srbd_plant.assemble_obs(core.robot, walked.x, walked.foot_w)[0])
    _, _, wqp = core.assemble_mpc(st)
    wres = pdipm_cuda.solve(wqp, core.opts)
    pdipm_cuda.reset_counts()
    pdipm_cuda.solve_adaptive(wqp, core.opts, WALK_TOL)
    ran = pdipm_cuda.chunks_ran()["ric_aug"]
    mu, crit_w = wres.residuals[:, 3], wres.residuals.amax(1)
    print(f"[rollout QPs] {label}: the b{B} QPs of the walk's last state, K1: mu <= "
          f"{MU_CONVERGED:g} on {int((mu <= MU_CONVERGED).sum())} of {B} envs, mu "
          f"{quantiles(mu.double().cpu().numpy())}; max(||rx||, ||rs||, ||re||, mu) "
          f"{quantiles(crit_w.double().cpu().numpy())}; solve_adaptive tol {WALK_TOL:g}: "
          f"{ran} of {pdipm_cuda.launches['ric_aug']} chunks ran")
    check(bool(torch.isfinite(wres.x).all()), "the walk's QPs are not finite in K1")

    # RL: the device env over a population, one captured RL step replayed.
    rng = np.random.default_rng(0)
    n_rl = 2 * RL_DIRS * RL_ENVS_PER
    env_step, reset_all, rl_obs, rl_core = rl_env_tpu.make_device_env(n_rl, device=dev)
    deltas = rng.standard_normal((RL_DIRS, rl_env_tpu.ACT_DIM, rl_env_tpu.OBS_DIM))
    w0 = np.zeros((rl_env_tpu.ACT_DIM, rl_env_tpu.OBS_DIM))
    w_env = train_rl_mpc.population(w0, deltas, 0.05, RL_ENVS_PER)
    start = reset_all()
    eager_rl = rl_env_tpu.make_rollout(env_step, rl_obs, RL_EQUAL_STEPS, graph=False)
    _, ret_e = eager_rl(start, w_env)
    ret_e = ret_e.clone()
    graph_rl = rl_env_tpu.make_rollout(env_step, rl_obs, RL_EQUAL_STEPS)
    pdipm_cuda.reset_counts()
    _, ret_g = graph_rl(start, w_env)
    rl_same = bool(torch.equal(ret_g, ret_e))
    graph_rl.steps = RL_STEPS
    rl_ms = cuda_ms(lambda: graph_rl(start, w_env), 1) / RL_STEPS
    _, returns = graph_rl(start, w_env)
    returns = returns.double().cpu().numpy()
    w1, spread = train_rl_mpc.ars_update(w0, deltas, returns, RL_ENVS_PER, 0.02)
    rl_trace = device_trace(graph_rl.loop, 2)
    rl_rate = n_rl * decim / (rl_ms * 1e-3)
    print(f"[rl] {label}: make_device_env b{n_rl} ({RL_DIRS} directions x 2 x {RL_ENVS_PER} "
          f"envs) f32 pallas_ric_aug: captured step vs eager over {RL_EQUAL_STEPS} steps, "
          f"returns bitwise equal {rl_same}; {RL_STEPS} steps: returns mean "
          f"{returns.mean():.4f}, min {returns.min():.4f}, finite "
          f"{bool(np.isfinite(returns).all())}; ARS update |w| {np.linalg.norm(w1):.4e} "
          f"(spread max {spread.max():+.4f}); ms an RL step {rl_ms:.3f}, env-steps/s "
          f"{rl_rate:.0f}; K1 a replayed step "
          f"{'not measured' if rl_trace is None else rl_trace['k1']}, device events "
          f"{'not measured' if rl_trace is None else rl_trace['events']}, idle "
          f"{'not measured' if rl_trace is None else format(rl_trace['idle'], '.2%')}")
    check(rl_same, "the captured RL step differs from the eager one")
    check(bool(np.isfinite(returns).all()), "RL returns not finite")
    check(bool(np.isfinite(w1).all()) and np.linalg.norm(w1) > 0, "the ARS update left w at 0")
    if rl_trace is not None:
        check(rl_trace["k1"] == 1.0, f"K1 ran {rl_trace['k1']} times a replayed RL step")
    out.update(rl_ms=rl_ms, rl_steps_s=rl_rate, rl_trace=rl_trace)

    # The host loop, its default solver ("tridiag_aug", K5b), against the
    # eager rollout's first cycle on the same solver.
    pdipm_cuda.reset_counts()
    t0 = time.perf_counter()
    sim = closed_loop_sim.simulate(num_envs=B, seconds=CLOSED_LOOP_SECONDS, every=1,
                                   verbose=False, device=dev)
    sim_s = time.perf_counter() - t0
    s_launches = pdipm_cuda.runs()
    n_ticks = int(CLOSED_LOOP_SECONDS / core.mpc_cfg.dt)
    k5b = tpu_rollout.make_core("tridiag_aug", device=dev, verbose=False)
    ro5, _ = tpu_rollout.make_rollout(k5b, 0.0101, graph=False)
    _, t5 = ro5(tpu_rollout.init_carry(k5b, B, 0.3, 0.55))
    x1 = t5[0].double().cpu().numpy()
    d_sim = max(float(np.abs(sim["pos"][decim - 1] - x1[:, 3:6]).max()),
                float(np.abs(sim["rpy"][decim - 1] - x1[:, 0:3]).max()),
                float(np.abs(sim["vx"][decim - 1] - x1[:, 9]).max()))
    sim_finite = all(np.isfinite(v).all() for v in sim.values())
    print(f"[closed loop] {label}: simulate b{B} {CLOSED_LOOP_SECONDS} s ({n_ticks} ticks) "
          f"solver tridiag_aug through MPCController: kernel launches that ran {s_launches} in "
          f"{sim_s:.2f} s "
          f"({sim_s / n_ticks * 1e3:.2f} ms a tick on the host's clock); finite {sim_finite}; "
          f"x after {decim} ticks vs the eager rollout's first cycle max |d| {d_sim:.3e} "
          f"(bound {SIM_VS_ROLLOUT_ATOL:g}); final "
          f"z {float(sim['pos'][-1][:, 2].min()):.4f}..{float(sim['pos'][-1][:, 2].max()):.4f}")
    check(s_launches == route_counts(tridiag_aug=n_ticks // decim + WARM_UP),
          f"simulate did not run K5b once a solve and in its warm-up: {s_launches}")
    check(sim_finite, "simulate is not finite")
    check(d_sim <= SIM_VS_ROLLOUT_ATOL, "simulate's first cycle differs from the rollout's")

    # solver="dense": a batched LU of the whole condensed reduced KKT, plain
    # torch on the card, at f64 on DENSE_ENVS envs against the same on the CPU.
    dense = pdipm.PdipmOptions(backend="dense", refine_steps=1)
    idx = torch.arange(DENSE_ENVS, device=dev)
    sub64 = qps.take(qp64, idx)
    pdipm_cuda.reset_counts()
    card = pdipm_cuda.solve(sub64, dense)
    torch.cuda.synchronize()
    d_launches = sum(pdipm_cuda.launches.values())
    # One intra-op thread for the CPU's batched LU: under several, LAPACK's
    # getrf in a CPU build of torch 2.13 stopped with "Parameter 6 was
    # incorrect on entry to DLASWP" and hung (the tests run it on one).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = pdipm.solve(qp_map(sub64, lambda v: v.cpu()), dense)
    finally:
        torch.set_num_threads(threads)
    cv = (cpu.residuals[:, 3] <= MU_CONVERGED)
    rel = max(float(((getattr(card, n).cpu() - getattr(cpu, n)).abs()
                     / getattr(cpu, n).abs().clamp_min(1.0)).amax(1)[cv].max()) for n in "xszy")
    ric64 = pdipm.solve(sub64, dataclasses.replace(dense, backend="ric", foot_split=True))
    wit = max(float(((getattr(ric64, n) - getattr(card, n)).abs()
                     / getattr(card, n).abs().clamp_min(1.0)).amax(1)[cv.to(dev)].max())
              for n in "xszy")
    _, dense_ms = timed_once(lambda: pdipm_cuda.solve(qp32, dense))
    nz, ne = qp32.nz, qp32.n_eq
    # The LU alone, torch's default library (MAGMA's batched LU at this
    # width) and cuSOLVER (`pdipm._cusolver`, the dense route's) in turns, on
    # a diagonally dominant random batch of the route's width.
    g = torch.Generator(device=dev).manual_seed(0)
    m = torch.randn(B, nz + ne, nz + ne, device=dev, generator=g)
    m += (nz + ne) * torch.eye(nz + ne, device=dev)

    def lu_under(cusolver):
        with pdipm._cusolver(m) if cusolver else contextlib.nullcontext():
            torch.linalg.lu_factor_ex(m, check_errors=False)

    lu_turns = [timed_once(lambda: lu_under(c))[1] for c in (False, True, True, False)]
    print(f"[dense] {label}: b{DENSE_ENVS} f64 on the card vs the CPU, converged envs "
          f"{int(cv.sum())}: max |dx,ds,dz,dy| {rel:.3e} relative to max(1, |v|) (bound "
          f"{CONDENSED_F64_RTOL:g}); the plain ric route vs dense on the card {wit:.3e} "
          f"(printed); kernel launches {d_launches}; b{B} f32 one solve {dense_ms:.1f} ms, its "
          f"LU and solves under cuSOLVER (batched LU of {nz + ne}-wide matrices, "
          f"{B * (nz + ne) ** 2 * 4 / 1e9:.2f} GB); the LU alone in turns, torch's default "
          f"(MAGMA) / cuSOLVER / cuSOLVER / default: "
          + " ".join(f"{t:.1f}" for t in lu_turns) + " ms")
    check(int(cv.sum()) >= DENSE_ENVS // 10, "dense: too few converged envs")
    check(rel <= CONDENSED_F64_RTOL, "dense on the card differs from the CPU")
    check(d_launches == 0, "the dense route launched a kernel")
    out.update(dense_ms=dense_ms, lu_turns=lu_turns)
    return out


# The wrapper's captured calls (`wrapper_phase`): WRAPPER_PERIODS 100 Hz
# periods of `decimation` ticks each (a reset of two envs between them) through
# `MPCController` and through the core's eager methods on a cloned state; the
# tick timed WRAPPER_REPS times a turn, run_mpc and the period fewer.
WRAPPER_PERIODS = 2
WRAPPER_REPS = 20
# The dense mode's run_mpc, captured with its LU under cuSOLVER, at this batch.
DENSE_WRAPPER_ENVS = 256


def same_bits(a, b) -> bool:
    """Whether two tensors hold the same bits (NaN payloads included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return bool(torch.equal(a.view(ints), b.view(ints)))
    return bool(torch.equal(a, b))


def in_turns(graph_fn, eager_fn, reps: int) -> tuple:
    """ms of graph_fn and eager_fn (CUDA events around the host's calls,
    `cuda_ms`) in the turns graph, eager, eager, graph: ((g1, g2), (e1, e2))."""
    g1, e1 = cuda_ms(graph_fn, reps), cuda_ms(eager_fn, reps)
    e2, g2 = cuda_ms(eager_fn, reps), cuda_ms(graph_fn, reps)
    return (g1, g2), (e1, e2)


def controller_confs(robot_name="HECTOR", **kw) -> tuple:
    """(ControllerConf, MPCConf) of the wrapper and control_step phases:
    HECTOR's defaults, the T1's `recommended_conf` on K1; `kw` over them."""
    from biped_pympc_tpu_torch import ControllerConf, MPCConf, recommended_conf

    if robot_name == "HECTOR":
        cconf, base = ControllerConf(), {}
    else:
        cconf, base = recommended_conf(robot_name)
        base = {**base, "solver": "pallas_ric_aug"}
    return cconf, MPCConf(**{**base, "verbose": False, **kw})


def controller_inputs(robot_name, nb, dev) -> tuple:
    """(obs, twist, height): standing, commanded to walk at 0.3 m/s."""
    import torch
    from biped_pympc_tpu_torch.examples import srbd_plant
    from biped_pympc_tpu_torch.models import robot as robots

    twist = torch.zeros(nb, 3, device=dev)
    twist[:, 0] = 0.3
    if robot_name == "HECTOR":
        return torch.tensor(hector_obs(nb), device=dev), twist, torch.full((nb,), 0.55,
                                                                           device=dev)
    robot = robots.get_robot(robot_name)
    x0 = torch.zeros(nb, 12, device=dev)
    x0[:, 5] = T1_HEIGHT
    obs, _ = srbd_plant.assemble_obs(robot, x0, srbd_plant.nominal_feet(
        robot, nb, torch.float32, dev))
    return obs, twist, torch.full((nb,), T1_HEIGHT, device=dev)


def wrapper_phase(label: str, dev) -> dict:
    """`[wrapper graph]`: `MPCController`'s calls, each captured as a CUDA
    graph at its first use and replayed, against `ctrl.core`'s eager methods
    on a cloned state: the torques of every tick and every state leaf at the
    end bit for bit, for the default, hybrid and adaptive solvers on HECTOR
    and `recommended_conf("T1")`, with the kernels' own launch counts
    (`pdipm_cuda.runs`) in each comparison; every call a replayed graph; one
    replayed run_mpc running K1 once as the kernel counts it and as the
    profiler sees it, and issuing nothing from the host; the device
    events and idle share of a captured and an eager tick and run_mpc; the
    ms of a tick, run_mpc and one 100 Hz period captured and eager in turns;
    the graphs' pool bytes; the T1-newton tick; the results a caller holds
    unchanged by a later period; and `solver="dense"` (adaptive_tol 0), whose
    run_mpc is captured with its LU under cuSOLVER, bit for bit the eager
    core and its first wrench against the CPU f64 controller. Returns the
    numbers the later lines use."""
    import torch
    from biped_pympc_tpu_torch import MPCController
    from biped_pympc_tpu_torch.control.controller import eager_run_mpc
    from biped_pympc_tpu_torch.ops import pdipm_cuda
    from biped_pympc_tpu_torch.utils.tree import leaves, tree_map

    def controller(robot_name="HECTOR", nb=B, dtype=torch.float32, device=dev, **kw):
        cconf, conf = controller_confs(robot_name, **kw)
        return MPCController(cconf, conf, num_envs=nb, gait_id=2, dtype=dtype, device=device)

    inputs = lambda robot_name, nb: controller_inputs(robot_name, nb, dev)

    def compare(ctrl, obs, twist, height, first=None):
        """WRAPPER_PERIODS periods through `ctrl` and through its core on a
        clone of its state: (every tick's tau bitwise, the leaves that
        differ at the end); the first solve's wrench appended to `first`."""
        core = ctrl.core
        est = tree_map(torch.clone, ctrl.state)
        ctrl.set_command(twist, height)
        core.set_command(est, twist, height)
        decim = core.mpc_cfg.decimation
        ids = [1, 2]
        mask = torch.zeros(ctrl.num_envs, dtype=torch.bool, device=dev)
        mask[ids] = True
        same = []
        for step in range(WRAPPER_PERIODS * decim):
            if step == decim:
                ctrl.reset(ids)
                core.reset(est, mask)
            ctrl.update_state(obs)
            core.ingest_state(est, obs)
            if step % decim == 0:
                ctrl.run_mpc()
                core.run_mpc(est)
                if first is not None and step == 0:
                    first.append(ctrl.ground_reaction_wrench)
            ctrl.run_lowlevel()
            core.run_lowlevel(est)
            same.append(same_bits(ctrl.get_action(), core.joint_torque(est)))
        theirs = dict(leaves(est))
        return all(same), [p for p, t in leaves(ctrl.state) if not same_bits(t, theirs[p])]

    out, bits = {}, {}
    ctrls = {}
    # The kernels' runs in a comparison, as they count them (`pdipm_cuda.runs`),
    # per solver: the eager core's solves, the warm-up before the capture and
    # the replays; the adaptive solve's chunks that ran, 1 to 4 a solve.
    solves = 2 * WRAPPER_PERIODS + WARM_UP
    per_solve = {"default": {"ric_aug": 1}, "hybrid": {"ric_aug": 1, "ric": 1},
                 "adaptive": {}, "T1": {"ric_aug": 1}}
    for tag, robot_name, kw in (("default", "HECTOR", {}),
                                ("hybrid", "HECTOR", {"solver": "pallas_hybrid"}),
                                ("adaptive", "HECTOR", {"adaptive_tol": WALK_TOL}),
                                ("T1", "T1", {})):
        ctrl = controller(robot_name, **kw)
        obs, twist, height = inputs(robot_name, B)
        pdipm_cuda.reset_counts()
        tau_same, differ = compare(ctrl, obs, twist, height)
        ran = pdipm_cuda.runs()
        replayed = sorted(name for name, loop in ctrl.graphs.items() if loop.graph is not None)
        bits[tag] = {"tau": tau_same, "leaves differing": differ, "replayed": len(replayed),
                     "PDIPM kernels ran": sum(ran.values())}
        if tag == "adaptive":
            check(solves <= ran["ric_aug"] <= 4 * solves
                  and ran == route_counts(ric_aug=ran["ric_aug"]), f"adaptive: K1 ran {ran}")
        else:
            check(ran == route_counts(**{r: n * solves for r, n in per_solve[tag].items()}),
                  f"{tag}: the kernels ran {ran}, not {per_solve[tag]} in each of {solves} solves")
        check(tau_same and not differ,
              f"{tag}: the captured wrapper differs from the eager core: tau {tau_same}, "
              f"leaves {differ[:5]}")
        check(replayed == sorted(["set_command", "update_state", "run_mpc", "run_lowlevel",
                                  "get_action", "reset"]),
              f"{tag}: not every call is a replayed graph: {replayed}")
        ctrls[tag] = (ctrl, obs, twist, height)
    torch.cuda.synchronize()

    # One replayed run_mpc: K1 runs once as the kernel counts it and as the
    # profiler sees it, and the host issues nothing.
    ctrl, obs, twist, height = ctrls["default"]
    core = ctrl.core
    pdipm_cuda.reset_counts()
    mpc_trace = device_trace(ctrl.run_mpc, 1)
    counted, issued = pdipm_cuda.runs(), dict(pdipm_cuda.launches)
    check(mpc_trace is not None, "the profiler saw no device event in a replayed run_mpc")
    check(counted == route_counts(ric_aug=1), f"one replayed run_mpc ran {counted}")
    check(issued == route_counts(), f"one replayed run_mpc issued {issued} from the host")
    check(mpc_trace["k1"] == counted["ric_aug"],
          f"the profiler saw K1 {mpc_trace['k1']} times in one replayed run_mpc")

    # Results the caller holds: unchanged by a later period.
    held = [ctrl.get_action(), ctrl.ground_reaction_wrench, ctrl.grf_world,
            ctrl.solver_residuals, ctrl.mpc_cost]
    copies = [t.clone() for t in held]
    est = tree_map(torch.clone, ctrl.state)
    decim = core.mpc_cfg.decimation

    def tick_graph():
        ctrl.update_state(obs)
        ctrl.run_lowlevel()
        ctrl.get_action()

    def tick_eager():
        core.ingest_state(est, obs)
        core.run_lowlevel(est)
        core.joint_torque(est)

    def period_graph():
        ctrl.set_command(twist, height)
        for step in range(decim):
            ctrl.update_state(obs)
            if step == 0:
                ctrl.run_mpc()
            ctrl.run_lowlevel()
            ctrl.get_action()

    def period_eager():
        core.set_command(est, twist, height)
        for step in range(decim):
            core.ingest_state(est, obs)
            if step == 0:
                core.run_mpc(est)
            core.run_lowlevel(est)
            core.joint_torque(est)

    period_graph()
    held_same = all(same_bits(a, b) for a, b in zip(held, copies))
    check(held_same, "a result the caller holds changed after a later period")
    with no_host_sync():
        period_graph()
    tick_ms = in_turns(tick_graph, tick_eager, WRAPPER_REPS)
    mpc_ms = in_turns(ctrl.run_mpc, lambda: core.run_mpc(est), WRAPPER_REPS // 2)
    period_ms = in_turns(period_graph, period_eager, WRAPPER_REPS // 4)
    traces = {"tick graph": device_trace(tick_graph, 10), "tick eager": device_trace(tick_eager, 10),
              "run_mpc eager": device_trace(lambda: core.run_mpc(est), 3),
              "run_mpc graph": mpc_trace}
    pools = {tag: {name: loop.pool_bytes for name, loop in c.graphs.items()}
             for tag, (c, *_) in ctrls.items()}
    for per_call in pools.values():
        per_call["total"] = sum(per_call.values())
    check(all(n > 0 for per_call in pools.values() for n in per_call.values()),
          f"a captured graph holds no pool: {pools}")

    # T1-newton: its observation IK keeps ~5,000 kernels a tick.
    newton = controller("T1-newton")
    n_obs, n_twist, n_height = inputs("T1-newton", B)
    newton.set_command(n_twist, n_height)
    newton.update_state(n_obs)
    newton.run_mpc()
    n_est = tree_map(torch.clone, newton.state)

    def n_tick_graph():
        newton.update_state(n_obs)
        newton.run_lowlevel()
        newton.get_action()

    def n_tick_eager():
        newton.core.ingest_state(n_est, n_obs)
        newton.core.run_lowlevel(n_est)
        newton.core.joint_torque(n_est)

    n_tick_ms = in_turns(n_tick_graph, n_tick_eager, 5)
    n_traces = {"graph": device_trace(n_tick_graph, 2), "eager": device_trace(n_tick_eager, 2)}

    # solver="dense" (adaptive_tol 0): its run_mpc captured too, the LU under
    # cuSOLVER; bit for bit the eager core, the preferred library as it was
    # after, the first wrench against the CPU f64 dense controller on 8 envs.
    library = torch.backends.cuda.preferred_linalg_library()
    dense = controller(nb=DENSE_WRAPPER_ENVS, solver="dense")
    d_obs, d_twist, d_height = inputs("HECTOR", DENSE_WRAPPER_ENVS)
    d_first = []
    d_tau, d_differ = compare(dense, d_obs, d_twist, d_height, d_first)
    d_graphs = {name: loop.graph is not None for name, loop in dense.graphs.items()}
    dref = controller(nb=8, dtype=torch.float64, device="cpu", solver="dense")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's batched LU on one thread (see `[dense]`)
    try:
        dref.set_command(d_twist[:8].cpu(), d_height[:8].cpu())
        dref.update_state(d_obs[:8].cpu())
        dref.run_mpc()
    finally:
        torch.set_num_threads(threads)
    d_dw = float((d_first[0][:8].cpu().double() - dref.ground_reaction_wrench).abs().max())
    check(eager_run_mpc(dense.core) is None, "dense: the static rule keeps its run_mpc eager")
    check(all(d_graphs.values()) and len(d_graphs) == 6,
          f"dense: not every call is a replayed graph: {d_graphs}")
    check(d_tau and not d_differ,
          f"dense: the captured wrapper differs from the eager core: tau {d_tau}, leaves "
          f"{d_differ[:5]}")
    check(torch.backends.cuda.preferred_linalg_library() == library,
          "dense: the preferred linear-algebra library was not restored")
    check(d_dw <= F32_U0_ATOL, "dense: the first wrench differs from the CPU f64 controller")

    def tr(t):
        return ("not measured" if t is None else
                f"{t['events']:.1f} device events, idle {t['idle']:.2%}")

    mean = lambda pair: sum(pair) / 2
    print(f"[wrapper graph] {label}: MPCController b{B} f32, each call captured at its first use "
          f"and replayed vs ctrl.core's eager methods on a cloned state over {WRAPPER_PERIODS} "
          f"periods with a reset: bitwise {bits}; one replayed run_mpc: K1 ran "
          f"{counted['ric_aug']} (as the kernel counts it), profiler K1 {mpc_trace['k1']:g}, "
          f"issued from the host {sum(issued.values())}; held "
          f"results unchanged by a later period: {held_same}; one period under no_host_sync: ok; "
          f"ms captured / eager (turns g e e g): tick (update_state + run_lowlevel + get_action) "
          f"{tick_ms[0][0]:.3f} {tick_ms[1][0]:.3f} {tick_ms[1][1]:.3f} {tick_ms[0][1]:.3f}, "
          f"run_mpc {mpc_ms[0][0]:.3f} {mpc_ms[1][0]:.3f} {mpc_ms[1][1]:.3f} {mpc_ms[0][1]:.3f}, "
          f"100 Hz period (set_command, run_mpc, {decim} ticks) {period_ms[0][0]:.3f} "
          f"{period_ms[1][0]:.3f} {period_ms[1][1]:.3f} {period_ms[0][1]:.3f}; "
          + "; ".join(f"{k} {tr(v)}" for k, v in traces.items())
          + f"; pool bytes {pools}; T1-newton tick captured / eager (turns) "
          f"{n_tick_ms[0][0]:.3f} {n_tick_ms[1][0]:.3f} {n_tick_ms[1][1]:.3f} "
          f"{n_tick_ms[0][1]:.3f} ms, graph {tr(n_traces['graph'])}, eager "
          f"{tr(n_traces['eager'])}; dense (adaptive_tol 0, LU under cuSOLVER) "
          f"b{DENSE_WRAPPER_ENVS} through the wrapper vs the eager core: tau bitwise {d_tau}, "
          f"leaves differing {d_differ}, captured {d_graphs}, preferred library after "
          f"{torch.backends.cuda.preferred_linalg_library()}; first wrench vs the CPU f64 "
          f"dense controller on 8 envs max |d| {d_dw:.3e} N (bound {F32_U0_ATOL})")
    out.update(tick_ms=mean(tick_ms[0]), tick_eager_ms=mean(tick_ms[1]), mpc_ms=mean(mpc_ms[0]),
               mpc_eager_ms=mean(mpc_ms[1]), period_ms=mean(period_ms[0]),
               period_eager_ms=mean(period_ms[1]), traces=traces, pools=pools)
    return out


# The captured control_step (`control_step_phase`): CONTROL_CALLS calls, each
# on a new state cloned from a rolling eager run, against the eager step; the
# call timed CONTROL_REPS times a turn, captured and eager.
CONTROL_CALLS = 10
CONTROL_REPS = 5


def control_step_phase(label: str, dev) -> dict:
    """`[control_step graph]`: `BipedControllerCore.control_step`, one CUDA
    graph captured at its first call and replayed (the counterpart of the JAX
    core's jitted step), against the eager step (`core._control_step`), for HECTOR
    on K1 (`pallas_ric_aug`), the hybrid (K2 + K1) and the T1 on K1, b4096
    f32: CONTROL_CALLS calls, each on a new state cloned from a rolling eager
    run (which takes a step of its own between them) with its own obs, give
    the eager step's tau, wrench and every state leaf bit for bit; the
    kernels ran once in each eager step, the warm-up and each replay, as
    they count themselves; one more call runs K1 (K1 and K2) once and issues
    nothing from the host, as the kernels count it and as the profiler sees
    it; the ms of a call captured and eager in turns, the device events and
    idle share of each, and the graph's pool bytes. Returns {tag: numbers}
    and the K1 / K2 runs of the phase."""
    import torch
    from biped_pympc_tpu_torch.control.controller import BipedControllerCore
    from biped_pympc_tpu_torch.ops import pdipm_cuda
    from biped_pympc_tpu_torch.utils.tree import leaves, tree_map

    out, runs = {}, {"ric_aug": 0, "ric": 0}
    per_call = {"default": {"ric_aug": 1}, "hybrid": {"ric_aug": 1, "ric": 1},
                "T1": {"ric_aug": 1}}
    for tag, robot_name, kw in (("default", "HECTOR", {}),
                                ("hybrid", "HECTOR", {"solver": "pallas_hybrid"}),
                                ("T1", "T1", {})):
        cconf, conf = controller_confs(robot_name, **kw)
        core = BipedControllerCore(cconf, conf, gait_id=2, device=dev)
        obs, twist, height = controller_inputs(robot_name, B, dev)
        eager = core.init_state(B)
        pdipm_cuda.reset_counts()
        bits = []
        for i in range(CONTROL_CALLS):
            obs_i = obs.clone()
            obs_i[:, 7] += 0.01 * i  # the body's forward velocity
            core._control_step(eager, obs_i, twist, height)
            mine = tree_map(torch.clone, eager)
            tau, mo = core.control_step(mine, obs_i, twist, height)
            tau_e, mo_e = core._control_step(eager, obs_i, twist, height)
            theirs = dict(leaves(eager))
            bits.append(same_bits(tau, tau_e) and same_bits(mo.wrench, mo_e.wrench)
                        and all(same_bits(t, theirs[p]) for p, t in leaves(mine)))
        torch.cuda.synchronize()
        ran = pdipm_cuda.runs()
        solves = 2 * CONTROL_CALLS + WARM_UP + CONTROL_CALLS
        check(all(bits), f"{tag}: the captured control_step differs from the eager one: {bits}")
        check(ran == route_counts(**{r: n * solves for r, n in per_call[tag].items()}),
              f"{tag}: the kernels ran {ran}, not {per_call[tag]} in each of {solves} solves")
        check(list(core.graphs) == [(B, torch.float32)], f"{tag}: graphs {list(core.graphs)}")

        # One more call: a replay runs the kernels once and issues nothing.
        mine = tree_map(torch.clone, eager)
        call = lambda: core.control_step(mine, obs, twist, height)
        step_eager = lambda: core._control_step(eager, obs, twist, height)
        pdipm_cuda.reset_counts()
        trace = device_trace(call, 1)
        counted, issued = pdipm_cuda.runs(), dict(pdipm_cuda.launches)
        check(trace is not None, f"{tag}: the profiler saw no device event in a replay")
        check(counted == route_counts(**per_call[tag]), f"{tag}: one replay ran {counted}")
        check(issued == route_counts(), f"{tag}: one replay issued {issued} from the host")
        check(trace["k1"] == sum(counted.values()),
              f"{tag}: the profiler saw {trace['k1']:g} PDIPM kernels in one replay")
        ms = in_turns(call, step_eager, CONTROL_REPS)
        eager_trace = device_trace(step_eager, 1)
        pool = core.graphs[(B, torch.float32)].loop.pool_bytes
        check(pool > 0, f"{tag}: the graph holds no pool")
        # Every K1 / K2 launch of the phase as the kernels count themselves:
        # the calls above, and the replay, the turns and the eager trace.
        total = pdipm_cuda.runs()
        for r in runs:
            runs[r] += ran[r] + total[r]
        out[tag] = {"bits": all(bits), "k1": counted, "ms": ms, "trace": trace,
                    "eager_trace": eager_trace, "pool": pool}

    def tr(t):
        return ("not measured" if t is None else
                f"{t['events']:.1f} device events, idle {t['idle']:.2%}")

    print(f"[control_step graph] {label}: BipedControllerCore.control_step b{B} f32 (set_command, "
          f"ingest_state, run_mpc, run_lowlevel, joint_torque), one CUDA graph captured at its "
          f"first call and replayed, vs the eager step over {CONTROL_CALLS} calls, each on a new "
          f"state cloned from a rolling eager run: "
          + "; ".join(
              f"{tag}: bitwise {o['bits']}, one replay ran {o['k1']} (the kernels' count), issued "
              f"0, profiler PDIPM kernels {o['trace']['k1']:g}; ms captured / eager (turns g e e "
              f"g) {o['ms'][0][0]:.3f} {o['ms'][1][0]:.3f} {o['ms'][1][1]:.3f} "
              f"{o['ms'][0][1]:.3f}; captured {tr(o['trace'])}, eager {tr(o['eager_trace'])}; "
              f"pool bytes {o['pool']}" for tag, o in out.items()))
    return {"phases": out, "runs": runs}


def quick(mode: str) -> int:
    """`--digests`: build the PDIPM kernels and print `route_digests` of
    this script's batch as one JSON line (it runs in a checkout of an
    earlier build too). `--geometry`: build, print the digests and their
    agreement with BEFORE_WARP_DIGESTS, run `geometry_phase` with its exploration,
    and hold K1 and K2 in the picked geometry against their plain versions
    at f64 on the converged envs. `--closed-loop`: build, then run
    `closed_loop_phases` alone. `--t1-extras`: build, then run
    `extras_phases` and `t1_phases` alone. `--wrapper`: build, then run
    `wrapper_phase` and `control_step_phase` alone."""
    import torch
    from biped_pympc_tpu_torch.bench import pdipm_geometry as pg
    from biped_pympc_tpu_torch.ops import pdipm, pdipm_cuda

    dev = torch.device("cuda:0")
    label = card_label()
    print(label)
    pdipm_cuda.build()
    opts = pdipm.PdipmOptions(backend="ric_aug", foot_split=True, refine_steps=1)
    qp32, qp64 = (make_qp_batch(B, 0, dt, dev) for dt in (torch.float32, torch.float64))
    if mode == "--closed-loop":
        closed_loop_phases(label, dev, qp32, qp64)
        return 0
    if mode == "--wrapper":
        t0 = time.perf_counter()
        wrapper_phase(label, dev)
        t1 = time.perf_counter()
        control_step_phase(label, dev)
        print(f"[elapsed] wrapper graph {t1 - t0:.1f}, control_step graph "
              f"{time.perf_counter() - t1:.1f} s")
        return 0
    if mode == "--t1-extras":
        t0 = time.perf_counter()
        extras_phases(label, dev, qp32, qp64)
        t1 = time.perf_counter()
        t1_phases(label, dev)
        print(f"[elapsed] ric_aug_core, mesh, drone {t1 - t0:.1f}, T1 "
              f"{time.perf_counter() - t1:.1f} s")
        return 0
    dig = route_digests(qp32, qp64, opts)
    print(json.dumps({"digests": dig}))
    if mode == "--digests":
        return 0
    same = {k: v == BEFORE_WARP_DIGESTS.get(k) for k, v in dig.items()}
    print(f"[digests] as recorded: {same}")
    geometry_phase(label, qp32, qp64, opts, explore=True)
    for r in pdipm_cuda.LEAN_ROUTES:
        o = pg.route_opts(r, opts)
        plain = pdipm.solve(qp64, o)
        kern = pdipm_cuda.solve(qp64, o)
        k32 = pdipm_cuda.solve(qp32, o)
        cv = plain.residuals[:, 3] <= MU_CONVERGED
        err = max(float((getattr(kern, n) - getattr(plain, n)).abs().amax(1)[cv].max())
                  for n in "xszy")
        rel = max(float(((getattr(kern, n) - getattr(plain, n)).abs()
                         / getattr(plain, n).abs().clamp_min(1.0)).amax(1)[cv].max())
                  for n in "xszy")
        fin = torch.isfinite(k32.x).all(1)
        du0 = (k32.x[:, 120:132].double() - plain.x[:, 120:132]).abs().amax(1)
        print(f"[geometry check] {r} {pdipm_cuda.geometry(r)}: f64 vs "
              f"plain f64 on {int(cv.sum())} converged envs max {err:.3e} abs, {rel:.3e} rel; "
              f"f32 finite {int(fin.sum())}/{B}, u0 |dGRF| converged finite max "
              f"{float(du0[cv & fin].max()):.3e} N, above 0.5 N {int((du0[fin] > 0.5).sum())}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:] and sys.argv[1:] not in (["--digests"], ["--geometry"], ["--closed-loop"],
                                             ["--t1-extras"], ["--wrapper"]):
        print(f"chip_smoke: takes no argument, --digests, --geometry, --closed-loop, "
              f"--t1-extras or --wrapper; got {sys.argv[1:]}", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        return quick(sys.argv[1])
    from biped_pympc_tpu_torch import ControllerConf, MPCConf, MPCController
    from biped_pympc_tpu_torch.control import mpc
    from biped_pympc_tpu_torch.models.hector import TORQUE_LIMIT
    from biped_pympc_tpu_torch.bench import pdipm_geometry as pg
    from biped_pympc_tpu_torch.ops import cuda_build, pdipm, pdipm_cuda
    from biped_pympc_tpu_torch.ops import qp as qps
    from biped_pympc_tpu_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    label = card_label()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {kind}; "
          f"devices visible {torch.cuda.device_count()}")
    print(label)

    # Seconds of each phase ([elapsed] line), so that a later phase can be
    # weighed against the script's time limit.
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    # 2. Build: one nvcc per kernel source, started together, each with
    # `-Xptxas -v` for the register report kept beside its library.
    t0 = time.perf_counter()
    lib_paths, k8_build = build_all()
    print(f"[build] nvcc {' '.join(cuda_build.NVCC_FLAGS)} -> {lib_paths} in "
          f"{time.perf_counter() - t0:.1f} s; the generated tape kernels build in the background")
    print(f"[registers] ptxas -v, sm_90a: {ptxas_report(lib_paths)}")
    print(f"[sass] {sass_report(lib_paths[-2])}")

    mark("build")

    # 3. K1 (augmented route) vs its plain version on the card, with the
    # controller's options (MPCConf defaults: the split "ric_aug" route, one
    # refinement pass; every other field at its default, gj_form "inplace").
    opts = pdipm.PdipmOptions(backend="ric_aug", foot_split=True, refine_steps=1)
    qp64 = make_qp_batch(B, 0, torch.float64, dev)
    qp32 = make_qp_batch(B, 0, torch.float32, dev)
    plain64 = pdipm.solve(qp64, opts)
    kern64 = pdipm_cuda.solve(qp64, opts)
    kern32 = pdipm_cuda.solve(qp32, opts)
    torch.cuda.synchronize()
    conv = (plain64.residuals[:, 3] <= MU_CONVERGED).cpu().numpy()
    n_conv = int(conv.sum())
    check(n_conv >= B // 10, f"only {n_conv} of {B} envs converged in the f64 reference")
    err64 = {n: (getattr(kern64, n) - getattr(plain64, n)).abs().amax(1).cpu().numpy()
             for n in "xszy"}
    res_rel = ((kern64.residuals - plain64.residuals).abs()
               / plain64.residuals.abs().clamp_min(1e-300)).amax(1).cpu().numpy()
    worst64 = max(float(e[conv].max()) for e in err64.values())
    all64 = max(float(e.max()) for e in err64.values())
    med64 = max(float(np.median(e)) for e in err64.values())
    print(f"[kernel f64 vs plain f64] b{B}: converged envs {n_conv}: max |dx,ds,dz,dy| "
          f"{worst64:.3e} (bound {F64_ATOL:g}), residual rel {res_rel[conv].max():.3e} "
          f"(bound {RES_RTOL:g}); all envs: max {all64:.3e}, median {med64:.3e}, "
          f"envs above bound {int(sum((e > F64_ATOL) for e in err64.values()).astype(bool).sum())}, "
          f"residual rel max {res_rel.max():.3e}")
    check(worst64 <= F64_ATOL, "f64 kernel differs from the plain version")
    check(float(res_rel[conv].max()) <= RES_RTOL, "f64 kernel residuals differ")
    check(med64 <= 1e-9, "f64 kernel differs from the plain version on the median env")

    finite = torch.isfinite(kern32.x).all(1).cpu().numpy()
    du0 = (kern32.x[:, 120:132].double() - plain64.x[:, 120:132]).abs().amax(1).cpu().numpy()
    print(f"[kernel f32 vs plain f64] u0 |dGRF| [N], converged finite envs "
          f"({int((conv & finite).sum())}): {quantiles(du0[conv & finite])} (bound {F32_U0_ATOL}); "
          f"all finite envs ({int(finite.sum())}/{B}): {quantiles(du0[finite])}, "
          f"above {F32_U0_ATOL} N: {int((du0[finite] > F32_U0_ATOL).sum())}")
    check(finite.mean() >= F32_FINITE_SHARE, f"f32 kernel finite on {finite.mean():.4f} of envs")
    check(float(du0[conv & finite].max()) <= F32_U0_ATOL, "f32 kernel GRF off on converged envs")

    # 4. K2 (condensed route) vs its plain version on the same batch. The
    # f32 condensed solve has a documented error and NaN tail under
    # randomization (biped_pympc_tpu/config.py:81-98): printed, not bounded.
    ric = dataclasses.replace(opts, backend="ric")
    ric_plain64 = pdipm.solve(qp64, ric)
    ric_kern64 = pdipm_cuda.solve(qp64, ric)
    ric_kern32 = pdipm_cuda.solve(qp32, ric)
    torch.cuda.synchronize()
    ric_conv = (ric_plain64.residuals[:, 3] <= MU_CONVERGED).cpu().numpy()
    ric_n_conv = int(ric_conv.sum())
    check(ric_n_conv >= B // 10, f"only {ric_n_conv} of {B} envs converged in the f64 ric reference")
    ric_err = np.max([(getattr(ric_kern64, n) - getattr(ric_plain64, n)).abs().amax(1).cpu().numpy()
                      for n in "xszy"], axis=0)
    ric_rel = np.max([((getattr(ric_kern64, n) - getattr(ric_plain64, n)).abs()
                       / getattr(ric_plain64, n).abs().clamp_min(1.0)).amax(1).cpu().numpy()
                      for n in "xszy"], axis=0)
    ric_res_rel = ((ric_kern64.residuals - ric_plain64.residuals).abs()
                   / ric_plain64.residuals.abs().clamp_min(1e-300)).amax(1).cpu().numpy()
    ric_worst64 = float(ric_err[ric_conv].max())
    print(f"[K2 f64 vs plain f64] b{B}: converged envs {ric_n_conv}: max |dx,ds,dz,dy| "
          f"{ric_rel[ric_conv].max():.3e} relative to max(1, |v|) (bound {CONDENSED_F64_RTOL:g}), "
          f"absolute {ric_worst64:.3e}, envs above {F64_ATOL:g} absolute "
          f"{int((ric_err[ric_conv] > F64_ATOL).sum())}, "
          f"residual rel {ric_res_rel[ric_conv].max():.3e} (bound {RES_RTOL:g}); all envs: "
          f"{quantiles(ric_err)}, above bound {int((ric_err > F64_ATOL).sum())}, "
          f"residual rel max {ric_res_rel.max():.3e}")
    check(float(ric_rel[ric_conv].max()) <= CONDENSED_F64_RTOL,
          "f64 K2 differs from the plain version")
    check(float(ric_res_rel[ric_conv].max()) <= RES_RTOL, "f64 K2 residuals differ")

    ric_finite = torch.isfinite(ric_kern32.x).all(1).cpu().numpy()
    ric_du0 = (ric_kern32.x[:, 120:132].double() - ric_plain64.x[:, 120:132]).abs().amax(1)
    ric_du0 = ric_du0.cpu().numpy()
    print(f"[K2 f32 vs plain f64] finite on {int(ric_finite.sum())}/{B} envs "
          f"({ric_finite.mean():.4%}); u0 |dGRF| [N], converged finite envs "
          f"({int((ric_conv & ric_finite).sum())}): {quantiles(ric_du0[ric_conv & ric_finite])}; "
          f"all finite envs: {quantiles(ric_du0[ric_finite])}, above {F32_U0_ATOL} N: "
          f"{int((ric_du0[ric_finite] > F32_U0_ATOL).sum())}")

    # 4a. K1 and K2 in the block group, the configuration before the warp
    # groups (BEFORE_WARP_DIGESTS holds its bits in 4m): against the same plain f64
    # solves, with the same bounds.
    blk64 = pg.solve_in(qp64, opts, pdipm_cuda.BLOCK)
    ric_blk64 = pg.solve_in(qp64, ric, pdipm_cuda.BLOCK)
    blk_err = max(float((getattr(blk64, n) - getattr(plain64, n)).abs().amax(1)[conv].max())
                  for n in "xszy")
    ric_blk_rel = max(float(((getattr(ric_blk64, n) - getattr(ric_plain64, n)).abs()
                             / getattr(ric_plain64, n).abs().clamp_min(1.0))
                            .amax(1)[ric_conv].max()) for n in "xszy")
    print(f"[block group f64 vs plain f64] b{B}: K1 converged envs max |dx,ds,dz,dy| "
          f"{blk_err:.3e} (bound {F64_ATOL:g}); K2 {ric_blk_rel:.3e} relative to max(1, |v|) "
          f"(bound {CONDENSED_F64_RTOL:g}); the picked geometry: K1 "
          f"{pdipm_cuda.geometry('ric_aug')}, K2 {pdipm_cuda.geometry('ric')}")
    check(blk_err <= F64_ATOL, "f64 K1 in the block group differs from the plain version")
    check(ric_blk_rel <= CONDENSED_F64_RTOL,
          "f64 K2 in the block group differs from the plain version")

    # 4b. K3: four warm 5-step launches vs one 20-step launch, both routes and
    # dtypes. The loop carries only (x, s, z, y) and the kernels compute
    # nothing from the iteration index or the start, so the bits must agree.
    def chunked(qp, opts_, n=4):
        step = dataclasses.replace(opts_, iterations=opts_.iterations // n)
        r = pdipm_cuda.solve(qp, step)
        for _ in range(n - 1):
            r = pdipm_cuda.solve(qp, step, pdipm.PdipmState(r.x, r.s, r.z, r.y))
        return r

    warm_line = []
    for tag, qp, opts_, fixed in (("K1 f32", qp32, opts, kern32), ("K1 f64", qp64, opts, kern64),
                                  ("K2 f32", qp32, ric, ric_kern32),
                                  ("K2 f64", qp64, ric, ric_kern64)):
        worst, differ = bit_diff(chunked(qp, opts_), fixed)
        warm_line.append(f"{tag} max |d| {worst:.3e}, envs differing in any bit {differ}")
        check(differ == 0, f"{tag}: 4 warm 5-step launches differ from one 20-step launch")
    print(f"[warm chunks] b{B}, 4 x 5 warm launches vs 1 x 20: " + "; ".join(warm_line))

    # 4c. The adaptive solve on the card: every launch issued at once, gated
    # by a device flag; run under the sync debug mode, so a wait raises.
    # A NaN anywhere in the residuals ends the loop for the whole batch, as
    # in the JAX package (ROADMAP, Queue 3): K2's f32 solve goes non-finite
    # on a few envs of this batch, so its cases run on the envs it keeps
    # finite, and the whole batch shows the early stop.
    ric_ok = torch.nonzero(torch.isfinite(ric_kern32.x).all(1)).flatten()
    ric_qp32 = qps.take(qp32, ric_ok)

    def adaptive_case(qp, opts_, tol):
        pdipm_cuda.reset_counts()
        with no_host_sync():
            res = pdipm_cuda.solve_adaptive(qp, opts_, tol)
        torch.cuda.synchronize()
        return res, pdipm_cuda.launches[opts_.backend], pdipm_cuda.chunks_ran()[opts_.backend]

    walk_chunks = {}
    for tag, qp_k, opts_ in (("K1", qp32, opts), ("K2", ric_qp32, ric)):
        five = dataclasses.replace(opts_, iterations=5)
        cap23 = dataclasses.replace(opts_, iterations=23)
        nan_qp = dataclasses.replace(qp_k, f=qp_k.f.clone())
        nan_qp.f[0, 0] = float("nan")
        cases = (("tol 0", qp_k, opts_, 0.0, pdipm_cuda.solve(qp_k, opts_), 4),
                 ("tol 1e12", qp_k, opts_, 1e12, pdipm_cuda.solve(qp_k, five), 1),
                 ("23 iterations", qp_k, cap23, 0.0, pdipm_cuda.solve(qp_k, cap23), 5),
                 ("NaN in env 0", nan_qp, opts_, 0.0, pdipm_cuda.solve(nan_qp, five), 1))
        line = [f"{qp_k.f.shape[0]} envs"]
        for name, qp, o, tol, want, want_ran in cases:
            res, issued, ran = adaptive_case(qp, o, tol)
            worst, differ = bit_diff(res, want)
            line.append(f"{name}: {ran} of {issued} launches ran, vs fixed max |d| {worst:.3e} "
                        f"differing envs {differ}")
            check(ran == want_ran, f"{tag} solve_adaptive {name}: {ran} chunks ran, "
                                   f"expected {want_ran}")
            check(differ == 0, f"{tag} solve_adaptive {name} differs from the fixed solve")
        check(bool(torch.isnan(res.residuals[0]).all()), f"{tag}: NaN env has finite residuals")
        _, issued, walk_chunks[tag] = adaptive_case(qp_k, opts_, WALK_TOL)
        line.append(f"tol {WALK_TOL:g}: {walk_chunks[tag]} of {issued} ran")
        if qp_k is not qp32:
            _, issued, ran = adaptive_case(qp32, opts_, 0.0)
            line.append(f"whole batch ({B - qp_k.f.shape[0]} envs non-finite at 20 steps), tol 0: "
                        f"{ran} of {issued} ran")
        print(f"[solve_adaptive {tag}] b{B} f32, no host sync: " + "; ".join(line))

    # K3 against its plain version: the f64 adaptive solve, kernel vs plain.
    ad64 = pdipm_cuda.solve_adaptive(qp64, opts, 0.0)
    ad_plain64 = pdipm.solve_adaptive_batch(qp64, opts, 0.0)
    k3_err = max(float((getattr(ad64, n) - getattr(ad_plain64, n)).abs().amax(1)[conv].max())
                 for n in "xszy")
    print(f"[K3 f64 vs plain f64] solve_adaptive tol 0, converged envs {n_conv}: max "
          f"|dx,ds,dz,dy| {k3_err:.3e} (bound {F64_ATOL:g})")
    check(k3_err <= F64_ATOL, "f64 adaptive kernel solve differs from the plain version")

    # 4d. K4: the compensated refinement residual on K1, through the public
    # solver entry `solve(qp, PdipmOptions(refine_residual="df"))`.
    df_opts = dataclasses.replace(opts, refine_residual="df")
    df_plain64 = pdipm.solve(qp64, df_opts)
    df64 = pdipm_cuda.solve(qp64, df_opts)
    df_conv = (df_plain64.residuals[:, 3] <= MU_CONVERGED).cpu().numpy()
    df_err = np.max([(getattr(df64, n) - getattr(df_plain64, n)).abs().amax(1).cpu().numpy()
                     for n in "xszy"], axis=0)
    df_worst64 = float(df_err[df_conv].max())
    short, short_df = (dataclasses.replace(o, iterations=DF_ITERS) for o in (opts, df_opts))
    df_vs_f32 = max(float((getattr(pdipm_cuda.solve(qp64, short_df), n)
                           - getattr(pdipm_cuda.solve(qp64, short), n)).abs().max())
                    for n in "xszy")
    df_vs_f32_20 = max(float((getattr(df64, n) - getattr(kern64, n)).abs().amax(1)[conv].max())
                       for n in "xszy")
    print(f"[K4 f64 vs plain f64] df residual, converged envs {int(df_conv.sum())}: max "
          f"|dx,ds,dz,dy| {df_worst64:.3e} (bound {F64_ATOL:g}); all envs {quantiles(df_err)}; "
          f"df vs f32 residual kernel at f64, {DF_ITERS} steps, all envs: {df_vs_f32:.3e} "
          f"(bound {DF_F64_ATOL:g}), 20 steps, converged envs: {df_vs_f32_20:.3e}")
    check(df_worst64 <= F64_ATOL, "f64 df kernel differs from the plain df version")
    check(df_vs_f32 <= DF_F64_ATOL, "f64 df kernel differs from the f32-residual kernel")

    pdipm_cuda.reset_counts()
    df32 = pdipm_cuda.solve(qp32, df_opts)
    torch.cuda.synchronize()
    df_launches = pdipm_cuda.launches["ric_aug"]
    check(df_launches == 1, "the df solve did not launch K1")
    df_finite = torch.isfinite(df32.x).all(1).cpu().numpy()
    df_du0 = (df32.x[:, 120:132].double() - plain64.x[:, 120:132]).abs().amax(1).cpu().numpy()
    print(f"[K4 f32 vs plain f64] u0 |dGRF| [N], converged finite envs "
          f"({int((conv & df_finite).sum())}): {quantiles(df_du0[conv & df_finite])} (bound "
          f"{F32_U0_ATOL}); all finite envs ({int(df_finite.sum())}/{B}): "
          f"{quantiles(df_du0[df_finite])}, above {F32_U0_ATOL} N: "
          f"{int((df_du0[df_finite] > F32_U0_ATOL).sum())}; K1 f32 residual on the same envs: "
          f"{quantiles(du0[finite])}, above {F32_U0_ATOL} N: "
          f"{int((du0[finite] > F32_U0_ATOL).sum())}; df launches {df_launches}")
    check(df_finite.mean() >= F32_FINITE_SHARE, f"f32 df kernel finite on {df_finite.mean():.4f}")
    check(float(df_du0[conv & df_finite].max()) <= F32_U0_ATOL,
          "f32 df kernel GRF off on converged envs")

    # 4e. K4's arithmetic where it matters. At the solve level df and the f32
    # residual agree to within what two roundings of the rest of a Newton
    # step differ by, so no bound on a solve can tell a working df from one
    # that lost its compensation: those readings are printed. The residual
    # itself, through K1's own device code on the cancellation case, is held
    # against the plain df version (every error-free step its own torch op);
    # the kernel's f32 residual is the control that must fail that bound.
    two, two_df = (dataclasses.replace(o, iterations=2) for o in (opts, df_opts))
    two_plain_df = pdipm.solve(qp32, two_df)
    solve_gap = lambda a: max(float((getattr(a, n) - getattr(two_plain_df, n)).abs().max())
                              for n in "xszy")
    res_line = [f"2-step f32 solve vs plain df: df kernel "
                f"{solve_gap(pdipm_cuda.solve(qp32, two_df)):.3e}, f32-residual kernel "
                f"{solve_gap(pdipm_cuda.solve(qp32, two)):.3e} (printed)"]
    for tag, qp_k in (("f32", qp32), ("f64", qp64)):
        w, dirs, rhs, exact = cancellation_case(qp_k, 3)
        pdipm_cuda.reset_counts()
        k_df = pdipm_cuda.refine_residual(qp_k, w, *dirs, *rhs, df_opts)
        k_f32 = pdipm_cuda.refine_residual(qp_k, w, *dirs, *rhs, opts)
        check(pdipm_cuda.residual_launches["ric_aug"] == 2,
              "the residual check did not launch K1's residual entry")
        p_df = pdipm.refine_residual_aug(qp_k, qps.h_diag(qp_k), w, df_opts, *dirs, *rhs)
        rel = lambda a, b: max(float((u.double() - v.double()).abs().max() / e.abs().max())
                               for u, v, e in zip(a, b, exact))
        bits = sum(int((u != v).sum()) for u, v in zip(k_df, p_df))
        got, control = rel(k_df, p_df), rel(k_f32, p_df)
        res_line.append(f"{tag} residual, b{B}: df kernel vs plain df {got:.3e} (bound "
                        f"{DF_RES_RTOL[tag]:g}; entries differing in any bit {bits}), f32-residual "
                        f"kernel vs plain df {control:.3e} (control)")
        check(got <= DF_RES_RTOL[tag], f"{tag} df residual kernel differs from its plain version")
        check(control > DF_RES_RTOL[tag],
              f"{tag} control: the f32 residual meets the df bound, so the check cannot fail")
        if tag == "f32":
            # Against the float64 residual, tests/test_pdipm.py::
            # test_df_residual_accuracy's bounds. (In f64 that reference rounds
            # as finely as the kernel's own residual, so it is left out.)
            to_exact, control_exact = rel(k_df, exact), rel(k_f32, exact)
            res_line.append(f"vs the f64 residual: df kernel {to_exact:.3e}, f32-residual kernel "
                            f"{control_exact:.3e}")
            check(to_exact <= 1e-6 and to_exact <= control_exact / 100,
                  "f32 df residual kernel is not compensated")
    print("[K4 residual] relative to each component's largest f64 residual: "
          + "; ".join(res_line))

    mark("K1-K4")

    # 4f. K5a and K5b, the block-Thomas routes, vs their plain versions on the
    # same batch. K5b is the robust class (bounded in f32 as K1); K5a is the
    # condensed class (its f32 line printed, as K2's).
    def vs_plain64(tag, opts_, rtol=None, converged=True):
        """f64 kernel vs f64 plain version: bounds on the converged envs (or,
        `converged` False, on every env the plain version keeps finite), the
        tail printed; the bound is F64_ATOL absolute, or `rtol` relative to
        max(1, |v|) when given. Returns (kernel f64 result, plain f64,
        mask of the bounded envs, worst bounded-env absolute error)."""
        plain = pdipm.solve(qp64, opts_)
        kern = pdipm_cuda.solve(qp64, opts_)
        torch.cuda.synchronize()
        if converged:
            cv = (plain.residuals[:, 3] <= MU_CONVERGED).cpu().numpy()
        else:
            cv = torch.isfinite(torch.cat(results(plain), 1)).all(1).cpu().numpy()
        check(int(cv.sum()) >= B // 10, f"only {int(cv.sum())} of {B} envs to hold in the "
                                        f"f64 {tag} reference")
        diff = {n: (getattr(kern, n) - getattr(plain, n)).abs() for n in "xszy"}
        err = np.max([d.amax(1).cpu().numpy() for d in diff.values()], axis=0)
        err_rel = np.max([(d / getattr(plain, n).abs().clamp_min(1.0)).amax(1).cpu().numpy()
                          for n, d in diff.items()], axis=0)
        rel = ((kern.residuals - plain.residuals).abs()
               / plain.residuals.abs().clamp_min(1e-300)).amax(1).cpu().numpy()
        worst, worst_rel = float(err[cv].max()), float(err_rel[cv].max())
        bounded = f"{worst_rel:.3e} relative to max(1, |v|) (bound {rtol:g}), absolute {worst:.3e}" \
            if rtol else f"{worst:.3e} (bound {F64_ATOL:g}), relative to max(1, |v|) {worst_rel:.3e}"
        print(f"[{tag} f64 vs plain f64] b{B} {pdipm_cuda.route(opts_)}"
              f"{' jacobi' if opts_.kkt_scale == 'jacobi' else ''}, {opts_.iterations} steps: "
              f"{'converged' if converged else 'finite'} envs {int(cv.sum())}: max "
              f"|dx,ds,dz,dy| {bounded}, envs above {F64_ATOL:g} absolute "
              f"{int((err[cv] > F64_ATOL).sum())}, residual rel {rel[cv].max():.3e} (bound "
              f"{RES_RTOL:g}); all envs: {quantiles(err)}, above {F64_ATOL:g} "
              f"{int((err > F64_ATOL).sum())}, residual rel max {rel.max():.3e}")
        check(worst_rel <= rtol if rtol else worst <= F64_ATOL,
              f"f64 {tag} differs from the plain version")
        check(float(rel[cv].max()) <= RES_RTOL, f"f64 {tag} residuals differ")
        return kern, plain, cv, worst

    def f32_tail(kern, plain, cv):
        """(finite envs, u0 |dGRF| per env, summary) of an f32 solve against
        the f64 plain version."""
        fin = torch.isfinite(kern.x).all(1).cpu().numpy()
        d = (kern.x[:, 120:132].double() - plain.x[:, 120:132]).abs().amax(1).cpu().numpy()
        return fin, d, (f"finite on {int(fin.sum())}/{B} envs ({fin.mean():.4%}); u0 |dGRF| [N], "
                        f"converged finite envs ({int((cv & fin).sum())}): {quantiles(d[cv & fin])}")

    def f32_vs_plain64(tag, kern, plain, cv, bounded):
        fin, d, summary = f32_tail(kern, plain, cv)
        print(f"[{tag} f32 vs plain f64] {summary}{f' (bound {F32_U0_ATOL})' if bounded else ''}; "
              f"all finite envs: {quantiles(d[fin])}, above {F32_U0_ATOL} N: "
              f"{int((d[fin] > F32_U0_ATOL).sum())}")
        if bounded:
            check(fin.mean() >= F32_FINITE_SHARE, f"f32 {tag} finite on {fin.mean():.4f} of envs")
            check(float(d[cv & fin].max()) <= F32_U0_ATOL, f"f32 {tag} GRF off on converged envs")

    def roundoff(tag, opts_, plain, cv):
        """The route's own roundoff sensitivity: its plain version run on the
        CPU (other summation orders) against the same on the card."""
        idx = torch.nonzero(torch.as_tensor(cv, device=dev)).flatten()
        cpu = pdipm.solve(qp_map(qps.take(qp64, idx), lambda v: v.cpu()), opts_)
        gap = {n: (getattr(cpu, n) - getattr(plain, n)[idx].cpu()).abs() for n in "xszy"}
        worst = max(float(g.max()) for g in gap.values())
        rel = max(float((g / getattr(cpu, n).abs().clamp_min(1.0)).max()) for n, g in gap.items())
        print(f"[{tag} roundoff] plain {tag} f64 on the CPU vs on the card, converged envs "
              f"{len(idx)}: max |dx,ds,dz,dy| {worst:.3e}, relative to max(1, |v|) {rel:.3e} "
              f"(printed: two correct roundings of the route)")
        return worst, rel

    roundoff("K2", ric, ric_plain64, ric_conv)
    thomas = {"K5b": dataclasses.replace(opts, backend="tridiag_aug", foot_split=False),
              "K5a": dataclasses.replace(opts, backend="tridiag", foot_split=False)}
    k5 = {}
    for tag, opts_ in thomas.items():
        kern64_, plain64_, cv_, worst_ = vs_plain64(tag, opts_,
                                                    CONDENSED_F64_RTOL if tag == "K5a" else None)
        if tag == "K5a":
            roundoff(tag, opts_, plain64_, cv_)
        kern32_ = pdipm_cuda.solve(qp32, opts_)
        f32_vs_plain64(tag, kern32_, plain64_, cv_, bounded=tag == "K5b")
        if tag == "K5a":  # the condensed class's f32 tail in the block group, beside;
            # its u0 tail is printed, its finite share bounded
            blk32 = f32_tail(pg.solve_in(qp32, opts_, pdipm_cuda.BLOCK), plain64_, cv_)[2]
            print(f"[K5a f32 block group vs plain f64] {blk32} (printed)")
            fin32 = f32_tail(kern32_, plain64_, cv_)[0]
            check(fin32.mean() >= F32_FINITE_SHARE, f"f32 K5a finite on {fin32.mean():.4f} of envs")
        k5[tag] = {"f64": kern64_, "f32": kern32_, "err": worst_, "plain": plain64_, "cv": cv_}

    # 4g. K3 on K5a and K5b: four warm 5-step launches vs one 20-step launch.
    warm_line = []
    for tag, opts_ in thomas.items():
        for dt, qp in (("f32", qp32), ("f64", qp64)):
            worst, differ = bit_diff(chunked(qp, opts_), k5[tag][dt])
            warm_line.append(f"{tag} {dt} max |d| {worst:.3e}, envs differing in any bit {differ}")
            check(differ == 0, f"{tag} {dt}: 4 warm 5-step launches differ from one 20-step launch")
    print(f"[warm chunks K5] b{B}, 4 x 5 warm launches vs 1 x 20: " + "; ".join(warm_line))

    # 4h. K5b with the compensated residual: the device function the
    # [K4 residual] phase holds bit for bit against plain df.
    k5_df = dataclasses.replace(thomas["K5b"], refine_residual="df")
    pdipm_cuda.reset_counts()
    k5df64 = pdipm_cuda.solve(qp64, k5_df)
    k5df32 = pdipm_cuda.solve(qp32, k5_df)
    torch.cuda.synchronize()
    check(pdipm_cuda.launches == route_counts(tridiag_aug=2), "the df solves did not launch K5b")
    k5df_plain64 = pdipm.solve(qp64, k5_df)
    k5df_cv = (k5df_plain64.residuals[:, 3] <= MU_CONVERGED).cpu().numpy()
    k5df_err = np.max([(getattr(k5df64, n) - getattr(k5df_plain64, n)).abs().amax(1).cpu().numpy()
                       for n in "xszy"], axis=0)
    k5df_fin = torch.isfinite(k5df32.x).all(1).cpu().numpy()
    k5df_du0 = (k5df32.x[:, 120:132].double() - k5df_plain64.x[:, 120:132]).abs().amax(1)
    k5df_du0 = k5df_du0.cpu().numpy()
    print(f"[K5b df] f64 vs plain df f64, converged envs {int(k5df_cv.sum())}: max |dx,ds,dz,dy| "
          f"{float(k5df_err[k5df_cv].max()):.3e} (bound {F64_ATOL:g}); all envs "
          f"{quantiles(k5df_err)}; f32 finite on {int(k5df_fin.sum())}/{B}, u0 vs plain df f64 on "
          f"converged finite envs {quantiles(k5df_du0[k5df_cv & k5df_fin])}, above {F32_U0_ATOL} N "
          f"over all finite envs: {int((k5df_du0[k5df_fin] > F32_U0_ATOL).sum())}")
    check(float(k5df_err[k5df_cv].max()) <= F64_ATOL, "f64 K5b df differs from the plain df")
    check(k5df_fin.mean() >= F32_FINITE_SHARE, "f32 K5b df not finite")

    def max_gap(a, b, mask):
        return max(float((getattr(a, n) - getattr(b, n)).abs().amax(1)[mask].max())
                   for n in "xszy") if bool(mask.any()) else float("nan")

    def rel_gap(a, b, mask):
        """max_gap relative to max(1, |v|) of `b`."""
        return max(float(((getattr(a, n) - getattr(b, n)).abs()
                          / getattr(b, n).abs().clamp_min(1.0)).amax(1)[mask].max())
                   for n in "xszy")

    # 4j. K5c (rank-2, condensed), K5d-c (unsplit 14-wide, condensed) and
    # K5d-a (unsplit 30-wide, augmented) vs their plain versions, each in its
    # warp group. K5d-a is the robust class (bounded in f32 as K1); the
    # condensed pair is bounded in f64 as K5a, with its roundoff witness, and
    # its f32 lines are printed, as K2's, the block group's beside the warp
    # group's on the same envs (so that a redesign that amplifies f32
    # rounding shows).
    riccati = {"K5c": dataclasses.replace(opts, backend="ric2", foot_split=False),
               "K5d-c": dataclasses.replace(opts, backend="ric", foot_split=False),
               "K5d-a": dataclasses.replace(opts, backend="ric_aug", foot_split=False)}
    k5n = {}
    for tag, opts_ in riccati.items():
        condensed = tag != "K5d-a"
        kern64_, plain64_, cv_, worst_ = vs_plain64(tag, opts_,
                                                    CONDENSED_F64_RTOL if condensed else None)
        if condensed:
            roundoff(tag, opts_, plain64_, cv_)
        kern32_ = pdipm_cuda.solve(qp32, opts_)
        f32_vs_plain64(tag, kern32_, plain64_, cv_, bounded=tag == "K5d-a")
        if condensed:
            blk32 = f32_tail(pg.solve_in(qp32, opts_, pdipm_cuda.BLOCK), plain64_, cv_)[2]
            print(f"[{tag} f32 block group vs plain f64] {blk32} (printed)")
        k5n[tag] = {"f64": kern64_, "f32": kern32_, "err": worst_, "plain": plain64_, "cv": cv_}

    # K5b, K5d-a, K5c and K5d-c in the block group, the parent's kernels
    # (their bits in 7b), against the same plain f64 solves, with the same
    # bounds: F64_ATOL absolute, or CONDENSED_F64_RTOL relative to max(1,
    # |v|) for the condensed K5c and K5d-c (the warp group's reading beside).
    blk_line = []
    for tag, runs in (("K5b", k5["K5b"]), ("K5d-a", k5n["K5d-a"]), ("K5c", k5n["K5c"]),
                      ("K5d-c", k5n["K5d-c"])):
        o = thomas[tag] if tag == "K5b" else riccati[tag]
        condensed = tag in ("K5c", "K5d-c")
        blk = pg.solve_in(qp64, o, pdipm_cuda.BLOCK)
        cv_ = torch.as_tensor(runs["cv"], device=dev)
        plain_ = runs["plain"]
        e = (rel_gap(blk, plain_, cv_) if condensed else max_gap(blk, plain_, cv_))
        warp_e = rel_gap(runs["f64"], plain_, cv_) if condensed else runs["err"]
        w_, differ = bit_diff(runs["f64"], blk)
        blk_line.append(f"{tag} {e:.3e}{' relative' if condensed else ''} (bound "
                        f"{CONDENSED_F64_RTOL if condensed else F64_ATOL:g}; warp group "
                        f"{warp_e:.3e}; the two part by {w_:.3e} on {differ} envs)")
        check(e <= (CONDENSED_F64_RTOL if condensed else F64_ATOL),
              f"f64 {tag} in the block group differs from the plain version")
    print(f"[block group f64 vs plain f64] b{B}, converged envs, max |dx,ds,dz,dy|: "
          + "; ".join(blk_line))

    # 4k. Jacobi equilibration (kkt_scale="jacobi") on K1 and K5d-c: f64
    # kernel vs f64 plain version (same scaling) within the route's bound,
    # and the f32 u0 tail beside the unscaled kernel's on the same envs.
    jacobi = {"K1 jacobi": (opts, kern32, None),
              "K5d-c jacobi": (riccati["K5d-c"], k5n["K5d-c"]["f32"], CONDENSED_F64_RTOL)}
    for tag, (base, unscaled32, rtol) in jacobi.items():
        opts_ = dataclasses.replace(base, kkt_scale="jacobi")
        _, plain64_, cv_, _ = vs_plain64(tag, opts_, rtol)
        scaled = f32_tail(pdipm_cuda.solve(qp32, opts_), plain64_, cv_)[2]
        unscaled = f32_tail(unscaled32, plain64_, cv_)[2]
        print(f"[{tag} f32 vs plain f64] jacobi: {scaled}; unscaled: {unscaled} (printed)")

    # 4l. K3 on the new kernels: four warm 5-step launches vs one 20-step one.
    warm_line = []
    for tag, opts_ in riccati.items():
        for dt, qp in (("f32", qp32), ("f64", qp64)):
            worst, differ = bit_diff(chunked(qp, opts_), k5n[tag][dt])
            warm_line.append(f"{tag} {dt} max |d| {worst:.3e}, envs differing in any bit {differ}")
            check(differ == 0, f"{tag} {dt}: 4 warm 5-step launches differ from one 20-step launch")
    print(f"[warm chunks K5c/K5d] b{B}, 4 x 5 warm launches vs 1 x 20: " + "; ".join(warm_line))

    mark("K5a-K5d")

    # 4n. K5e, the packed foot-split routes (foot_pack True: the paired
    # elimination's arithmetic on each stage pair; "apply": each half
    # inverted as the unpacked route does, stored packed), each in its warp
    # group, against K2 / K1 on this batch (largest difference, envs that
    # differ in any bit: per foot the arithmetic is theirs, the Bd K^-1 Bd^T
    # sum is the packed one) and against their plain packed versions at f64
    # on the converged envs, bounded as the route's class (K5e-a as K1,
    # K5e-c relative as the condensed routes); then four warm 5-step
    # launches vs one of 20. K5e-c also in its block group, the parent's
    # kernel (its bits in 7b): held to the same f64 bound, its f32 tail
    # printed beside the warp group's, and the digests of the two groups
    # against each other and K2's: under gj_form "inplace" each packing is
    # K2's arithmetic, and K5e-c's warp group sums mu and the residual norms
    # in the block group's order (`block_order_sum`), so both of its groups
    # give the bits of K2's block group; K2's warp group sums in its own.
    unpacked = {"ric": (ric, {"f32": ric_kern32, "f64": ric_kern64}, "K2"),
                "ric_aug": (opts, {"f32": kern32, "f64": kern64}, "K1")}
    ric_blk = {"f32": pg.solve_in(qp32, ric, pdipm_cuda.BLOCK), "f64": ric_blk64}
    k5e, warm_line = {}, []
    for backend, (base, twin_runs, twin) in unpacked.items():
        for pack in (True, "apply"):
            tag = f"K5e-{'c' if backend == 'ric' else 'a'} {'pair' if pack is True else 'apply'}"
            o = dataclasses.replace(base, foot_pack=pack)
            kern64_, plain64_, cv_, worst_ = vs_plain64(
                tag, o, CONDENSED_F64_RTOL if backend == "ric" else None)
            kern32_ = pdipm_cuda.solve(qp32, o)
            f32_vs_plain64(tag, kern32_, plain64_, cv_, bounded=backend == "ric_aug")
            runs = {"f32": kern32_, "f64": kern64_}
            line = []
            for dt in ("f32", "f64"):
                worst, differ = bit_diff(runs[dt], twin_runs[dt])
                line.append(f"{dt} max |d| {worst:.3e}, envs differing in any bit {differ}")
                w_worst, w_differ = bit_diff(chunked(qp32 if dt == "f32" else qp64, o), runs[dt])
                warm_line.append(f"{tag} {dt} max |d| {w_worst:.3e}, envs differing {w_differ}")
                check(w_differ == 0, f"{tag} {dt}: 4 warm 5-step launches differ from one of 20")
            print(f"[{tag} vs {twin}] b{B}, same batch: " + "; ".join(line))
            if backend == "ric":
                blk = {"f32": pg.solve_in(qp32, o, pdipm_cuda.BLOCK),
                       "f64": pg.solve_in(qp64, o, pdipm_cuda.BLOCK)}
                same = lambda a, b: digest(results(a)) == digest(results(b))
                cv_t = torch.as_tensor(cv_, device=dev)
                blk_rel = rel_gap(blk["f64"], plain64_, cv_t)
                pair_same = {f"{dt} {name}": same(a, b) for dt in ("f32", "f64") for name, a, b in (
                    ("warp group = own block group", runs[dt], blk[dt]),
                    ("block group = K2 block group", blk[dt], ric_blk[dt]),
                    ("warp group = K2 warp group", runs[dt], twin_runs[dt]))}
                plains = rel_gap(plain64_, ric_plain64, cv_t)
                print(f"[{tag} digests] b{B}, gj_form {o.gj_form}: {pair_same}; its plain version "
                      f"and K2's part by {plains:.3e} relative to max(1, |v|) on the converged "
                      f"envs; the block group "
                      f"f64 vs plain f64 on the converged envs {blk_rel:.3e} relative to max(1, "
                      f"|v|) (bound {CONDENSED_F64_RTOL:g}); f32 block group "
                      f"{f32_tail(blk['f32'], plain64_, cv_)[2]}, warp group "
                      f"{f32_tail(kern32_, plain64_, cv_)[2]} (printed)")
                check(blk_rel <= CONDENSED_F64_RTOL,
                      f"f64 {tag} in the block group differs from the plain version")
                check(o.gj_form != "inplace" or all(v for k, v in pair_same.items()
                                                    if "K2 warp" not in k),
                      f"{tag}: a group does not give the bits of K2's block group: {pair_same}")
            k5e[tag] = {"opts": o, "f32": kern32_, "f64": kern64_, "err": worst_}
    print(f"[warm chunks K5e] b{B}, 4 x 5 warm launches vs 1 x 20: " + "; ".join(warm_line))

    mark("K5e")

    # 4o. K5f, the Gauss-Jordan form and pivot knobs. gj_form "inplace" (the
    # default: the pivot row times the pivot's reciprocal) vs "tableau" (the
    # pivot row divided) on every Riccati route, bits and largest difference;
    # k_pivot on K5d-c and aug_pivot=False on K1, K5d-a and K5e-a against
    # their plain versions at f64. Natural order gives NaN on the augmented
    # blocks in f32 (BENCH.md:219-229) and, in f64, amplifies the rounding
    # of each elimination step: the plain version in the two forms parts by
    # 6.3e-3 after 20 steps on the converged envs (CPU, PERF.md, Findings).
    # So aug_pivot=False is held after SHORT_STEPS steps on every env both
    # sides keep finite, and its 20-step reading on the converged envs is
    # printed beside that witness (`form_witness`).
    forms = {"K1": opts, "K2": ric, "K5c": riccati["K5c"], "K5d-c": riccati["K5d-c"],
             "K5d-a": riccati["K5d-a"], "K5e-c": dataclasses.replace(ric, foot_pack="apply"),
             "K5e-a": dataclasses.replace(opts, foot_pack="apply")}
    tableau, line = {}, []
    for tag, o in forms.items():
        for dt, qp in (("f32", qp32), ("f64", qp64)):
            tableau[tag, dt] = pdipm_cuda.solve(qp, dataclasses.replace(o, gj_form="tableau"))
            worst, differ = bit_diff(pdipm_cuda.solve(qp, o), tableau[tag, dt])
            line.append(f"{tag} {dt} max |d| {worst:.3e}, envs differing {differ}")
    print(f"[K5f gj_form] b{B}, inplace vs tableau: " + "; ".join(line))
    kpiv = dataclasses.replace(riccati["K5d-c"], k_pivot=True)
    _, _, _, kpiv_err = vs_plain64("K5f k_pivot K5d-c", kpiv, CONDENSED_F64_RTOL)
    finite = lambda r: torch.isfinite(torch.cat(results(r), 1)).all(1)
    nopivot = {"K1": dataclasses.replace(opts, aug_pivot=False),
               "K5d-a": dataclasses.replace(riccati["K5d-a"], aug_pivot=False),
               "K5e-a": dataclasses.replace(opts, foot_pack=True, aug_pivot=False)}
    nopivot_err = {}

    def form_witness(tag, opts_, plain, mask):
        """The route's sensitivity to the rounding of its eliminations: its
        plain f64 version in the other Gauss-Jordan form against `plain`.
        Returns (absolute, relative) as `max_gap`, `rel_gap`."""
        other = "tableau" if opts_.gj_form == "inplace" else "inplace"
        alt = pdipm.solve(qp64, dataclasses.replace(opts_, gj_form=other))
        mask = torch.as_tensor(mask, device=dev)
        worst, rel = max_gap(alt, plain, mask), rel_gap(alt, plain, mask)
        print(f"[{tag} form witness] plain f64 {other} vs {opts_.gj_form}, {opts_.iterations} "
              f"steps, envs {int(mask.sum())}: max |dx,ds,dz,dy| {worst:.3e}, relative to max(1, "
              f"|v|) {rel:.3e} (printed: two correct roundings of the route)")
        return worst, rel

    for tag, o in nopivot.items():
        plain = pdipm.solve(qp64, o)
        kern = pdipm_cuda.solve(qp64, o)
        kern32_ = pdipm_cuda.solve(qp32, o)
        short = dataclasses.replace(o, iterations=SHORT_STEPS)
        plain_s, kern_s = pdipm.solve(qp64, short), pdipm_cuda.solve(qp64, short)
        torch.cuda.synchronize()
        cv = finite(kern) & finite(plain) & (plain.residuals[:, 3] <= MU_CONVERGED)
        held = finite(kern_s) & finite(plain_s)
        err20, err = max_gap(kern, plain, cv), max_gap(kern_s, plain_s, held)
        nopivot_err[tag] = err
        print(f"[K5f aug_pivot=False {tag}] b{B} {pdipm_cuda.route(o)}: finite envs at 20 steps "
              f"kernel f64 {int(finite(kern).sum())}, plain f64 {int(finite(plain).sum())}, kernel "
              f"f32 {int(finite(kern32_).sum())} of {B}; {SHORT_STEPS} steps, envs both finite "
              f"{int(held.sum())}: max |dx,ds,dz,dy| {err:.3e} (bound {F64_ATOL:g}); 20 steps, "
              f"converged envs both finite {int(cv.sum())}: {err20:.3e} (printed)")
        form_witness(f"K5f aug_pivot=False {tag}", o, plain, cv)
        check(int(held.sum()) >= B // 10 and err <= F64_ATOL,
              f"f64 {tag} aug_pivot=False differs from plain")

    # 4p. K5g, the step variants of the one Newton-step body: each corrector
    # form, the refinement schedule and the sigma cap (the JAX package's
    # diagnostic value), f64 kernel vs f64 plain on the converged envs, the
    # f32 u0 tail printed, and how far each moves its route's default solve
    # (the option acts). These variants leave a reduced solve unrefined or
    # cap the barrier, and their paths part with rounding as the route's
    # default does not: K1 combined read 3.263e-6 absolute where two
    # roundings of its plain version part by 5.102e-6, aff_ref 4.856e-5
    # (PERF.md, Findings). So each is bounded by the larger of its route's
    # class bound and WITNESS_FACTOR times such a witness, measured here: its
    # plain version in the other Gauss-Jordan form (K1, K2), or on the CPU
    # (K5a, which has no Gauss-Jordan step). Under the cap the 20-step rule
    # converges on no env (mu >= 1e-3 on 512 of these envs, CPU f64): the
    # capped variants are held after SHORT_STEPS steps on every env the
    # plain version keeps finite.
    variants = {"K1 combined": dataclasses.replace(opts, corrector_form="combined"),
                "K1 sum_refine": dataclasses.replace(opts, corrector_form="sum_refine"),
                "K1 aff_ref": dataclasses.replace(opts, corrector_form="aff_ref"),
                "K5a combined": dataclasses.replace(thomas["K5a"], corrector_form="combined"),
                "K1 refine_skip_iters=10": dataclasses.replace(opts, refine_skip_iters=10),
                "K1 sigma_cap=1e6": dataclasses.replace(opts, sigma_cap=1e6),
                "K2 sigma_cap=1e6": dataclasses.replace(ric, sigma_cap=1e6)}
    defaults = {"K1": opts, "K2": ric, "K5a": thomas["K5a"]}
    k5g = {}
    for tag, o in variants.items():
        route_tag = tag.split()[0]
        condensed = route_tag in ("K2", "K5a")
        held = dataclasses.replace(o, iterations=SHORT_STEPS) if o.sigma_cap > 0 else o
        pdipm_cuda.reset_counts()
        kern64_, kern32_ = pdipm_cuda.solve(qp64, held), pdipm_cuda.solve(qp32, held)
        torch.cuda.synchronize()
        launched = sum(pdipm_cuda.launches.values())
        plain64_ = pdipm.solve(qp64, held)
        cv_ = finite(plain64_) if o.sigma_cap > 0 else plain64_.residuals[:, 3] <= MU_CONVERGED
        check(int(cv_.sum()) >= B // 10, f"only {int(cv_.sum())} envs to hold K5g {tag} on")
        worst_, worst_rel = max_gap(kern64_, plain64_, cv_), rel_gap(kern64_, plain64_, cv_)
        res_rel = float(((kern64_.residuals - plain64_.residuals).abs()
                         / plain64_.residuals.abs().clamp_min(1e-300)).amax(1)[cv_].max())
        w_abs, w_rel = (roundoff(f"K5g {tag}", held, plain64_, cv_.cpu().numpy())
                        if route_tag == "K5a" else form_witness(f"K5g {tag}", held, plain64_, cv_))
        err, floor_, witness = ((worst_rel, CONDENSED_F64_RTOL, w_rel) if condensed
                                else (worst_, F64_ATOL, w_abs))
        bound_ = max(floor_, WITNESS_FACTOR * witness)
        moved, acts = bit_diff(kern64_, pdipm_cuda.solve(
            qp64, dataclasses.replace(defaults[route_tag], iterations=held.iterations)))
        print(f"[K5g {tag} f64 vs plain f64] b{B} {pdipm_cuda.route(o)}, {held.iterations} steps, "
              f"{'finite' if o.sigma_cap > 0 else 'converged'} envs {int(cv_.sum())}: max "
              f"|dx,ds,dz,dy| {worst_:.3e}, relative to max(1, |v|) {worst_rel:.3e} (bound "
              f"{bound_:.3e} {'relative' if condensed else 'absolute'}: the larger of {floor_:g} "
              f"and {WITNESS_FACTOR} x the witness), residual rel {res_rel:.3e} (bound "
              f"{RES_RTOL:g}); f32 vs plain f64: {f32_tail(kern32_, plain64_, cv_.cpu().numpy())[2]} "
              f"(printed); f64 vs the default {route_tag} solve: max |d| {moved:.3e}, envs "
              f"differing {acts}")
        check(err <= bound_, f"f64 K5g {tag} differs from the plain version")
        check(res_rel <= RES_RTOL, f"f64 K5g {tag} residuals differ")
        check(acts > 0, f"K5g {tag}: the option did not reach the kernel")
        k5g[tag] = {"opts": o, "err": worst_, "launches": launched}

    # 4m. The shared Newton step left K1, K2, K5a and K5b as they were: the
    # digest of each one's x, s, z, y and residuals on this batch, each in
    # the block group, against the one the build before the move gave
    # (PARENT_DIGESTS); printed with the times in 7.
    inputs_same = all(digest(pdipm_cuda._inputs(qp)) == PARENT_DIGESTS["inputs", dt]
                      for dt, qp in (("f32", qp32), ("f64", qp64)))
    # K1 and K2 in the form and geometry those builds had: gj_form
    # "tableau", the block group; K5a and K5b in the block group.
    block_tableau = {(tag, dt): pg.solve_in(qp, dataclasses.replace(o, gj_form="tableau"),
                                             pdipm_cuda.BLOCK)
                     for tag, o in (("K1", opts), ("K2", ric))
                     for dt, qp in (("f32", qp32), ("f64", qp64))}
    block_k5 = {(tag, dt): pg.solve_in(qp, thomas[tag], pdipm_cuda.BLOCK)
                for tag in ("K5a", "K5b") for dt, qp in (("f32", qp32), ("f64", qp64))}
    refactor_same = {f"{tag} {dt}": digest(results(runs[tag, dt])) == PARENT_DIGESTS[tag, dt]
                     for tag, runs in (("K1", block_tableau), ("K2", block_tableau),
                                       ("K5a", block_k5), ("K5b", block_k5))
                     for dt in ("f32", "f64")}

    # 4i. Layouts over a block's shared memory raise before any launch: the
    # largest horizon of each route and dtype that fits in the geometry
    # `pdipm_cuda.geometry` picks (the block layout, or a warp group's lean
    # one: the WORK_ROUTES' with the stored inverses in the workspace where
    # needed), and for K5b, K5d-a and K5a a horizon beyond it in f64, which
    # raises.
    fits = {}
    for route in pdipm_cuda.SOURCES:
        lib_ = pdipm_cuda._library(route)
        layout = "lean" if pdipm_cuda.geometry(route).lean else "smem"
        for dt in (torch.float32, torch.float64):
            size = torch.empty((), dtype=dt).element_size()
            fits[f"{route} {str(dt)[6:]}"] = max(
                T_ for T_ in range(1, 151)
                if getattr(lib_, f"pdipm_{route}_{layout}_bytes")(T_, size)
                <= pdipm_cuda.MAX_SMEM_PER_BLOCK)
    pdipm_cuda.reset_counts()
    raised = {}
    for tag, opts_ in (("K5b", thomas["K5b"]), ("K5d-a", riccati["K5d-a"]),
                       ("K5a", thomas["K5a"])):
        over = fits[f"{pdipm_cuda.route(opts_)} float64"] + 1
        try:
            pdipm_cuda.solve(make_qp_batch(8, 0, torch.float64, dev, over), opts_)
        except ValueError as exc:
            raised[f"{tag} T={over}"] = str(exc)
        check(any(k.startswith(tag) and "shared memory" in v for k, v in raised.items()),
              f"{tag} f64 T={over} did not raise")
    check(pdipm_cuda.launches == route_counts(), "a layout that does not fit was launched")
    print(f"[shared memory] largest horizon that fits per route and dtype: {fits}; beyond it, "
          f"f64, raised before any launch: {raised}")

    mark("K5f, K5g, digests")

    # 5. Main path: MPCController at b4096 on the card, default solver (K1).
    obs = torch.tensor(hector_obs(B), device=dev)
    twist = torch.zeros(B, 3, device=dev)
    twist[:, 0] = 0.3
    height = torch.full((B,), 0.55, device=dev)
    limit = torch.tensor(TORQUE_LIMIT, device=dev)
    ctrl = MPCController(ControllerConf(), MPCConf(verbose=False), num_envs=B, gait_id=2,
                         device=dev)
    ctrl.set_command(twist, height)
    phase0 = ctrl.state.gait_phase.clone()
    pdipm_cuda.reset_counts()
    n_mpc, first_wrench, tau_ok, m_trace = traced_walk(ctrl, obs, TICKS, limit)
    launches = pdipm_cuda.runs()
    warp_launches = pdipm_cuda.runs(warp=True)
    issued = dict(pdipm_cuda.launches)
    fz = -first_wrench[:, :, 2]
    phase_adv = float((ctrl.state.gait_phase - phase0).min())
    print(f"[main path] MPCController b{B} HECTOR gait 2, {TICKS} ticks, its calls replayed "
          f"graphs: run_mpc {n_mpc}, kernel launches that ran (as the kernels count them) "
          f"{launches} (in a warp group {warp_launches}), issued from the host {issued}, PDIPM "
          f"kernels in the profiler's trace of the walk {m_trace['k1']:g}; tau finite and within "
          f"limits: {tau_ok}; first solve "
          f"fz left [{float(fz[:, 0].min()):.2f}, {float(fz[:, 0].max()):.2f}] N, right swing "
          f"max |fz| {float(fz[:, 1].abs().max()):.3e} N; gait phase advanced by {phase_adv:.4f}")
    check(launches == route_counts(ric_aug=n_mpc + WARM_UP),
          "the main path did not run K1 once per run_mpc and once in its capture's warm-up")
    check(warp_launches["ric_aug"] == n_mpc + WARM_UP,
          "the main path's K1 did not run in its warp group")
    check(issued == route_counts(ric_aug=ISSUED_CAPTURED),
          f"the main path's K1 was not issued in the warm-up and the capture alone: {issued}")
    check(m_trace["k1"] == launches["ric_aug"],
          f"the profiler saw {m_trace['k1']:g} PDIPM kernels in the main path's walk, the "
          f"kernel counted {launches['ric_aug']}")
    check(tau_ok, "joint torques not finite or beyond the torque limits")
    check(bool((fz[:, 1].abs() < 1.0).all()), "swinging right foot carries force")
    check(bool((first_wrench[:, 0, 2] < -50.0).all()), "stance left foot not loaded")
    check(phase_adv > 0.05, "gait phase did not advance")
    # One eager tick with the solve, default mode, through the core on a
    # clone of the state: nothing in it waits for the device (no constant is
    # copied from the host per call), so each call can be captured; and one
    # tick of the wrapper's replays.
    est = tree_map(torch.clone, ctrl.state)
    with no_host_sync():
        ctrl.core.ingest_state(est, obs)
        ctrl.core.run_mpc(est)
        ctrl.core.run_lowlevel(est)
        ctrl.update_state(obs)
        ctrl.run_mpc()
        ctrl.run_lowlevel()
    print("[main path] one eager update_state + run_mpc + run_lowlevel (ctrl.core) and one "
          "replayed under no_host_sync: ok")

    # Same first solve on 8 envs through the plain version on the CPU, f64.
    ref = MPCController(ControllerConf(), MPCConf(verbose=False), num_envs=8, gait_id=2,
                        dtype=torch.float64, device="cpu")
    ref.set_command(twist[:8].cpu(), height[:8].cpu())
    ref.update_state(obs[:8].cpu())
    ref.run_mpc()
    dw = float((first_wrench[:8].cpu().double() - ref.ground_reaction_wrench).abs().max())
    print(f"[main path vs CPU plain f64] first-solve wrench max |d| {dw:.3e} N over 8 envs "
          f"(bound {F32_U0_ATOL})")
    check(dw <= F32_U0_ATOL, "first main-path wrench differs from the CPU reference")

    # 6. Hybrid main path: K2 on every env, K1 on the worst max(64, B // 32).
    hyb_conf = MPCConf(solver="pallas_hybrid", verbose=False)
    hctrl = MPCController(ControllerConf(), hyb_conf, num_envs=B, gait_id=2, device=dev)
    hctrl.set_command(twist, height)
    stats = []
    pdipm_cuda.reset_counts()
    h_mpc, h_first, h_tau_ok, h_trace = traced_walk(
        hctrl, obs, HYBRID_TICKS, limit, on_solve=lambda: stats.append(hctrl.hybrid_stats))
    h_launches = pdipm_cuda.runs()
    h_warp = pdipm_cuda.runs(warp=True)
    h_fz = -h_first[:, :, 2]
    print(f"[hybrid path] MPCController solver=pallas_hybrid b{B}, {HYBRID_TICKS} ticks: "
          f"run_mpc {h_mpc}, kernel launches that ran {h_launches} (in a warp group {h_warp}), "
          f"PDIPM kernels in the profiler's trace of the walk {h_trace['k1']:g}; "
          f"hybrid_stats first "
          f"{stats[0]}, max dropped_nonfinite {max(st['dropped_nonfinite'] for st in stats)}, "
          f"resolved per solve {[st['resolved'] for st in stats]}; tau finite and within "
          f"limits: {h_tau_ok}; first solve fz left [{float(h_fz[:, 0].min()):.2f}, "
          f"{float(h_fz[:, 0].max()):.2f}] N, right swing max |fz| "
          f"{float(h_fz[:, 1].abs().max()):.3e} N")
    check(h_launches == route_counts(ric_aug=h_mpc + WARM_UP, ric=h_mpc + WARM_UP),
          "the hybrid path did not run K2 and K1 once each per run_mpc and in its warm-up")
    check(h_warp == h_launches,
          f"the hybrid path's K1 and K2 did not run in their warp groups: {h_warp}")
    check(h_trace["k1"] == sum(h_launches.values()),
          f"the profiler saw {h_trace['k1']:g} PDIPM kernels in the hybrid walk, the kernels "
          f"counted {sum(h_launches.values())}")
    check(all(st["dropped_nonfinite"] == 0 for st in stats), "hybrid dropped non-finite envs")
    check(h_tau_ok, "hybrid joint torques not finite or beyond the torque limits")
    check(bool((h_fz[:, 1].abs() < 1.0).all()), "hybrid: swinging right foot carries force")
    check(bool((h_first[:, 0, 2] < -50.0).all()), "hybrid: stance left foot not loaded")

    href = MPCController(ControllerConf(), hyb_conf, num_envs=8, gait_id=2,
                         dtype=torch.float64, device="cpu")
    href.set_command(twist[:8].cpu(), height[:8].cpu())
    href.update_state(obs[:8].cpu())
    href.run_mpc()
    h_dw = float((h_first[:8].cpu().double() - href.ground_reaction_wrench).abs().max())
    print(f"[hybrid path vs CPU plain f64] first-solve wrench max |d| {h_dw:.3e} N over 8 envs; "
          f"CPU hybrid_stats {href.hybrid_stats}")

    # 6b. Adaptive main path: MPCConf(adaptive_tol=1e-2), chunks of 5 (K1 with
    # the warm entry K3, gated on the device).
    ad_conf = MPCConf(adaptive_tol=WALK_TOL, verbose=False)
    actrl = MPCController(ControllerConf(), ad_conf, num_envs=B, gait_id=2, device=dev)
    actrl.set_command(twist, height)
    per_solve = []
    pdipm_cuda.reset_counts()
    a_mpc, a_first, a_tau_ok = walk(actrl, obs, ADAPTIVE_TICKS, limit, on_solve=lambda: per_solve.append(
        pdipm_cuda.chunks_ran()["ric_aug"]))
    a_launches = pdipm_cuda.runs()
    a_issued = dict(pdipm_cuda.launches)
    ran_per_solve = np.diff([0] + per_solve).tolist()
    # A replayed run_mpc launches every chunk; a chunk whose gate is shut
    # returns at once, uncounted, but the profiler sees its launch.
    a_trace = device_trace(actrl.run_mpc, 1)
    check(a_trace is not None, "the profiler saw no device event in an adaptive run_mpc")
    a_fz = -a_first[:, :, 2]
    print(f"[adaptive path] MPCController adaptive_tol={WALK_TOL:g} b{B}, {ADAPTIVE_TICKS} ticks: "
          f"run_mpc {a_mpc}, kernel launches that ran {a_launches} (all warm), chunks ran per "
          f"solve {ran_per_solve} (the first with its capture's warm-up), issued from the host "
          f"{a_issued}; K1 in the profiler's trace of one more replayed run_mpc "
          f"{a_trace['k1']:g}; tau finite and within limits: "
          f"{a_tau_ok}; first solve fz left [{float(a_fz[:, 0].min()):.2f}, "
          f"{float(a_fz[:, 0].max()):.2f}] N, right swing max |fz| "
          f"{float(a_fz[:, 1].abs().max()):.3e} N; vs default first solve max |d| "
          f"{float((a_first - first_wrench).abs().max()):.3e} N")
    check(a_issued == route_counts(ric_aug=4 * ISSUED_CAPTURED),
          "the adaptive path's warm-up and capture did not each issue 4 warm K1 launches")
    check(a_trace["k1"] == 4, "a replayed adaptive run_mpc did not launch its 4 chunks")
    check(a_launches == route_counts(ric_aug=sum(ran_per_solve)),
          f"the adaptive path's K1 ran outside its chunks: {a_launches}")
    check(2 <= ran_per_solve[0] <= 8 and all(1 <= r <= 4 for r in ran_per_solve[1:]),
          "adaptive chunks ran out of range")
    check(a_tau_ok, "adaptive joint torques not finite or beyond the torque limits")
    check(bool((a_fz[:, 1].abs() < 1.0).all()), "adaptive: swinging right foot carries force")
    check(bool((a_first[:, 0, 2] < -50.0).all()), "adaptive: stance left foot not loaded")

    # adaptive_tol = 0 forced through the adaptive route: the default wrench.
    fctrl = MPCController(ControllerConf(), MPCConf(verbose=False), num_envs=B, gait_id=2,
                          device=dev)
    fctrl.set_command(twist, height)
    fctrl.update_state(obs)
    _, f_xref, f_qp = fctrl.core.assemble_mpc(fctrl.state)
    f_out = mpc.postprocess_solution(f_qp, pdipm_cuda.solve_adaptive(f_qp, fctrl.core.opts, 0.0),
                                     fctrl.state.est.rotation_body, f_xref,
                                     fctrl.core.mpc_cfg.horizon_length,
                                     contact_frame=fctrl.core.mpc_cfg.contact_frame)
    f_dw = float((f_out.wrench - first_wrench).abs().max())
    aref = MPCController(ControllerConf(), ad_conf, num_envs=8, gait_id=2, dtype=torch.float64,
                         device="cpu")
    aref.set_command(twist[:8].cpu(), height[:8].cpu())
    aref.update_state(obs[:8].cpu())
    aref.run_mpc()
    a_dw = float((a_first[:8].cpu().double() - aref.ground_reaction_wrench).abs().max())
    print(f"[adaptive path checks] tol 0 through the adaptive route vs default first-solve wrench: "
          f"max |d| {f_dw:.3e} N (bitwise: {bool(torch.equal(f_out.wrench, first_wrench))}); "
          f"first solve vs CPU plain f64 on 8 envs: max |d| {a_dw:.3e} N (bound {F32_U0_ATOL})")
    check(torch.equal(f_out.wrench, first_wrench), "adaptive route at tol 0 differs from default")
    check(a_dw <= F32_U0_ATOL, "first adaptive wrench differs from the CPU reference")

    # 6c. The main paths of the other routes, each with its launch counts
    # from 0 and its first solve against the CPU plain f64 controller on 8
    # envs: "pallas_aug" (K5b), "pallas" (K5a), "pallas_ric2" (K5c),
    # "pallas_ric" unsplit (K5d-c), "pallas_ric_aug" unsplit (K5d-a),
    # "pallas_ric_aug" with Jacobi scaling (K1), and the foot packing (K5e):
    # "pallas_ric_aug" with solver_foot_pack=True (K5e-a), "pallas_hybrid"
    # with it (K5e-c on every env, K5e-a on the re-solve, no K1 or K2) and
    # "pallas_ric" with "apply" (K5e-c). The augmented paths and K5a are
    # bounded as the default path (K5a is the condensed class: the plain
    # version's own f32 solve of this walk on the CPU is 0.83 N off the f64
    # one, K2's 0.27 N; the kernel's rounding reads 0.10 N on the H100); the
    # first wrench of the other condensed paths is printed, as the hybrid's.
    # Each path's launches per run_mpc, per route:
    paths = (("pallas_aug", {}, {"tridiag_aug": 1}, 2 * PATH_TICKS, True),
             ("pallas", {}, {"tridiag": 1}, PATH_TICKS, True),
             ("pallas_ric2", {}, {"ric2": 1}, PATH_TICKS, False),
             ("pallas_ric", {"solver_foot_split": False}, {"ric_dense": 1}, PATH_TICKS, False),
             ("pallas_ric_aug", {"solver_foot_split": False}, {"ric_aug_dense": 1}, PATH_TICKS,
              True),
             ("pallas_ric_aug", {"solver_kkt_scale": "jacobi"}, {"ric_aug": 1}, PATH_TICKS, True),
             ("pallas_ric_aug", {"solver_foot_pack": True}, {"ric_aug_pack": 1}, PATH_TICKS, True),
             ("pallas_hybrid", {"solver_foot_pack": True}, {"ric_pack": 1, "ric_aug_pack": 1},
              PATH_TICKS, False),
             ("pallas_ric", {"solver_foot_pack": "apply"}, {"ric_pack": 1}, PATH_TICKS, False))
    path_ctrl, path_launches = {}, {}
    for solver, knobs, per_mpc, ticks, bounded in paths:
        name = " ".join([solver] + [f"{k}={v!r}" for k, v in knobs.items()])
        conf = MPCConf(solver=solver, verbose=False, **knobs)
        tctrl = MPCController(ControllerConf(), conf, num_envs=B, gait_id=2, device=dev)
        tctrl.set_command(twist, height)
        pdipm_cuda.reset_counts()
        t_mpc, t_first, t_tau_ok = walk(tctrl, obs, ticks, limit)
        t_launches = pdipm_cuda.runs()
        t_warp = {r: n for r, n in pdipm_cuda.runs(warp=True).items() if r in per_mpc}
        t_fz = -t_first[:, :, 2]
        tref = MPCController(ControllerConf(), conf, num_envs=8, gait_id=2, dtype=torch.float64,
                             device="cpu")
        tref.set_command(twist[:8].cpu(), height[:8].cpu())
        tref.update_state(obs[:8].cpu())
        tref.run_mpc()
        t_dw = float((t_first[:8].cpu().double() - tref.ground_reaction_wrench).abs().max())
        print(f"[{name} path] MPCController b{B}, {ticks} ticks: "
              f"run_mpc {t_mpc}, kernel launches that ran {t_launches} (in a warp group {t_warp}); tau "
              f"finite and within limits: "
              f"{t_tau_ok}; first solve fz left [{float(t_fz[:, 0].min()):.2f}, "
              f"{float(t_fz[:, 0].max()):.2f}] N, right swing max |fz| "
              f"{float(t_fz[:, 1].abs().max()):.3e} N; vs CPU plain f64 on 8 envs max |d| "
              f"{t_dw:.3e} N{f' (bound {F32_U0_ATOL})' if bounded else ' (printed)'}; vs default "
              f"first solve max |d| {float((t_first - first_wrench).abs().max()):.3e} N")
        check(t_launches == route_counts(**{r: n * (t_mpc + WARM_UP) for r, n in per_mpc.items()}),
              f"the {name} path did not run its kernels {per_mpc} per run_mpc and in its warm-up")
        check(all(t_warp[r] == t_launches[r] for r in t_warp) and set(t_warp) == set(per_mpc),
              f"the {name} path's {sorted(per_mpc)} did not run in their warp groups: {t_warp}")
        check(t_tau_ok, f"{name}: joint torques not finite or beyond the torque limits")
        check(bool((t_fz[:, 1].abs() < 1.0).all()), f"{name}: swinging right foot carries force")
        check(bool((t_first[:, 0, 2] < -50.0).all()), f"{name}: stance left foot not loaded")
        check(float((tctrl.state.gait_phase - phase0).min()) > 0.0,
              f"{name}: gait phase did not advance")
        if bounded:
            check(t_dw <= F32_U0_ATOL, f"{name}: first wrench differs from the CPU reference")
        path_ctrl[name], path_launches[name] = tctrl, t_launches

    mark("main paths")

    # 6c'. The wrapper's calls as captured graphs against the eager core.
    wrap = wrapper_phase(label, dev)
    mark("wrapper graph")

    # 6c''. The core's control_step as one captured graph against the eager step.
    csteps = control_step_phase(label, dev)
    mark("control_step graph")

    # 6d. The closed loop: the captured rollout, the RL env, simulate, dense.
    loop = closed_loop_phases(label, dev, qp32, qp64)
    mark("closed loop")

    # 6e. The Booster T1 on K1: the controller and the captured closed loop.
    t1_out = t1_phases(label, dev)
    mark("T1")

    # 6f. ric_aug_core, the env batch over ranks, the planar drone.
    extras = extras_phases(label, dev, qp32, qp64)
    mark("ric_aug_core, mesh, drone")

    # 7. Times on the card (CUDA events, after warm-up; the plain versions in
    # one call each, without a warm-up call of their own).
    k32 = cuda_ms(lambda: pdipm_cuda.solve(qp32, opts), 20)
    k64 = cuda_ms(lambda: pdipm_cuda.solve(qp64, opts), 10)
    p32 = timed_once(lambda: pdipm.solve(qp32, opts))[1]
    p64 = timed_once(lambda: pdipm.solve(qp64, opts))[1]
    r32 = cuda_ms(lambda: pdipm_cuda.solve(qp32, ric), 20)
    r64 = cuda_ms(lambda: pdipm_cuda.solve(qp64, ric), 10)
    rp32 = timed_once(lambda: pdipm.solve(qp32, ric))[1]
    rp64 = timed_once(lambda: pdipm.solve(qp64, ric))[1]
    hyb32 = cuda_ms(lambda: pdipm_cuda.solve_hybrid(qp32, ric), 20)
    budget = max(64, B // 32)
    worst = torch.sort(ric_kern32.residuals.amax(1).nan_to_num(float("inf")), descending=True,
                       stable=True).indices[:budget]
    sub32 = qps.take(qp32, worst)
    k1_sub = cuda_ms(lambda: pdipm_cuda.solve(sub32, opts), 20)
    mpc_ms = cuda_ms(ctrl.run_mpc, 10)
    hmpc_ms = cuda_ms(hctrl.run_mpc, 10)
    ad0 = cuda_ms(lambda: pdipm_cuda.solve_adaptive(qp32, opts, 0.0), 20)
    ad0_ric = cuda_ms(lambda: pdipm_cuda.solve_adaptive(ric_qp32, ric, 0.0), 20)
    r32_sub = cuda_ms(lambda: pdipm_cuda.solve(ric_qp32, ric), 20)
    adw = cuda_ms(lambda: pdipm_cuda.solve_adaptive(qp32, opts, WALK_TOL), 20)
    ad0_plain = timed_once(lambda: pdipm.solve_adaptive_batch(qp32, opts, 0.0))[1]
    df_ms = cuda_ms(lambda: pdipm_cuda.solve(qp32, df_opts), 20)
    df_plain_ms = timed_once(lambda: pdipm.solve(qp32, df_opts))[1]
    k32_again = cuda_ms(lambda: pdipm_cuda.solve(qp32, opts), 20)
    amp_ms = cuda_ms(actrl.run_mpc, 10)

    def tick():
        ctrl.update_state(obs)
        ctrl.run_lowlevel()
        ctrl.get_action()

    tick_ms = cuda_ms(tick, 50)
    tick_trace = device_trace(tick, 10)
    mpc_trace = device_trace(ctrl.run_mpc, 3)
    k5_ms = {}
    for tag, opts_, path in (("K5b", thomas["K5b"], "pallas_aug"), ("K5a", thomas["K5a"], "pallas"),
                             ("K5c", riccati["K5c"], "pallas_ric2"),
                             ("K5d-c", riccati["K5d-c"], "pallas_ric solver_foot_split=False"),
                             ("K5d-a", riccati["K5d-a"],
                              "pallas_ric_aug solver_foot_split=False")):
        k5_ms[tag] = {"opts": opts_,
                      "k32": cuda_ms(lambda: pdipm_cuda.solve(qp32, opts_), 10),
                      "k64": cuda_ms(lambda: pdipm_cuda.solve(qp64, opts_), 5),
                      "p32": timed_once(lambda: pdipm.solve(qp32, opts_))[1],
                      "p64": timed_once(lambda: pdipm.solve(qp64, opts_))[1],
                      "mpc": cuda_ms(path_ctrl[path].run_mpc, 5)}
    jac_opts = dataclasses.replace(opts, kkt_scale="jacobi")
    jac32 = cuda_ms(lambda: pdipm_cuda.solve(qp32, jac_opts), 20)
    jac_mpc = cuda_ms(path_ctrl["pallas_ric_aug solver_kkt_scale='jacobi'"].run_mpc, 10)
    # K5e, K5f and K5g: each new route and option value in f32 beside its
    # bound, the plain versions of the JSON line's entries, the packed paths.
    new_ms = {}
    for tag, o in ([(t, v["opts"]) for t, v in k5e.items()]
                   + [(f"{t} tableau", dataclasses.replace(forms[t], gj_form="tableau"))
                      for t in ("K1", "K2")]
                   + [("K5d-c k_pivot", kpiv)]
                   + [(f"{t} aug_pivot=False", o) for t, o in nopivot.items()]
                   + [(t, v["opts"]) for t, v in k5g.items()]):
        new_ms[tag] = {"opts": o, "k32": cuda_ms(lambda: pdipm_cuda.solve(qp32, o), 10),
                       "bound": bound(qp32, o)}
    for tag in ("K5e-c pair", "K5e-a pair", *k5g):
        new_ms[tag]["p32"] = timed_once(lambda: pdipm.solve(qp32, new_ms[tag]["opts"]))[1]
    pack_paths = ("pallas_ric_aug solver_foot_pack=True", "pallas_hybrid solver_foot_pack=True",
                  "pallas_ric solver_foot_pack='apply'")
    pack_mpc = {name: cuda_ms(path_ctrl[name].run_mpc, 5) for name in pack_paths}
    units = B * opts.iterations / 5
    print(f"[times] {label}: b{B} h10 {opts.iterations} iterations: kernel f32 {k32:.3f} ms "
          f"({units / k32 * 1e3:.0f} 5-iteration units/s), kernel f64 {k64:.3f} ms, "
          f"plain f32 {p32:.3f} ms, plain f64 {p64:.3f} ms")
    print(f"[times] {label}: b{B} h10 K2 (ric): kernel f32 {r32:.3f} ms "
          f"({units / r32 * 1e3:.0f} 5-iteration units/s), kernel f64 {r64:.3f} ms, "
          f"plain f32 {rp32:.3f} ms, plain f64 {rp64:.3f} ms")
    print(f"[times] {label}: b{B} f32 solve_hybrid {hyb32:.3f} ms (K1 alone on its "
          f"{budget}-env re-solve batch {k1_sub:.3f} ms)")
    print(f"[times] {label}: MPCController b{B} f32, its calls replayed graphs: run_mpc "
          f"{mpc_ms:.3f} ms, hybrid run_mpc {hmpc_ms:.3f} ms, 1 kHz tick (update_state + run_lowlevel + get_action) "
          f"{tick_ms:.3f} ms; device events (profiler) a tick "
          f"{'not measured' if tick_trace is None else tick_trace['events']}, device idle "
          f"{'not measured' if tick_trace is None else format(tick_trace['idle'], '.2%')}, a "
          f"run_mpc {'not measured' if mpc_trace is None else mpc_trace['events']} (K1 "
          f"{'not measured' if mpc_trace is None else mpc_trace['k1']}), device idle "
          f"{'not measured' if mpc_trace is None else format(mpc_trace['idle'], '.2%')}; eager "
          f"(ctrl.core, [wrapper graph]) run_mpc {wrap['mpc_eager_ms']:.3f} ms, tick "
          f"{wrap['tick_eager_ms']:.3f} ms; the closed loop's captured cycle {loop['rollout_ms']:.3f} ms (eager "
          f"{loop['rollout_eager_ms']:.3f} ms), RL step {loop['rl_ms']:.3f} ms")
    print(f"[times] {label}: b{B} f32 solve_adaptive tol 0 (4 launches): K1 {ad0:.3f} ms vs "
          f"fixed {k32:.3f} ms, K2 on its {ric_qp32.f.shape[0]} finite envs {ad0_ric:.3f} ms vs "
          f"fixed {r32_sub:.3f} ms, plain (K1 route) {ad0_plain:.3f} "
          f"ms; tol {WALK_TOL:g} (K1, {walk_chunks['K1']} chunks ran) {adw:.3f} ms; adaptive "
          f"run_mpc {amp_ms:.3f} ms")
    print(f"[times] {label}: b{B} f32 K1 with the df residual {df_ms:.3f} ms vs f32 residual "
          f"{k32_again:.3f} ms (same run), plain df {df_plain_ms:.3f} ms")
    print(f"[times] {label}: b{B} f32 K1 with kkt_scale=jacobi {jac32:.3f} ms vs unscaled "
          f"{k32_again:.3f} ms; its MPCController run_mpc {jac_mpc:.3f} ms vs {mpc_ms:.3f} ms")
    bounds = {"ric_aug": bound(qp32, opts), "ric": bound(qp32, ric), "warm": bound(qp32, opts),
              "df": bound(qp32, df_opts)}
    bounds.update({pdipm_cuda.route(t["opts"]): bound(qp32, t["opts"]) for t in k5_ms.values()})
    for tag, t in k5_ms.items():
        key = pdipm_cuda.route(t["opts"])
        b32, by = bounds[key]
        b64, _ = bound(qp64, t["opts"])
        print(f"[times] {label}: b{B} h10 {tag} ({key}): kernel f32 {t['k32']:.3f} ms "
              f"({units / t['k32'] * 1e3:.0f} 5-iteration units/s), kernel f64 {t['k64']:.3f} ms, "
              f"plain f32 {t['p32']:.3f} ms, plain f64 {t['p64']:.3f} ms; bound f32 {b32:.3f} ms, "
              f"f64 {b64:.3f} ms (by {by}); MPCController run_mpc {t['mpc']:.3f} ms")
    twin_ms = {"K1": k32, "K2": r32, "K5a": k5_ms["K5a"]["k32"], "K5d-c": k5_ms["K5d-c"]["k32"],
               "K5d-a": k5_ms["K5d-a"]["k32"], "K5e-c": r32, "K5e-a": k32}
    for tag, t in new_ms.items():
        twin = tag.split()[0]
        plain = f", plain f32 {t['p32']:.3f} ms" if "p32" in t else ""
        print(f"[times] {label}: b{B} h10 {tag} ({pdipm_cuda.route(t['opts'])}): kernel f32 "
              f"{t['k32']:.3f} ms{plain}; bound f32 {t['bound'][0]:.3f} ms (by {t['bound'][1]}); "
              f"{'K2' if twin == 'K5e-c' else 'K1' if twin == 'K5e-a' else twin} default "
              f"{twin_ms[twin]:.3f} ms ({t['k32'] / twin_ms[twin] - 1:+.1%})")
    print(f"[times] {label}: b{B} f32 K1 / K2 under gj_form inplace (the default now) {k32:.3f} / "
          f"{r32:.3f} ms, under tableau (the former form) {new_ms['K1 tableau']['k32']:.3f} / "
          f"{new_ms['K2 tableau']['k32']:.3f} ms in this run; the former build's K1 / K2 {TABLEAU_MS['K1']:.3f} / "
          f"{TABLEAU_MS['K2']:.3f} ms ({k32 / TABLEAU_MS['K1'] - 1:+.1%} / {r32 / TABLEAU_MS['K2'] - 1:+.1%})")
    print(f"[times] {label}: MPCController b{B} f32 run_mpc of the packed paths: "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in pack_mpc.items())
          + f" (default {mpc_ms:.3f} ms, hybrid {hmpc_ms:.3f} ms)")
    bounds.update({tag: t["bound"] for tag, t in new_ms.items()})
    bounds.update({pdipm_cuda.route(k5e[tag]["opts"]): new_ms[tag]["bound"]
                   for tag in ("K5e-c pair", "K5e-a pair")})
    print(f"[times] {label}: bounds at b{B} f32 (ms, bound by): "
          + ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in bounds.items()))
    steps = [("ric_aug", opts), ("ric", ric), ("ric_aug df", df_opts)] + [
        (pdipm_cuda.route(t["opts"]), t["opts"]) for t in k5_ms.values()] + [
        (pdipm_cuda.route(k5e[t]["opts"]), k5e[t]["opts"]) for t in ("K5e-c pair", "K5e-a pair")] + [
        (t, v["opts"]) for t, v in k5g.items()]
    per_step = lambda o, fn: float(np.mean([fn(r) for r in step_refines(o)]))
    flops = [(k, per_step(o, lambda r: kernel_flops(pdipm_cuda.route(o), qp32.horizon, r,
                                                     o.refine_residual == "df", o.corrector_form)),
              per_step(o, lambda r: needed_flops(qp32.horizon, r, o.refine_residual == "df",
                                                 o.corrector_form)))
             for k, o in steps]
    print(f"[flops] per env and Newton step at h{qp32.horizon} (the mean over the solve's steps): "
          f"what the kernel's loops do / the least (the bounds' count): "
          + ", ".join(f"{k} {done:.4g} / {least:.4g}" for k, done, least in flops))
    now = {"K1": new_ms["K1 tableau"]["k32"], "K2": new_ms["K2 tableau"]["k32"],
           **{tag: cuda_ms(lambda: pg.solve_in(qp32, thomas[tag], pdipm_cuda.BLOCK), 2)
              for tag in ("K5a", "K5b")}}
    print(f"[refactor] {label}: K1 and K2 under gj_form tableau in the block group, K5a and "
          f"K5b in the block group, in the one Newton-step kernel, b{B} cold 20 steps: inputs "
          f"as recorded: "
          f"{inputs_same}; x, s, z, y "
          f"and residuals bitwise the build before the move (digest): {refactor_same}; f32 ms now "
          f"/ before the move: "
          + ", ".join(f"{k} {v:.3f} / {PARENT_MS[k]:.3f} ({v / PARENT_MS[k] - 1:+.1%})"
                      for k, v in now.items()))

    mark("times")

    # 7b. K1 and K2 in their geometries (`geometry_phase`), and every route's
    # bits against the build before the warp groups (K1, K2 in the block
    # group).
    before = {k: v == BEFORE_WARP_DIGESTS[k]
              for k, v in route_digests(qp32, qp64, opts).items()}
    print(f"[refactor] {label}: every route's b{B} solve, K1 and K2 in the block group, bitwise "
          f"the build before the warp groups (BEFORE_WARP_DIGESTS): {before}")
    check(all(before.values()), "a route's bits differ from the build before the warp groups")
    geometry_phase(label, qp32, qp64, opts)

    mark("geometry")

    # 7c. K5b, K5d-a, K5a, K5c and K5d-c at the longer HORIZONS, in their
    # warp groups, on this script's walking batch at that horizon (the
    # condensed K5a, K5c and K5d-c on its first HORIZON_ENVS envs), against
    # the f64 plain version with their class's bounds: K5b and K5d-a as the
    # robust class, f64 on the converged envs, f32 u0 and finiteness; the
    # condensed routes f64 relative to max(1, |v|), their f32 u0 tail printed
    # beside the block group's where the block layout fits (so that a
    # redesign that amplifies f32 rounding shows), K5a's f32 finiteness
    # bounded (K5c's and K5d-c's printed, as at h10). The f64 bound
    # is the larger of the class bound (F64_ATOL absolute, or
    # CONDENSED_F64_RTOL relative) and WITNESS_FACTOR times the plain route's
    # own roundoff there (its f64 solve on the CPU against the same on the
    # card, over the WITNESS_ENVS converged envs where the kernel parts
    # most), as for the step variants (4p); both are printed.
    for T_ in HORIZONS:
        q64, q32 = (make_qp_batch(B, 0, dt, dev, T_) for dt in (torch.float64, torch.float32))
        u0 = slice(12 * T_, 12 * T_ + 12)
        for tag, opts_, nb in (("K5b", thomas["K5b"], B), ("K5d-a", riccati["K5d-a"], B),
                               ("K5a", thomas["K5a"], HORIZON_ENVS),
                               ("K5c", riccati["K5c"], HORIZON_ENVS),
                               ("K5d-c", riccati["K5d-c"], HORIZON_ENVS)):
            key = pdipm_cuda.route(opts_)
            condensed = tag in ("K5a", "K5c", "K5d-c")
            sub = (lambda q: q) if nb == B else (
                lambda q: qps.take(q, torch.arange(nb, device=dev)))
            h64, h32 = sub(q64), sub(q32)
            pdipm_cuda.reset_counts()
            k64_, k32_ = pdipm_cuda.solve(h64, opts_), pdipm_cuda.solve(h32, opts_)
            torch.cuda.synchronize()
            check(pdipm_cuda.launches[key] == 2 and pdipm_cuda.warp_launches[key] == 2,
                  f"{tag} h{T_}: not two launches in its warp group")
            plain_ = pdipm.solve(h64, opts_)
            cv_ = plain_.residuals[:, 3] <= MU_CONVERGED
            check(int(cv_.sum()) >= nb // 10, f"only {int(cv_.sum())} envs converged at h{T_}")
            gap = torch.stack([(getattr(k64_, n) - getattr(plain_, n)).abs().amax(1)
                               for n in "xszy"]).amax(0)
            rel = torch.stack([((getattr(k64_, n) - getattr(plain_, n)).abs()
                                / getattr(plain_, n).abs().clamp_min(1.0)).amax(1)
                               for n in "xszy"]).amax(0)
            worst_, worst_rel = float(gap[cv_].max()), float(rel[cv_].max())
            cv_idx = torch.nonzero(cv_).flatten()
            part = rel if condensed else gap
            idx = cv_idx[torch.argsort(part[cv_idx], descending=True)[:WITNESS_ENVS]]
            cpu = pdipm.solve(qp_map(qps.take(h64, idx), lambda v: v.cpu()), opts_)
            cgap = {n: (getattr(cpu, n) - getattr(plain_, n)[idx].cpu()).abs() for n in "xszy"}
            wit = max(float(g.max()) for g in cgap.values())
            wit_rel = max(float((g / getattr(cpu, n).abs().clamp_min(1.0)).max())
                          for n, g in cgap.items())
            err, floor_, w_ = ((worst_rel, CONDENSED_F64_RTOL, wit_rel) if condensed
                               else (worst_, F64_ATOL, wit))
            bound_ = max(floor_, WITNESS_FACTOR * w_)
            fin = torch.isfinite(k32_.x).all(1)
            du0 = (k32_.x[:, u0].double() - plain_.x[:, u0]).abs().amax(1)
            block32 = ""
            if condensed and pdipm_cuda.smem_bytes(key, T_, torch.float32) <= \
                    pdipm_cuda.MAX_SMEM_PER_BLOCK:
                b32 = pg.solve_in(h32, opts_, pdipm_cuda.BLOCK).x
                bfin = torch.isfinite(b32).all(1)
                bu0 = (b32[:, u0].double() - plain_.x[:, u0]).abs().amax(1)
                block32 = (f"; the block group's f32 finite {int(bfin.sum())}/{nb}, u0 |dGRF| "
                           f"converged finite {quantiles(bu0[cv_ & bfin].cpu().numpy())} "
                           f"(printed)")
            reps = 2 if T_ <= 20 else 1
            ms32 = cuda_ms(lambda: pdipm_cuda.solve(h32, opts_), reps)
            ms64 = cuda_ms(lambda: pdipm_cuda.solve(h64, opts_), reps)
            lib_ = pdipm_cuda._library(key)
            work = {dt: getattr(lib_, f"pdipm_{key}_work_bytes")(T_, sz, 0)
                    for dt, sz in (("f32", 4), ("f64", 8))}
            print(f"[{tag} h{T_}] {label}: b{nb} {key} in its warp group, converged envs "
                  f"{int(cv_.sum())}: f64 vs plain f64 max |dx,ds,dz,dy| {worst_:.3e}, relative "
                  f"to max(1, |v|) {worst_rel:.3e} (bound {bound_:.3e} "
                  f"{'relative' if condensed else 'absolute'}: the larger of {floor_:g} and "
                  f"{WITNESS_FACTOR} x the witness); witness (plain f64 on the CPU vs the card, the {len(idx)} "
                  f"converged envs the kernel parts most on) {wit:.3e} absolute, {wit_rel:.3e} "
                  f"relative; f32 finite {int(fin.sum())}/{nb}, u0 |dGRF| converged finite "
                  f"{quantiles(du0[cv_ & fin].cpu().numpy())}"
                  f"{' (printed)' if condensed else f' (bound {F32_U0_ATOL})'}, above "
                  f"{F32_U0_ATOL} N over all finite envs {int((du0[fin] > F32_U0_ATOL).sum())}"
                  f"{block32}; kernel f32 {ms32:.3f} ms, f64 {ms64:.3f} ms; workspace bytes per env "
                  f"{work}")
            check(err <= bound_, f"f64 {tag} h{T_} differs from the plain version")
            if tag in ("K5b", "K5d-a", "K5a"):
                check(float(fin.double().mean()) >= F32_FINITE_SHARE,
                      f"f32 {tag} h{T_} finite on {int(fin.sum())} envs")
            if not condensed:
                check(float(du0[cv_ & fin].max()) <= F32_U0_ATOL,
                      f"f32 {tag} h{T_} GRF off on converged envs")

    mark("horizons")
    t0 = time.perf_counter()
    k8_libs = k8_build.result()
    print(f"[K8 build wait] {sum(len(v) for v in k8_libs.values())} generated tape kernels, "
          f"built in the background, ready after {time.perf_counter() - t0:.1f} s more")
    mark("K8 build wait")
    bench_kernels = bench_twins(label, k8_libs)
    mark("bench twins")
    print("[elapsed] seconds of each phase: "
          + ", ".join(f"{name} {t1 - t0:.1f}" for (_, t0), (name, t1) in zip(marks, marks[1:]))
          + f"; total {marks[-1][1] - marks[0][1]:.1f} s; cut to make room for the control_step "
          f"graph phase: nothing")

    def entry(name, source, replaces, launches_, err, ms, plain_ms, key):
        return {"name": name, "route": "cuda", "source": f"biped_pympc_tpu_torch/csrc/{source}",
                "replaces": f"biped_pympc_tpu/ops/pdipm_pallas.py:{replaces}",
                "launches": launches_, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": None}

    kernels = [
        entry("pdipm_ric_aug", "pdipm_ric_aug.cu", "308",
              launches["ric_aug"] + t1_out["k1_launches"] + extras["mesh_launches"]
              + csteps["runs"]["ric_aug"], worst64, k32, p32, "ric_aug"),
        entry("pdipm_ric", "pdipm_ric.cu", "308 (backend=ric, foot_split)",
              h_launches["ric"] + csteps["runs"]["ric"], ric_worst64, r32, rp32, "ric"),
        entry("pdipm_warm_entry", "pdipm_common.cuh",
              "316 (warm=True, via solve_adaptive:1855)", a_launches["ric_aug"], k3_err, ad0,
              ad0_plain, "warm"),
        entry("pdipm_df_residual", "pdipm_common.cuh", "1290 (df_resid, refine_residual=df)",
              df_launches, df_worst64, df_ms, df_plain_ms, "df"),
        entry("pdipm_tridiag_aug", "pdipm_tridiag_aug.cu",
              "308 (backend=tridiag_aug: factor_aug :1134, thomas_solve_aug :1183)",
              path_launches["pallas_aug"]["tridiag_aug"], k5["K5b"]["err"], k5_ms["K5b"]["k32"],
              k5_ms["K5b"]["p32"], "tridiag_aug"),
        entry("pdipm_tridiag", "pdipm_tridiag.cu",
              "308 (backend=tridiag: factor :424, thomas_solve :478)",
              path_launches["pallas"]["tridiag"], k5["K5a"]["err"], k5_ms["K5a"]["k32"],
              k5_ms["K5a"]["p32"], "tridiag"),
        entry("pdipm_ric2", "pdipm_ric2.cu",
              "308 (backend=ric2: factor_ric2 :839, _kinv2_apply :885)",
              path_launches["pallas_ric2"]["ric2"], k5n["K5c"]["err"], k5_ms["K5c"]["k32"],
              k5_ms["K5c"]["p32"], "ric2"),
        entry("pdipm_ric_dense", "pdipm_ric_dense.cu",
              "308 (backend=ric, foot_split=False: factor_ric :896)",
              path_launches["pallas_ric solver_foot_split=False"]["ric_dense"], k5n["K5d-c"]["err"],
              k5_ms["K5d-c"]["k32"], k5_ms["K5d-c"]["p32"], "ric_dense"),
        entry("pdipm_ric_aug_dense", "pdipm_ric_aug_dense.cu",
              "308 (backend=ric_aug, foot_split=False: factor_ric_aug :1007)",
              path_launches["pallas_ric_aug solver_foot_split=False"]["ric_aug_dense"],
              k5n["K5d-a"]["err"],
              k5_ms["K5d-a"]["k32"], k5_ms["K5d-a"]["p32"], "ric_aug_dense"),
        entry("pdipm_ric_pack", "pdipm_ric_pack.cu",
              "308 (backend=ric, foot_split, foot_pack: _gj_pair_inplace :191, "
              "_split_bkb_pack :630, factor_ric_split :675-709)",
              sum(path_launches[p]["ric_pack"] for p in pack_paths), k5e["K5e-c pair"]["err"],
              new_ms["K5e-c pair"]["k32"], new_ms["K5e-c pair"]["p32"], "ric_pack"),
        entry("pdipm_ric_aug_pack", "pdipm_ric_aug_pack.cu",
              "308 (backend=ric_aug, foot_split, foot_pack: _gj_pair_pivot :239, "
              "_split_bkb_pack :630, factor_ric_aug_split :791-823)",
              sum(path_launches[p]["ric_aug_pack"] for p in pack_paths), k5e["K5e-a pair"]["err"],
              new_ms["K5e-a pair"]["k32"], new_ms["K5e-a pair"]["p32"], "ric_aug_pack"),
        entry("pdipm_gj_form_and_pivots", "pdipm_common.cuh",
              "149 (_gj_inverse_nopivot_inplace, gj_form=inplace, chosen at :327-331; "
              "tableau :124; k_pivot :921; aug_pivot :800-825, :1037)",
              launches["ric_aug"], worst64, k32, p32, "ric_aug"),
        *[entry(f"pdipm_step {tag}", "pdipm_common.cuh",
                "1237 (iteration_base: " + {"combined": "corrector_form :1420-1426",
                                            "sum_refine": "corrector_form :1427-1451",
                                            "aff_ref": "corrector_form :1452-1467",
                                            "refine_skip_iters=10": "refine_skip_iters :1499-1517",
                                            "sigma_cap=1e6": "sigma_cap :1248-1249"}[tag.split()[1]]
                + ")", k5g[tag]["launches"], k5g[tag]["err"], new_ms[tag]["k32"],
                new_ms[tag]["p32"], tag) for tag in k5g],
        *bench_kernels,
    ]
    check(all(type(k["launches"]) is int for k in kernels), "a kernel's launches is not a count")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. It builds both PDIPM kernels with nvcc (the
augmented route K1, `biped_pympc_tpu_torch/csrc/pdipm_ric_aug.cu`, and the
condensed route K2, `csrc/pdipm_ric.cu`), holds each against its plain
PyTorch version on a randomized b4096 QP batch, drives `MPCController`
(HECTOR, walking gait, 4096 envs) on the card with the default solver for
200 ticks and with the hybrid speed mode (K2 everywhere, K1 re-solves) for
100 ticks, checks that every solve went through the kernels and that the
outputs are sane, and times the kernels, the plain versions, the hybrid
solve, `run_mpc` and one 1 kHz tick. Each phase prints one line of findings;
any failure raises and the script exits non-zero. It exits non-zero without
a result when no CUDA device is visible. The last line is a JSON object
naming the device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B = 4096
TICKS = 200
HYBRID_TICKS = 100
# Envs whose f64 reference ends with mu = s.z / ni at or below this are the
# ones the fixed 20-step Mehrotra rule has converged on. On the rest it is
# still moving (the f64 20- and 40-step solutions differ by up to tens of N),
# so two correct implementations that round differently part ways there;
# the agreement bounds apply to the converged envs and the tail is printed.
MU_CONVERGED = 1e-5
F64_ATOL = 1e-6
RES_RTOL = 1e-6
F32_U0_ATOL = 0.5  # N
F32_FINITE_SHARE = 0.999
# HECTOR's standing pose, walking command (tests/test_controller.py:12-19).
Q0 = (0.0, 0.0, 0.45, -0.9, 0.45)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_label() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def make_qp_batch(batch, seed, dtype, device):
    """Randomized HECTOR walking QPs through the port's `build_qp`: small
    random attitude, position, twist; forward command in [-0.2, 0.4] m/s;
    contact tables of the 5-step walking gait at random phase (swing stages
    in every env); per-env friction in [0.4, 1.0]."""
    import torch
    from biped_pympc_tpu_torch.models import hector
    from biped_pympc_tpu_torch.models.srbd import SrbdLin
    from biped_pympc_tpu_torch.ops import qp as qps
    from biped_pympc_tpu_torch.utils.maths import rot_x, rot_y, rot_z

    rng = np.random.default_rng(seed)
    T = 10
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
    mu = rng.uniform(0.4, 1.0, batch)

    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    rot = rot_z(t(x0[:, 2])) @ rot_y(t(x0[:, 1])) @ rot_x(t(x0[:, 0]))
    lin = SrbdLin(
        rot_body=rot, inertia_world=rot @ t(hector.I_BODY) @ rot.transpose(-1, -2),
        body_pos=t(pos), foot_pos=t(feet), mass=t(np.full(batch, hector.MASS)),
        residual_lin_accel=t(np.zeros((batch, 3))), residual_ang_accel=t(np.zeros((batch, 3))))
    q = t([150.0, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1])
    r = t([1e-5] * 6 + [1e-4] * 6)
    return qps.build_qp(lin, t(x0), t(x_ref), t(contact), 0.025, t(mu), q, r, T)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from biped_pympc_tpu_torch import ControllerConf, MPCConf, MPCController
    from biped_pympc_tpu_torch.models.hector import TORQUE_LIMIT
    from biped_pympc_tpu_torch.ops import pdipm, pdipm_cuda
    from biped_pympc_tpu_torch.ops import qp as qps

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. Device.
    kind = torch.cuda.get_device_name(0)
    label = card_label()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {kind}; "
          f"devices visible {torch.cuda.device_count()}")
    print(label)

    # 2. Build: one nvcc per kernel source, started together.
    t0 = time.perf_counter()
    lib_paths = pdipm_cuda.build()
    print(f"[build] nvcc {' '.join(pdipm_cuda.NVCC_FLAGS)} -> {sorted(lib_paths.values())} in "
          f"{time.perf_counter() - t0:.1f} s")

    # 3. K1 (augmented route) vs its plain version on the card.
    opts = pdipm.PdipmOptions()
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
    ric = pdipm.PdipmOptions(backend="ric")
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
          f"{ric_worst64:.3e} (bound {F64_ATOL:g}), relative to max(1, |v|) "
          f"{ric_rel[ric_conv].max():.3e}, envs above bound {int((ric_err[ric_conv] > F64_ATOL).sum())}, "
          f"residual rel {ric_res_rel[ric_conv].max():.3e} (bound {RES_RTOL:g}); all envs: "
          f"{quantiles(ric_err)}, above bound {int((ric_err > F64_ATOL).sum())}, "
          f"residual rel max {ric_res_rel.max():.3e}")
    check(ric_worst64 <= F64_ATOL, "f64 K2 differs from the plain version")
    check(float(ric_res_rel[ric_conv].max()) <= RES_RTOL, "f64 K2 residuals differ")

    ric_finite = torch.isfinite(ric_kern32.x).all(1).cpu().numpy()
    ric_du0 = (ric_kern32.x[:, 120:132].double() - ric_plain64.x[:, 120:132]).abs().amax(1)
    ric_du0 = ric_du0.cpu().numpy()
    print(f"[K2 f32 vs plain f64] finite on {int(ric_finite.sum())}/{B} envs "
          f"({ric_finite.mean():.4%}); u0 |dGRF| [N], converged finite envs "
          f"({int((ric_conv & ric_finite).sum())}): {quantiles(ric_du0[ric_conv & ric_finite])}; "
          f"all finite envs: {quantiles(ric_du0[ric_finite])}, above {F32_U0_ATOL} N: "
          f"{int((ric_du0[ric_finite] > F32_U0_ATOL).sum())}")

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
    for k in pdipm_cuda.launches:
        pdipm_cuda.launches[k] = 0
    n_mpc, first_wrench, tau_ok = walk(ctrl, obs, TICKS, limit)
    torch.cuda.synchronize()
    launches = dict(pdipm_cuda.launches)
    fz = -first_wrench[:, :, 2]
    phase_adv = float((ctrl.state.gait_phase - phase0).min())
    print(f"[main path] MPCController b{B} HECTOR gait 2, {TICKS} ticks: run_mpc {n_mpc}, "
          f"kernel launches {launches}; tau finite and within limits: {tau_ok}; first solve "
          f"fz left [{float(fz[:, 0].min()):.2f}, {float(fz[:, 0].max()):.2f}] N, right swing "
          f"max |fz| {float(fz[:, 1].abs().max()):.3e} N; gait phase advanced by {phase_adv:.4f}")
    check(launches == {"ric_aug": n_mpc, "ric": 0},
          "the main path did not launch K1 once per run_mpc")
    check(tau_ok, "joint torques not finite or beyond the torque limits")
    check(bool((fz[:, 1].abs() < 1.0).all()), "swinging right foot carries force")
    check(bool((first_wrench[:, 0, 2] < -50.0).all()), "stance left foot not loaded")
    check(phase_adv > 0.05, "gait phase did not advance")

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
    for k in pdipm_cuda.launches:
        pdipm_cuda.launches[k] = 0
    h_mpc, h_first, h_tau_ok = walk(hctrl, obs, HYBRID_TICKS, limit,
                                    on_solve=lambda: stats.append(hctrl.hybrid_stats))
    torch.cuda.synchronize()
    h_launches = dict(pdipm_cuda.launches)
    h_fz = -h_first[:, :, 2]
    print(f"[hybrid path] MPCController solver=pallas_hybrid b{B}, {HYBRID_TICKS} ticks: "
          f"run_mpc {h_mpc}, kernel launches {h_launches}; hybrid_stats first "
          f"{stats[0]}, max dropped_nonfinite {max(st['dropped_nonfinite'] for st in stats)}, "
          f"resolved per solve {[st['resolved'] for st in stats]}; tau finite and within "
          f"limits: {h_tau_ok}; first solve fz left [{float(h_fz[:, 0].min()):.2f}, "
          f"{float(h_fz[:, 0].max()):.2f}] N, right swing max |fz| "
          f"{float(h_fz[:, 1].abs().max()):.3e} N")
    check(h_launches == {"ric_aug": h_mpc, "ric": h_mpc},
          "the hybrid path did not launch K2 and K1 once each per run_mpc")
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

    # 7. Times on the card (CUDA events, after warm-up).
    k32 = cuda_ms(lambda: pdipm_cuda.solve(qp32, opts), 20)
    k64 = cuda_ms(lambda: pdipm_cuda.solve(qp64, opts), 10)
    p32 = cuda_ms(lambda: pdipm.solve(qp32, opts), 3)
    p64 = cuda_ms(lambda: pdipm.solve(qp64, opts), 3)
    r32 = cuda_ms(lambda: pdipm_cuda.solve(qp32, ric), 20)
    r64 = cuda_ms(lambda: pdipm_cuda.solve(qp64, ric), 10)
    rp32 = cuda_ms(lambda: pdipm.solve(qp32, ric), 3)
    rp64 = cuda_ms(lambda: pdipm.solve(qp64, ric), 3)
    hyb32 = cuda_ms(lambda: pdipm_cuda.solve_hybrid(qp32, ric), 20)
    budget = max(64, B // 32)
    worst = torch.sort(ric_kern32.residuals.amax(1).nan_to_num(float("inf")), descending=True,
                       stable=True).indices[:budget]
    sub32 = qps.take(qp32, worst)
    k1_sub = cuda_ms(lambda: pdipm_cuda.solve(sub32, opts), 20)
    mpc_ms = cuda_ms(ctrl.run_mpc, 10)
    hmpc_ms = cuda_ms(hctrl.run_mpc, 10)

    def tick():
        ctrl.update_state(obs)
        ctrl.run_lowlevel()
        ctrl.get_action()

    tick_ms = cuda_ms(tick, 50)
    units = B * opts.iterations / 5
    print(f"[times] {label}: b{B} h10 {opts.iterations} iterations: kernel f32 {k32:.3f} ms "
          f"({units / k32 * 1e3:.0f} 5-iteration units/s), kernel f64 {k64:.3f} ms, "
          f"plain f32 {p32:.3f} ms, plain f64 {p64:.3f} ms")
    print(f"[times] {label}: b{B} h10 K2 (ric): kernel f32 {r32:.3f} ms "
          f"({units / r32 * 1e3:.0f} 5-iteration units/s), kernel f64 {r64:.3f} ms, "
          f"plain f32 {rp32:.3f} ms, plain f64 {rp64:.3f} ms")
    print(f"[times] {label}: b{B} f32 solve_hybrid {hyb32:.3f} ms (K1 alone on its "
          f"{budget}-env re-solve batch {k1_sub:.3f} ms)")
    print(f"[times] {label}: MPCController b{B} f32: run_mpc {mpc_ms:.3f} ms, hybrid run_mpc "
          f"{hmpc_ms:.3f} ms, 1 kHz tick (update_state + run_lowlevel + get_action) "
          f"{tick_ms:.3f} ms")

    print(json.dumps({"kernels": [{
        "name": "pdipm_ric_aug",
        "route": "cuda",
        "source": "biped_pympc_tpu_torch/csrc/pdipm_ric_aug.cu",
        "replaces": "biped_pympc_tpu/ops/pdipm_pallas.py:308",
        "launches": launches["ric_aug"],
        "max_abs_err": worst64,
        "ms": k32,
        "plain_ms": p32,
    }, {
        "name": "pdipm_ric",
        "route": "cuda",
        "source": "biped_pympc_tpu_torch/csrc/pdipm_ric.cu",
        "replaces": "biped_pympc_tpu/ops/pdipm_pallas.py:308 (backend=ric, foot_split)",
        "launches": h_launches["ric"],
        "max_abs_err": ric_worst64,
        "ms": r32,
        "plain_ms": rp32,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

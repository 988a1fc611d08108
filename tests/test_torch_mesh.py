"""The env-batch split over ranks (`parallel/mesh.py`) and the sharded
training (`examples/train_rl_mpc_tpu.py`) in two gloo processes on the CPU,
as `tests/test_multihost.py` runs JAX's over two processes: each rank holds
its shard's sharded control step, with and without metrics, the sharded
population rollout and one sharded ARS iteration against the same runs
unsharded on the whole batch, and `metrics_summary` against numpy.

Run as a script, this file is one rank: `python tests/test_torch_mesh.py
RANK WORLD PORT`."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
B = 4  # the global batch: two envs a rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hector_inputs(batch, dtype):
    rng = np.random.default_rng(0)
    obs = np.zeros((batch, 43))
    obs[:, 2] = 0.55
    obs[:, 3] = 1.0
    obs[:, 13:23] = np.tile([0.0, 0.0, 0.45, -0.9, 0.45], 2) + rng.uniform(-0.02, 0.02, (batch, 10))
    obs[:, 7:13] = rng.uniform(-0.05, 0.05, (batch, 6))
    twist = np.zeros((batch, 3))
    twist[:, 0] = rng.uniform(0.0, 0.4, batch)
    height = np.full(batch, 0.55)
    return [torch.tensor(a, dtype=dtype) for a in (obs, twist, height)]


def _check(name, got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)


def worker(rank: int, world: int, port: int) -> None:
    import torch.distributed as dist

    from biped_pympc_tpu_torch.config import ControllerConf, MPCConf
    from biped_pympc_tpu_torch.control.controller import BipedControllerCore
    from biped_pympc_tpu_torch.examples import train_rl_mpc_tpu as trainer
    from biped_pympc_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = pmesh.make_mesh("cpu")
        lo, hi = pmesh.shard_range(B, mesh)
        assert (mesh.rank, mesh.world, (lo, hi)) == (rank, world, (rank * 2, rank * 2 + 2))
        inputs = _hector_inputs(B, torch.float64)
        for solver in ("ric_aug", "pallas_hybrid"):
            core = BipedControllerCore(ControllerConf(), MPCConf(solver=solver, verbose=False),
                                       gait_id=2, dtype=torch.float64, device="cpu")
            full = core.init_state(B)
            tau_u, out_u = core.control_step(full, *inputs)
            for with_metrics in (False, True):
                state = pmesh.shard_state(core.init_state(B), mesh)
                ret = pmesh.controller_step(core, mesh, with_metrics)(
                    state, *pmesh.shard_state(inputs, mesh))
                _check(f"{solver} tau", ret[0], tau_u[lo:hi])
                _check(f"{solver} wrench", ret[1].wrench, out_u.wrench[lo:hi])
                _check(f"{solver} gait phase", state.gait_phase, full.gait_phase[lo:hi])
                assert ret[1].hybrid_counts is None
                if not with_metrics:
                    assert len(ret) == 2
                    continue
                metrics = ret[2]
                mean_cost = metrics if solver == "ric_aug" else metrics[0]
                torch.testing.assert_close(mean_cost, out_u.cost.mean(), rtol=1e-15, atol=0)
                if solver == "pallas_hybrid":
                    _check("hybrid counts", metrics[1], out_u.hybrid_counts)
            summary = pmesh.metrics_summary(out_u.cost[lo:hi], mesh)
            cost = out_u.cost.numpy()
            for key, want in (("mean", cost.mean()), ("max", cost.max()),
                              ("p50", np.median(cost))):
                np.testing.assert_allclose(summary[key].item(), want, rtol=1e-15, atol=0,
                                           err_msg=key)

        kw = dict(iters=1, n_dirs=1, envs_per=2, steps=2, seed=3, solver="tridiag_aug",
                  verbose=False)
        w_mesh = trainer.train(mesh=mesh, **kw)[0]
        w_ref = trainer.train(device="cpu", **kw)[0]
        np.testing.assert_array_equal(w_mesh, w_ref)
        rollout, carry0, w0 = trainer.make_sharded_training(mesh, B, steps=2, solver="tridiag_aug")
        _, returns = rollout(carry0, w0)
        env_step, reset_all, rl_obs, _ = trainer.make_device_env(B, solver="tridiag_aug",
                                                                 device="cpu")
        _, want = trainer.make_rollout(env_step, rl_obs, 2)(reset_all(), w0)
        _check("sharded rollout returns", returns, want)
        print(f"MESH_OK rank={rank} world={world}", flush=True)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_match_the_unsharded_runs():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), "2", str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"MESH_OK rank={rank} world=2" in out, out[-3000:]


def test_mesh_needs_an_initialized_group_and_an_even_split():
    from biped_pympc_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.make_mesh("cpu")
    with pytest.raises(ValueError, match="does not split evenly"):
        pmesh.shard_range(5, pmesh.Mesh(0, 2, torch.device("cpu")))


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))

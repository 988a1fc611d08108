"""The unsplit condensed route with Jacobi scaling (backend="ric",
foot_split=False, kkt_scale="jacobi") in float32: does the port lose envs
to non-finite values that the JAX package keeps?

Both sides solve the same float32 QPs: chip_smoke.py's randomized walking
draws (seed 0) built once through the JAX package's `build_qp` and carried
into the port with `convert.stage_qp_from_numpy`; MPCConf's options (20
Newton steps, one refinement pass). The port's plain version is held
against the JAX Pallas kernel it mirrors, run by the Pallas interpreter.
Which envs go non-finite in float32 is a matter of rounding: the envs a
nudge of f by 2^-22 relative flips, in the JAX kernel itself, are the
rounding witness. The port may lose no more envs than the JAX kernel plus
that witness.

    python tests/test_torch_ric_jacobi_f32_tail.py [batch]

prints the counts of every side at `batch` (default 4096, about two
minutes on a CPU), with and without the scaling, the pure-JAX
`pdipm.solve` included.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import biped_pympc_tpu.ops.pdipm_pallas as pp  # noqa: E402
import chip_smoke  # noqa: E402
from biped_pympc_tpu.models import hector as jax_hector  # noqa: E402
from biped_pympc_tpu.models.srbd import SrbdLin  # noqa: E402
from biped_pympc_tpu.ops import pdipm as jax_pdipm  # noqa: E402
from biped_pympc_tpu.ops import qp as jax_qp  # noqa: E402
from biped_pympc_tpu.utils.maths import rot_x, rot_y, rot_z  # noqa: E402
from biped_pympc_tpu_torch import convert  # noqa: E402
from biped_pympc_tpu_torch.ops import pdipm as port_pdipm  # noqa: E402

torch.set_num_threads(1)
NUDGE = 1 + 2.0 ** -22


def walking_qp(batch):
    """The first `batch` envs of chip_smoke's b4096 walking draws (seed 0)
    as a float32 JAX StageQP, built with JAX's `build_qp`."""
    f32 = jnp.float32
    q = jnp.asarray([150.0, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1], f32)
    r = jnp.asarray([1e-5] * 6 + [1e-4] * 6, f32)

    def one(x0, x_ref, contact, feet, mu):
        rot = rot_z(x0[2]) @ rot_y(x0[1]) @ rot_x(x0[0])
        lin = SrbdLin(rot_body=rot, inertia_world=rot @ jnp.asarray(jax_hector.I_BODY, f32) @ rot.T,
                      body_pos=x0[3:6], foot_pos=feet, mass=f32(jax_hector.MASS),
                      residual_lin_accel=jnp.zeros(3, f32), residual_ang_accel=jnp.zeros(3, f32))
        return jax_qp.build_qp(lin, x0, x_ref, contact, f32(0.025), mu, q, r, x_ref.shape[0])

    draws = chip_smoke.walking_draws(4096, 0)
    return jax.jit(jax.vmap(one))(*(jnp.asarray(d[:batch], f32) for d in draws))


def _lost(xs) -> set:
    """Envs with any non-finite entry in x, s, z or y."""
    ok = np.all(np.concatenate([np.isfinite(np.asarray(v)) for v in xs], axis=1), axis=1)
    return set(np.flatnonzero(~ok).tolist())


def lost_envs(batch, kkt_scale="jacobi", pure=False) -> dict:
    """{side: envs lost} of the float32 solve of `walking_qp(batch)`: the JAX
    Pallas kernel (interpreted) and the port's plain version, each also on f
    nudged by 2^-22 relative, and with `pure` the JAX `pdipm.solve`."""
    kw = dict(backend="ric", foot_split=False, kkt_scale=kkt_scale, refine_steps=1)
    jax_opts = jax_pdipm.PdipmOptions(**kw)
    port_opts = port_pdipm.PdipmOptions(**kw)
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    qp = walking_qp(batch)
    nudged = qp._replace(f=qp.f * np.float32(NUDGE))
    pl.pallas_call = interpreted
    try:
        kernel = jax.jit(lambda v: pp.solve(v, jax_opts))
        out = {"jax_kernel": kernel(qp), "jax_kernel_nudged": kernel(nudged)}
    finally:
        pl.pallas_call = orig
    if pure:
        out["jax_pure"] = jax.jit(jax.vmap(lambda v: jax_pdipm.solve(v, jax_opts)))(qp)
    for side, tree in (("port", qp), ("port_nudged", nudged)):
        out[side] = port_pdipm.solve(convert.stage_qp_from_numpy(
            jax.tree.map(np.asarray, tree), torch.float32), port_opts)
    return {side: _lost([res.x, res.s, res.z, res.y]) for side, res in out.items()}


def test_port_loses_no_more_envs_than_jax_plus_rounding():
    lost = lost_envs(256)
    witness = lost["jax_kernel"] ^ lost["jax_kernel_nudged"]
    assert len(lost["port"]) <= len(lost["jax_kernel"]) + len(witness), lost


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    for kkt_scale in ("jacobi", "none"):
        lost = lost_envs(batch, kkt_scale, pure=True)
        print(f"kkt_scale={kkt_scale} b{batch}, envs non-finite: "
              + ", ".join(f"{side} {len(envs)}" for side, envs in lost.items())
              + f"; differing envs: jax_kernel vs nudged "
              f"{len(lost['jax_kernel'] ^ lost['jax_kernel_nudged'])}, jax_kernel vs port "
              f"{len(lost['jax_kernel'] ^ lost['port'])}, port vs nudged "
              f"{len(lost['port'] ^ lost['port_nudged'])}, in both jax_kernel and port "
              f"{len(lost['jax_kernel'] & lost['port'])}", flush=True)


if __name__ == "__main__":
    main()

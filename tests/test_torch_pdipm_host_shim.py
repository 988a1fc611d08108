"""The device code of the routes with a warp group (K1, K2, K5b, K5d-a) on
the CPU: each built with g++ against `ops/host_shim.h` (`ops/host_build.py`:
one host thread per CUDA thread, barriers and shuffles as the shim's),
launched through the port's own wrapper (`pdipm_cuda.run_kernel`) on CPU
tensors, in the block group and in the route's warp group (K5b and K5d-a
with their stored inverses in shared memory and in the workspace), and held
against the plain version in f64 at a small size (B = 2, T = 2, 2 Newton
steps). Skips, deciding inside each test, where g++ is absent. The build
has no FMA contraction, so its agreement is that of the arithmetic, not the
card's rounding."""

import dataclasses

import pytest
import torch

from biped_pympc_tpu_torch.bench import bench_common
from biped_pympc_tpu_torch.bench import pdipm_geometry as pg
from biped_pympc_tpu_torch.ops import host_build, pdipm, pdipm_cuda

ATOL = 1e-10
GEOMETRIES = ("block", "warp")


def _geom(route, name):
    return pdipm_cuda.BLOCK if name == "block" else pdipm_cuda.geometry(route)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{route: the host build of K1 / K2 / K5b / K5d-a}, or a skip without
    g++."""
    if host_build.find_gxx() is None:
        pytest.skip("g++ is not installed: the host build of the kernels needs it")
    out = tmp_path_factory.mktemp("host_build")
    return {r: pdipm_cuda.load_library(
        host_build.build(pdipm_cuda.SOURCES[r], str(out / f"lib{r}.so")), r)
        for r in pdipm_cuda.LEAN_ROUTES}


def _qp(batch, horizon=2):
    return bench_common.make_qp_batch(batch, horizon=horizon, dtype=torch.float64, device="cpu")


def _opts(route, **kw):
    """The controller's options on `route` (`pdipm_geometry.route_opts`), 2
    Newton steps."""
    return dataclasses.replace(pg.route_opts(route), **{"iterations": 2, **kw})


def _assert_close(got, want, atol=ATOL):
    for name in ("x", "s", "z", "y", "residuals"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=atol,
                                   msg=name)


@pytest.mark.parametrize("horizon", [1, 2, 3])
@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("route", pdipm_cuda.LEAN_ROUTES)
def test_kernel_matches_the_plain_version(libs, route, geom, horizon):
    """B = 2, 2 steps, f64, T = 1 (a y-chain of one stage), 2 and 3 (an odd
    batch): both geometries within 1e-10 of the plain version."""
    qp = _qp(2 if horizon < 3 else 3, horizon)
    opts = _opts(route)
    got = pdipm_cuda.run_kernel(libs[route], qp, opts, None, geom=_geom(route, geom))
    _assert_close(got, pdipm.solve(qp, opts))


@pytest.mark.parametrize("horizon", [2, 3])
@pytest.mark.parametrize("route", pdipm_cuda.WORK_ROUTES)
def test_workspace_gives_the_bits_of_shared_memory(libs, route, horizon):
    """K5b and K5d-a in their warp group with the stored inverses in the
    device-memory workspace (here host memory) and in shared memory: the
    same arithmetic, so the same bits, both within 1e-10 of the plain
    version."""
    qp = _qp(2, horizon)
    opts = _opts(route)
    geom = _geom(route, "warp")
    shared = pdipm_cuda.run_kernel(libs[route], qp, opts, None, geom=geom, force_workspace=False)
    work = pdipm_cuda.run_kernel(libs[route], qp, opts, None, geom=geom, force_workspace=True)
    for name in ("x", "s", "z", "y", "residuals"):
        assert torch.equal(getattr(work, name), getattr(shared, name)), name
    _assert_close(work, pdipm.solve(qp, opts))


# Each option value on each route that takes it (df: the augmented routes
# only, `pdipm.check_options`; aug_pivot=False, K5f's natural order: on
# K5d-a, whose warp group eliminates both ways).
OPTIONS = [(route, name, kw) for name, kw in (
    ("tableau", dict(gj_form="tableau")), ("jacobi", dict(kkt_scale="jacobi")),
    ("sum_refine", dict(corrector_form="sum_refine")), ("combined", dict(corrector_form="combined")),
    ("aff_ref", dict(corrector_form="aff_ref")), ("df", dict(refine_residual="df")),
    ("sigma_cap", dict(sigma_cap=1e3)), ("no_pivot", dict(aug_pivot=False)))
    for route in pdipm_cuda.LEAN_ROUTES
    if not (route == "ric" and name == "df")
    and not (name == "no_pivot" and route != "ric_aug_dense")]


@pytest.mark.parametrize("route, name, kw", OPTIONS, ids=[f"{r}-{n}" for r, n, _ in OPTIONS])
def test_warp_group_options_match_the_plain_version(libs, route, name, kw):
    """The options reach the warp group's step body as they reach the block
    group's."""
    qp = _qp(2)
    opts = _opts(route, **kw)
    got = pdipm_cuda.run_kernel(libs[route], qp, opts, None, geom=_geom(route, "warp"))
    _assert_close(got, pdipm.solve(qp, opts))


@pytest.mark.parametrize("route", pdipm_cuda.LEAN_ROUTES)
def test_warm_chunks_equal_one_launch_in_the_warp_group(libs, route):
    """K3 in the warp group: two warm 1-step launches give the bits of one
    2-step launch."""
    qp = _qp(2)
    opts = _opts(route)
    geom = _geom(route, "warp")
    one = pdipm_cuda.run_kernel(libs[route], qp, opts, None, geom=geom)
    step = dataclasses.replace(opts, iterations=1)
    r = pdipm_cuda.run_kernel(libs[route], qp, step, None, geom=geom)
    r = pdipm_cuda.run_kernel(libs[route], qp, step, None, pdipm.PdipmState(r.x, r.s, r.z, r.y),
                              geom=geom)
    for name in ("x", "s", "z", "y", "residuals"):
        assert torch.equal(getattr(r, name), getattr(one, name)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_warp_entry_refuses_df_on_the_condensed_route(libs, dtype):
    """K2's warp entry, like its block entry, refuses the compensated
    residual (an augmented-route option): it returns an error and writes
    nothing."""
    qp = bench_common.make_qp_batch(2, horizon=2, dtype=dtype, device="cpu")
    opts = dataclasses.replace(_opts("ric"), refine_residual="df")
    suffix = "f32" if dtype == torch.float32 else "f64"
    for entry in (f"pdipm_ric_warp_{suffix}", f"pdipm_ric_{suffix}"):
        ins = pdipm_cuda._inputs(qp)
        outs = [torch.full((2, n), 7.0, dtype=dtype) for n in
                (qp.nz, qp.n_ineq, qp.n_ineq, qp.n_eq, 4)]
        err = getattr(libs["ric"], entry)(
            *[t.data_ptr() for t in ins], None, None, None, None, *[t.data_ptr() for t in outs],
            None, None, 2, qp.horizon, pdipm_cuda.ctypes.addressof(pdipm_cuda.args(opts)), None)
        assert err != 0, entry
        assert all(bool((t == 7.0).all()) for t in outs), entry


def test_ab_loader_runs_any_build_through_its_block_entries(libs, tmp_path):
    """`bench/pdipm_ab.load_block` declares only the block-group entries
    that every build shares; through it the host build of K2 gives the bits
    of the full loader's, and the plain version's values."""
    from biped_pympc_tpu_torch.bench import pdipm_ab

    path = host_build.build(pdipm_cuda.SOURCES["ric"], str(tmp_path / "libric.so"))
    qp = _qp(2)
    opts = _opts("ric")
    got = pdipm_cuda.run_kernel(pdipm_ab.load_block(path, "ric"), qp, opts, None,
                                geom=pdipm_cuda.BLOCK)
    want = pdipm_cuda.run_kernel(libs["ric"], qp, opts, None, geom=pdipm_cuda.BLOCK)
    assert pdipm_ab.digest(got) == pdipm_ab.digest(want)
    _assert_close(got, pdipm.solve(qp, opts))
    assert pdipm_ab.KEYS == ["ric", "ric2", "ric_aug", "ric_aug_dense", "ric_dense", "tridiag",
                             "tridiag_aug"]

"""The device code of the routes with a warp group (K1, K2, K5b, K5d-a, K5a,
K5e-a, K5c, K5d-c, K5e-c) on the CPU: each built with g++ against `ops/host_shim.h`
(`ops/host_build.py`: one host thread per CUDA thread, barriers and shuffles
as the shim's), launched through the port's own wrapper
(`pdipm_cuda.run_kernel`) on CPU tensors, in the block group and in the
route's warp group (K5b, K5d-a, K5a, K5c and K5d-c with their stored stage
inverses in shared memory and in the workspace; K5e-a and K5e-c in both
packings), and held
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
    """{route: the host build of every route with a warp group}, or a skip
    without g++."""
    if host_build.find_gxx() is None:
        pytest.skip("g++ is not installed: the host build of the kernels needs it")
    out = tmp_path_factory.mktemp("host_build")
    return {r: pdipm_cuda.load_library(
        host_build.build(pdipm_cuda.SOURCES[r], str(out / f"lib{r}.so")), r)
        for r in pdipm_cuda.LEAN_ROUTES}


@pytest.fixture(autouse=True)
def _own_counts(monkeypatch):
    """The host builds' launches count in copies, not in the process's
    counts that other tests of the same worker read."""
    for name in ("launches", "warp_launches", "residual_launches", "_runs", "_ran"):
        monkeypatch.setattr(pdipm_cuda, name, dict(getattr(pdipm_cuda, name)))


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


# f32 bounds relative to max(1, |v|) after 2 steps: the condensed K5a's W^-1
# blocks (up to ~1e8) amplify f32 rounding (1.1e-4 read at T = 2), and so do
# K5c's and K5d-c's (4.1e-5 and 5.5e-5 read at T = 3), held to K5a's class
# bound; the augmented K5e-a reads 1.6e-6 and the condensed K5e-c, K2's
# 4x4 halves, 1.3e-6, both held to 2e-5.
F32_RTOL = {"tridiag": 5e-4, "ric_aug_pack": 2e-5, "ric2": 5e-4, "ric_dense": 5e-4,
            "ric_pack": 2e-5}


@pytest.mark.parametrize("horizon", [1, 3])
@pytest.mark.parametrize("route", sorted(F32_RTOL))
def test_k5a_and_k5e_a_warp_groups_match_the_plain_version_in_f32(libs, route, horizon):
    """K5a's, K5e-a's, K5c's, K5d-c's and K5e-c's warp groups in f32 against
    the plain version in f32, B = 2, 2 steps, within their class's f32
    bound."""
    qp = bench_common.make_qp_batch(2, horizon=horizon, dtype=torch.float32, device="cpu")
    opts = _opts(route)
    got = pdipm_cuda.run_kernel(libs[route], qp, opts, None, geom=_geom(route, "warp"))
    want = pdipm.solve(qp, opts)
    for name in ("x", "s", "z", "y", "residuals"):
        u, v = getattr(got, name), getattr(want, name)
        rel = float(((u - v).abs() / v.abs().clamp_min(1.0)).max())
        assert rel <= F32_RTOL[route], (name, rel)


@pytest.mark.parametrize("horizon", [2, 3])
@pytest.mark.parametrize("route", pdipm_cuda.WORK_ROUTES)
def test_workspace_gives_the_bits_of_shared_memory(libs, route, horizon):
    """K5b, K5d-a, K5a, K5c and K5d-c in their warp group with the stored
    inverses (K5c's and K5d-c's stage records) in the
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
# K5d-a and K5e-a, whose warp groups eliminate both ways; k_pivot, the pivot
# search of the unsplit condensed blocks: on K5d-c; the packings:
# `route_opts` pairs the halves, "apply" eliminates each as K1 does (K5e-a,
# with and without the pivot search) or as K2 does (K5e-c); kkt_scale on
# K5e-c, which ignores it as the plain version does).
CONDENSED = ("ric", "tridiag", "ric2", "ric_dense", "ric_pack")
OPTIONS = [(route, name, kw) for name, kw in (
    ("tableau", dict(gj_form="tableau")), ("jacobi", dict(kkt_scale="jacobi")),
    ("sum_refine", dict(corrector_form="sum_refine")), ("combined", dict(corrector_form="combined")),
    ("aff_ref", dict(corrector_form="aff_ref")), ("df", dict(refine_residual="df")),
    ("sigma_cap", dict(sigma_cap=1e3)), ("no_pivot", dict(aug_pivot=False)),
    ("k_pivot", dict(k_pivot=True)),
    ("apply", dict(foot_pack="apply")), ("apply_no_pivot", dict(foot_pack="apply", aug_pivot=False)))
    for route in pdipm_cuda.LEAN_ROUTES
    if not (route in CONDENSED and name == "df")
    and not (name == "no_pivot" and route not in ("ric_aug_dense", "ric_aug_pack"))
    and not (name == "k_pivot" and route != "ric_dense")
    and not (name == "apply" and route not in ("ric_aug_pack", "ric_pack"))
    and not (name == "apply_no_pivot" and route != "ric_aug_pack")]


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


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("route", pdipm_cuda.LEAN_ROUTES)
def test_kernel_counts_the_launches_that_ran(libs, route, geom):
    """Each route adds one per launch, from its own device code, to its
    counter in its group (`pdipm_cuda.runs`; a launch replayed in a CUDA
    graph moves it as an eager one does); a gated launch adds to the
    counter it is given only when its gate is open, and leaves its outputs
    as they were when it is shut."""
    qp = _qp(2)
    opts = _opts(route)
    g = _geom(route, geom)
    pdipm_cuda.reset_counts()
    for _ in range(2):
        pdipm_cuda.run_kernel(libs[route], qp, opts, None, geom=g)
    lean = geom == "warp"
    assert pdipm_cuda.runs(warp=lean)[route] == 2 and pdipm_cuda.runs(warp=not lean)[route] == 0
    assert pdipm_cuda.launches[route] == 2
    ran = torch.zeros(1, dtype=torch.int32)
    outs = [torch.full((2, n), 7.0, dtype=torch.float64)
            for n in (qp.nz, qp.n_ineq, qp.n_ineq, qp.n_eq, 4)]
    for go in (0, 1):
        pdipm_cuda._launch(libs[route], qp, pdipm_cuda._inputs(qp), opts, None, None, outs,
                           go=torch.tensor([go], dtype=torch.int32), ran=ran, geom=g)
        assert all(bool((t == 7.0).all()) == (go == 0) for t in outs)
    assert ran.tolist() == [1] and pdipm_cuda.runs()[route] == 2
    assert pdipm_cuda.launches[route] == 4


def _assert_df_refused(libs, route, dtype):
    """Both entries of condensed `route` return an error for the compensated
    residual and write nothing."""
    qp = bench_common.make_qp_batch(2, horizon=2, dtype=dtype, device="cpu")
    opts = dataclasses.replace(_opts(route), refine_residual="df")
    suffix = "f32" if dtype == torch.float32 else "f64"
    for entry, work in ((f"pdipm_{route}_warp_{suffix}", route in pdipm_cuda.WORK_ROUTES),
                        (f"pdipm_{route}_{suffix}", False)):
        ins = pdipm_cuda._inputs(qp)
        outs = [torch.full((2, n), 7.0, dtype=dtype) for n in
                (qp.nz, qp.n_ineq, qp.n_ineq, qp.n_eq, 4)]
        err = getattr(libs[route], entry)(
            *[t.data_ptr() for t in ins], None, None, None, None, *[t.data_ptr() for t in outs],
            None, None, 2, qp.horizon, pdipm_cuda.ctypes.addressof(pdipm_cuda.args(opts)), None,
            *[None] * work)
        assert err != 0, entry
        assert all(bool((t == 7.0).all()) for t in outs), entry


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_warp_entry_refuses_df_on_the_condensed_route(libs, dtype):
    """K2's warp entry, like its block entry, refuses the compensated
    residual (an augmented-route option): it returns an error and writes
    nothing."""
    _assert_df_refused(libs, "ric", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_k5a_warp_entry_refuses_df(libs, dtype):
    """K5a's warp entry (with its workspace argument) refuses the compensated
    residual as its block entry does."""
    _assert_df_refused(libs, "tridiag", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("route", ["ric2", "ric_dense"])
def test_k5c_and_k5d_c_warp_entries_refuse_df(libs, route, dtype):
    """K5c's and K5d-c's warp entries (with their workspace argument) refuse
    the compensated residual as their block entries do."""
    _assert_df_refused(libs, route, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_k5e_c_warp_entry_refuses_df(libs, dtype):
    """K5e-c's warp entry refuses the compensated residual as its block
    entry does."""
    _assert_df_refused(libs, "ric_pack", dtype)


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
    assert pdipm_ab.KEYS == ["ric", "ric2", "ric_aug", "ric_aug_dense", "ric_aug_pack",
                             "ric_dense", "ric_pack", "tridiag", "tridiag_aug"]


@pytest.mark.parametrize("pack, pivot", [(True, True), ("apply", True), (True, False),
                                         ("apply", False)])
def test_k5e_a_pair_warp_matches_the_plain_version(libs, pack, pivot):
    """K5e-a's warp group eliminates each stage pair in one warp
    (`gj_pair_warp`): in both packings, pivoted or not, 4 steps, f64, T = 1
    (one pair: the second warp idle) and 3 (the first warp two pairs),
    within 1e-10 of the plain version (NaN where it has NaN: the natural
    order fails on the stress QPs by design)."""
    _assert_pair_warp_matches_the_plain_version(
        libs, "ric_aug_pack", _opts("ric_aug_pack", foot_pack=pack, aug_pivot=pivot, iterations=4))


def _assert_pair_warp_matches_the_plain_version(libs, route, opts):
    """`route`'s warp group within 1e-10 of the plain version at T = 1 and
    3, NaN where it has NaN."""
    for horizon in (1, 3):
        qp = _qp(2, horizon)
        got = pdipm_cuda.run_kernel(libs[route], qp, opts, None, geom=_geom(route, "warp"))
        want = pdipm.solve(qp, opts)
        for name in ("x", "s", "z", "y", "residuals"):
            torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0,
                                       atol=ATOL, equal_nan=True, msg=f"{name} T={horizon}")


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("pivot", [True, False], ids=["pivot", "no_pivot"])
def test_k1_pair_warp_matches_the_plain_version(libs, pivot, jacobi):
    """K1's warp group eliminates the two foot blocks of each stage in one
    warp (`gj_pair_warp` over its unpacked blocks), between Jacobi's passes
    when `kkt_scale="jacobi"`: pivoted or not, 4 steps, f64, T = 1 (the
    second warp idle) and 3 (the first warp two stages), within 1e-10 of the
    plain version (NaN where it has NaN: the natural order fails on the
    stress QPs by design)."""
    _assert_pair_warp_matches_the_plain_version(
        libs, "ric_aug", _opts("ric_aug", aug_pivot=pivot,
                               kkt_scale="jacobi" if jacobi else "none", iterations=4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_k1_warp_group_gives_its_block_groups_iterates(libs, dtype):
    """K1's warp group eliminates each foot block with its block group's
    arithmetic entry for entry (`gj_pair_regs` against
    `gj_inverse_inplace`), so after 2 steps at T = 3 its iterates are the
    block group's bit for bit, pivoted and not, under both Gauss-Jordan forms
    and with Jacobi's scaling; only the residual norms, which the warp group
    sums in its own order, may part."""
    qp = bench_common.make_qp_batch(2, horizon=3, dtype=dtype, device="cpu")
    for kw in ({}, dict(aug_pivot=False), dict(gj_form="tableau"), dict(kkt_scale="jacobi")):
        opts = _opts("ric_aug", **kw)
        warp, block = (pdipm_cuda.run_kernel(libs["ric_aug"], qp, opts, None,
                                             geom=_geom("ric_aug", g)) for g in GEOMETRIES)
        for name in ("x", "s", "z", "y"):
            torch.testing.assert_close(getattr(warp, name), getattr(block, name), rtol=0,
                                       atol=0, equal_nan=True, msg=f"{name} {kw}")


@pytest.mark.parametrize("horizon", [1, 2, 3])
@pytest.mark.parametrize("pack", [True, "apply"], ids=["pair", "apply"])
def test_k5e_c_warp_group_matches_the_plain_version(libs, pack, horizon):
    """K5e-c's warp group inverts each 4x4 half in one lane's registers: in
    both packings, under both Gauss-Jordan forms (the pair scales the pivot
    row by its reciprocal whatever gj_form says, as the plain version does),
    B = 2, 4 steps, f64, T = 1, 2 and 3, within 1e-10 of the plain version."""
    qp = _qp(2, horizon)
    for form in ("inplace", "tableau"):
        opts = _opts("ric_pack", foot_pack=pack, gj_form=form, iterations=4)
        got = pdipm_cuda.run_kernel(libs["ric_pack"], qp, opts, None,
                                    geom=_geom("ric_pack", "warp"))
        _assert_close(got, pdipm.solve(qp, opts))


@pytest.mark.parametrize("horizon", [1, 3])
@pytest.mark.parametrize("pack", [True, "apply"], ids=["pair", "apply"])
def test_k5e_c_warp_group_gives_k2s_bits_under_the_default_form(libs, pack, horizon):
    """Under gj_form "inplace" each half of K5e-c's pair is K2's inverse and
    the packed Bd K^-1 Bd^T is K2's sum in K2's order, and K5e-c's warp
    group sums mu and the residual norms in the block group's order, so it
    gives the bits of K2's block group in both packings; under "tableau" the
    pair (the reciprocal whatever the form) parts from K2 and "apply" does
    not."""
    qp = _qp(2, horizon)
    for form in ("inplace", "tableau"):
        opts = _opts("ric_pack", foot_pack=pack, gj_form=form)
        got = pdipm_cuda.run_kernel(libs["ric_pack"], qp, opts, None,
                                    geom=_geom("ric_pack", "warp"))
        k2 = pdipm_cuda.run_kernel(libs["ric"], qp, dataclasses.replace(opts, foot_pack=False),
                                   None, geom=_geom("ric", "block"))
        assert _same_bits(got, k2) == (form == "inplace" or pack == "apply"), form


def _same_bits(a, b):
    return all(torch.equal(getattr(a, n), getattr(b, n))
               for n in ("x", "s", "z", "y", "residuals"))


@pytest.mark.parametrize("form", ["inplace", "tableau"])
@pytest.mark.parametrize("pack", [True, "apply"], ids=["pair", "apply"])
def test_k5e_c_warp_group_gives_its_block_groups_bits(libs, pack, form):
    """K5e-c's warp group does its block group's arithmetic entry for entry
    and sums mu, mu_aff and the residual norms in the block group's order
    (`block_order_sum`), so at T = 10 after 10 steps, where K2's two groups
    already part by the order of those sums, its two groups give the same
    bits, in both packings and both forms."""
    qp = _qp(2, 10)
    opts = _opts("ric_pack", foot_pack=pack, gj_form=form, iterations=10)
    warp, block = (pdipm_cuda.run_kernel(libs["ric_pack"], qp, opts, None,
                                         geom=_geom("ric_pack", g)) for g in GEOMETRIES)
    assert _same_bits(warp, block)
    k2 = dataclasses.replace(opts, foot_pack=False)
    assert not _same_bits(*(pdipm_cuda.run_kernel(libs["ric"], qp, k2, None,
                                                  geom=_geom("ric", g)) for g in GEOMETRIES))

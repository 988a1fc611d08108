"""The launch geometry of the port's PDIPM kernels (`pdipm_cuda.geometry`):
K1 ("ric_aug") and K5e-a ("ric_aug_pack") run two warps per env, K2
("ric"), K5b ("tridiag_aug"), K5a ("tridiag"), K5c ("ric2") and K5d-c
("ric_dense") and K5e-c ("ric_pack") one, K5d-a ("ric_aug_dense") four,
one env per block, in their lean layouts (K5b's, K5d-a's, K5a's, K5c's and
K5d-c's stored stage inverses in shared memory or in a device-memory
workspace); every route keeps its block group for a caller that asks for
it. The layouts' byte
counts come from the kernels' own `make_layout`, read from a g++ build of
those routes against the host shim (`ops/host_build.py`; the tests that
need it skip, deciding inside the test, where g++ is absent)."""

import contextlib
import dataclasses
import types

import pytest
import torch

from biped_pympc_tpu_torch.ops import host_build, pdipm, pdipm_cuda

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# The largest horizon each route ran before the warp groups, per dtype: the
# block layout within 232,448 B (ROADMAP Queue 3, item 5).
BLOCK_MAX_T = {("ric_aug", "f32"): 45, ("ric_aug", "f64"): 22, ("ric", "f32"): 64,
               ("ric", "f64"): 31, ("ric_pack", "f32"): 63, ("ric_pack", "f64"): 31}
# The options of each route of BLOCK_MAX_T.
BLOCK_OPTS = {"ric_aug": dict(backend="ric_aug"), "ric": dict(backend="ric"),
              "ric_pack": dict(backend="ric", foot_pack=True)}
# One H100 SM: shared memory, the runtime's reserve per block and the
# allocation unit, in bytes; threads and blocks at most.
SM_SMEM, BLOCK_RESERVED_SMEM, SMEM_ALLOC_UNIT = 233472, 1024, 128
MAX_THREADS_PER_SM, MAX_BLOCKS_PER_SM = 2048, 32


def _size(dt):
    return torch.empty((), dtype=DTYPES[dt]).element_size()


# The largest horizon K5b, K5d-a, K5a, K5c and K5d-c run in their warp
# group, per dtype: the lean layout with the stored inverses in the
# workspace within 232,448 B; the values a stage stores (T x N x N
# inverses of width N; K5c its 12 x 12 Ru^-1, E Ru^-1 and the 2 x 2 S^-1);
# and the largest horizon their block layout fits (ROADMAP Queue 3, item 5).
WORK_MAX_T = {("tridiag_aug", "f32"): 103, ("tridiag_aug", "f64"): 50,
              ("ric_aug_dense", "f32"): 86, ("ric_aug_dense", "f64"): 42,
              ("tridiag", "f32"): 145, ("tridiag", "f64"): 72,
              ("ric2", "f32"): 94, ("ric2", "f64"): 46,
              ("ric_dense", "f32"): 94, ("ric_dense", "f64"): 46}
WORK_STAGE_VALUES = {"tridiag_aug": 42 ** 2, "ric_aug_dense": 30 ** 2, "tridiag": 26 ** 2,
                     "ric2": 12 ** 2 + 2 * 12 + 4, "ric_dense": 14 ** 2}
WORK_BLOCK_MAX_T = {("tridiag_aug", "f32"): 24, ("tridiag_aug", "f64"): 11,
                    ("ric_aug_dense", "f32"): 30, ("ric_aug_dense", "f64"): 14,
                    ("tridiag", "f32"): 44, ("tridiag", "f64"): 22,
                    ("ric2", "f32"): 46, ("ric2", "f64"): 23,
                    ("ric_dense", "f32"): 50, ("ric_dense", "f64"): 24}


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


def _bytes(libs, route, T, dt, lean):
    kind = "lean" if lean else "smem"
    return getattr(libs[route], f"pdipm_{route}_{kind}_bytes")(T, _size(dt))


@pytest.mark.parametrize("route, dt", sorted(BLOCK_MAX_T))
def test_block_layout_fits_the_horizons_of_before(libs, route, dt):
    """The block layout, unchanged, fits exactly the horizons it fit before."""
    fits = [T for T in range(1, 80)
            if _bytes(libs, route, T, dt, lean=False) <= pdipm_cuda.MAX_SMEM_PER_BLOCK]
    assert fits == list(range(1, BLOCK_MAX_T[route, dt] + 1))


@pytest.mark.parametrize("route, dt", sorted(BLOCK_MAX_T))
def test_every_horizon_that_ran_still_runs(libs, route, dt):
    """Each horizon up to the largest one of before fits the route's warp
    group: its lean layout within an H100 block's shared memory."""
    g = pdipm_cuda.geometry(route)
    assert g.lean and g.envs_per_block == 1
    for T in range(1, BLOCK_MAX_T[route, dt] + 1):
        assert _bytes(libs, route, T, dt, lean=True) <= pdipm_cuda.MAX_SMEM_PER_BLOCK, T


@pytest.mark.parametrize("T", [1, 2, 5, 10, 20, 30, 45, 64])
@pytest.mark.parametrize("route, dt", sorted(BLOCK_MAX_T))
def test_block_bytes_are_envs_times_the_env_layout(monkeypatch, libs, route, dt, T):
    """A warp group's block holds one env: the launch asks the library for
    the lean layout of one env and calls the warp entry when that is within
    232,448 B (always, up to the horizons of before), else raises before any
    launch. Through a stand-in library that answers the host build's bytes."""
    from biped_pympc_tpu_torch.bench import bench_common

    g = pdipm_cuda.geometry(route)
    assert (g.threads_per_env, g.envs_per_block) == (pdipm_cuda.WARP_THREADS[route], 1)
    lean = _bytes(libs, route, T, dt, lean=True)
    if T <= BLOCK_MAX_T[route, dt]:
        assert lean <= pdipm_cuda.MAX_SMEM_PER_BLOCK
    qp = bench_common.make_qp_batch(2, horizon=T, dtype=DTYPES[dt], device="cpu")
    opts = pdipm.PdipmOptions(foot_split=True, iterations=1, **BLOCK_OPTS[route])
    assert pdipm_cuda.route(opts) == route
    monkeypatch.setattr(pdipm_cuda, "launches", dict(pdipm_cuda.launches))
    monkeypatch.setattr(pdipm_cuda, "warp_launches", dict(pdipm_cuda.warp_launches))
    lib = _FakeLib(lean)
    if lean > pdipm_cuda.MAX_SMEM_PER_BLOCK:
        with pytest.raises(ValueError, match="shared memory per block"):
            pdipm_cuda.run_kernel(lib, qp, opts, None)
        assert lib.calls == [(f"pdipm_{route}_lean_bytes", (T, _size(dt)))]
    else:
        pdipm_cuda.run_kernel(lib, qp, opts, None)
        assert lib.calls == [(f"pdipm_{route}_lean_bytes", (T, _size(dt))),
                             (f"pdipm_{route}_warp_{dt}", None)]


@pytest.mark.parametrize("route", pdipm_cuda.LEAN_ROUTES)
@pytest.mark.parametrize("dt", DTYPES)
def test_lean_layout_is_smaller(libs, route, dt):
    """The lean layout needs less than the block layout at every horizon."""
    for T in range(1, 65):
        assert _bytes(libs, route, T, dt, lean=True) < _bytes(libs, route, T, dt, lean=False)


def _resident(nbytes, threads):
    """Envs per SM of one-env blocks of `nbytes` shared memory and `threads`
    threads, by shared memory (with the runtime's reserve, in whole units),
    blocks and threads; registers not counted."""
    per_block = -(-(nbytes + BLOCK_RESERVED_SMEM) // SMEM_ALLOC_UNIT) * SMEM_ALLOC_UNIT
    return min(SM_SMEM // per_block, MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // threads)


@pytest.mark.parametrize("route, dt, want, block_want", [
    ("ric_aug", "f32", 6, 4), ("ric", "f32", 8, 5), ("ric_aug", "f64", 3, 2), ("ric", "f64", 4, 2),
    ("ric_aug_pack", "f32", 6, 4), ("ric_aug_pack", "f64", 3, 2),
    ("ric2", "f32", 8, 4), ("ric2", "f64", 4, 2), ("ric_dense", "f32", 8, 4),
    ("ric_dense", "f64", 4, 2), ("ric_pack", "f32", 8, 5), ("ric_pack", "f64", 4, 2)])
def test_h10_geometry_puts_more_envs_on_an_sm(libs, route, dt, want, block_want):
    """At h10 the warp group's lean layouts let more envs reside on an SM by
    shared memory than the block group's (K2's block group in f32 is held to
    4 by its register cap besides; K5e-a's lean layout, K1's with the packed
    P_t and yc in its union, fits K1's 6; K5c's and K5d-c's, K2's with their
    stage records in the workspace, which the library takes where it puts
    more envs on an SM (`uses_workspace`; the host build's occupancy stub
    does not, so its lean bytes here carry them), K2's 8; K5e-c's is K2's, 8
    against its block group's 5 by shared memory, 4 with the registers)."""
    g = pdipm_cuda.geometry(route)
    lean = _bytes(libs, route, 10, dt, lean=True)
    resident = _resident(lean, g.threads_per_env)
    if route in pdipm_cuda.WORK_ROUTES:
        records = getattr(libs[route], f"pdipm_{route}_work_bytes")(10, _size(dt), 1)
        resident = max(resident, _resident(lean - records, g.threads_per_env))
    assert resident == want
    assert _resident(_bytes(libs, route, 10, dt, lean=False), 128) == block_want


@pytest.mark.parametrize("dt, want, with_inverses, block_want",
                         [("f32", 12, 5, 4), ("f64", 6, 2, 2)])
def test_k5a_workspace_layout_puts_more_envs_on_an_sm(libs, dt, want, with_inverses, block_want):
    """K5a's lean layout without its stored inverses (in the workspace) holds
    12 envs an SM at h10 in f32 and 6 in f64 by shared memory, against 5 and
    2 with them and the block layout's 4 and 2, so the library moves them
    (`uses_workspace`; the host build's occupancy stub does not, so its lean
    bytes here carry them)."""
    inverses = getattr(libs["tridiag"], "pdipm_tridiag_work_bytes")(10, _size(dt), 1)
    lean = _bytes(libs, "tridiag", 10, dt, lean=True)
    assert _resident(lean - inverses, 32) == want
    assert _resident(lean, 32) == with_inverses
    assert _resident(_bytes(libs, "tridiag", 10, dt, lean=False), 128) == block_want


class _FakeLib:
    """Stands in for a route's library: records the layout queried and the
    entry called, and launches nothing."""

    def __init__(self, nbytes):
        self.calls, self.nbytes = [], nbytes

    def __getattr__(self, name):
        def fn(*a):
            self.calls.append((name, a[:2] if name.endswith("_bytes") else None))
            return self.nbytes if name.endswith("_bytes") else 0
        return fn


@pytest.mark.parametrize("route", sorted(pdipm_cuda.SOURCES))
@pytest.mark.parametrize("T", [1, 10, 20])
def test_other_routes_keep_the_block_group(monkeypatch, route, T):
    """Every route has a warp group now, and keeps its block group for a
    caller that asks for it (`geom=BLOCK`, as chip_smoke.py and the benches
    do to compare): one env per 128-thread block, its own block layout (the
    library's `smem_bytes`) and its block entry, at any horizon and dtype,
    counted as a launch but not as a warp-group launch."""
    from biped_pympc_tpu_torch.bench import bench_common
    from biped_pympc_tpu_torch.bench import pdipm_geometry as pg

    assert pdipm_cuda.BLOCK == pdipm_cuda.Geometry(128, 1) and not pdipm_cuda.BLOCK.lean
    assert pdipm_cuda.geometry(route) != pdipm_cuda.BLOCK and route in pdipm_cuda.LEAN_ROUTES
    opts = dataclasses.replace(pg.route_opts(route), iterations=1)
    assert pdipm_cuda.route(opts) == route
    monkeypatch.setattr(pdipm_cuda, "launches", dict.fromkeys(pdipm_cuda.launches, 0))
    monkeypatch.setattr(pdipm_cuda, "warp_launches", dict.fromkeys(pdipm_cuda.warp_launches, 0))
    for dt, dtype in DTYPES.items():
        qp = bench_common.make_qp_batch(2, horizon=T, dtype=dtype, device="cpu")
        lib = _FakeLib(1024)
        pdipm_cuda.run_kernel(lib, qp, opts, None, geom=pdipm_cuda.BLOCK)
        assert lib.calls == [(f"pdipm_{route}_smem_bytes", (T, _size(dt))),
                             (f"pdipm_{route}_{dt}", None)]
    assert (pdipm_cuda.launches[route], pdipm_cuda.warp_launches[route]) == (2, 0)


@pytest.mark.parametrize("T", [10, 40])
@pytest.mark.parametrize("dt", DTYPES)
def test_k5e_c_lean_layout_is_k2s(libs, dt, T):
    """K5e-c's lean layout holds K2's values, the stage pairs only reordered
    (`krow`): the same bytes as K2's at h10 and h40 in f32 and f64, and so
    K2's horizons (90 / 44 against its block layout's 63 / 31)."""
    assert _bytes(libs, "ric_pack", T, dt, lean=True) == _bytes(libs, "ric", T, dt, lean=True)
    fits = lambda r, lean: max(t for t in range(1, 120)
                               if _bytes(libs, r, t, dt, lean) <= pdipm_cuda.MAX_SMEM_PER_BLOCK)
    assert fits("ric_pack", True) == fits("ric", True) == {"f32": 90, "f64": 44}[dt]
    assert fits("ric_pack", False) == BLOCK_MAX_T["ric_pack", dt]


class _WorkLib(_FakeLib):
    """A stand-in for K5b's or K5d-a's library: `lean_bytes` answers
    `nbytes`, `work_bytes` answers `work` per env, and the warp entry records
    the workspace pointer it is given."""

    def __init__(self, nbytes, work):
        super().__init__(nbytes)
        self.work, self.given = work, []

    def __getattr__(self, name):
        if name.endswith("_work_bytes"):
            return lambda *a: (self.calls.append((name, a)), self.work)[1]
        if "_warp_" in name:
            return lambda *a: (self.calls.append((name, None)), self.given.append(a[-1]), 0)[2]
        return super().__getattr__(name)


@pytest.mark.parametrize("route", pdipm_cuda.WORK_ROUTES)
@pytest.mark.parametrize("T", [1, 10, 20])
def test_work_routes_take_their_warp_group(monkeypatch, route, T):
    """K5b, K5d-a, K5a, K5c and K5d-c run their warp group (one, four, one,
    one and one warps an env, one env per block) at any horizon and dtype:
    the launch asks the library for the
    lean layout's bytes and the workspace per env, allocates batch x that
    when it is not 0 and passes it to the warp entry, else passes null."""
    from biped_pympc_tpu_torch.bench import bench_common
    from biped_pympc_tpu_torch.bench import pdipm_geometry as pg

    g = pdipm_cuda.geometry(route)
    assert g == pdipm_cuda.Geometry(pdipm_cuda.WARP_THREADS[route], 1, lean=True)
    assert (g.threads_per_env, route in pdipm_cuda.LEAN_ROUTES) == (
        {"tridiag_aug": 32, "ric_aug_dense": 128, "tridiag": 32, "ric2": 32,
         "ric_dense": 32}[route], True)
    opts = dataclasses.replace(pg.route_opts(route), iterations=1)
    assert pdipm_cuda.route(opts) == route
    monkeypatch.setattr(pdipm_cuda, "launches", dict.fromkeys(pdipm_cuda.launches, 0))
    monkeypatch.setattr(pdipm_cuda, "warp_launches", dict.fromkeys(pdipm_cuda.warp_launches, 0))
    for dt, dtype in DTYPES.items():
        qp = bench_common.make_qp_batch(2, horizon=T, dtype=dtype, device="cpu")
        for work in (0, 96):
            lib = _WorkLib(1024, work)
            pdipm_cuda.run_kernel(lib, qp, opts, None)
            assert lib.calls == [(f"pdipm_{route}_lean_bytes", (T, _size(dt))),
                                 (f"pdipm_{route}_work_bytes", (T, _size(dt), 0)),
                                 (f"pdipm_{route}_warp_{dt}", None)]
            assert (lib.given[0] is None) == (work == 0)
    assert pdipm_cuda.warp_launches[route] == pdipm_cuda.launches[route] == 4


@pytest.mark.parametrize("T", [10, 20, 40])
@pytest.mark.parametrize("route, dt", sorted(WORK_MAX_T))
def test_work_layouts_fit_at_the_long_horizons(libs, route, dt, T):
    """K5b's, K5d-a's, K5a's, K5c's and K5d-c's lean layouts at h10, h20 and
    h40 fit in an H100 block: with the T stored inverses in shared memory
    where the layout with them fits (the host build's occupancy stub never
    prefers the workspace), else workspace-backed, T x WORK_STAGE_VALUES
    values per env; forced, the workspace takes them at any horizon and the
    rest fits; the block layout fits exactly up to its old limit."""
    lean = _bytes(libs, route, T, dt, lean=True)
    assert lean <= pdipm_cuda.MAX_SMEM_PER_BLOCK
    work = getattr(libs[route], f"pdipm_{route}_work_bytes")
    inverses = T * WORK_STAGE_VALUES[route] * _size(dt)
    assert work(T, _size(dt), 1) == inverses
    if work(T, _size(dt), 0):
        assert work(T, _size(dt), 0) == inverses
        assert lean + inverses > pdipm_cuda.MAX_SMEM_PER_BLOCK
    else:
        assert lean > inverses  # the inverses are in it
    # The block layout refused f64 from T = 12 (K5b), 15 (K5d-a), 23 (K5a), 24
    # (K5c) and 25 (K5d-c).
    assert (_bytes(libs, route, T, dt, lean=False) > pdipm_cuda.MAX_SMEM_PER_BLOCK) == (
        T > WORK_BLOCK_MAX_T[route, dt])


@pytest.mark.parametrize("route, dt", sorted(WORK_MAX_T))
def test_work_routes_refuse_only_beyond_their_limit(libs, route, dt):
    """Every horizon up to WORK_MAX_T fits the warp group's lean layout, and
    none beyond it (the limit PERF.md states): the refusal is left only
    there, where the layout without the inverses outgrows a block."""
    fits = [T for T in range(1, 150)
            if _bytes(libs, route, T, dt, lean=True) <= pdipm_cuda.MAX_SMEM_PER_BLOCK]
    assert fits == list(range(1, WORK_MAX_T[route, dt] + 1))


@pytest.mark.parametrize("dt", DTYPES)
def test_hybrid_solves_both_take_their_warp_groups(monkeypatch, dt):
    """`solve_hybrid` on the card: the fast K2 solve of every env and the K1
    re-solve of the max(64, B // 32) worst both launch in their warp groups,
    whatever the batch (the warp groups were ahead from b128 up, PERF.md);
    recorded through a stand-in for the launch."""
    from biped_pympc_tpu_torch.bench import bench_common

    seen = []

    def fake_run_kernel(lib, qp, opts, stream, state=None, geom=None):
        key = pdipm_cuda.route(opts)
        seen.append((key, qp.f.shape[0], geom or pdipm_cuda.geometry(key)))
        return pdipm.solve(qp, opts, state)

    qp = bench_common.make_qp_batch(8, horizon=2, dtype=DTYPES[dt], device="cpu")
    monkeypatch.setattr(pdipm_cuda, "_device", lambda qp, opts: torch.device("cuda"))
    monkeypatch.setattr(pdipm_cuda, "_library", lambda backend: None)
    monkeypatch.setattr(pdipm_cuda, "run_kernel", fake_run_kernel)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=None))
    pdipm_cuda.solve_hybrid(qp, pdipm.PdipmOptions(backend="ric", foot_split=True,
                                                   refine_steps=1, iterations=2), budget=3)
    assert [(k, n) for k, n, _ in seen] == [("ric", 8), ("ric_aug", 3)]
    for key, _, geom in seen:
        assert geom.lean and geom.threads_per_env == pdipm_cuda.WARP_THREADS[key]


def test_block_geometry_rejected_for_other_routes_in_a_warp_group():
    """K5e-c ("ric_pack"), the last route to leave the block group, takes
    its one-warp group (K2's); a warp-group geometry that is not the
    route's own (another thread count, or the warp count without the lean
    layout) raises before any launch."""
    from biped_pympc_tpu_torch.bench import bench_common

    qp = bench_common.make_qp_batch(2, horizon=2, dtype=torch.float64, device="cpu")
    before = dict(pdipm_cuda.launches)
    pack = pdipm.PdipmOptions(backend="ric", foot_split=True, foot_pack=True)
    assert pdipm_cuda.route(pack) == "ric_pack"
    assert pdipm_cuda.geometry("ric_pack") == pdipm_cuda.Geometry(32, 1, lean=True) \
        == pdipm_cuda.geometry("ric")
    for opts, geom in ((pack, pdipm_cuda.Geometry(32, 1)),
                       (pack, pdipm_cuda.Geometry(64, 1, lean=True)),
                       (pdipm.PdipmOptions(backend="tridiag"), pdipm_cuda.Geometry(64, 1, lean=True)),
                       (pdipm.PdipmOptions(backend="ric"), pdipm_cuda.Geometry(64, 1)),
                       (pdipm.PdipmOptions(backend="ric_aug"), pdipm_cuda.Geometry(32, 2))):
        lib = _FakeLib(1024)
        with pytest.raises(ValueError, match="runs in"):
            pdipm_cuda.run_kernel(lib, qp, opts, None, geom=geom)
        assert lib.calls == []
    assert pdipm_cuda.launches == before


def test_build_keeps_the_compiler_output_beside_each_library(tmp_path):
    """`cuda_build.build` writes each library's compiler output (ptxas's
    registers and spills) beside it, so a library built by an earlier run
    still reports; a library with no log reports None."""
    from biped_pympc_tpu_torch.ops import cuda_build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "ptxas info    : Used 42 registers"\n'
                    'for a; do case "$a" in *.so) : > "$a";; esac; done\n')
    nvcc.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    path = cuda_build.library_path("k", str(src), (), str(tmp_path / "b"))
    assert cuda_build.build_log(path) is None
    cuda_build.build({"k": str(src)}, {"k": path}, str(tmp_path / "b"), nvcc=lambda: str(nvcc))
    assert "Used 42 registers" in cuda_build.build_log(path)
    cuda_build.build({"k": str(src)}, {"k": path}, str(tmp_path / "b"),
                     nvcc=lambda: pytest.fail("rebuilt a library that was there"))
    assert "Used 42 registers" in cuda_build.build_log(path)


def test_occupancy_query_names_the_group(monkeypatch):
    """`pdipm_geometry.envs_per_sm` asks the library for the block group
    (lean 0) or the route's warp group (lean 1) at the horizon and value
    size, and raises on the library's negative error."""
    from biped_pympc_tpu_torch.bench import pdipm_geometry as pg

    lib = _FakeLib(0)
    answers = iter([6, 4, -2])
    lib.pdipm_ric_aug_envs_per_sm = lambda *a: (lib.calls.append(a), next(answers))[1]
    monkeypatch.setattr(pdipm_cuda, "_library", lambda route: lib)
    assert pg.envs_per_sm("ric_aug", 10, torch.float32, pdipm_cuda.geometry("ric_aug")) == 6
    assert pg.envs_per_sm("ric_aug", 10, torch.float64, pdipm_cuda.BLOCK) == 4
    with pytest.raises(RuntimeError, match="occupancy query failed"):
        pg.envs_per_sm("ric_aug", 10, torch.float32, pdipm_cuda.BLOCK)
    assert lib.calls == [(10, 4, 1), (10, 8, 0), (10, 4, 0)]

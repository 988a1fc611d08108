"""Rules of the torch port that hold without the card: no jax imports (and
nothing of the JAX package or its `bench/` scripts), the CPU / CUDA dispatch
of the PDIPM, the build helper's errors, the kernels' C interface. The tests
marked `cuda` hold each kernel against the plain version on the card: cold
and warm starts, chunked launches, the adaptive gate and the compensated
residual of the PDIPM kernels, and the roofline probes and the synthetic
tape of the bench twins (`python -m pytest
tests/test_torch_port_rules.py -m cuda --noconftest` on a GPU machine, which
has no jax for `tests/conftest.py`)."""

import ast
import ctypes
import dataclasses
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from biped_pympc_tpu_torch.bench import ab_roofline, bench_synthetic, tape_codegen
from biped_pympc_tpu_torch.ops import cuda_build, pdipm, pdipm_cuda
from biped_pympc_tpu_torch.ops import qp as qps
from biped_pympc_tpu_torch.models.srbd import SrbdLin
from biped_pympc_tpu_torch.utils import tracing

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "biped_pympc_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "biped_pympc_tpu"), (path, mod)


# The JAX package's measurement scripts, importable by their bare names
# from bench/ (`import bench_common`) as well as through the package name.
BENCH_MODULES = {"bench"} | {p.stem for p in (REPO / "bench").glob("*.py")}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_of_bench(path):
    """The port's twins of bench/ keep their own copies of what they need."""
    for mod in _imported_modules(path):
        assert mod.split(".")[0] not in BENCH_MODULES, (path, mod)


def test_port_file_scan_covers_the_new_modules():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"biped_pympc_tpu_torch/ops/df.py", "biped_pympc_tpu_torch/ops/pdipm_cuda.py",
            "biped_pympc_tpu_torch/ops/cuda_build.py",
            "biped_pympc_tpu_torch/bench/bench_common.py",
            "biped_pympc_tpu_torch/bench/ab_roofline.py",
            "biped_pympc_tpu_torch/bench/bench_synthetic.py", "chip_smoke.py"} <= names
    assert {f"biped_pympc_tpu_torch/examples/{m}.py" for m in (
        "srbd_plant", "closed_loop_sim", "tpu_rollout", "rl_env", "rl_env_tpu", "train_rl_mpc",
        "train_rl_mpc_tpu", "cuda_graph", "planar_drone")} <= names
    assert {f"biped_pympc_tpu_torch/{m}.py" for m in (
        "models/chain", "models/urdf", "models/t1", "parallel/mesh", "utils/profiling",
        "utils/viz", "utils/cuda_graph", "utils/tracing")} <= names
    assert {"bench_common", "ab_roofline", "bench_synthetic"} <= BENCH_MODULES


_C_TYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "double": ctypes.c_double}


def _c_entry_params(source: str, name: str):
    """Parameter types of `int name(...)` in a kernel source's extern "C"
    block, as ctypes types."""
    m = re.search(rf"\bint {name}\((.*?)\)\s*\{{", source, flags=re.S)
    assert m, name
    kinds = []
    for param in m.group(1).split(","):
        decl = param.strip()
        kinds.append("ptr" if "*" in decl else decl.split()[0])
    return [_C_TYPES[k] for k in kinds]


@pytest.mark.parametrize("backend", sorted(pdipm_cuda.SOURCES))
def test_declared_c_interface_matches_the_entries(monkeypatch, backend):
    """`load_library` declares each entry with the types and arity the
    source defines (a pointer passed as c_int would be cut to 32 bits)."""
    source = pathlib.Path(pdipm_cuda.SOURCES[backend]).read_text()
    extern_c = source[source.index('extern "C" {'):]
    names = [f"pdipm_{backend}_{suffix}" for suffix in ("f32", "f64")]
    if backend == "ric_aug":
        names += [f"pdipm_ric_aug_residual_{suffix}" for suffix in ("f32", "f64")]
    extras = [f"pdipm_{backend}_smem_bytes", f"pdipm_{backend}_error_string"]
    if backend in pdipm_cuda.LEAN_ROUTES:  # the warp entries and occupancy
        names += [f"pdipm_{backend}_warp_{suffix}" for suffix in ("f32", "f64")]
        names.append(f"pdipm_{backend}_envs_per_sm")
        extras.append(f"pdipm_{backend}_lean_bytes")
    if backend in pdipm_cuda.WORK_ROUTES:  # K5b's and K5d-a's workspace
        extras.append(f"pdipm_{backend}_work_bytes")
    fake = types.SimpleNamespace(**{
        name: types.SimpleNamespace() for name in names + extras})
    monkeypatch.setattr(pdipm_cuda.ctypes, "CDLL", lambda path: fake)
    lib = pdipm_cuda.load_library("unused.so", backend)
    for name in names:
        assert getattr(lib, name).argtypes == _c_entry_params(extern_c, name), name
        assert getattr(lib, name).restype is ctypes.c_int
    assert len(pdipm_cuda.ENTRY_ARGTYPES) == 22
    assert len(pdipm_cuda.WORK_ENTRY_ARGTYPES) == 23
    assert len(pdipm_cuda.RESIDUAL_ARGTYPES) == 20


@pytest.mark.parametrize("module, path, entries", [
    (ab_roofline, ab_roofline.SOURCE,
     [f"roofline_{k}_{s}" for k in ("fma_peak", "stream") for s in ("f32", "f64")]),
    (bench_synthetic, bench_synthetic.INTERP_SOURCE, ["tape_run_f32", "tape_run_f64"])],
    ids=["roofline", "tape"])
def test_bench_kernels_declare_their_c_interface(monkeypatch, module, path, entries):
    """The bench twins declare each entry of their source with its types
    (the tape's: its interpreter, kept to compare)."""
    source = pathlib.Path(path).read_text()
    extern_c = source[source.index('extern "C" {'):]
    prefix = entries[0].split("_")[0]
    fake = types.SimpleNamespace(**{name: types.SimpleNamespace()
                                    for name in entries + [f"{prefix}_error_string"]})
    monkeypatch.setattr(module, "build", lambda: "unused.so")
    monkeypatch.setattr(module.ctypes, "CDLL", lambda path: fake)
    monkeypatch.setattr(module, "_lib", [])
    lib = module._library()
    for name in entries:
        assert getattr(lib, name).argtypes == _c_entry_params(extern_c, name), name
        assert getattr(lib, name).restype is ctypes.c_int


def _qp(batch, dtype, device="cpu", horizon=10):
    """A small standing QP batch through the port's `build_qp`."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device).expand(batch, 3, 3)
    lin = SrbdLin(rot_body=eye, inertia_world=eye * t([0.5413, 0.52, 0.0691]),
                  body_pos=t(np.tile([0.0, 0.0, 0.55], (batch, 1))),
                  foot_pos=t(np.tile([[0.0, 0.1, 0.0], [0.0, -0.1, 0.0]], (batch, 1, 1))),
                  mass=t(np.full(batch, 13.856)), residual_lin_accel=t(np.zeros((batch, 3))),
                  residual_ang_accel=t(np.zeros((batch, 3))))
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.02, 0.02, (batch, 12)) + np.eye(12)[5] * 0.55
    x_ref = np.zeros((batch, horizon, 12))
    x_ref[:, :, 5] = 0.55
    return qps.build_qp(lin, t(x0), t(x_ref), t(np.ones((batch, horizon, 2))), 0.025, 1.0,
                        t([150.0, 150, 250, 100, 100, 250, 1, 1, 5, 10, 10, 1]),
                        t([1e-5] * 6 + [1e-4] * 6), horizon)


def test_solve_refuses_devices_other_than_cpu_and_cuda():
    qp = _qp(2, torch.float64)
    meta = qps.StageQP(**{k: (v.to("meta") if torch.is_tensor(v) else v)
                          for k, v in vars(qp).items()})
    with pytest.raises(ValueError, match="CPU and CUDA"):
        pdipm_cuda.solve(meta)


def test_kernel_wrapper_refuses_unsupported_dtype():
    with pytest.raises(TypeError, match="float32 or float64"):
        pdipm_cuda.run_kernel(None, _qp(2, torch.float16), pdipm.PdipmOptions(), None)


def test_build_without_nvcc_raises_clear_error(monkeypatch, tmp_path):
    monkeypatch.setattr(pdipm_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pdipm_cuda.build()
    assert not list(tmp_path.iterdir())


def test_failed_ric_build_raises_and_does_not_fall_back(monkeypatch, tmp_path):
    """nvcc builds both routes at once; when the condensed route's source
    fails to compile, a CUDA solve on that route raises with the compiler's
    output instead of running the plain version."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nfor a; do last=$a; done\n'
                    'case "$last" in *pdipm_ric.cu) echo "pdipm_ric.cu: error" >&2; exit 1;; esac\n'
                    'for a; do case "$a" in *.so) : > "$a";; esac; done\n')
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(pdipm_cuda, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(pdipm_cuda, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(pdipm_cuda, "_libs", {})
    monkeypatch.setattr(pdipm, "solve", lambda *a, **k: pytest.fail("fell back to the plain version"))
    on_card = types.SimpleNamespace(f=types.SimpleNamespace(device=torch.device("cuda", 0)))
    before = dict(pdipm_cuda.launches)
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*pdipm_ric.cu: error"):
        pdipm_cuda.solve(on_card, pdipm.PdipmOptions(backend="ric", foot_split=True))
    assert pdipm_cuda.launches == before
    built = sorted(p.name.rsplit("_", 1)[0] for p in build_dir.glob("*.so"))
    assert sorted(p.stem for p in build_dir.glob("*.log")) == \
        sorted(p.stem for p in build_dir.glob("*.so"))  # each library's compiler output
    assert built == ["libpdipm_ric2", "libpdipm_ric_aug", "libpdipm_ric_aug_dense",
                     "libpdipm_ric_aug_pack", "libpdipm_ric_dense", "libpdipm_ric_pack",
                     "libpdipm_tridiag", "libpdipm_tridiag_aug"], built


def test_kernel_sources_include_only_their_own_headers():
    """The kernel sources stand alone: every #include is a system header or a
    file of csrc/, nothing of the JAX package."""
    csrc = REPO / "biped_pympc_tpu_torch" / "csrc"
    for path in sorted(csrc.iterdir()):
        for inc in re.findall(r'^#include\s+(\S+)', path.read_text(), flags=re.M):
            assert inc.startswith("<") or (csrc / inc.strip('"')).is_file(), (path.name, inc)
    assert {pathlib.Path(p).name for p in (*pdipm_cuda.SOURCES.values(), *pdipm_cuda.HEADERS,
                                           ab_roofline.SOURCE, bench_synthetic.INTERP_SOURCE,
                                           tracing.SOURCE)} \
        == {p.name for p in csrc.iterdir()}


def test_layout_over_the_shared_memory_limit_raises_before_launch():
    """A (route, horizon, dtype) whose layout exceeds an H100 block's shared
    memory raises ValueError naming all four, and launches nothing (nor
    allocates a workspace): the block layout, and a warp group's lean one."""
    def entry(*args):
        pytest.fail("launched a layout that does not fit")

    fake = types.SimpleNamespace(pdipm_tridiag_aug_smem_bytes=lambda T, size: 387736,
                                 pdipm_tridiag_aug_lean_bytes=lambda T, size: 387736,
                                 pdipm_tridiag_aug_f64=entry, pdipm_tridiag_aug_warp_f64=entry,
                                 pdipm_tridiag_aug_work_bytes=entry)
    before = dict(pdipm_cuda.launches)
    for geom in (pdipm_cuda.BLOCK, pdipm_cuda.geometry("tridiag_aug")):
        with pytest.raises(ValueError, match=r"'tridiag_aug' at horizon 10 in torch.float64 "
                                             r"needs 387736 B .* at most 232448 B"):
            pdipm_cuda.run_kernel(fake, _qp(2, torch.float64),
                                  pdipm.PdipmOptions(backend="tridiag_aug"), None, geom=geom)
    assert pdipm_cuda.launches == before


def test_controller_without_device_needs_a_card(monkeypatch):
    """The controller runs on the card unless asked for the CPU: with no card
    and no device it raises, naming device="cpu", and never falls back."""
    import biped_pympc_tpu_torch as tpkg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(verbose=False), num_envs=1)
    ctrl = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(verbose=False), num_envs=1,
                              device="cpu")
    assert ctrl.state.gait_phase.device.type == "cpu"


def test_dense_solver_runs():
    """solver="dense" (a batched LU of the condensed reduced KKT) runs: it has
    no kernel, so `pdipm_cuda.solve` runs its plain version and launches
    nothing."""
    import biped_pympc_tpu_torch as tpkg

    ctrl = tpkg.MPCController(tpkg.ControllerConf(), tpkg.MPCConf(solver="dense", verbose=False),
                              num_envs=2, device="cpu")
    assert ctrl.core.opts.backend == "dense"
    obs = torch.zeros(2, 43)
    obs[:, 2], obs[:, 3] = 0.55, 1.0
    obs[:, 13:18] = obs[:, 18:23] = torch.tensor([0.0, 0.0, 0.45, -0.9, 0.45])
    before = dict(pdipm_cuda.launches)
    ctrl.update_state(obs)
    ctrl.run_mpc()
    assert pdipm_cuda.launches == before
    fz = -ctrl.ground_reaction_wrench[:, :, 2]
    assert bool(torch.isfinite(ctrl.ground_reaction_wrench).all())
    assert bool((fz.sum(1) > 0.8 * 13.856 * 9.81).all())


@pytest.mark.parametrize("pack", [True, "apply"])
def test_foot_pack_names_its_roadmap_item(pack):
    """The foot packing (K5e: PERF.md section 6, its K5e rows) is ported:
    where the JAX controller packs, the port maps the value as it is onto
    the packed route and runs it (here its plain version on the CPU)."""
    import biped_pympc_tpu_torch as tpkg

    conf = tpkg.MPCConf(solver="pallas_ric_aug", solver_foot_pack=pack, verbose=False)
    ctrl = tpkg.MPCController(tpkg.ControllerConf(), conf, num_envs=1, device="cpu")
    assert ctrl.core.opts.foot_pack == pack
    assert pdipm_cuda.route(ctrl.core.opts) == "ric_aug_pack"
    obs = torch.zeros(1, 43)
    obs[:, 2], obs[:, 3] = 0.55, 1.0
    obs[:, 13:18] = obs[:, 18:23] = torch.tensor([0.0, 0.0, 0.45, -0.9, 0.45])
    ctrl.update_state(obs)
    ctrl.run_mpc()
    assert bool(torch.isfinite(ctrl.ground_reaction_wrench).all())


def test_hash_covers_the_shared_header(monkeypatch, tmp_path):
    """An edit to the header both kernels include builds both anew."""
    header = tmp_path / "pdipm_common.cuh"
    header.write_text("// one")
    monkeypatch.setattr(pdipm_cuda, "HEADERS", (str(header),))
    first = {b: pdipm_cuda.library_path(b) for b in pdipm_cuda.SOURCES}
    header.write_text("// two")
    second = {b: pdipm_cuda.library_path(b) for b in pdipm_cuda.SOURCES}
    assert all(first[b] != second[b] for b in first)


# Eight f64 Newton steps: far enough to exercise every phase, short of the
# non-converged late steps where two correct implementations that round
# differently part ways (PERF.md, Findings); chip_smoke.py checks the
# full 20 steps, and f32, on converged envs. Residual norms of the equality
# rows sit near roundoff (~1e-10), hence the absolute floor on them.
# The options of each kernel (`pdipm_cuda.route`):
OPTIONS = {"ric_aug": dict(backend="ric_aug", foot_split=True),
           "ric": dict(backend="ric", foot_split=True), "tridiag_aug": dict(backend="tridiag_aug"),
           "tridiag": dict(backend="tridiag"), "ric2": dict(backend="ric2"),
           "ric_dense": dict(backend="ric", foot_split=False),
           "ric_aug_dense": dict(backend="ric_aug", foot_split=False),
           "ric_pack": dict(backend="ric", foot_split=True, foot_pack=True),
           "ric_aug_pack": dict(backend="ric_aug", foot_split=True, foot_pack=True)}
ROUTES = list(OPTIONS)
RICCATI = ["ric_aug", "ric", "ric2", "ric_dense", "ric_aug_dense"]  # take kkt_scale
# The option values that are not a route of their own, each on a kernel
# that reads it: the packing's other form, the Gauss-Jordan form and the
# pivot knobs, the corrector forms, the refinement schedule, the sigma cap
# and the step rule's constants.
# Under gj_form "inplace" the "apply" form of ric_pack inverts each half as
# the paired form does, bit for bit, so it is held under "tableau".
FLAGS = {"ric_pack apply": ("ric_pack", dict(foot_pack="apply", gj_form="tableau")),
         "ric_aug_pack apply": ("ric_aug_pack", dict(foot_pack="apply")),
         "ric_aug_pack no pivot": ("ric_aug_pack", dict(aug_pivot=False)),
         "ric tableau": ("ric", dict(gj_form="tableau")),
         "ric2 tableau": ("ric2", dict(gj_form="tableau")),
         "ric_dense k_pivot": ("ric_dense", dict(k_pivot=True)),
         "ric_aug no pivot": ("ric_aug", dict(aug_pivot=False)),
         "ric_aug_dense no pivot": ("ric_aug_dense", dict(aug_pivot=False)),
         "ric_aug combined": ("ric_aug", dict(corrector_form="combined")),
         "ric_aug sum_refine": ("ric_aug", dict(corrector_form="sum_refine")),
         "ric_aug aff_ref": ("ric_aug", dict(corrector_form="aff_ref")),
         "tridiag combined": ("tridiag", dict(corrector_form="combined")),
         "ric sum_refine": ("ric", dict(corrector_form="sum_refine")),
         "ric_aug skip 2": ("ric_aug", dict(refine_skip_iters=2)),
         "ric_aug sigma_cap": ("ric_aug", dict(sigma_cap=1e2)),
         "ric sigma_cap": ("ric", dict(sigma_cap=1e2)),
         "ric_aug frac 0.95": ("ric_aug", dict(frac_to_boundary=0.95))}


def test_options_cover_every_kernel():
    assert sorted(OPTIONS) == sorted(pdipm_cuda.SOURCES)
    assert all(pdipm_cuda.route(pdipm.PdipmOptions(**kw)) == key for key, kw in OPTIONS.items())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ROUTES)
@pytest.mark.parametrize("horizon, refine_steps", [(10, 1), (5, 0), (20, 2)])
def test_kernel_matches_plain_on_card(horizon, refine_steps, backend):
    """A (route, horizon) whose f64 layout in the route's geometry does not
    fit in shared memory must raise before any launch instead (none here
    since K5b's and K5d-a's warp groups run T = 20 in f64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    qp = _qp(64, torch.float64, "cuda", horizon)
    opts = pdipm.PdipmOptions(iterations=8, refine_steps=refine_steps, **OPTIONS[backend])
    before = dict(pdipm_cuda.launches)
    geom = pdipm_cuda.geometry(backend)
    if pdipm_cuda.smem_bytes(backend, horizon, torch.float64, geom) > pdipm_cuda.MAX_SMEM_PER_BLOCK:
        with pytest.raises(ValueError, match="shared memory"):
            pdipm_cuda.solve(qp, opts)
        assert pdipm_cuda.launches == before
        return
    got = pdipm_cuda.solve(qp, opts)
    want = pdipm.solve(qp, opts)
    torch.cuda.synchronize()
    assert pdipm_cuda.launches == {**before, backend: before[backend] + 1}
    for name in "xszy":
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-7)
    torch.testing.assert_close(got.residuals, want.residuals, rtol=1e-6, atol=1e-10)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("flag", list(FLAGS))
def test_flag_kernel_matches_plain_on_card(flag):
    """Each option value on a kernel that reads it vs its plain version at
    f64, eight steps, one refinement pass, the bounds of
    test_kernel_matches_plain_on_card; the value reaches the kernel (the
    solve is not the route's default solve bit for bit)."""
    _card()
    backend, kw = FLAGS[flag]
    qp = _qp(64, torch.float64, "cuda")
    base = pdipm.PdipmOptions(iterations=8, refine_steps=1, **OPTIONS[backend])
    opts = dataclasses.replace(base, **kw)
    assert pdipm_cuda.route(opts) == backend
    before = dict(pdipm_cuda.launches)
    got = pdipm_cuda.solve(qp, opts)
    want = pdipm.solve(qp, opts)
    torch.cuda.synchronize()
    assert pdipm_cuda.launches == {**before, backend: before[backend] + 1}
    for name in "xszy":
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-7)
    torch.testing.assert_close(got.residuals, want.residuals, rtol=1e-6, atol=1e-10)
    assert not _bit_equal(got, pdipm_cuda.solve(qp, base))


def _bit_equal(a, b):
    return all(torch.equal(getattr(a, n), getattr(b, n)) for n in ("x", "s", "z", "y", "residuals"))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_warm_chunks_bit_equal_fixed_on_card(dtype, backend):
    """Four warm 5-step launches == one 20-step launch, bit for bit; and the
    adaptive solve at tol=0 is the same solve in 4 gated launches."""
    _card()
    qp = _qp(64, dtype, "cuda")
    opts = pdipm.PdipmOptions(refine_steps=1, **OPTIONS[backend])
    fixed = pdipm_cuda.solve(qp, opts)
    five = dataclasses.replace(opts, iterations=5)
    res = pdipm_cuda.solve(qp, five)
    for _ in range(3):
        res = pdipm_cuda.solve(qp, five, pdipm.PdipmState(res.x, res.s, res.z, res.y))
    assert _bit_equal(res, fixed)
    pdipm_cuda.reset_counts()
    adaptive = pdipm_cuda.solve_adaptive(qp, opts, 0.0)
    assert pdipm_cuda.launches[backend] == 4 and pdipm_cuda.chunks_ran()[backend] == 4
    assert _bit_equal(adaptive, fixed)
    pdipm_cuda.reset_counts()
    one = pdipm_cuda.solve_adaptive(qp, opts, 1e12)
    assert pdipm_cuda.launches[backend] == 4 and pdipm_cuda.chunks_ran()[backend] == 1
    assert _bit_equal(one, pdipm_cuda.solve(qp, five))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", RICCATI)
def test_jacobi_kernel_matches_plain_on_card(backend):
    """kkt_scale="jacobi" on every Riccati kernel vs its plain version at
    f64, the bounds of test_kernel_matches_plain_on_card; the flag reaches
    the kernel (the scaled solve is not the unscaled one bit for bit)."""
    _card()
    qp = _qp(64, torch.float64, "cuda")
    opts = pdipm.PdipmOptions(iterations=8, refine_steps=1, kkt_scale="jacobi",
                              **OPTIONS[backend])
    got = pdipm_cuda.solve(qp, opts)
    want = pdipm.solve(qp, opts)
    torch.cuda.synchronize()
    for name in "xszy":
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-7)
    assert not _bit_equal(got, pdipm_cuda.solve(qp, dataclasses.replace(opts, kkt_scale="none")))


@pytest.mark.cuda
def test_unsplit_aug_f64_layout_refused_at_horizon_20_on_card():
    """K5d-a keeps T x 900 stored inverses: in f64 at horizon 20 its block
    layout exceeds a block's shared memory and a block-group launch raises
    before any launch; its warp group keeps them in the workspace there and
    runs, matching the plain version, and refuses only beyond T = 42."""
    _card()
    opts = pdipm.PdipmOptions(**OPTIONS["ric_aug_dense"])
    assert pdipm_cuda.smem_bytes("ric_aug_dense", 20, torch.float64) > pdipm_cuda.MAX_SMEM_PER_BLOCK
    assert pdipm_cuda.smem_bytes("ric_aug_dense", 10, torch.float64) <= pdipm_cuda.MAX_SMEM_PER_BLOCK
    qp = _qp(4, torch.float64, "cuda", 20)
    lib = pdipm_cuda._library("ric_aug_dense")
    before = dict(pdipm_cuda.launches)
    with pytest.raises(ValueError, match="'ric_aug_dense' at horizon 20 in torch.float64"):
        pdipm_cuda.run_kernel(lib, qp, opts, None, geom=pdipm_cuda.BLOCK)
    assert pdipm_cuda.launches == before
    got = pdipm_cuda.solve(qp, opts)
    want = pdipm.solve(qp, opts)
    for name in ("x", "s", "z", "y"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="'ric_aug_dense' at horizon 43 in torch.float64"):
        pdipm_cuda.solve(_qp(2, torch.float64, "cuda", 43), opts)


def _cancellation_case(qp, seed=3):
    """Residual inputs at late-iteration scales: W over 1e-6..1e6, directions
    ~30, r = K d + a 1e-4 true residual (K d in f64 from the rounded data),
    so r - K d cancels nearly every digit. Returns (w, dirs, rhs)."""
    rng = np.random.default_rng(seed)
    nb, dtype, dev = qp.f.shape[0], qp.f.dtype, qp.f.device
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)
    w = t(10.0 ** rng.uniform(-6, 6, (nb, qp.n_ineq)))
    dirs = [t(rng.standard_normal((nb, n)) * 30) for n in (qp.nz, qp.n_ineq, qp.n_eq)]
    f = lambda v: v.to(torch.float64)
    q64 = dataclasses.replace(qp, q_diag=f(qp.q_diag), r_diag=f(qp.r_diag), f=f(qp.f), b0=f(qp.b0),
                              g_u=f(qp.g_u), d=f(qp.d), dyn=dataclasses.replace(
                                  qp.dyn, A=f(qp.dyn.A), B=f(qp.dyn.B), c=f(qp.dyn.c)))
    neg_kd = pdipm.refine_residual_aug(q64, qps.h_diag(q64), f(w), pdipm.PdipmOptions(),
                                       *map(f, dirs), *[torch.zeros_like(f(v)) for v in dirs])
    rhs = [(t(rng.standard_normal(tuple(m.shape)) * 1e-4, torch.float64) - m).to(dtype)
           for m in neg_kd]
    return w, dirs, rhs


def test_refine_residual_on_cpu_is_the_plain_version():
    qp = _qp(3, torch.float32)
    w, dirs, rhs = _cancellation_case(qp)
    for kind in pdipm.REFINE_RESIDUALS:
        opts = pdipm.PdipmOptions(backend="ric_aug", refine_residual=kind)
        got = pdipm_cuda.refine_residual(qp, w, *dirs, *rhs, opts)
        want = pdipm.refine_residual_aug(qp, qps.h_diag(qp), w, opts, *dirs, *rhs)
        assert all(torch.equal(g, v) for g, v in zip(got, want)), kind
    with pytest.raises(ValueError, match="aug"):
        pdipm_cuda.refine_residual(qp, w, *dirs, *rhs,
                                   pdipm.PdipmOptions(backend="ric", refine_residual="df"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_df_kernel_matches_plain_on_card(dtype):
    """The compensated refinement residual on K1 vs its plain version. On the
    cancellation case, K1's residual code (through its residual entry) must
    match the plain df version, every error-free step its own torch op, to
    1e-6 (f32) / 1e-9 (f64) of the largest residual, and the f32 residual, the
    control, must miss that bound. The solve (eight steps, as
    test_kernel_matches_plain_on_card) is held at f64 to 1e-7, and at f32
    against the f64 plain df solve at chip_smoke.py's GRF bound, 0.5 N."""
    _card()
    qp = _qp(64, dtype, "cuda")
    opts = pdipm.PdipmOptions(iterations=8, refine_steps=1, refine_residual="df",
                              **OPTIONS["ric_aug"])
    w, dirs, rhs = _cancellation_case(qp)
    plain = pdipm.refine_residual_aug(qp, qps.h_diag(qp), w, opts, *dirs, *rhs)
    rel = lambda got: max(float((g - p).abs().max() / p.abs().max()) for g, p in zip(got, plain))
    bound = 1e-6 if dtype == torch.float32 else 1e-9
    assert rel(pdipm_cuda.refine_residual(qp, w, *dirs, *rhs, opts)) <= bound
    control = pdipm_cuda.refine_residual(qp, w, *dirs, *rhs, dataclasses.replace(
        opts, refine_residual="f32"))
    assert rel(control) > bound
    got = pdipm_cuda.solve(qp, opts)
    want = pdipm.solve(_qp(64, torch.float64, "cuda"), opts)
    torch.cuda.synchronize()
    atol = 1e-7 if dtype == torch.float64 else 0.5
    for name in "xszy":
        torch.testing.assert_close(getattr(got, name).double(), getattr(want, name), rtol=0,
                                   atol=atol)
    with pytest.raises(ValueError, match="aug"):
        pdipm_cuda.solve(qp, dataclasses.replace(opts, backend="ric"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tridiag_aug_df_kernel_matches_plain_on_card(dtype):
    """K5b with the compensated residual (the device function K1's residual
    entry checks) vs the plain df solve at f64, the bounds of
    test_df_kernel_matches_plain_on_card; K5a refuses df before any launch."""
    _card()
    qp = _qp(64, dtype, "cuda")
    opts = pdipm.PdipmOptions(iterations=8, refine_steps=1, refine_residual="df",
                              backend="tridiag_aug")
    before = dict(pdipm_cuda.launches)
    got = pdipm_cuda.solve(qp, opts)
    want = pdipm.solve(_qp(64, torch.float64, "cuda"), opts)
    torch.cuda.synchronize()
    assert pdipm_cuda.launches == {**before, "tridiag_aug": before["tridiag_aug"] + 1}
    atol = 1e-7 if dtype == torch.float64 else 0.5
    for name in "xszy":
        torch.testing.assert_close(getattr(got, name).double(), getattr(want, name), rtol=0,
                                   atol=atol)
    with pytest.raises(ValueError, match="aug"):
        pdipm_cuda.solve(qp, dataclasses.replace(opts, backend="tridiag"))
    assert pdipm_cuda.launches["tridiag"] == before["tridiag"]


# The bench twins' kernels (K6, K7, K8) on the card.
def _roofline_peak(dtype, rows=32):
    a, x = ab_roofline.roofline_inputs()[0][16]
    return torch.from_numpy(a).to("cuda", dtype), torch.from_numpy(x[:rows]).to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("chains, threads", [(1, 128), (2, 256), (4, 96), (8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fma_peak_kernel_matches_plain_on_card(dtype, chains, threads):
    """K6, 2,000 steps: float32 within a rounding of the plain version (both
    round once per step; the plain version's float64 detour rounds twice,
    which parts from one rounding only on a float32 midpoint), float64
    within 2,000 roundings (the plain version rounds product and sum)."""
    _card()
    a, x = _roofline_peak(dtype)
    before = ab_roofline.launches["fma_peak"]
    got = ab_roofline.fma_peak(a, x, 2000, chains, threads)
    want = ab_roofline.fma_peak_plain(a, x, 2000)
    torch.cuda.synchronize()
    assert ab_roofline.launches["fma_peak"] == before + 1
    rtol = 1e-6 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)


@pytest.mark.cuda
def test_fma_peak_kernel_refuses_bad_knobs_on_card():
    _card()
    a, x = _roofline_peak(torch.float32)
    before = ab_roofline.launches["fma_peak"]
    for chains, threads in ((3, 128), (1, 100), (1, 2048)):
        with pytest.raises(RuntimeError, match="launch failed"):
            ab_roofline.fma_peak(a, x, 10, chains, threads)
    assert ab_roofline.launches["fma_peak"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [256, 3])
def test_stream_kernel_matches_plain_on_card(rows):
    """K7 in float32, 2,000 passes, rtol 1e-5 (chip_smoke's bound at 20,000),
    also over a ragged last tile."""
    _card()
    a, b, x = (torch.from_numpy(v[:rows]).cuda() for v in ab_roofline.roofline_inputs()[1])
    before = ab_roofline.launches["stream"]
    got = ab_roofline.stream(a, b, x, 2000)
    want = ab_roofline.stream_plain(a, b, x, 2000)
    torch.cuda.synchronize()
    assert ab_roofline.launches["stream"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ops, batch", [(10, 256), (1000, 4096), (100, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tape_kernel_matches_plain_on_card(dtype, n_ops, batch):
    """K8, the kernel generated from the tape, against the plain version, a
    batch that is no multiple of the block included, at 32-, 64- and
    128-thread blocks: atol 1e-6 in float32, 1e-12 in float64 (the kernel
    fuses x y + c); the interpreter it replaced within the same bounds."""
    _card()
    tape = bench_synthetic.make_tape(n_ops)
    rng = np.random.default_rng(1)
    s = torch.tensor(rng.uniform(0.5, 1.5, (bench_synthetic.N_STATE, batch)), dtype=dtype,
                     device="cuda")
    before = dict(bench_synthetic.launches)
    want = bench_synthetic.apply_tape_rows(tape, s)
    atol = 1e-6 if dtype == torch.float32 else 1e-12
    enc = bench_synthetic.encode_tape(tape, dtype, s.device)
    got = bench_synthetic.run_tape(enc, s)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    for threads in (32, 128):  # the launcher's other block sizes, uncounted
        assert torch.equal(enc.kernel(s, threads), got)
    interp = bench_synthetic.run_tape_interpreted(tape, s)
    torch.cuda.synchronize()
    assert bench_synthetic.launches == {"tape": before["tape"] + 1,
                                        "tape_interp": before["tape_interp"] + 1}
    torch.testing.assert_close(interp, want, rtol=0, atol=atol)


@pytest.mark.cuda
def test_tape_segments_give_the_bits_of_one_kernel_on_card():
    """A tape cut into consecutive kernels (the 16 values of each env passed
    through device memory) gives the bits of one kernel of the whole tape,
    and counts a launch per segment."""
    _card()
    tape = bench_synthetic.make_tape(250)
    s = torch.rand(bench_synthetic.N_STATE, 300, device="cuda") + 0.5
    whole = bench_synthetic.run_tape(tape, s)
    enc = bench_synthetic.encode_tape(tape, s.dtype, s.device)
    sources, paths, per_tape = tape_codegen.plan([(tape, s.dtype)], pdipm_cuda.BUILD_DIR,
                                                 segment=100)
    cuda_build.build(sources, paths, pdipm_cuda.BUILD_DIR)
    enc.kernel = tape_codegen.Kernel(s.dtype, [tape_codegen.load(p) for p in per_tape[0]])
    before = bench_synthetic.launches["tape"]
    cut = bench_synthetic.run_tape(enc, s)
    torch.cuda.synchronize()
    assert len(enc.kernel.libs) == 3 and bench_synthetic.launches["tape"] == before + 3
    assert torch.equal(cut, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pallas_ric_aug", "tridiag_aug"])
def test_captured_rollout_equals_eager_on_card(solver):
    """One MPC cycle captured as a CUDA graph and replayed
    (`examples/tpu_rollout.Rollout`) gives the eager cycles' bits; the host
    counts K1 / K5b only in the warm-up and the capture, the kernel counts
    itself in the warm-up and once a replayed cycle (`pdipm_cuda.runs`), and
    a second call replays from the carry it is given."""
    _card()
    from biped_pympc_tpu_torch.examples import tpu_rollout

    core = tpu_rollout.make_core(solver, device="cuda", verbose=False)
    carry = tpu_rollout.init_carry(core, 64, 0.3, 0.55)
    eager, cycles = tpu_rollout.make_rollout(core, 0.0301, graph=False)
    _, want = eager(carry)
    want = want.clone()
    graph, _ = tpu_rollout.make_rollout(core, 0.0301)
    before, ran = dict(pdipm_cuda.launches), pdipm_cuda.runs()
    _, got = graph(carry)
    torch.cuda.synchronize()
    route = pdipm_cuda.route(core.opts)
    assert graph.loop.graph is not None and cycles == 3
    assert pdipm_cuda.launches == {**before, route: before[route] + 2}
    assert pdipm_cuda.runs() == {**ran, route: ran[route] + 1 + cycles}
    assert torch.equal(got, want)
    _, again = graph(carry)
    assert torch.equal(again, want)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pallas_ric_aug", "pallas_hybrid"])
def test_captured_wrapper_equals_eager_core_on_card(solver):
    """`MPCController`'s calls, each a CUDA graph captured at its first use
    and replayed, give the bits of the core's eager methods on a clone of the
    state over two periods with a reset; every call is a replayed graph; and
    a replayed run_mpc runs K1 once (K1 and K2 in the hybrid), as the
    kernels count themselves, and issues nothing from the host."""
    _card()
    from biped_pympc_tpu_torch import ControllerConf, MPCConf, MPCController
    from biped_pympc_tpu_torch.utils.tree import leaves, tree_map

    nb = 64
    ctrl = MPCController(ControllerConf(), MPCConf(solver=solver, verbose=False), num_envs=nb,
                         gait_id=2, device="cuda")
    core = ctrl.core
    obs = torch.zeros(nb, 43, device="cuda")
    obs[:, 2], obs[:, 3] = 0.55, 1.0
    obs[:, 13:18] = obs[:, 18:23] = torch.tensor([0.0, 0.0, 0.45, -0.9, 0.45], device="cuda")
    twist = torch.tensor([0.3, 0.0, 0.0], device="cuda").expand(nb, 3)
    height = torch.full((nb,), 0.55, device="cuda")
    est = tree_map(torch.clone, ctrl.state)
    ctrl.set_command(twist, height)
    core.set_command(est, twist, height)
    mask = torch.zeros(nb, dtype=torch.bool, device="cuda")
    mask[[1, 2]] = True
    for step in range(20):
        if step == 10:
            ctrl.reset([1, 2])
            core.reset(est, mask)
        ctrl.update_state(obs)
        core.ingest_state(est, obs)
        if step % 10 == 0:
            ctrl.run_mpc()
            core.run_mpc(est)
        ctrl.run_lowlevel()
        core.run_lowlevel(est)
        assert torch.equal(ctrl.get_action(), core.joint_torque(est)), step
    theirs = dict(leaves(est))
    for path, t in leaves(ctrl.state):
        assert torch.equal(t, theirs[path]), path
    assert all(loop.graph is not None for loop in ctrl.graphs.values()) and len(ctrl.graphs) == 6
    before, ran = dict(pdipm_cuda.launches), pdipm_cuda.runs()
    ctrl.run_mpc()
    after = {k: n - ran[k] for k, n in pdipm_cuda.runs().items() if n != ran[k]}
    assert after == ({"ric_aug": 1} if solver == "pallas_ric_aug" else {"ric_aug": 1, "ric": 1})
    assert pdipm_cuda.launches == before


# The batched LU of solver="dense" at its size on the main path: b4096, the
# (nz + ne)-wide KKT of horizon 10 (24 * 10 + 14 * 10 = 380), f32.
LU_BATCH, LU_WIDTH = 4096, 380


@pytest.mark.cuda
def test_dense_lu_cannot_be_captured_on_card():
    """The reason `pdipm._factor_dense` selects cuSOLVER on the card:
    `torch.linalg.lu_factor_ex` under torch's default linear-algebra
    backend (MAGMA's batched LU at this width) cannot be captured in a CUDA
    graph. The capture runs in a process of its own, since a refused capture
    can leave the process's CUDA context unusable; a torch whose LU can be
    captured fails this test, and the selection should then go."""
    _card()
    import subprocess
    import sys

    code = f"""
import torch
dev = torch.device("cuda")
m = torch.randn({LU_BATCH}, {LU_WIDTH}, {LU_WIDTH}, device=dev)
m += {LU_WIDTH} * torch.eye({LU_WIDTH}, device=dev)
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    torch.linalg.lu_factor_ex(m, check_errors=False)
torch.cuda.current_stream().wait_stream(side)
torch.cuda.synchronize()
graph = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(graph):
        torch.linalg.lu_factor_ex(m, check_errors=False)
    graph.replay()
    torch.cuda.synchronize()
except RuntimeError:
    print("refused")
else:
    print("captured")
"""
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    lines = run.stdout.split()
    assert lines and lines[-1] == "refused", (run.returncode, run.stdout, run.stderr[-2000:])


@pytest.mark.cuda
def test_dense_lu_under_cusolver_is_captured_on_card():
    """`pdipm._cusolver` around the dense route's LU and solve at the main
    path's size: the capture takes them, a replay gives the eager call's
    bits, and the preferred library is torch's default again after each
    call, eager and captured."""
    _card()
    dev = torch.device("cuda")
    default = torch.backends.cuda.preferred_linalg_library()
    g = torch.Generator(device=dev).manual_seed(0)
    m = torch.randn(LU_BATCH, LU_WIDTH, LU_WIDTH, device=dev, generator=g)
    m += LU_WIDTH * torch.eye(LU_WIDTH, device=dev)
    rhs = torch.randn(LU_BATCH, LU_WIDTH, 1, device=dev, generator=g)

    def factor_solve():
        with pdipm._cusolver(m):
            lu, piv, _ = torch.linalg.lu_factor_ex(m, check_errors=False)
        with pdipm._cusolver(lu):
            return lu, torch.linalg.lu_solve(lu, piv, rhs)

    want = [t.clone() for t in factor_solve()]
    assert torch.backends.cuda.preferred_linalg_library() == default
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        factor_solve()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = factor_solve()
    assert torch.backends.cuda.preferred_linalg_library() == default
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pallas_ric_aug", "pallas_hybrid", "dense"])
def test_captured_control_step_equals_eager_on_card(solver):
    """`BipedControllerCore.control_step`, one CUDA graph captured at its
    first call and replayed, against the eager step over four calls, each on
    a new state cloned from a rolling eager run: the state, tau and the
    wrench bit for bit; a replay runs K1 once (K1 and K2 in the hybrid), as
    the kernels count themselves, and issues nothing from the host."""
    _card()
    from biped_pympc_tpu_torch import ControllerConf, MPCConf
    from biped_pympc_tpu_torch.control.controller import BipedControllerCore
    from biped_pympc_tpu_torch.utils.tree import leaves, tree_map

    nb = 64
    core = BipedControllerCore(ControllerConf(), MPCConf(solver=solver, verbose=False),
                               gait_id=2, device="cuda")
    obs = torch.zeros(nb, 43, device="cuda")
    obs[:, 2], obs[:, 3] = 0.55, 1.0
    obs[:, 13:18] = obs[:, 18:23] = torch.tensor([0.0, 0.0, 0.45, -0.9, 0.45], device="cuda")
    twist = torch.tensor([0.3, 0.0, 0.0], device="cuda").expand(nb, 3)
    height = torch.full((nb,), 0.55, device="cuda")
    eager = core.init_state(nb)
    for i in range(4):
        core._control_step(eager, obs, twist, height)
        mine = tree_map(torch.clone, eager)
        before, ran = dict(pdipm_cuda.launches), pdipm_cuda.runs()
        tau, out = core.control_step(mine, obs + 0.001 * i, twist, height)
        torch.cuda.synchronize()
        after = {k: n - ran[k] for k, n in pdipm_cuda.runs().items() if n != ran[k]}
        if i > 0:
            assert pdipm_cuda.launches == before
            assert after == {"pallas_ric_aug": {"ric_aug": 1}, "dense": {},
                             "pallas_hybrid": {"ric_aug": 1, "ric": 1}}[solver]
        tau_e, out_e = core._control_step(eager, obs + 0.001 * i, twist, height)
        assert torch.equal(tau, tau_e) and torch.equal(out.wrench, out_e.wrench), i
        theirs = dict(leaves(eager))
        for path, t in leaves(mine):
            assert torch.equal(t, theirs[path]), (i, path)
    assert list(core.graphs) == [(nb, torch.float32)]

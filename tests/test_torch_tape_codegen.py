"""K8's redesign, the straight-line kernel generated from the tape
(`biped_pympc_tpu_torch/bench/tape_codegen.py`), on the CPU: the generated
source built with g++ against `ops/host_shim.h` (`ops/host_build.py`) and
run on CPU tensors through the port's own launcher (`tape_codegen.Kernel`),
against the port's plain `apply_tape_rows`, the JAX script's
`apply_tape_rows` (`bench/bench_synthetic.py`) and, in float64, its serial
NumPy `eval_cpu`, and bit for bit against the host build of the
interpreter it replaced (`csrc/tape.cu`); the exact constants, the cut into segments, the
libraries' names, the build of every tape at once and the wrapper's refusal
to interpret or fall back. Skips what needs g++, deciding inside the test,
where it is absent. The host build has no FMA contraction, so its agreement
is that of the arithmetic, not the card's rounding."""

import ctypes
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biped_pympc_tpu_torch.bench import bench_synthetic, tape_codegen
from biped_pympc_tpu_torch.ops import cuda_build, host_build, pdipm_cuda
from test_torch_port_rules import REPO

sys.path.insert(0, str(REPO / "bench"))
import bench_synthetic as jax_synthetic  # noqa: E402

torch.set_num_threads(1)
ATOL = {torch.float32: 1e-6, torch.float64: 1e-12}  # chip_smoke.py's K8_ATOL
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# (n_ops, seed) of the tapes held against the plain version: the first
# five seeds at 10 and 100 ops, and 300, 37 and 250 ops; the bound is
# relative to max(1, |v|), as some tapes grow the state past 1e13. At 300
# ops seeds 1, 3 and 4 overflow the state or amplify the one rounding by
# which the kernel's fused x y + c and 1 + y y part from the plain
# version's to 1e-4 in float32: every seed is held bit for bit against
# the interpreter, whose arithmetic is the kernel's (`INTERP_TAPES`).
TAPES = [(n, seed) for n in (10, 100) for seed in range(5)] + [(300, 0), (37, 7), (250, 2)]
INTERP_TAPES = [(n, seed) for n in (10, 100, 300) for seed in range(5)] + [(1000, 0)]


def _assert_close_rel(got, want, atol):
    """|got - want| <= atol max(1, |want|) where `want` is finite; NaN
    and +-inf where, and only where, `want` has them."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    gap = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert gap.size == 0 or gap.max() <= atol, f"max gap {gap.max():.3e} relative to max(1, |v|)"


def _state(batch, dtype, seed=1):
    """The JAX script's state: rng(1), uniform [0.5, 1.5), (16, batch)."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.5, 1.5, (tape_codegen.N_STATE, batch)).astype(np.float32)
    return torch.from_numpy(s).to(dtype)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """(tape, dtype, segment) -> the host build of its generated kernels,
    built once each; a skip without g++."""
    if host_build.find_gxx() is None:
        pytest.skip("g++ is not installed: the host build of the kernels needs it")
    out = tmp_path_factory.mktemp("tape_gen")
    cache = {}

    def get(tape, dtype, segment=tape_codegen.SEGMENT_OPS):
        sources, paths, per_tape = tape_codegen.plan([(tape, dtype)], str(out), segment)
        for key, src in sources.items():
            if key not in cache:
                cache[key] = host_build.build(src, paths[key])
        return tape_codegen.Kernel(dtype, [tape_codegen.load(p) for p in per_tape[0]])

    return get


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n_ops, seed", TAPES)
def test_generated_kernel_matches_plain_and_jax(host_kernel, n_ops, seed, dt):
    """The generated kernel of 10-300-op tapes on 65 envs (a ragged last
    block of 64 threads) against the port's plain version and the JAX
    script's `apply_tape_rows` in the same dtype, and in float64 its serial
    NumPy evaluation, within K8's bounds relative to max(1, |v|)."""
    dtype = DTYPES[dt]
    tape = bench_synthetic.make_tape(n_ops, seed)
    s = _state(65, dtype)
    got = host_kernel(tape, dtype)(s, threads=64)
    _assert_close_rel(got, bench_synthetic.apply_tape_rows(tape, s), ATOL[dtype])
    jx = np.asarray(jax.jit(lambda v: jax_synthetic.apply_tape_rows(tape, v))(
        jnp.asarray(s.numpy())))
    assert jx.dtype == s.numpy().dtype
    _assert_close_rel(got, jx, ATOL[dtype])
    if dtype == torch.float64:
        _assert_close_rel(got, jax_synthetic.eval_cpu(tape, s.numpy().T.copy()).T, ATOL[dtype])


@pytest.fixture(scope="module")
def host_interpreter(tmp_path_factory):
    """The host build of the interpreter of csrc/tape.cu: (ops, (16, B)
    state) -> the tape on the state; a skip without g++."""
    if host_build.find_gxx() is None:
        pytest.skip("g++ is not installed: the host build of the kernels needs it")
    out = tmp_path_factory.mktemp("tape_interp")
    lib = ctypes.CDLL(host_build.build(bench_synthetic.INTERP_SOURCE, str(out / "libtape.so")))
    for fn in (lib.tape_run_f32, lib.tape_run_f64):
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def run(tape, s):
        enc = bench_synthetic.encode_tape(tape, s.dtype)
        out_ = torch.empty_like(s)
        fn = lib.tape_run_f32 if s.dtype == torch.float32 else lib.tape_run_f64
        assert fn(enc.code.data_ptr(), enc.c.data_ptr(), len(tape), s.data_ptr(),
                  out_.data_ptr(), s.shape[1], None) == 0
        return out_

    return run


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n_ops, seed", INTERP_TAPES)
def test_generated_kernel_gives_the_interpreters_bits(host_kernel, host_interpreter, n_ops,
                                                      seed, dt):
    """The generated kernel and the interpreter it replaced write the same
    roundings (fma, 1 + y y fused, the IEEE division, the blend), so on 65
    envs they give the same bits for any tape, those that overflow the
    state included (NaN where NaN)."""
    dtype = DTYPES[dt]
    tape = bench_synthetic.make_tape(n_ops, seed)
    s = _state(65, dtype)
    got, want = host_kernel(tape, dtype)(s), host_interpreter(tape, s)
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    same = (got.view(ints) == want.view(ints)) | (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), f"{int((~same).sum())} values differ"


@pytest.mark.parametrize("threads", [32, 64, 128])
def test_block_size_does_not_change_the_bits(host_kernel, threads):
    """Each env is one thread whatever the block: 32-, 64- and 128-thread
    blocks give the same bits, over a batch that is no multiple of any."""
    tape = bench_synthetic.make_tape(100)
    kern = host_kernel(tape, torch.float64)
    s = _state(70, torch.float64)
    assert torch.equal(kern(s, threads=threads), kern(s, threads=32))


@pytest.mark.parametrize("dt", DTYPES)
def test_segments_give_the_bits_of_one_kernel(host_kernel, dt):
    """A 250-op tape cut into kernels of 100 ops (three launches, the 16
    values of each env passed through memory) gives the bits of one kernel
    of the whole tape, and the launcher reports each launch."""
    dtype = DTYPES[dt]
    tape = bench_synthetic.make_tape(250, seed=2)
    whole, cut = host_kernel(tape, dtype), host_kernel(tape, dtype, segment=100)
    assert (len(whole.libs), len(cut.libs)) == (1, 3)
    s = _state(40, dtype)
    seen = []
    got = cut(s, threads=32, on_launch=lambda: seen.append(1))
    assert len(seen) == 3
    assert torch.equal(got, whole(s, threads=32))


def test_launch_error_raises(host_kernel):
    """A launch the kernel refuses (a block that is no multiple of 32)
    raises, and reports no launch."""
    kern = host_kernel(bench_synthetic.make_tape(10), torch.float32)
    seen = []
    with pytest.raises(RuntimeError, match="generated tape kernel launch failed"):
        kern(_state(8, torch.float32), threads=48, on_launch=lambda: seen.append(1))
    assert seen == []
    with pytest.raises(ValueError, match="contiguous"):
        kern(_state(8, torch.float64))


@pytest.mark.parametrize("dt", DTYPES)
def test_constants_round_trip_exactly(dt):
    """Every fma constant is written as an exact hex-float literal of the
    constant rounded to the dtype: read back, it is that value bit for bit
    (the constants the interpreter reads, `encode_tape`)."""
    dtype = DTYPES[dt]
    tape = bench_synthetic.make_tape(400, seed=5)
    text = tape_codegen.source(tape, dtype)
    suffix = "f" if dtype == torch.float32 else ""
    lits = re.findall(r"fmaf?\(s\d+, s\d+, (-?0x[0-9a-f.]+p[-+]\d+)" + suffix + r"\)", text)
    consts = [c for op, *_, c in tape if op == "fma"]
    assert len(lits) == len(consts) > 50
    enc = bench_synthetic.encode_tape(tape, dtype)
    rounded = [c for (op, *_), c in zip(tape, enc.c.double().tolist()) if op == "fma"]
    assert [float.fromhex(v) for v in lits] == rounded
    assert tape_codegen.literal(0.0, dtype) == "0x0p+0" + suffix
    assert float.fromhex(tape_codegen.literal(-1e-3, dtype).rstrip("f")) == (
        float(np.float32(-1e-3)) if dtype == torch.float32 else -1e-3)


def test_changed_tape_gets_a_new_library_path(tmp_path):
    """A library's name is a hash of its generated source and the flags: the
    same tape and dtype name the same library; a changed op, row, constant
    or dtype names another."""
    tape = bench_synthetic.make_tape(50)
    path = lambda t, dt=torch.float32: tape_codegen.plan([(t, dt)], str(tmp_path))[2][0]
    assert path(tape) == path(list(tape))
    changed = [
        [("mul" if tape[0][0] != "mul" else "add", *tape[0][1:])] + tape[1:],
        tape[:1] + [(tape[1][0], (tape[1][1] + 1) % 16, *tape[1][2:])] + tape[2:],
        [(*op[:4], op[4] + 1e-3) if op[0] == "fma" else op for op in tape],
        tape[:-1]]
    names = {tuple(path(tape))} | {tuple(path(t)) for t in changed}
    assert len(names) == len(changed) + 1
    assert path(tape, torch.float64) != path(tape)
    assert all(p.startswith(str(tmp_path)) and p.endswith(".so") for p in path(tape))


def test_plan_cuts_long_tapes_into_segments(tmp_path):
    """A tape of more than SEGMENT_OPS ops is cut into kernels of that many
    ops in tape order, each source written beside its library; a short tape
    and the empty tape are one kernel."""
    n = 2 * tape_codegen.SEGMENT_OPS + 5
    tape = bench_synthetic.make_tape(n)
    sources, paths, per_tape = tape_codegen.plan(
        [(tape, torch.float32), (tape[:7], torch.float32), ([], torch.float64)], str(tmp_path))
    assert [len(p) for p in per_tape] == [3, 1, 1]
    assert len(sources) == len(paths) == 5
    firsts = []
    for key, src in sources.items():
        with open(src) as fh:
            head = fh.readline()
        assert paths[key] == str(tmp_path / f"lib{key}.so")
        firsts.append(int(re.search(r"tape ops (\d+)\.\.", head).group(1)))
    assert firsts[:3] == [0, tape_codegen.SEGMENT_OPS, 2 * tape_codegen.SEGMENT_OPS]


def test_build_starts_every_tape_with_the_interpreter(monkeypatch, tmp_path):
    """`bench_synthetic.build` compiles the interpreter and the kernels of
    every tape it is given in one `cuda_build.build` (one nvcc each, all
    started together), and nothing that is built already."""
    calls = []

    def fake_build(sources, paths, build_dir, nvcc=None, flags=()):
        calls.append(sorted(sources))
        for p in paths.values():
            open(p, "w").close()
        return paths

    monkeypatch.setattr(pdipm_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "build", fake_build)
    tapes = [(bench_synthetic.make_tape(n), torch.float32) for n in (10, 100)]
    out = bench_synthetic.build(tapes)
    assert len(calls) == 1 and "tape" in calls[0] and len(calls[0]) == 3
    assert out["interp"] == bench_synthetic.interp_path() and len(out["tapes"]) == 2
    bench_synthetic.build(tapes)
    assert calls[1] == calls[0]  # cuda_build.build itself skips what exists


def test_cuda_state_without_a_library_raises_and_never_interprets(monkeypatch, tmp_path):
    """A state that does not lie on the CPU goes to the generated kernel:
    without a compiler its build raises; neither the interpreter nor the
    plain version runs, and no launch is counted."""
    monkeypatch.setattr(pdipm_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(bench_synthetic, "_library",
                        lambda: pytest.fail("interpreted the tape"))
    monkeypatch.setattr(bench_synthetic, "apply_tape_rows",
                        lambda *a: pytest.fail("fell back to the plain version"))
    tape = bench_synthetic.make_tape(20)
    s = _state(8, torch.float32).to("meta")
    before = dict(bench_synthetic.launches)
    for arg in (tape, bench_synthetic.encode_tape(tape, torch.float32, "meta")):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            bench_synthetic.run_tape(arg, s)
    assert bench_synthetic.launches == before


def test_source_refuses_what_it_cannot_write():
    with pytest.raises(ValueError, match="tape op 1"):
        tape_codegen.source([("mul", 0, 1, 2, 0.0), ("tanh", 0, 1, 2, 0.0)], torch.float32)
    with pytest.raises(ValueError, match="tape op 0"):
        tape_codegen.source([("add", 16, 1, 2, 0.0)], torch.float64)
    with pytest.raises(TypeError, match="float32 or float64"):
        tape_codegen.source([], torch.float16)


def test_critical_path_follows_the_dependencies():
    """Depth and cycles of the latency model on a hand-made tape: a chain
    through row 0, a div1p on it, an independent op on row 5, and a
    read of the chain's end; and the seed-0 1e4-op tape's depth."""
    op, div = tape_codegen.LATENCY[torch.float32]["op"], tape_codegen.LATENCY[torch.float32]["div"]
    tape = [("add", 0, 1, 2, 0.0), ("mul", 0, 0, 3, 0.0), ("div1p", 4, 0, 0, 0.0),
            ("sub", 5, 6, 7, 0.0)]
    cp = tape_codegen.critical_path(tape)
    assert cp["depth"] == 3
    first = 2 * op               # op, then the blend's fma
    second = first + 2 * op      # waits for row 0
    third = second + op + div + op  # y y + 1 on row 0, the division, the blend
    assert cp["cycles"] == third
    long = tape_codegen.critical_path(bench_synthetic.make_tape(10_000))
    assert long["depth"] == 2511 and 40_000 < long["cycles"] < 45_000

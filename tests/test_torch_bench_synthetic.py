"""The port's synthetic tape (`biped_pympc_tpu_torch/bench/bench_synthetic.py`)
against `bench/bench_synthetic.py`: `make_tape` and `eval_cpu` as there,
the plain version `apply_tape_rows` against the JAX Pallas kernel of
`pallas_fn` (run by the Pallas interpreter) and XLA's `apply_tape_rows` in
float32, and against the JAX script's NumPy `eval_cpu` in float64 at a
length JAX cannot trace in reasonable time; the encoding of the tape, the
wrapper's CPU / card dispatch and the CPU run of `main`. The kernel against
its plain version on the card is a `cuda` test of test_torch_port_rules.py,
which imports no jax."""

import json
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from biped_pympc_tpu_torch.bench import bench_synthetic
from biped_pympc_tpu_torch.ops import cuda_build, pdipm_cuda
from test_torch_port_rules import REPO

sys.path.insert(0, str(REPO / "bench"))
import bench_synthetic as jax_synthetic  # noqa: E402

torch.set_num_threads(1)
F32_ATOL = 1e-6
F64_ATOL = 1e-12


def _state(batch, dtype=np.float32):
    """The JAX script's state: rng(1), uniform [0.5, 1.5), (16, batch)."""
    rng = np.random.default_rng(1)
    return rng.uniform(0.5, 1.5, (bench_synthetic.N_STATE, batch)).astype(np.float32).astype(dtype)


@pytest.mark.parametrize("n_ops, seed", [(10, 0), (100, 0), (1000, 0), (100, 1), (37, 7)])
def test_make_tape_matches_jax(n_ops, seed):
    assert bench_synthetic.make_tape(n_ops, seed) == jax_synthetic.make_tape(n_ops, seed)


def test_eval_cpu_matches_jax():
    tape = jax_synthetic.make_tape(200)
    state = _state(8, np.float64).T.copy()
    np.testing.assert_array_equal(bench_synthetic.eval_cpu(tape, state),
                                  jax_synthetic.eval_cpu(tape, state))


def _pallas_interpreted(tape, s):
    """The kernel of `pallas_fn` (bench_synthetic.py:154-163), interpreted."""
    def kernel(s_ref, o_ref):
        o_ref[...] = jax_synthetic.apply_tape_rows(tape, s_ref[...])

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(s.shape, s.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)(s)


@pytest.mark.parametrize("n_ops", [10, 100])
def test_plain_matches_jax_pallas_and_xla_f32(n_ops):
    tape = bench_synthetic.make_tape(n_ops)
    s = _state(256)
    got = bench_synthetic.apply_tape_rows(tape, torch.from_numpy(s)).numpy()
    xla = np.asarray(jax.jit(lambda v: jax_synthetic.apply_tape_rows(tape, v))(s))
    pallas = np.asarray(jax.jit(lambda v: _pallas_interpreted(tape, v))(s))
    assert got.dtype == xla.dtype == pallas.dtype == np.float32
    np.testing.assert_allclose(got, xla, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=F32_ATOL)


def test_plain_matches_jax_eval_cpu_f64():
    """1e3 ops, float64: above what the JAX tape traces in reasonable time,
    so the JAX script's serial NumPy evaluation is the reference."""
    tape = bench_synthetic.make_tape(1000)
    s = _state(64, np.float64)
    got = bench_synthetic.apply_tape_rows(tape, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, jax_synthetic.eval_cpu(tape, s.T.copy()).T, rtol=0,
                               atol=F64_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_encode_tape_round_trips(dtype):
    """The rows decode to the tape; the constants as rounded to `dtype`."""
    tape = bench_synthetic.make_tape(500, seed=3)
    enc = bench_synthetic.encode_tape(tape, dtype)
    assert enc.code.dtype == torch.int32 and tuple(enc.code.shape) == (500, 4)
    assert enc.c.dtype == dtype and enc.ops == tape
    rounded = [c if dtype == torch.float64 else float(np.float32(c)) for *_, c in tape]
    assert bench_synthetic.decode_tape(enc) == [(*op[:4], c) for op, c in zip(tape, rounded)]
    assert {int(v) for v in enc.code[:, 0]} == set(range(len(bench_synthetic.OPS)))


@pytest.mark.parametrize("bad", [("tanh", 0, 1, 2, 0.0), ("mul", 16, 0, 0, 0.0),
                                 ("add", 0, -1, 0, 0.0)])
def test_encode_tape_refuses_what_the_kernel_cannot_run(bad):
    with pytest.raises(ValueError, match="tape op 1"):
        bench_synthetic.encode_tape([("mul", 0, 1, 2, 0.0), bad])


def test_cpu_tensors_run_the_plain_version():
    tape = bench_synthetic.make_tape(50)
    s = torch.from_numpy(_state(33))
    before = dict(bench_synthetic.launches)
    want = bench_synthetic.apply_tape_rows(tape, s)
    torch.testing.assert_close(bench_synthetic.run_tape(tape, s), want, rtol=0, atol=0)
    enc = bench_synthetic.encode_tape(tape)
    torch.testing.assert_close(bench_synthetic.run_tape(enc, s), want, rtol=0, atol=0)
    assert bench_synthetic.launches == before
    with pytest.raises(ValueError, match=r"\(16, B\)"):
        bench_synthetic.run_tape(tape, s[:8])
    with pytest.raises(TypeError, match="float32 or float64"):
        bench_synthetic.run_tape(tape, s.half())


def test_tensor_off_the_cpu_launches_or_raises(monkeypatch, tmp_path):
    """A state that does not lie on the CPU goes to the kernel: without a
    compiler the build raises, and the plain version never runs."""
    monkeypatch.setattr(pdipm_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(bench_synthetic, "_lib", [])
    monkeypatch.setattr(bench_synthetic, "apply_tape_rows",
                        lambda *a: pytest.fail("fell back to the plain version"))
    s = torch.from_numpy(_state(8)).to("meta")
    enc = bench_synthetic.encode_tape(bench_synthetic.make_tape(5), torch.float32, "meta")
    before = dict(bench_synthetic.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        bench_synthetic.run_tape(enc, s)
    assert bench_synthetic.launches == before


def test_tape_flops_count_as_written():
    tape = [("fma", 0, 1, 2, 0.1), ("mul", 0, 1, 2, 0.0), ("add", 0, 1, 2, 0.0),
            ("sub", 0, 1, 2, 0.0), ("div1p", 0, 1, 2, 0.0)]
    assert bench_synthetic.tape_flops(tape) == 2 + 1 + 1 + 1 + 3 + 5 * 3


def test_main_on_cpu_prints_one_line_per_method(capsys):
    bench_synthetic.main(["--device", "cpu", "--ops", "1e1,2e3", "--batches", "8", "--chain", "2",
                          "--reps", "1", "--cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(d["method"], d["n_ops"]) for d in lines] == [("plain", 10), ("cpu", 10),
                                                          ("plain", 2000), ("cpu", 2000)]
    assert all(d["device"] == "cpu" and d["ms_per_eval"] > 0 and d["batch"] == 8 for d in lines)


def test_measurement_on_the_card_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_synthetic.main(["--ops", "1e1", "--batches", "8"])

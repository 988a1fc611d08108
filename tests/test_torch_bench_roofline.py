"""The port's roofline probes (`biped_pympc_tpu_torch/bench/ab_roofline.py`)
against `bench/ab_roofline.py`: the plain versions of K6 and K7 against the
JAX Pallas kernels `peak_kernel` and `stream_kernel`, captured from
`measure_vpu_roofline` and run by the Pallas interpreter on the CPU, on the
same numpy-seeded inputs at the real step counts; `flop_model`; the port's
`make_qp_batch` against `bench_common.make_qp_batch`; the wrappers' CPU /
card dispatch. The kernels against their plain versions on the card are
`cuda` tests of test_torch_port_rules.py, which imports no jax."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from biped_pympc_tpu_torch.bench import ab_roofline, bench_common
from biped_pympc_tpu_torch.ops import cuda_build, pdipm_cuda
from test_torch_port_rules import REPO

sys.path.insert(0, str(REPO / "bench"))
import ab_roofline as jax_roofline  # noqa: E402
import bench_common as jax_bench_common  # noqa: E402

torch.set_num_threads(1)
# K6 in float32 against the float64 plain version: where that is below
# F32_FINITE in magnitude the float32 value must be finite and within
# K6_F32_RTOL relative (100,000 roundings of up to 6e-8 each), above F32_INF
# it must be inf (float32's largest is 3.4e38); between the two nothing is
# compared.
F32_FINITE, F32_INF, K6_F32_RTOL = 3.0e38, 3.5e38, 1e-2
K7_F32_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_kernels():
    """The Pallas kernels of `measure_vpu_roofline` with their out_shapes, in
    launch order (peak_kernel at nacc 16, 32, 64, 128, then stream_kernel),
    captured by a recorder standing in for `pallas_call`."""
    captured = []

    def recorder(kernel, out_shape=None, **kwargs):
        captured.append((kernel, out_shape))
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

    orig = pl.pallas_call
    pl.pallas_call = recorder
    try:
        jax_roofline.measure_vpu_roofline()
    finally:
        pl.pallas_call = orig
    assert [k.__name__ for k, _ in captured] == ["peak_kernel"] * 4 + ["stream_kernel"]
    return captured


def _interpreted(kernel, out_shape, *args):
    return np.asarray(pl.pallas_call(kernel, out_shape=out_shape, interpret=True)(*args))


def assert_k6_f32(got, want64):
    """`got` (float32) against the float64 `want64` by the inf-mask rule."""
    small, big = np.abs(want64) < F32_FINITE, np.abs(want64) > F32_INF
    assert np.isfinite(got[small]).all()
    np.testing.assert_allclose(got[small], want64[small], rtol=K6_F32_RTOL, atol=0)
    assert np.isinf(got[big]).all()
    return small, big


def test_peak_kernel_interpreted_matches_plain(jax_kernels):
    """K6 at nacc 16, 100,000 steps: JAX's float32 kernel against the
    port's float64 plain version by the inf-mask rule (a up to 1.001 grows
    some chains past float32's range); the port's float32 plain version
    keeps the same infinities."""
    kernel, out_shape = jax_kernels[0]
    a, x = ab_roofline.roofline_inputs()[0][16]
    assert out_shape.shape == x.shape
    got = _interpreted(kernel, out_shape, a, x)
    want64 = ab_roofline.fma_peak_plain(torch.from_numpy(a).double(), torch.from_numpy(x).double(),
                                        ab_roofline.PEAK_ITERS).numpy()
    small, big = assert_k6_f32(got, want64)
    assert big.sum() > 100 and small.sum() > 10000  # both sides of the rule are exercised
    plain32 = ab_roofline.fma_peak_plain(torch.from_numpy(a), torch.from_numpy(x),
                                         ab_roofline.PEAK_ITERS).numpy()
    assert_k6_f32(plain32, want64)
    np.testing.assert_array_equal(np.isinf(plain32), np.isinf(got))


def test_stream_kernel_interpreted_matches_plain(jax_kernels):
    """K7, 20,000 passes over (256, 512) in float32, rtol 1e-5."""
    kernel, out_shape = jax_kernels[4]
    a, b, x = ab_roofline.roofline_inputs()[1]
    got = _interpreted(kernel, out_shape, a, b, x)
    want = ab_roofline.stream_plain(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(x),
                                    ab_roofline.STREAM_ITERS).numpy()
    np.testing.assert_allclose(want, got, rtol=K7_F32_RTOL, atol=0)


@pytest.mark.parametrize("T", [10, 20])
@pytest.mark.parametrize("refine", [0, 1])
def test_flop_model_matches_jax(T, refine):
    assert ab_roofline.flop_model(T, refine) == jax_roofline.flop_model(T, refine)


@pytest.mark.parametrize("batch", [16, 12])
def test_make_qp_batch_matches_jax(batch):
    """Entry for entry in float32 (a batch of 12 gets 8 envs on both sides)."""
    want = jax.tree.map(np.asarray, jax_bench_common.make_qp_batch(batch))
    got = bench_common.make_qp_batch(batch, device="cpu")
    for name in ("q_diag", "r_diag", "f", "b0", "g_u", "d"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name), name)
    for name in ("A", "B", "c"):
        np.testing.assert_array_equal(getattr(got.dyn, name).numpy(), getattr(want.dyn, name), name)


def test_variants_are_jax_main_routes():
    """The six routes of JAX's `main` (ab_roofline.py:227-242), every field."""
    from biped_pympc_tpu.ops import pdipm as jax_pdipm

    jax_variants = {
        "ric_dense": jax_pdipm.PdipmOptions(backend="ric", refine_steps=1),
        "ric_split": jax_pdipm.PdipmOptions(backend="ric", refine_steps=1, foot_split=True),
        "ricaug_dense": jax_pdipm.PdipmOptions(backend="ric_aug", refine_steps=1),
        "ricaug_split": jax_pdipm.PdipmOptions(backend="ric_aug", refine_steps=1,
                                               foot_split=True),
        "ric_split_pack": jax_pdipm.PdipmOptions(backend="ric", refine_steps=1, foot_split=True,
                                                 foot_pack=True),
        "ricaug_split_pack": jax_pdipm.PdipmOptions(backend="ric_aug", refine_steps=1,
                                                    foot_split=True, foot_pack=True)}
    assert list(ab_roofline.VARIANTS) == list(jax_variants)
    for name, opts in ab_roofline.VARIANTS.items():
        for field, value in vars(opts).items():
            assert getattr(jax_variants[name], field) == value, (name, field)
    assert set(ab_roofline.VARIANTS) == set(ab_roofline.flop_model())


def _small_peak(dtype):
    a, x = ab_roofline.roofline_inputs()[0][16]
    return torch.from_numpy(a).to(dtype), torch.from_numpy(x[:32]).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cpu_tensors_run_the_plain_versions(dtype):
    before = dict(ab_roofline.launches)
    a, x = _small_peak(dtype)
    torch.testing.assert_close(ab_roofline.fma_peak(a, x, 50),
                               ab_roofline.fma_peak_plain(a, x, 50), rtol=0, atol=0)
    sa, sb, sx = (torch.from_numpy(v[:4]).to(dtype) for v in ab_roofline.roofline_inputs()[1])
    torch.testing.assert_close(ab_roofline.stream(sa, sb, sx, 50),
                               ab_roofline.stream_plain(sa, sb, sx, 50), rtol=0, atol=0)
    assert ab_roofline.launches == before


def test_plain_fma_rounds_once_in_float32():
    """The float32 plain step is the fused multiply-add's single rounding:
    on these inputs a separate product and sum differ from it."""
    a, b, x = (torch.from_numpy(v[:8]) for v in ab_roofline.roofline_inputs()[1])
    once = ab_roofline.stream_plain(a, b, x, 1)
    torch.testing.assert_close(once, (x.double() * a.double() + b.double()).float(), rtol=0,
                               atol=0)
    assert not torch.equal(ab_roofline.stream_plain(a, b, x, 2000), _twice(a, b, x, 2000))


def _twice(a, b, x, iters):
    for _ in range(iters):
        x = x * a + b
    return x


def test_wrappers_check_their_inputs():
    a, x = _small_peak(torch.float32)
    with pytest.raises(ValueError, match="8 n, 128"):
        ab_roofline.fma_peak(a, x[:, :64], 1)
    with pytest.raises(ValueError, match="expected"):
        ab_roofline.fma_peak(a.double(), x, 1)
    with pytest.raises(TypeError, match="float32 or float64"):
        ab_roofline.stream(a.half(), a.half(), a.half(), 1)


def test_tensor_off_the_cpu_launches_or_raises(monkeypatch, tmp_path):
    """A tensor that does not lie on the CPU goes to the kernel: without a
    compiler the build raises, and the plain version never runs."""
    monkeypatch.setattr(pdipm_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(ab_roofline, "_lib", [])
    monkeypatch.setattr(ab_roofline, "fma_steps",
                        lambda *a: pytest.fail("fell back to the plain version"))
    a, x = _small_peak(torch.float32)
    before = dict(ab_roofline.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ab_roofline.fma_peak(a.to("meta"), x.to("meta"), 1)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ab_roofline.stream(a.to("meta"), a.to("meta"), a.to("meta"), 1)
    assert ab_roofline.launches == before


def test_measurement_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_roofline.main(["--ceil-only"])

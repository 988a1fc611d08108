"""Rules of the torch port that hold without the card: no jax imports, the
CPU / CUDA dispatch of the PDIPM, the build helper's errors. The one test
marked `cuda` holds each kernel against the plain version on the card
(`python -m pytest tests/test_torch_port_rules.py -m cuda --noconftest` on a
GPU machine, which has no jax for `tests/conftest.py`)."""

import ast
import pathlib
import types

import numpy as np
import pytest
import torch

from biped_pympc_tpu_torch.ops import pdipm, pdipm_cuda
from biped_pympc_tpu_torch.ops import qp as qps
from biped_pympc_tpu_torch.models.srbd import SrbdLin

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
    monkeypatch.setattr(pdipm_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(pdipm_cuda.os.path, "isfile", lambda p: False)
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
        pdipm_cuda.solve(on_card, pdipm.PdipmOptions(backend="ric"))
    assert pdipm_cuda.launches == before
    built = sorted(p.name for p in build_dir.iterdir())
    assert len(built) == 1 and built[0].startswith("libpdipm_ric_aug_"), built


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
@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["ric_aug", "ric"])
@pytest.mark.parametrize("horizon, refine_steps", [(10, 1), (5, 0), (20, 2)])
def test_kernel_matches_plain_on_card(horizon, refine_steps, backend):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    qp = _qp(64, torch.float64, "cuda", horizon)
    opts = pdipm.PdipmOptions(iterations=8, refine_steps=refine_steps, backend=backend)
    before = dict(pdipm_cuda.launches)
    got = pdipm_cuda.solve(qp, opts)
    want = pdipm.solve(qp, opts)
    torch.cuda.synchronize()
    assert pdipm_cuda.launches == {**before, backend: before[backend] + 1}
    for name in "xszy":
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=1e-7)
    torch.testing.assert_close(got.residuals, want.residuals, rtol=1e-6, atol=1e-10)

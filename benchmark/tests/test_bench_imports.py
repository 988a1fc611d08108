"""Import rules of the benchmark, read from the sources (AST), each import's
top-level name (the part before the first dot) compared whole: nothing
imports JAX or the JAX package, the reference imports nothing of the
program under test, and nothing imports the JAX-era scripts of `bench/`."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH.parent
FILES = sorted(BENCH.rglob("*.py"))
OLD_BENCH = {"bench"} | {p.stem for p in (REPO / "bench").glob("*.py")}


def imported(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_benchmark_file_imports(path):
    tops = set(imported(path))
    assert not tops & {"jax", "jaxlib", "flax", "biped_pympc_tpu"}, tops
    assert not tops & OLD_BENCH, tops
    if "reference" in path.relative_to(BENCH).parts:
        assert "biped_pympc_tpu_torch" not in tops, tops


def test_scan_sees_every_part_and_no_stem_of_bench():
    parts = {p.relative_to(BENCH).parts[0] for p in FILES}
    assert {"run.py", "common.py", "loops", "metrics", "reference", "tests"} <= parts
    assert not {p.stem for p in FILES} & OLD_BENCH


def test_forbidden_modules_compares_whole_names(monkeypatch):
    """The run's own look at `sys.modules`: the port's name begins with the
    JAX package's, and only whole top-level names count."""
    import sys
    import types

    from benchmark.common import forbidden_modules

    m = types.ModuleType("probe")
    loaded = {"biped_pympc_tpu_torch.wrapper": m, "jaxtyping": m, "numpy": m}
    monkeypatch.setattr(sys, "modules", loaded)
    assert forbidden_modules() == []
    loaded["biped_pympc_tpu.ops"] = m
    loaded["jaxlib.xla_client"] = m
    assert forbidden_modules() == ["biped_pympc_tpu", "jaxlib"]

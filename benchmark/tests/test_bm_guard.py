"""The no-JAX check, and what the benchmark's sources import."""

import ast

import pytest

from benchmark.guard import forbidden_modules
from benchmark.tests.conftest import BENCH


@pytest.mark.parametrize("name", ["geomloss_tpu", "geomloss_tpu.ops", "jax", "jax.numpy", "jaxlib", "flax.linen"])
def test_guard_catches(name):
    assert forbidden_modules({name: None, "torch": None}) == [name]


@pytest.mark.parametrize("name", ["geomloss_tpu_torch", "geomloss_tpu_torch.ops", "jaxtyping", "flaxen", "torch"])
def test_guard_passes(name):
    assert forbidden_modules({name: None}) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(*parts):
    return [p for p in BENCH.joinpath(*parts).rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_benchmark_imports_no_jax():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "geomloss_tpu"), (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("math", "numpy", "torch"), (path, mod)

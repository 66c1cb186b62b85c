"""Fixtures of the benchmark's tests: a copy of the benchmark whose traffic
mixes are cut to sizes that the CPU runs in seconds."""

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

#: Test sizes of the traffic mixes: the multiscale route still taken
#: (N M > 1e8), the online route at a few thousand points.
SMALL = {"sphere-1e6": 12000, "online-1e5": 2000}


def copy_benchmark(dest):
    """``dest`` with ``BENCHMARK.json`` and a copy of the benchmark's folder
    whose traffic mixes are cut to :data:`SMALL` (the program is read from
    the checkout)."""
    shutil.copytree(BENCH, dest / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, n in SMALL.items():
        path = dest / "benchmark" / "workloads" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic.update(n=n, m=n)
        path.write_text(json.dumps(traffic))
    return dest


@pytest.fixture
def small_bench(tmp_path):
    return copy_benchmark(tmp_path)

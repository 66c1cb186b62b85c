"""The benchmark finds every part by name, keeps to the contract's form,
and takes a new cell and a new metric as new files and entries only."""

import hashlib
import json
import re

import pytest

from benchmark.layout import Layout
from benchmark.tests.conftest import BENCH, ROOT, copy_benchmark
from benchmark.trace import Trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def lay():
    return Layout()


def test_every_cell_resolves_by_name(lay):
    spec = lay.spec
    configs = {c["name"]: c for c in spec["configs"]}
    for cell in spec["workloads"]:
        config = lay.config(cell["config"])
        assert config["name"] == cell["config"]
        assert (ROOT / configs[cell["config"]]["file"]).resolve() == (BENCH / "configs" / f"{cell['config']}.json")
        traffic = lay.traffic(cell["traffic"])
        assert traffic["name"] == cell["traffic"]
        limits = lay.limits(cell["name"])
        assert limits["cell"] == cell["name"]
        assert {"loss_rel", "grad_rel"} & set(limits)
        assert callable(lay.reference(config["reference"]))
        assert callable(lay.clouds(traffic["clouds"]))
        entry = config["entry"]
        assert entry["grad"] in entry["inputs"] and ":" in entry["callable"]
        # Every cell reports setup_s, another end-to-end metric and a per-layer one:
        names = {m["name"] for m in lay.end_to_end(cell["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert lay.per_layer(cell["name"])
    for m in spec["per_layer"]:
        assert callable(lay.reader(m["name"]))


def test_contract_form(lay):
    spec = lay.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1] == "benchmark/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    for entry in spec["configs"] + spec["workloads"] + spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["chips"] == 1
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in spec["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
    for path in BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path


def _digests(folder):
    return {
        p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in folder.rglob("*") if p.is_file() and "__pycache__" not in p.parts
    }


#: A new kind of inputs: uniform weights on points uniform in the unit cube.
CUBE = """import torch


def draw(traffic, gen, dtype, device):
    n, m, dim = traffic["n"], traffic["m"], traffic["dim"]
    x = torch.rand(n, dim, generator=gen, dtype=dtype, device=device)
    y = torch.rand(m, dim, generator=gen, dtype=dtype, device=device)
    return {"a": torch.full((n,), 1.0 / n, dtype=dtype, device=device), "x": x,
            "b": torch.full((m,), 1.0 / m, dtype=dtype, device=device), "y": y}
"""

#: A new reference: the untruncated gaussian MMD, dense (it imports a
#: helper of the folder, as a reference file may).
GAUSSIAN_DENSE = """import torch

from .pairs import cross


def compute(inputs, call, rows, dtype=torch.float64, tf32=False):
    a, x, b, y = (inputs[k].to(dtype) for k in "axby")
    s2 = call["blur"] ** 2

    def k(p, q):
        return torch.exp(-torch.cdist(p, q) ** 2 / (2 * s2))

    Kxx, Kxy = k(x, x), k(x, y)
    value = 0.5 * a @ Kxx @ a + 0.5 * b @ k(y, y) @ b - a @ Kxy @ b
    xr = x[rows]
    grad = a[rows, None] / s2 * (xr * (Kxy[rows] @ b - Kxx[rows] @ a)[:, None]
                                 - (cross(Kxy[rows], (b[:, None] * y).T, tf32) - cross(Kxx[rows], (a[:, None] * x).T, tf32)))
    return float(value), grad
"""


def test_a_cell_and_a_metric_are_new_files(tmp_path):
    """A new deployment with a new reference, a traffic mix with a new kind
    of inputs, a cell and a per-layer metric are new files and entries: no
    file of the benchmark changes, and the new cell runs and is correct."""
    from benchmark.tests.test_bm_runs import drive

    root = copy_benchmark(tmp_path)
    before = _digests(root / "benchmark")
    bench = root / "benchmark"
    # New files ...
    (bench / "configs" / "gaussian-blur05-cube3d.json").write_text(json.dumps({
        "name": "gaussian-blur05-cube3d", "source": "example", "dtype": "float32",
        "entry": {"callable": "geomloss_tpu_torch:SamplesLoss", "inputs": ["a", "x", "b", "y"], "grad": "x"},
        "call": {"loss": "gaussian", "blur": 0.5, "backend": "online"},
        "reference": "gaussian_dense",
    }))
    (bench / "reference" / "gaussian_dense.py").write_text(GAUSSIAN_DENSE)
    (bench / "clouds" / "uniform-cube.py").write_text(CUBE)
    (bench / "workloads" / "cube-500.json").write_text(json.dumps({
        "name": "cube-500", "clouds": "uniform-cube", "n": 500, "m": 400, "dim": 3,
    }))
    (bench / "limits" / "gaussian.cube-500.json").write_text(json.dumps({
        "cell": "gaussian.cube-500", "loss_rel": {"limit": 1e-4}, "grad_rel": {"limit": 1e-3},
    }))
    (bench / "metrics" / "calls.count.py").write_text("def read(trace):\n    return float(trace.calls)\n")
    # ... and new entries in BENCHMARK.json:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "gaussian-blur05-cube3d", "source": "example",
                            "file": "benchmark/configs/gaussian-blur05-cube3d.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "gaussian.cube-500", "config": "gaussian-blur05-cube3d",
                              "traffic": "cube-500", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "calls.count", "unit": "calls", "better": "higher", "source": "host_clock",
                              "layer": "x", "moves": "ms_per_call", "workloads": ["gaussian.cube-500"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    lay = Layout(root, bench)
    cell = lay.cell("gaussian.cube-500")
    assert lay.config(cell["config"])["call"]["blur"] == 0.5
    assert lay.traffic(cell["traffic"])["n"] == 500
    assert lay.limits("gaussian.cube-500")["loss_rel"]["limit"] == 1e-4
    assert "calls.count" in {m["name"] for m in lay.per_layer("gaussian.cube-500")}
    assert "calls.count" not in {m["name"] for m in lay.per_layer("gaussian.sphere-1e6")}
    tr = Trace(7, 1.0, [], [], [], set(), {}, (1, 1, 3), "cpu", None)
    assert lay.reader("calls.count")(tr) == 7.0
    result = drive(root, "gaussian.cube-500", "none")
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_rel", "grad_rel"}
    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items()), "an existing file of the benchmark changed"

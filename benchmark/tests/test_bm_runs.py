"""Runs of the harness: without a card, without the program, with the
timed path broken underneath, and with the control in the program's place.

Each run is a process of its own (``drive.py``, or the command itself), so
that no test configuration's imports reach it.
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import BENCH, ROOT

CELLS = ["gaussian.sphere-1e6", "sinkhorn.online-1e5"]


def _run(args, cwd=ROOT, env=None, timeout=900):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, **(env or {})))


def test_no_card_no_result():
    """Without a card the run fails and prints nothing on its output: it
    never falls back to the CPU."""
    out = _run(["benchmark/run.py", "--workload", CELLS[0], "--seed", str(2**31 + 7), "--seconds", "1",
                "--trace", "0"], env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    """In a folder that holds only BENCHMARK.json and the benchmark's files
    the run fails and prints nothing on its output."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(["benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
               cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def drive(root, cell, fault):
    """The result line of ``drive.py`` (with its ``readings``)."""
    out = _run([str(BENCH / "tests" / "drive.py"), str(root), cell, fault])
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


FAULTS = [(c, "none") for c in CELLS] + [
    ("sinkhorn.online-1e5", "frozen_step"),
    ("gaussian.sphere-1e6", "half_batch"),
    ("sinkhorn.online-1e5", "half_batch"),
    ("gaussian.sphere-1e6", "altered_value"),
    ("sinkhorn.online-1e5", "altered_value"),
    ("gaussian.sphere-1e6", "yy_term"),
    ("sinkhorn.online-1e5", "yy_term"),
]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_faults_come_out_not_correct(small_bench, cell, fault):
    """A sound run is correct; each fault that the cell can have makes it
    not correct, the term that no gradient in x sees included. (One chip:
    no exchange between chips to leave out.)"""
    result = drive(small_bench, cell, fault)
    assert result["attempted"] >= 1
    assert result["correct"] is (fault == "none"), result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(small_bench, cell):
    """The reference computed one precision lower (TF32 products) in the
    program's place fails the cell's limits; the program passes them."""
    result = drive(small_bench, cell, "control")
    assert result["correct"], result["checks"]
    assert not result["readings"]["control_correct"], result["readings"]

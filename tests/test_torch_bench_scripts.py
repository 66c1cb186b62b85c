"""The benchmark twins (``bench_torch.py``, ``bench_suite_torch.py``,
``bench_accuracy_torch.py``) on the CPU.

The accuracy twin's error functions against ``bench_accuracy.py``'s on the
same float64 inputs; the headline line's keys and accuracy, its values
against the JAX package's ``SamplesLoss``; the suite's lines and bounds;
and that no twin imports JAX, the JAX package or the JAX-side bench
scripts, or runs without a card. (The multiscale call's phases are the
program's own spans: ``tests/test_torch_profiling.py``.)
"""

import ast
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_accuracy
import bench_accuracy_torch
import bench_suite_torch
import bench_torch
import geomloss_tpu

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = ("bench_torch.py", "bench_suite_torch.py", "bench_accuracy_torch.py")
#: bench.py's keys, and the CUDA timing fields that replace its marginal_ms.
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline", "events_ms", "busy_ms", "profiled_wall_ms", "idle_share",
                 "launches", "peak_mem_gb", "loss_value", "loss_exact", "loss_rel_err_vs_exact", "loss_float64",
                 "loss_rel_err_vs_float64", "device")
DEVICE_METRICS = ("events_ms", "busy_ms", "profiled_wall_ms", "idle_share", "launches", "peak_mem_gb")


def accuracy_problem(N, M, seed=0):
    """Float64 clouds on the sphere, positive weights and dual potentials
    whose plan neither overflows nor vanishes at blur 0.1."""
    rng = np.random.RandomState(seed)
    x, y = rng.randn(N, 3), rng.randn(M, 3)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    a, b = rng.rand(N) + 0.5, rng.rand(M) + 0.5
    F, G = 0.01 * rng.randn(N), 0.01 * rng.randn(M)
    return 0.1, a / a.sum(), x, b / b.sum(), y, F, G


def accuracy_calls(blur, a, x, b, y, F, G):
    """Each error function's arguments (the same order in both scripts)."""
    A = 1.1 * a
    return {
        "plan_marginals": (blur, a, x, b, y, F, G),
        "blurred_relative_error": (blur, x, a, A),
        "marginal_error": (blur, a, x, b, y, F, G),
        "wasserstein_distance": (a, b, np.abs(F), np.abs(G)),
    }


@pytest.mark.parametrize("fn", ["plan_marginals", "blurred_relative_error", "marginal_error", "wasserstein_distance"])
@pytest.mark.parametrize("shape", [(200, 300), (300, 200)])
def test_accuracy_functions_match_bench_accuracy(shape, fn):
    args = accuracy_calls(*accuracy_problem(*shape, seed=shape[0]))[fn]
    got = getattr(bench_accuracy_torch, fn)(*(torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in args))
    ref = getattr(bench_accuracy, fn)(*(jnp.asarray(v) if isinstance(v, np.ndarray) else v for v in args))
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-14)


def test_headline_line_on_the_cpu(capsys):
    line = bench_torch.headline(500, "cpu", backend="tensorized", reps=2)
    printed = [s for s in capsys.readouterr().out.splitlines() if s.strip()]
    assert len(printed) == 1 and json.loads(printed[0]) == line
    assert all(key in line for key in HEADLINE_KEYS)
    assert line["metric"] == "sinkhorn_divergence_loss+grad_100k_3d_blur0.05_torch"
    assert line["unit"] == "ms" and line["value"] > 0 and line["vs_baseline"] == 1400.0 / line["value"]
    assert line["loss_rel_err_vs_exact"] <= 1e-6
    assert line["loss_rel_err_vs_float64"] <= 1e-3
    # The same call through the JAX package in float64, on the same clouds:
    # the port's float64 value to rounding, its float32 values (tensorized
    # and online) within float32's error (6e-7 and 2e-7 here).
    x, y = (jnp.asarray(bench_torch.sphere_cloud(500, s), jnp.float64) for s in (0, 1))
    ref = float(geomloss_tpu.SamplesLoss(**bench_torch.CALL, backend="tensorized")(x, y))
    np.testing.assert_allclose(line["loss_float64"], ref, rtol=1e-12)
    np.testing.assert_allclose([line["loss_value"], line["loss_exact"]], ref, rtol=1e-5)
    # No device metric comes from a CPU run.
    assert all(line[key] is None for key in DEVICE_METRICS) and line["device"] == "cpu"


@pytest.mark.parametrize("name,n", [("sinkhorn_tensorized_blur.05", 100), ("sinkhorn_multiscale_blur.05", 300),
                                    ("gaussian_mmd_blur.1", 200), ("energy_mmd", 200)])
def test_suite_leg_line_holds_its_bound(name, n, monkeypatch, capsys):
    monkeypatch.setattr(bench_suite_torch, "EXACT_MIN_N", n - 1)  # the exact field too
    kw = dict((c[0], c[1]) for c in bench_suite_torch.CONFIGS)[name]
    results = {}
    (line,) = bench_suite_torch.run_config(name, kw, [n], torch.device("cpu"), "cpu", results)
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert line["metric"] == f"{name}_N{n}_torch" and results == {line["metric"]: line["value"]}
    assert line["within_bound"] and line["err_vs_float64"] <= line["bound_vs_float64"]
    assert line["grad_err_vs_float64"] <= line["grad_bound_vs_float64"]
    # Each bound lies below what a kernel that dropped the loss would miss by.
    assert line["bound_vs_float64"] < (1.0 if name.startswith("sinkhorn") else abs(line["loss_float64"]))
    assert line["err_kind"] == ("relative" if name.startswith("sinkhorn") else "absolute")
    assert np.isfinite(line["rel_err_vs_exact"])
    assert all(line[key] is None for key in DEVICE_METRICS)


def test_accuracy_protocol_rows(monkeypatch):
    x = torch.from_numpy(bench_torch.sphere_cloud(300, 0))
    y = torch.from_numpy(bench_torch.sphere_cloud(300, 1))
    rows = []
    monkeypatch.setattr(bench_accuracy_torch, "emit", lambda card, **row: rows.append(row))
    bench_accuracy_torch.potentials_protocol(x, y, 0.05, torch.device("cpu"), "cpu",
                                             configs=[("tensorized", "tensorized", None)], scalings=(0.5, 0.99))
    truth, coarse, tight = rows
    assert truth["metric"] == "ground_truth_wasserstein_blur0.05_float64_torch"
    # The float32 solve at the reference's own scaling lands on the float64 truth.
    assert tight["err_vs_truth"] <= 1e-5 < coarse["err_vs_truth"]
    assert tight["marginal_error"] < coarse["marginal_error"]


FORBIDDEN = ("jax", "geomloss_tpu", "bench", "bench_suite", "bench_accuracy")


@pytest.mark.parametrize("twin", TWINS)
def test_twin_imports_no_jax_side_module(twin):
    tree = ast.parse((ROOT / twin).read_text())
    names = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import) for alias in node.names}
    names |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module}
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{twin} imports {bad}"


@pytest.mark.parametrize("twin", TWINS)
def test_twin_refuses_to_run_without_a_card(twin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = sys.modules[twin[:-3]]
    monkeypatch.setattr(sys, "argv", [twin])  # no arguments: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main()

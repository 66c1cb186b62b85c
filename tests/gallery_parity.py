"""Runs the two examples galleries side by side for the gallery tests.

``examples/<name>.py`` (the JAX gallery) is loaded with
``GEOMLOSS_TPU_SMOKE=1`` set before the load, so that its ``size()`` calls
give their smoke sizes; ``examples_torch/<name>.py`` (the port's) runs on
the CPU at the same sizes (``_example_utils_torch.SMOKE``). Neither writes
into the tree: plotting is off on both sides and the profile's traces go
under the test's ``tmp_path``.
"""

import importlib.util
import inspect
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))

import _example_utils_torch as gallery  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """The gallery's CPU runs are small: one intra-op thread a worker (with
    one per core, the test workers' PyTorch thread pools contend for the
    cores and a run slows 10-20x)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def run_torch(name, tmp_path, prepare=None, **sizes):
    """``examples_torch/<name>.py`` at its smoke size (``sizes`` override
    it) on the CPU with plotting off, its property asserted; returns
    ``(out, text, values)`` (see ``gallery.run``). ``prepare`` gets the
    loaded module first."""
    mod = gallery.load(name)
    mod.OUT = str(tmp_path)  # plot_profile's traces
    if prepare is not None:
        prepare(mod)
    kw = dict(gallery.SMOKE[name], device="cpu", **sizes)
    if "plot" in inspect.signature(mod.main).parameters:
        kw["plot"] = False
    out, text, values = gallery.run(mod, **kw)
    ok, what = gallery.check(name, out, text, values)
    assert ok, f"{name}: {what} does not hold: returned {out!r}"
    return out, text, values


def load_jax(name, monkeypatch, tmp_path):
    """``examples/<name>.py`` loaded at its smoke size, plotting off."""
    monkeypatch.setenv("GEOMLOSS_TPU_SMOKE", "1")
    # _example_utils reads the variable when it is imported:
    monkeypatch.delitem(sys.modules, "_example_utils", raising=False)
    spec = importlib.util.spec_from_file_location(
        f"examples_jax_{name}", os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.delitem(sys.modules, "_example_utils", raising=False)
    if hasattr(mod, "get_pyplot"):
        mod.get_pyplot = lambda: None
    mod.OUT = str(tmp_path)  # plot_profile's traces
    return mod


class JitRecorder:
    """Stands for ``jax`` inside a JAX example: every call of a function it
    jits is recorded with what it returned (``returns``)."""

    def __init__(self, jax):
        self._jax = jax
        self.returns = []

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn, **kw):
        jitted = self._jax.jit(fn, **kw)

        def call(*args, **kwargs):
            out = jitted(*args, **kwargs)
            self.returns.append(out)
            return out

        return call


def capture(mod, name, into):
    """Wrap ``mod.<name>`` so that each result is appended to ``into`` as
    numpy."""
    fn = getattr(mod, name)

    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        into.append(np.asarray(out.detach().cpu() if hasattr(out, "detach") else out))
        return out

    setattr(mod, name, call)


def close(got, expected, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(expected, np.float64), rtol=rtol, atol=atol)


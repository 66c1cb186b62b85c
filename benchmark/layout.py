"""Where the benchmark finds its parts, by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. Everything that belongs to one configuration, one traffic mix,
one kind of input, one reference, one cell or one per-layer metric is a
file of its own under this folder, named after it:

* ``configs/<config>.json``: the deployment: the entry and its call, its
  precision, the reference that judges it;
* ``workloads/<traffic>.json``: the traffic mix: the kind of inputs and
  their sizes;
* ``clouds/<kind>.py``: a kind of inputs, a function ``draw(traffic, gen,
  dtype, device)`` that returns the entry's named inputs;
* ``reference/<name>.py``: a plain reference, a function ``compute(inputs,
  call, rows, dtype, tf32)`` that returns the value and the gradient rows;
* ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct`` in that cell, with the readings they were set from;
* ``metrics/<metric>.py``: the reader of a per-layer metric, a function
  ``read(trace)`` that returns a number or ``None``.

A new cell needs new files and new entries in ``BENCHMARK.json`` only.
"""

import importlib.util
import json
import sys
from pathlib import Path

#: This folder.
HERE = Path(__file__).resolve().parent
#: The checkout that holds ``BENCHMARK.json`` and the program.
ROOT = HERE.parent


def _load(path, module_name):
    """The module of the file ``path`` under ``module_name`` (the one
    already loaded from that file, if any)."""
    mod = sys.modules.get(module_name)
    if mod is not None and Path(getattr(mod, "__file__", "")).resolve() == path.resolve():
        return mod
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Layout:
    """The benchmark's description and files under a root (``root`` holds
    ``BENCHMARK.json``, ``bench`` the benchmark's folder)."""

    def __init__(self, root=ROOT, bench=HERE):
        self.root = Path(root)
        self.bench = Path(bench)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _json(self, *parts):
        path = self.bench.joinpath(*parts)
        with open(path) as f:
            return json.load(f)

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name):
        return self._json("configs", name + ".json")

    def traffic(self, name):
        return self._json("workloads", name + ".json")

    def limits(self, cell_name):
        return self._json("limits", cell_name + ".json")

    def end_to_end(self, cell_name):
        return [m for m in self.spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]

    def per_layer(self, cell_name):
        return [m for m in self.spec["per_layer"] if cell_name in m.get("workloads", [cell_name])]

    def reader(self, metric_name):
        """The ``read`` function of ``metrics/<metric_name>.py``."""
        path = self.bench / "metrics" / (metric_name + ".py")
        return _load(path, "benchmark_metric_" + metric_name.replace(".", "_").replace("-", "_")).read

    def clouds(self, kind):
        """The ``draw`` function of ``clouds/<kind>.py``."""
        path = self.bench / "clouds" / (kind + ".py")
        return _load(path, "benchmark_clouds_" + kind.replace(".", "_").replace("-", "_")).draw

    def reference(self, name):
        """The ``compute`` function of ``reference/<name>.py``. The module
        is loaded as a part of :mod:`benchmark.reference`, so that it may
        import that folder's helpers relatively."""
        path = self.bench / "reference" / (name + ".py")
        return _load(path, "benchmark.reference." + name).compute

"""The PyTorch examples gallery (``examples_torch/``) as a whole, and two
scripts whose JAX example costs too much on the CPU, held through their
library calls at a smaller size (``test_torch_examples_grid.py`` holds the
barycenter scripts so).

- No script imports ``jax``, ``optax``, ``geomloss_tpu`` or ``examples``
  (an AST walk), and each runs on the card unless it is given
  ``device="cpu"``: without a card, its default raises.
- ``plot_kernel_truncation`` (34 s): ``spatial_sort_blocks`` and
  ``masks_from_coarse`` on the script's clouds at 2,000 points (where
  tiles are pruned). Its ``sinkhorn_multiscale`` solves run here at the
  smoke size without JAX (an eager JAX multiscale solve costs ~12 s of
  compiles); ``test_torch_multiscale.py`` and
  ``test_torch_custom_cost.py`` hold truncated and ``truncate=None``
  solves against JAX.
- ``track_barycenter`` (a descent, as ``test_torch_examples_flows.py``
  holds the others) against its JAX example, to 1e-4.
- ``plot_profile``: the script at the smoke size (its return is wall
  times); its traces are written under the test's ``tmp_path``.
Tolerances: 1e-4 relative (float32 solves on both sides).
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gallery_parity import ROOT, close, gallery, load_jax, one_thread, run_torch  # noqa: F401 (one_thread: an autouse fixture)

RTOL = 1e-4
SCRIPTS = sorted(gallery.SMOKE)
FORBIDDEN = ("jax", "optax", "geomloss_tpu", "examples")


def test_gallery_is_complete():
    """One script per JAX example, under the same file names."""
    jax_side = {f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
                if f.endswith(".py") and not f.startswith("_")}
    torch_side = {f[:-3] for f in os.listdir(os.path.join(ROOT, "examples_torch"))
                  if f.endswith(".py") and not f.startswith("_")}
    assert torch_side == jax_side == set(SCRIPTS) == set(gallery.PROPERTIES)


@pytest.mark.parametrize("name", SCRIPTS + ["_example_utils_torch"])
def test_imports_no_jax(name):
    tree = ast.parse(open(os.path.join(ROOT, "examples_torch", name + ".py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in FORBIDDEN, f"{name} imports {m}"


@pytest.mark.parametrize("name", SCRIPTS)
def test_runs_on_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gallery.load(name).main()


def test_profile(tmp_path):
    run_torch("plot_profile", tmp_path)
    for loss in ("gaussian", "sinkhorn"):
        for backend in ("online", "multiscale"):
            assert os.path.isfile(tmp_path / f"profile_{loss}_{backend}" / "trace.json")


def test_kernel_truncation(tmp_path):
    from geomloss_tpu.models import multiscale as jms
    from geomloss_tpu.ops import block_sparse as jbs
    from geomloss_tpu_torch.models import multiscale as tms
    from geomloss_tpu_torch.ops import block_sparse as tbs

    run_torch("plot_kernel_truncation", tmp_path)

    # The kept tiles, as the script draws them, where some are pruned:
    N, block, tile = 2000, 64, 512
    x, y = gallery.annulus(N, seed=1), gallery.crescent(N, seed=2)
    w = np.full(N, 1.0 / N, np.float32)
    masks = []
    for ms, bs, arr in ((tms, tbs, torch.tensor), (jms, jbs, jnp.asarray)):
        (aw_c, _), (x_c, _), _ = ms.spatial_sort_blocks(arr(w), arr(x), 0.1, 1.5, block, tile)
        (bw_c, _), (y_c, _), _ = ms.spatial_sort_blocks(arr(w), arr(y), 0.1, 1.5, block, tile)
        f0 = arr(np.zeros(x_c.shape[0], np.float32))
        g0 = arr(np.zeros(y_c.shape[0], np.float32))
        mask = bs.masks_from_coarse(x_c, y_c, f0, g0, aw_c, bw_c, 0.02**2, 2, 5, tile // block)
        masks.append((np.asarray(mask.cols), np.asarray(mask.counts), np.asarray(x_c)))
    (t_cols, t_cnt, t_xc), (j_cols, j_cnt, j_xc) = masks
    close(t_xc, j_xc, RTOL, atol=1e-6)
    np.testing.assert_array_equal(t_cnt, j_cnt)
    for i, c in enumerate(t_cnt):
        assert set(t_cols[i, :c]) == set(j_cols[i, :c])
    assert 0 < t_cnt.sum() < t_cols.shape[0] * (int(t_cols.max()) + 1)


def test_track_barycenter(monkeypatch, tmp_path):
    out, _, _ = run_torch("track_barycenter", tmp_path)
    close(out, load_jax("track_barycenter", monkeypatch, tmp_path).main(), RTOL)

"""The gallery's label transfers and labeled clusters (``examples_torch/``)
against the JAX gallery (``examples/``) at its smoke sizes, on the same
numpy data.

The transferred labels (the argmax of the votes through the implicit
plan) must be equal point for point, so the accuracies are equal; the
votes themselves are held to 1e-4 relative (float32 potentials over
``eps = blur^2``), and the two cluster values to 1e-4 at the 8 decimals
the scripts print.
"""

import numpy as np

from gallery_parity import capture, close, gallery, load_jax, one_thread, run_torch  # noqa: F401 (one_thread: an autouse fixture)

VOTES_RTOL = 1e-4


def _votes(name, monkeypatch, tmp_path):
    """Both scripts' return and votes (the result of their gibbs_apply)."""
    t_votes, j_votes = [], []
    out, _, _ = run_torch(name, tmp_path, prepare=lambda mod: capture(mod, "gibbs_apply", t_votes))
    jmod = load_jax(name, monkeypatch, tmp_path)
    capture(jmod, "gibbs_apply", j_votes)
    ref = jmod.main()
    (t,), (j,) = t_votes, j_votes
    assert np.isfinite(t).all()
    close(t, j, VOTES_RTOL, atol=VOTES_RTOL * np.abs(j).max())
    np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))
    return out, ref


def test_optimal_transport_labels(monkeypatch, tmp_path):
    out, ref = _votes("plot_optimal_transport_labels", monkeypatch, tmp_path)
    close(out, ref, VOTES_RTOL)


def test_transfer_labels_tractograms(monkeypatch, tmp_path):
    """The multiscale route's potentials at the full size, auto's
    tensorized one at this size; the fiber votes' accuracy equal."""
    out, ref = _votes("transfer_labels_tractograms", monkeypatch, tmp_path)
    assert out == ref


def test_optimal_transport_cluster(monkeypatch, tmp_path, capsys):
    """The 6-argument labeled form and the plain call (multiscale)."""
    _, text, _ = run_torch("plot_optimal_transport_cluster", tmp_path)
    capsys.readouterr()
    load_jax("plot_optimal_transport_cluster", monkeypatch, tmp_path).main()
    ref = capsys.readouterr().out
    for pattern in (r"labeled-cluster value : (\S+)", r"spatial-cluster value : (\S+)"):
        close(gallery.printed(text, pattern), gallery.printed(ref, pattern), VOTES_RTOL)

"""The gallery's ``ot`` scripts and Sinkhorn value sweeps
(``examples_torch/``) against the JAX gallery (``examples/``) at its smoke
sizes, on the same numpy data: the returned values to 1e-4 relative; the
color transfer's return, a difference of two palette means (~1.6e-3), and
the barycenter's endpoint error (~3e-6), to 1e-5 absolute.
"""

from gallery_parity import close, gallery, load_jax, one_thread, run_torch  # noqa: F401 (one_thread: an autouse fixture)

RTOL = 1e-4
ATOL = 1e-5


def test_optimal_transport_2D(monkeypatch, tmp_path):
    out, text, _ = run_torch("plot_optimal_transport_2D", tmp_path)
    close(out, load_jax("plot_optimal_transport_2D", monkeypatch, tmp_path).main(), RTOL)


def test_optimal_transport_color(monkeypatch, tmp_path):
    out, _, _ = run_torch("plot_optimal_transport_color", tmp_path)
    close(out, load_jax("plot_optimal_transport_color", monkeypatch, tmp_path).main(), 0, atol=ATOL)


def test_barycenter_samples(monkeypatch, tmp_path):
    out, _, _ = run_torch("plot_barycenter_samples", tmp_path)
    ref = load_jax("plot_barycenter_samples", monkeypatch, tmp_path).main()
    close(out["midpoint_mean_x"], ref["midpoint_mean_x"], RTOL)
    close(out["endpoint_err_ring"], ref["endpoint_err_ring"], 0, atol=ATOL)


def test_epsilon_scaling(monkeypatch, tmp_path, capsys):
    """Every scaling's value (printed to 8 decimals) and the returned one."""
    out, text, _ = run_torch("plot_epsilon_scaling", tmp_path)
    capsys.readouterr()
    ref = load_jax("plot_epsilon_scaling", monkeypatch, tmp_path).main()
    ref_text = capsys.readouterr().out
    close(out, ref, RTOL)
    for s in ("0.3", "0.5", "0.7"):
        pattern = rf"scaling={s}:\s+\d+ iterations, S_eps = (\S+)"
        close(gallery.printed(text, pattern), gallery.printed(ref_text, pattern), RTOL)
    assert text.splitlines()[0] == ref_text.splitlines()[0]  # the schedule


def test_transport_blur(monkeypatch, tmp_path):
    out, _, _ = run_torch("plot_transport_blur", tmp_path)
    close(out, load_jax("plot_transport_blur", monkeypatch, tmp_path).main(), RTOL)

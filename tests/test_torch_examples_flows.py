"""The gallery's flows and training loop (``examples_torch/``) against the
JAX gallery (``examples/``) at its smoke sizes, on the same numpy data.

Every script runs on the CPU and must show the property it prints
(``_example_utils_torch.PROPERTIES``). The flows are float32 descents of
3-10 steps: their returns are held to 1e-4 relative, the 2D flow's MMD
losses to 3e-4 (a float32 MMD is a difference of terms that nearly
cancel: the laplacian's value at the flow's start lies 3.5e-5 from its
float64 value in both packages, and 8 steps carry that further).
``model_fitting`` draws its noise from ``jax.random`` on one side and a
``torch.Generator`` on the other, so one training step is held instead:
the loss and its gradient in (means, log-stds) on the same parameters
and noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gallery_parity import JitRecorder, close, gallery, load_jax, one_thread, run_torch  # noqa: F401 (one_thread: an autouse fixture)

FLOW_RTOL = 1e-4
MMD_FLOW_RTOL = 3e-4


def test_gradient_flow(monkeypatch, tmp_path):
    """Each step's S_eps and the final points, step by step."""
    steps = []

    def recorded(objective, x, rate):
        val, x = gallery.flow_step(objective, x, rate)
        steps.append((val.item(), x.numpy()))
        return val, x

    _, _, values = run_torch("gradient_flow", tmp_path, prepare=lambda mod: setattr(mod, "flow_step", recorded))

    jmod = load_jax("gradient_flow", monkeypatch, tmp_path)
    jmod.jax = rec = JitRecorder(jax)
    jmod.main(**gallery.SMOKE["gradient_flow"])
    assert len(rec.returns) == len(steps) == len(values)
    close([v for v, _ in steps], [float(v) for v, _ in rec.returns], FLOW_RTOL)
    close(steps[-1][1], np.asarray(rec.returns[-1][1]), FLOW_RTOL, atol=1e-6)


def test_interpolation_3D(monkeypatch, tmp_path):
    out, _, _ = run_torch("plot_interpolation_3D", tmp_path)
    close(out, load_jax("plot_interpolation_3D", monkeypatch, tmp_path).main(), FLOW_RTOL)


def test_gradient_flows_1D(monkeypatch, tmp_path):
    out, _, _ = run_torch("plot_gradient_flows_1D", tmp_path)
    close(out, load_jax("plot_gradient_flows_1D", monkeypatch, tmp_path).main(), FLOW_RTOL)


def test_gradient_flows_2D(monkeypatch, tmp_path):
    out, _, _ = run_torch("plot_gradient_flows_2D", tmp_path)
    ref = load_jax("plot_gradient_flows_2D", monkeypatch, tmp_path).main()
    assert out.keys() == ref.keys()
    for name in out:
        close(out[name], ref[name], FLOW_RTOL if name.startswith("sinkhorn") else MMD_FLOW_RTOL)


class _RandomShim:
    """``jax.random`` whose draws are the given numpy arrays."""

    def __init__(self, ks, eps):
        self.ks, self.eps = ks, eps

    def randint(self, key, shape, lo, hi):
        assert shape == self.ks.shape and (lo, hi) == (0, 3)
        return jnp.asarray(self.ks)

    def normal(self, key, shape, dtype):
        assert shape == self.eps.shape
        return jnp.asarray(self.eps, dtype)

    def fold_in(self, key, data):
        return key


class _JaxShim:
    def __init__(self, ks, eps):
        self.random = _RandomShim(ks, eps)


def test_model_fitting(monkeypatch, tmp_path):
    """The whole loop at smoke size, then one step against the JAX
    example's ``sample_model`` + ``SamplesLoss`` under
    ``jax.value_and_grad``: loss to 1e-5, gradients to 1e-4 relative."""
    from geomloss_tpu import SamplesLoss as JaxSamplesLoss
    from geomloss_tpu_torch import SamplesLoss

    run_torch("model_fitting", tmp_path)
    tmod = gallery.load("model_fitting")
    N = gallery.SMOKE["model_fitting"]["N"]
    kw = dict(loss="sinkhorn", p=2, blur=0.03, diameter=2.0, scaling=0.7)
    data, _ = gallery.gaussian_mixture(N, [(0.25, 0.3), (0.6, 0.7), (0.8, 0.25)], [0.05, 0.08, 0.04], seed=0)
    rng = np.random.RandomState(1)
    means = (0.5 + 0.1 * rng.randn(3, 2)).astype(np.float32)
    log_std = np.log(np.full(3, 0.1, np.float32) * rng.uniform(0.8, 1.2, 3).astype(np.float32))
    ks = rng.randint(0, 3, N).astype(np.int32)
    eps = rng.randn(N, 2).astype(np.float32)

    params = tuple(torch.tensor(p, requires_grad=True) for p in (means, log_std))
    opt = torch.optim.Adam(params, lr=3e-2)
    val = tmod.train_step(params, opt, SamplesLoss(**kw), torch.tensor(data),
                          (torch.tensor(ks).long(), torch.tensor(eps)))
    grads = [p.grad.numpy() for p in params]

    jmod = load_jax("model_fitting", monkeypatch, tmp_path)
    jmod.jax = _JaxShim(ks, eps)
    jloss = JaxSamplesLoss(**kw)
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(jmod.sample_model(p, None, N), jnp.asarray(data))
    ))((jnp.asarray(means), jnp.asarray(log_std)))
    close(val.item(), float(jval), 1e-5)
    for g, jg in zip(grads, jgrads):
        close(g, np.asarray(jg), 1e-4, atol=1e-4 * np.abs(np.asarray(jg)).max())
    # Adam's first step moves each parameter by lr * sign(grad):
    close(params[0].detach().numpy(), means - 3e-2 * np.sign(np.asarray(jgrads[0])), 0, atol=1e-6)

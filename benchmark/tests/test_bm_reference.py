"""The reference: its exactness bound, its TF32 rounding, and its
agreement with the program in float64 on the CPU (the same semantics;
what the program truncates, the reference keeps)."""

import math

import pytest
import torch

from benchmark.layout import Layout
from benchmark.reference import mmd, pairs, sinkhorn


def sphere(n, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(n, 3, generator=g, dtype=dtype)
    return v / v.norm(dim=1, keepdim=True)


def test_tf32_round():
    t = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-10, -3.0 - 2**-11, 0.0])
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9, -3.0, 0.0])
    assert torch.equal(pairs.tf32_round(t), want)


@pytest.mark.parametrize("eps", [4.0, 0.05, 0.0025])
def test_softmin_leaves_out_less_than_its_bound(eps):
    torch.manual_seed(0)
    x, y = sphere(3000, 1), sphere(2500, 2)
    X, Y = pairs.Tiles(x, leaf=64), pairs.Tiles(y, leaf=64)
    h = torch.randn(2500, dtype=torch.float64)  # dual values of a few eps' spread
    marked = torch.rand(3000, generator=torch.Generator().manual_seed(6)) < 0.3
    S, mean = pairs.softmin(X, Y, h, eps, mean_of=marked)
    s = h[None, :] - torch.cdist(x, y) ** 2 / (2 * eps)
    dense = -eps * torch.logsumexp(s, dim=1)
    assert torch.allclose(S, dense, rtol=0, atol=eps * 10 * math.exp(-pairs.SKIP_LOG))
    w = torch.softmax(s[marked], dim=1)
    assert torch.allclose(mean, w @ y, rtol=0, atol=1e-10)
    if eps < 0.01:  # the bound leaves tiles out where it can
        assert not pairs.kept_tiles(X, Y, Y.tile_max(h[Y.perm]), eps).all()


def clouds(n, seed):
    """The benchmark's weighted clouds (``clouds/geomloss-sphere.py``) of
    ``n`` points a side, in float64 on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return Layout().clouds("geomloss-sphere")({"n": n, "m": n, "dim": 3}, gen, torch.float64, torch.device("cpu"))


def _program(call, inputs, rows):
    from geomloss_tpu_torch import SamplesLoss

    a, x, b, y = (inputs[k] for k in "axby")
    xg = x.clone().requires_grad_(True)
    v = SamplesLoss(**call)(a, xg, b, y)
    (g,) = torch.autograd.grad(v, xg)
    return float(v.detach()), g[rows]


SINKHORN = Layout().config("sinkhorn-p2-blur01-sphere3d")["call"]
GAUSSIAN = Layout().config("gaussian-blur01-sphere3d")["call"]


@pytest.mark.parametrize(
    "call, n",
    [
        (dict(SINKHORN, backend="auto"), 12000),  # the classic multiscale path, truncated tables
        (dict(SINKHORN, backend="online"), 1500),
        (GAUSSIAN, 12000),
    ],
    ids=["multiscale", "online", "gaussian"],
)
def test_reference_is_the_program_in_float64(call, n):
    torch.set_num_threads(2)
    inputs = clouds(n, 3)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(5))[:300]
    v, g = _program(call, inputs, rows)
    fn = mmd.compute if call["loss"] == "gaussian" else sinkhorn.compute
    vr, gr = fn(inputs, call, rows)
    assert abs(v - vr) <= 1e-11 * abs(vr)
    assert float((g - gr).norm()) <= 1e-9 * float(gr.norm())


def test_reference_follows_the_intermediate_scale(monkeypatch):
    """Above N_FINE_OK points (lowered here, in both) the scheme pools an
    intermediate scale; the program truncates its extrapolations and fine
    tables, the reference does not: they agree to the tables' gap."""
    from geomloss_tpu_torch.models import multiscale

    torch.set_num_threads(2)
    monkeypatch.setattr(multiscale, "N_FINE_OK", 8192)
    monkeypatch.setattr(sinkhorn, "N_FINE_OK", 8192)
    call = dict(SINKHORN, backend="auto")
    inputs = clouds(12000, 3)
    rows = torch.randperm(12000, generator=torch.Generator().manual_seed(5))[:300]
    v, g = _program(call, inputs, rows)
    vr, gr = sinkhorn.compute(inputs, call, rows)
    assert sinkhorn.mid_delay(12000, [0] * 8, 5, 0.5, 2) == 1
    assert abs(v - vr) <= 1e-6 * abs(vr)
    assert float((g - gr).norm()) <= 1e-5 * float(gr.norm())

"""The clouds and weights of GeomLoss's own benchmark of ``SamplesLoss``
(``examples/performances/plot_benchmarks_samplesloss_3D.py``,
``generate_samples``): points drawn unevenly on a sphere of diameter 1,

    x = randn(N, D); x[:, 0] += 1; x = x / (2 * |x|)
    y = randn(M, D); y[:, 1] += 2; y = y / (2 * |y|)
    a = |randn(N)| / sum, b = |randn(M)| / sum

drawn in that order from the benchmark's generator, on the device and in
the configuration's dtype. The traffic mix gives ``n``, ``m`` and
``dim``.
"""

import torch


def _shifted_sphere(n, dim, axis, shift, gen, dtype, device):
    v = torch.randn(n, dim, generator=gen, dtype=dtype, device=device)
    v[:, axis] += shift
    return v / (2 * torch.linalg.vector_norm(v, dim=1, keepdim=True))


def _weights(n, gen, dtype, device):
    w = torch.randn(n, generator=gen, dtype=dtype, device=device).abs()
    return w / w.sum()


def draw(traffic, gen, dtype, device):
    n, m, dim = traffic["n"], traffic["m"], traffic["dim"]
    x = _shifted_sphere(n, dim, 0, 1.0, gen, dtype, device)
    y = _shifted_sphere(m, dim, 1, 2.0, gen, dtype, device)
    a = _weights(n, gen, dtype, device)
    b = _weights(m, gen, dtype, device)
    return {"a": a, "x": x, "b": b, "y": y}

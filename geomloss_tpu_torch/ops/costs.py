"""Ground cost functions between point clouds.

The pairwise (squared) Euclidean distance matrix is computed through the
expansion ``|x|^2 - 2<x,y> + |y|^2``, as in :mod:`geomloss_tpu.ops.costs`.
Everything here broadcasts over leading batch dimensions.

The JAX package requests full-precision coordinate matmuls explicitly
(``COORD_PRECISION``) because the TPU's matrix unit rounds to bfloat16.
On a GPU the trap is TF32, which keeps a 10-bit mantissa: its rounding
noise, divided by a small ``eps``, would corrupt the Gibbs exponents. So
TF32 is switched off for float32 matmuls and cuDNN when this module is
imported, and every matmul here runs in full float32 or float64.
"""

import torch

# Full-precision float32 matmuls: pairwise scores must not go through TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "squared_distances",
    "distances",
    "cost_routines",
    "halved_sqdist",
    "SQDIST_FLOOR",
]

#: Numerical floor applied before taking square roots of squared distances.
SQDIST_FLOOR = 1e-8


def squared_distances(x, y):
    """Full pairwise squared distances ``|x_i - y_j|^2``.

    Args:
        x: ``(..., N, D)`` tensor.
        y: ``(..., M, D)`` tensor.

    Returns:
        ``(..., N, M)`` tensor of squared Euclidean distances.
    """
    D_xx = (x * x).sum(-1)[..., :, None]
    D_yy = (y * y).sum(-1)[..., None, :]
    D_xy = torch.matmul(x, y.transpose(-1, -2))
    return D_xx - 2 * D_xy + D_yy


def distances(x, y):
    """Pairwise Euclidean distances, with a small clamp before the sqrt."""
    return torch.sqrt(torch.clamp(squared_distances(x, y), min=SQDIST_FLOOR))


def halved_sqdist(x, y):
    """C(x, y) = |x - y|^2 / 2, the p=2 ground cost."""
    return squared_distances(x, y) / 2


#: Ground costs C(x,y) = |x-y|^p / p.
cost_routines = {
    1: distances,
    2: halved_sqdist,
}

"""Typed containers shared across the library.

PyTorch counterpart of :mod:`geomloss_tpu.utils.typing`: the same
NamedTuple data contracts, holding ``torch.Tensor`` fields.
"""

from typing import Any, NamedTuple, Optional, Sequence

import torch

Tensor = torch.Tensor


class CostMatrices(NamedTuple):
    """The four (explicit or implicit) cost structures of a Sinkhorn solver.

    Each field is whatever the paired ``softmin`` understands: a dense
    ``(..., N, M)`` tensor, a tuple of point clouds ``(x, y)``, or a grid
    descriptor.
    """

    xy: Any  # C(x_i, y_j)
    yx: Any  # C(y_j, x_i)
    xx: Optional[Any] = None  # C(x_i, x_j), only used when debiasing
    yy: Optional[Any] = None  # C(y_i, y_j), only used when debiasing


class SinkhornPotentials(NamedTuple):
    """Optimal dual potentials of a (possibly debiased) Sinkhorn solve."""

    f_aa: Optional[Tensor]  # potential for OT(a, a), supported by x
    g_bb: Optional[Tensor]  # potential for OT(b, b), supported by y
    g_ab: Optional[Tensor]  # potential for OT(a, b), supported by y
    f_ba: Optional[Tensor]  # potential for OT(a, b), supported by x


class DescentParameters(NamedTuple):
    """Annealing schedule: plain Python lists, one entry per iteration."""

    scale_list: Sequence[int]
    eps_list: Sequence[float]
    rho_list: Sequence[Optional[float]]

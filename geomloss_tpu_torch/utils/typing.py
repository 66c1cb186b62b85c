"""Typed containers shared across the library.

PyTorch counterpart of :mod:`geomloss_tpu.utils.typing`: the same
NamedTuple data contracts, holding ``torch.Tensor`` fields. Only the
containers of the online Sinkhorn path are ported so far.
"""

from typing import NamedTuple, Optional, Sequence

import torch

Tensor = torch.Tensor


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

r"""Unbalanced OT support for the ``ot.solve*`` API.

Counterpart of :mod:`geomloss_tpu.solvers.unbalanced`: the ``dampening``
function factory and the batched ``sinkhorn_cost`` that turns optimal dual
potentials into divergence values, in the four {debias} x {balanced}
cases, with the mass constants of the biased unbalanced case (Sejourne et
al., arXiv:1910.12958).
"""

from typing import Optional

import torch

from ..utils.typing import SinkhornPotentials

__all__ = ["dampening", "dot_products", "sinkhorn_cost"]


def dampening(*, eps: float, rho: Optional[float]):
    """Dampening function: identity for balanced OT, contraction otherwise."""
    if rho is None:
        return lambda f: f
    return lambda f: f / (1 + eps / rho)


def dot_products(a, f):
    """Batchwise dot products: the first axis is ALWAYS the batch axis (for
    an unbatched ``(N,)`` pair this is the pointwise product)."""
    assert a.shape == f.shape
    B = a.shape[0]
    return (a.reshape(B, -1) * f.reshape(B, -1)).sum(dim=1)


def _masses(a):
    """Total mass of each batch entry, broadcastable against ``a``."""
    return a.reshape(a.shape[0], -1).sum(-1).reshape((-1,) + (1,) * (a.ndim - 1))


def sinkhorn_cost(
    *,
    a,
    b,
    batchsize: int,
    potentials: SinkhornPotentials,
    eps: float,
    rho: Optional[float],
    debias: bool = True,
):
    """Values of the Sinkhorn divergence from optimal dual potentials:
    ``(batchsize,)``, or a scalar when ``batchsize == 0``."""
    f_aa, g_bb = potentials.f_aa, potentials.g_bb
    g_ab, f_ba = potentials.g_ab, potentials.f_ba

    assert f_ba.shape == a.shape
    assert g_ab.shape == b.shape

    if batchsize == 0:
        a, b = a[None, ...], b[None, ...]
        f_ba, g_ab = f_ba[None, ...], g_ab[None, ...]
        if f_aa is not None:
            f_aa = f_aa[None, ...]
        if g_bb is not None:
            g_bb = g_bb[None, ...]

    assert eps > 0
    assert rho is None or rho > 0

    if rho is None:
        if not debias:
            F_a, G_b = f_ba, g_ab
        else:
            F_a, G_b = f_ba - f_aa, g_ab - g_bb
    else:
        if not debias:
            F_a = -torch.exp(-f_ba / rho)
            G_b = -torch.exp(-g_ab / rho)
            Cst_a = (rho + (eps / 2) * _masses(b)) * torch.ones_like(F_a)
            Cst_b = (rho + (eps / 2) * _masses(a)) * torch.ones_like(G_b)
            F_a = Cst_a + (rho + eps / 2) * F_a
            G_b = Cst_b + (rho + eps / 2) * G_b
        else:
            F_a = torch.exp(-f_aa / rho) - torch.exp(-f_ba / rho)
            G_b = torch.exp(-g_bb / rho) - torch.exp(-g_ab / rho)
            F_a = (rho + eps / 2) * F_a
            G_b = (rho + eps / 2) * G_b

    total_costs = dot_products(a, F_a) + dot_products(b, G_b)

    assert total_costs.shape == (max(batchsize, 1),)
    if batchsize == 0:
        total_costs = total_costs[0]
    return total_costs

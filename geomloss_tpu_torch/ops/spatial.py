r"""Spatial ordering of point clouds: Hilbert-curve keys.

Counterpart of :mod:`geomloss_tpu.ops.spatial`. The multiscale solver
sorts points so that fixed-size blocks are spatially compact; beyond a few
thousand points it orders them by :func:`hilbert_key` with a stable sort
(``torch.argsort(keys, stable=True)``), which gives the permutation of the
JAX package's linear-time radix sort, itself stable. That radix sort
(``radix_sort_perm``) works around the TPU's sort compile times and has no
counterpart here.
"""

import torch

__all__ = ["hilbert_key"]


def _spread_bits_2(v):
    """Insert two zero bits between each of the low 10 bits."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def _spread_bits_1(v):
    """Insert one zero bit between each of the low 15 bits."""
    v = v & 0x7FFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def hilbert_key(x, bits=10):
    """Hilbert-curve index of each point of ``x`` on a ``2^bits`` grid,
    by Skilling's transpose algorithm ("Programming the Hilbert curve",
    AIP 2004).

    Args:
        x: ``(N, D)`` float coordinates, D in {1, 2, 3}.
        bits: bits per axis (10 -> 30-bit keys for D=3).

    Returns:
        ``(N,)`` int64 keys (the bit arithmetic runs in int64, so no shift
        or mask reaches a sign bit); sorting by them yields a Hilbert
        traversal.
    """
    N, D = x.shape
    n_bins = 1 << bits
    mins = x.min(dim=0).values
    scale = torch.clamp(x.max(dim=0).values - mins, min=1e-12)
    Xi = torch.clamp(torch.floor((x - mins) / scale * n_bins), 0, n_bins - 1).long()

    if D == 1:
        return Xi[:, 0]

    X = [Xi[:, i] for i in range(D)]

    # --- Skilling: AxesToTranspose ------------------------------------------
    for q_exp in range(bits - 1, 0, -1):
        Q = 1 << q_exp
        P = Q - 1
        for i in range(D):
            cond = (X[i] & Q) != 0
            # if: invert low bits of X[0]; else: exchange low bits of X[0], X[i]
            t = (X[0] ^ X[i]) & P
            new_X0 = torch.where(cond, X[0] ^ P, X[0] ^ t)
            if i > 0:
                X[i] = torch.where(cond, X[i], X[i] ^ t)
            X[0] = new_X0

    # Gray encode:
    for i in range(1, D):
        X[i] = X[i] ^ X[i - 1]
    t2 = torch.zeros_like(X[0])
    for q_exp in range(bits - 1, 0, -1):
        Q = 1 << q_exp
        t2 = torch.where((X[D - 1] & Q) != 0, t2 ^ (Q - 1), t2)
    for i in range(D):
        X[i] = X[i] ^ t2

    # --- Interleave the transpose into a single index ------------------------
    if D == 2:
        return (_spread_bits_1(X[0]) << 1) | _spread_bits_1(X[1])
    return (_spread_bits_2(X[0]) << 2) | (_spread_bits_2(X[1]) << 1) | _spread_bits_2(X[2])

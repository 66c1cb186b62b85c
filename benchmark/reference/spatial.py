"""Spatial order and cluster blocks of a point cloud, in plain PyTorch.

A frozen copy of the arithmetic that GeomLoss's multiscale scheme defines
for its clusters: Hilbert keys by Skilling's transpose algorithm
("Programming the Hilbert curve", AIP 2004), a stable sort by key, the
cloud padded to ``tile * 2^k`` points with zero-weight copies of its last
point, and blocks of ``block_size`` consecutive sorted points whose
weighted centroids and summed weights are the coarse measure. The
reference recomputes all of this from the raw clouds; it takes no order,
block or table from the program it judges.
"""

import math

import numpy as np
import torch

#: Kernel tile side of the classic multiscale path up to 2^19 points.
TILE = 512


def _spread_bits_2(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def _spread_bits_1(v):
    v = v & 0x7FFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def hilbert_key(x, bits=10):
    """Hilbert index of each point of ``x`` (``(N, D)``, D <= 3) on a
    ``2^bits`` grid spanning the cloud's bounding box, as int64."""
    _, D = x.shape
    n_bins = 1 << bits
    mins = x.min(dim=0).values
    scale = torch.clamp(x.max(dim=0).values - mins, min=1e-12)
    Xi = torch.clamp(torch.floor((x - mins) / scale * n_bins), 0, n_bins - 1).long()
    if D == 1:
        return Xi[:, 0]
    X = [Xi[:, i] for i in range(D)]
    for q_exp in range(bits - 1, 0, -1):
        Q = 1 << q_exp
        P = Q - 1
        for i in range(D):
            cond = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            new_X0 = torch.where(cond, X[0] ^ P, X[0] ^ t)
            if i > 0:
                X[i] = torch.where(cond, X[i], X[i] ^ t)
            X[0] = new_X0
    for i in range(1, D):
        X[i] = X[i] ^ X[i - 1]
    t2 = torch.zeros_like(X[0])
    for q_exp in range(bits - 1, 0, -1):
        Q = 1 << q_exp
        t2 = torch.where((X[D - 1] & Q) != 0, t2 ^ (Q - 1), t2)
    for i in range(D):
        X[i] = X[i] ^ t2
    if D == 2:
        return (_spread_bits_1(X[0]) << 1) | _spread_bits_1(X[1])
    return (_spread_bits_2(X[0]) << 2) | (_spread_bits_2(X[1]) << 1) | _spread_bits_2(X[2])


def auto_tile(n_max):
    """Tile side for an ``n_max``-point problem: 512 up to 2^19 points,
    1024 beyond, doubled while there are more than 8192 tiles."""
    npad = 1 << max(int(np.ceil(np.log2(max(n_max, 2)))), 0)
    if npad <= (1 << 19):
        return TILE
    tile = 1024
    while npad // tile > 8192:
        tile *= 2
    return tile


def padded_size(n, multiple):
    """``multiple * 2^k``, the least such size at or above ``n``."""
    npad = multiple
    while npad < n:
        npad *= 2
    return npad


def sorted_padded(a, x, pad_multiple):
    """The cloud padded with zero-weight copies of its last point to
    ``pad_multiple * 2^k`` points and sorted by Hilbert key (computed in
    float64, stable). Returns ``(a_s, x_s, order)``: ``order[k]`` is the
    index, in the padded cloud, of sorted slot ``k`` (pads index past N)."""
    N, D = x.shape
    npad = padded_size(N, pad_multiple)
    if npad <= (1 << 12):
        # (GeomLoss orders such small clouds by a KD split, which the
        # reference does not copy.)
        raise ValueError("the reference sorts clouds of more than 4,096 padded points only")
    pad = x[-1:].expand(npad - N, D)
    x_full = torch.cat([x, pad])
    a_full = torch.cat([a, a.new_zeros(npad - N)])
    bits = max(4, min(10, math.ceil(math.log2(max(npad, 2) / 16) / D)))
    order = torch.argsort(hilbert_key(x_full.double(), bits=bits), stable=True)
    return a_full[order], x_full[order], order


def cluster_blocks(a_s, x_s, block_size):
    """Summed weights and weighted centroids of blocks of ``block_size``
    consecutive sorted points (a block of padding alone: weight 0, centroid
    at the origin)."""
    K = a_s.shape[0] // block_size
    ab = a_s.reshape(K, block_size)
    xb = x_s.reshape(K, block_size, -1)
    w = ab.sum(-1)
    cent = (ab[..., None] * xb).sum(1) / torch.clamp(w, min=1e-30)[:, None]
    return w, cent


def block_size_for(n_max, tile, target_clusters=2000):
    """Largest power-of-two divisor of ``tile`` that leaves at least
    ``target_clusters`` blocks of ``n_max`` points."""
    block_size = 1
    while block_size * 2 <= tile and n_max // (block_size * 2) >= target_clusters:
        block_size *= 2
    return block_size

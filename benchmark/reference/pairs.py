"""Pair sums of the reference, in plain PyTorch and in blocks of rows.

Every pair term is ``exp(s_ij)`` with a score ``s_ij`` that is affine in
the cross products ``x_i . y_j`` (the cost ``|x - y|^2 / 2`` expanded), so
a block of scores is one matrix product. In float64 the expansion loses
nothing that matters (its rounding is ~1e-16 of ``|x||y|``). The control
runs the same code in float32 with the matrix products' inputs rounded to
TF32 (:func:`tf32_round`), which is what a tensor-core cost would compute.

:func:`softmin` cuts both clouds into compact tiles (:func:`kd_tiles`) and
visits, for each row tile, only the column tiles whose terms could add up
to more than ``exp(-SKIP_LOG)`` of a row's sum, by a bound from the tiles'
bounding spheres and the largest dual value in each column tile: its
results are exact to ``exp(-SKIP_LOG)`` relative.
"""

import math

import torch

#: The share of a row's sum that the visited tiles may leave out, as
#: ``exp(-SKIP_LOG)`` (~1.9e-12): far below float32 rounding.
SKIP_LOG = 27.0

#: Most points a tile of the bounds (the smaller, the tighter the bounds).
LEAF = 256

#: Rows a block (about): a block's scores are its rows by the union of
#: its row tiles' visited columns.
ROW_BLOCK = 1024


def tf32_round(t):
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as the tensor cores' TF32 inputs."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def cross(a, b, tf32=False):
    """``a @ b.T``, with both inputs rounded to TF32 for the control."""
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b.T


def kd_tiles(x, leaf=LEAF):
    """A balanced KD order of ``x``: segments split at their median along
    their widest axis until none holds more than ``leaf`` points. Returns
    ``(perm, starts)``: the order and the leaves' offsets in it."""
    n, D = x.shape
    dev = x.device
    perm = torch.arange(n, device=dev)
    starts = torch.tensor([0, n], device=dev)
    while int((starts[1:] - starts[:-1]).max()) > leaf:
        lens = starts[1:] - starts[:-1]
        seg = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev), lens)
        xp = x[perm]
        idx = seg[:, None].expand(-1, D)
        lo = torch.full((lens.shape[0], D), math.inf, dtype=x.dtype, device=dev).scatter_reduce(0, idx, xp, "amin")
        hi = torch.full((lens.shape[0], D), -math.inf, dtype=x.dtype, device=dev).scatter_reduce(0, idx, xp, "amax")
        axis = (hi - lo).argmax(dim=1)
        order = torch.argsort(xp.gather(1, axis[seg][:, None])[:, 0], stable=True)
        order = order[torch.argsort(seg[order], stable=True)]
        perm = perm[order]
        mids = starts[:-1] + lens // 2
        starts = torch.cat([torch.stack([starts[:-1], mids], dim=1).reshape(-1), starts[-1:]])
    return perm, starts


class Tiles:
    """A cloud in its own KD order (``perm``), cut into leaves, with each
    leaf's bounding sphere (centre, radius) and point count."""

    def __init__(self, pts, leaf=LEAF):
        self.perm, starts = kd_tiles(pts, leaf)
        self.pts = pts[self.perm]
        self.n, self.dim = pts.shape
        self.nt = starts.shape[0] - 1
        lens = starts[1:] - starts[:-1]
        self.seg = torch.repeat_interleave(torch.arange(self.nt, device=pts.device), lens)
        self.count = lens.to(pts.dtype)
        self.center = torch.zeros(self.nt, self.dim, dtype=pts.dtype, device=pts.device).index_add_(
            0, self.seg, self.pts) / self.count[:, None]
        dist = torch.linalg.vector_norm(self.pts - self.center[self.seg], dim=1)
        self.radius = torch.zeros(self.nt, dtype=pts.dtype, device=pts.device).scatter_reduce(
            0, self.seg, dist, "amax")
        width = int(lens.max())
        pos = torch.arange(self.n, device=pts.device) - starts[:-1][self.seg]
        self.index = torch.full((self.nt, width), -1, dtype=torch.long, device=pts.device)
        self.index[self.seg, pos] = torch.arange(self.n, device=pts.device)
        self.starts = starts.tolist()

    def tile_max(self, h):
        """The largest entry of ``h`` (in this order) in each tile."""
        return torch.full((self.nt,), -math.inf, dtype=h.dtype, device=h.device).scatter_reduce(
            0, self.seg, h, "amax")

    def columns(self, tiles):
        """Point indices (in this order) of the given tiles."""
        idx = self.index[tiles].reshape(-1)
        return idx[idx >= 0]


def kept_tiles(rows, src, hmax, eps):
    """``(rows.nt, src.nt)`` bool: the column tiles that a row tile visits.

    For rows ``i`` of tile ``I`` and sources ``j`` of tile ``J`` at centre
    distance ``c``, ``|x_i - y_j|`` lies in ``[c - r_I - r_J, c + r_I +
    r_J]``: tile ``J`` adds at most ``exp(m_IJ) = n_J exp(hmax_J - lo^2 / 2
    eps)`` to each row's sum, and some tile at least ``exp(b_I) = max_J
    exp(hmax_J - hi^2 / 2 eps)``. The tiles left out are those of least
    ``m_IJ`` whose ``exp(m_IJ)`` add up to at most ``exp(b_I - SKIP_LOG)``."""
    c = torch.cdist(rows.center, src.center)
    rr = rows.radius[:, None] + src.radius[None, :]
    lo = torch.clamp(c - rr, min=0.0)
    hi = c + rr
    most = hmax[None, :] + torch.log(src.count)[None, :] - lo * lo / (2 * eps)
    best = (hmax[None, :] - hi * hi / (2 * eps)).amax(dim=1, keepdim=True)
    ranked, order = torch.sort(most, dim=1)
    left_out = torch.logcumsumexp(ranked, dim=1) <= best - SKIP_LOG
    return torch.ones_like(left_out).scatter_(1, order, ~left_out)


def _row_blocks(rows):
    """``(r0, r1, tiles)`` of blocks of consecutive row tiles, about
    :data:`ROW_BLOCK` rows each."""
    t0 = 0
    while t0 < rows.nt:
        t1 = t0 + 1
        while t1 < rows.nt and rows.starts[t1 + 1] - rows.starts[t0] <= ROW_BLOCK:
            t1 += 1
        yield rows.starts[t0], rows.starts[t1], slice(t0, t1)
        t0 = t1


def softmin(rows, src, h, eps, mean_of=None, tf32=False):
    """``S_i = -eps log sum_j exp(h_j - |x_i - y_j|^2 / (2 eps))`` for every
    row of ``rows`` over the sources ``src`` (both :class:`Tiles`; ``h`` and
    the result in the clouds' own order, not the tiles').

    With ``mean_of`` (a bool mask over the rows), also returns, for the
    rows it marks, in their order, the softmax-weighted mean of the
    sources, ``sum_j w_ij y_j`` with ``w_ij`` the terms over their sum.
    """
    x, y = rows.pts, src.pts
    hs = h[src.perm]
    keep = kept_tiles(rows, src, src.tile_max(hs), eps)
    hb = hs - (y * y).sum(1) / (2 * eps)
    rsq = (x * x).sum(1) / (2 * eps)
    out = torch.empty(rows.n, dtype=x.dtype, device=x.device)
    marked = mean_of[rows.perm] if mean_of is not None else None
    means = torch.empty((rows.n, rows.dim), dtype=x.dtype, device=x.device) if mean_of is not None else None
    for r0, r1, tiles in _row_blocks(rows):
        cols = src.columns(keep[tiles].any(dim=0).nonzero()[:, 0])
        yc = y.index_select(0, cols)
        s = cross(x[r0:r1], yc, tf32) / eps + hb.index_select(0, cols)[None, :]
        lse = torch.logsumexp(s, dim=1)
        out[r0:r1] = -eps * (lse - rsq[r0:r1])
        if marked is not None:
            sel = marked[r0:r1].nonzero()[:, 0]
            if sel.numel():
                w = torch.exp(s.index_select(0, sel) - lse.index_select(0, sel)[:, None])
                means[r0 + sel] = cross(w, yc.T.contiguous(), tf32)
        del s
    result = torch.empty_like(out)
    result[rows.perm] = out
    if mean_of is None:
        return result
    back = torch.empty_like(means)
    back[rows.perm] = means
    return result, back[mean_of]

"""The energy distance and its gradient in x, in plain PyTorch.

``SamplesLoss("energy")`` is, on every backend,

    1/2 <a, K_xx a> + 1/2 <b, K_yy b> - <a, K_xy b>,
    k(x, y) = -d(x, y),  d = sqrt(max(|x - y|^2, 1e-8))

(upstream GeomLoss's ``distances``) over every point pair: the energy
kernel is never truncated. Its gradient in ``x_i`` is

    a_i (sum_j b_j (x_i - y_j) / |x_i - y_j| - sum_k a_k (x_i - x_k) / |x_i - x_k|)

over every pair at a distance above zero (a pair at distance 0, such as a
point with itself, adds nothing). No pair is cut: the program's gradient
leaves out the pairs closer than 1e-3, a departure that the configuration
states and the cell's limits judge.

Every squared distance is one matrix product of augmented points,
``[x, |x|^2, 1] . [-2 y, 1, |y|^2]``, in the requested dtype: in float64
its rounding is ~1e-16 of ``|x|^2``; the control (float32) takes the
cross products' inputs rounded to TF32 (:func:`pairs.tf32_round`), and
every other matrix product through :func:`pairs.cross`. The value's self
terms run over triangles of row blocks (a block of rows against the
columns from its first row on: the square on the diagonal once, the rest
twice), so a call evaluates about ``N M + (N^2 + M^2) / 2`` pairs, plus
the gradient rows against both clouds.
"""

import torch

from .pairs import cross, tf32_round

#: Pairs in a block of rows by columns, about (2 GiB of float64 scores).
BLOCK_PAIRS = 1 << 28

#: The clamp of upstream's ``distances`` (squared).
SQDIST_FLOOR = 1e-8


def _augmented(p, tf32):
    """``([p, |p|^2, 1], [-2 p, 1, |p|^2])``: row and column forms whose
    products are the squared distances (the coordinates rounded to TF32
    for the control, the norms exact)."""
    q = tf32_round(p) if tf32 else p
    norm = (p * p).sum(1, keepdim=True)
    one = torch.ones_like(norm)
    return torch.cat([q, norm, one], 1), torch.cat([-2 * q, one, norm], 1)


def _distance_sum(rows, cols, u, w, tf32, tri):
    """``sum_i u_i sum_j w_j d_ij`` over the rows' forms ``rows`` and the
    columns' ``cols``; with ``tri`` (the same cloud, ``u`` = ``w``), over
    row blocks against the columns from their first row on."""
    n, m = rows.shape[0], cols.shape[0]
    total = rows.new_zeros(())
    r0 = 0
    while r0 < n:
        c0 = r0 if tri else 0
        r1 = min(n, r0 + max(1, BLOCK_PAIRS // (m - c0)))
        d = (rows[r0:r1] @ cols[c0:].T).clamp_min_(SQDIST_FLOOR).sqrt_()
        wc = w[c0:]
        if tri:
            wc = wc.clone()
            wc[r1 - r0 :] *= 2
        total += torch.dot(u[r0:r1], cross(d, wc[None, :], tf32)[:, 0])
        del d
        r0 = r1
    return total


def _inverse_distance_sums(xr, self_at, rows, cols, pts, w, tf32):
    """``(sum_j w_j / d_ij, sum_j w_j p_j / d_ij)`` for the gradient rows
    (their forms ``rows``, their points ``xr``) over the columns (forms
    ``cols``, points ``pts``, weights ``w``); pairs at distance 0, and
    with ``self_at`` (the rows' indices among the columns) each row's own
    column, add nothing."""
    n, m = rows.shape[0], cols.shape[0]
    s = xr.new_zeros(n)
    t = torch.zeros_like(xr)
    V = torch.cat([w[:, None], w[:, None] * pts], 1)
    step = max(1, BLOCK_PAIRS // n)
    for c0 in range(0, m, step):
        c1 = min(m, c0 + step)
        sq = rows @ cols[c0:c1].T
        inv = torch.where(sq > 0, torch.rsqrt(sq), torch.zeros_like(sq))
        if self_at is not None:
            own = ((self_at >= c0) & (self_at < c1)).nonzero()[:, 0]
            inv[own, self_at[own] - c0] = 0
        st = cross(inv, V[c0:c1].T.contiguous(), tf32)
        s += st[:, 0]
        t += st[:, 1:]
        del sq, inv
    return s, t


def compute(inputs, call, grad_rows, dtype=torch.float64, tf32=False):
    """The value and the gradient rows ``grad_rows`` (indices into ``x``)
    of the energy distance between the weighted clouds of ``inputs``
    (``a``, ``x``, ``b``, ``y``), computed in ``dtype`` (``tf32``: float32
    with TF32 matrix products, the control). Returns ``(value, grad)``:
    a float and a ``(len(grad_rows), D)`` tensor on the clouds' device."""
    if call.get("loss") != "energy":
        raise NotImplementedError("the reference covers the energy distance")
    a, x, b, y = (inputs[k].to(dtype) for k in "axby")
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xr, xc = _augmented(x, tf32)
        yr, yc = _augmented(y, tf32)
        s_xx = _distance_sum(xr, xc, a, a, tf32, tri=True)
        s_yy = _distance_sum(yr, yc, b, b, tf32, tri=True)
        s_xy = _distance_sum(xr, yc, a, b, tf32, tri=False)
        value = -0.5 * s_xx - 0.5 * s_yy + s_xy

        rows = grad_rows.to(x.device)
        xg = x.index_select(0, rows)
        sb, tb = _inverse_distance_sums(xg, None, xr.index_select(0, rows), yc, y, b, tf32)
        sa, ta = _inverse_distance_sums(xg, rows, xr.index_select(0, rows), xc, x, a, tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    grad = a.index_select(0, rows)[:, None] * (xg * (sb - sa)[:, None] - tb + ta)
    return float(value), grad

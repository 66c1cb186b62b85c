"""The debiased Sinkhorn divergence and its gradient in x, in plain PyTorch.

The same semantics as GeomLoss's ``SamplesLoss("sinkhorn", p=2, ...)``,
written again from its definition:

* the temperatures ``eps_list`` of :func:`schedule.epsilon_schedule`;
* the symmetric, averaged updates ``f <- (f + softmin(g)) / 2`` of the
  four potentials ``f_ba, g_ab, f_aa, g_bb`` at each temperature, all four
  from the previous iterates, after an initial sweep at ``eps_list[0]``;
* on the multiscale route, the coarse-to-fine scheme: the same descent on
  the cluster blocks of :mod:`spatial` up to the jump temperature (above
  2^20 points, on pooled blocks of the points for the next temperatures
  too), the four potentials extrapolated onto the points, then the
  remaining temperatures on the points;
* one last extrapolation at the final temperature, whose sources are
  held fixed, and the value ``<a, f_ba - f_aa> + <b, g_ab - g_bb>``.

Its gradient in ``x_i`` is then ``a_i (sum_k u_ik x_k - sum_j w_ij y_j)``,
with ``w`` and ``u`` the last extrapolation's softmax weights of the rows
``x_i`` over ``y`` and over ``x``. Every softmin is exact to ``exp(-27)``
(:mod:`pairs`): where the program truncates the fine phase to tables of
kept tiles, the reference keeps every tile that matters by its own bound,
so that what it reads is the scheme, not a table.
"""

import math

import numpy as np
import torch

from . import pairs, spatial
from .schedule import epsilon_schedule

#: Largest point count the classic two-scale descent serves; above it (and
#: with truncation) the scheme delays the fine phase by an intermediate
#: scale of pooled points.
N_FINE_OK = 1 << 20


def log_weights(a):
    """``log a``, zero weights at -100000."""
    return torch.where(a > 0, torch.log(torch.clamp(a, min=1e-30)), torch.full_like(a, -100000.0))


def default_cluster_scale(diameter, D):
    """GeomLoss's default coarse resolution: ~2000 clusters."""
    return diameter / (math.sqrt(D) * 2000 ** (1 / D))


def jump_index(eps_list, cluster_scale, p):
    """The first step past the two warm-up iterations whose temperature
    resolves the cluster scale, else the last."""
    for i, e in enumerate(eps_list[2:]):
        if cluster_scale**p > e:
            return i + 1
    return len(eps_list) - 1


def mid_delay(n_max, eps_list, jump, scaling, p):
    """The temperatures after the jump that run on the intermediate scale
    (0: the classic two-scale descent)."""
    if n_max <= N_FINE_OK:
        return 0
    n_delay = int(np.ceil(np.log(n_max / N_FINE_OK) / np.log(1.0 / float(scaling) ** p)))
    return min(n_delay, len(eps_list) - 1 - jump)


def pooled(w, pts, size):
    """Blocks of ``size`` consecutive sorted points pooled into one point of
    their summed weight at their weighted centroid (a block of padding
    alone at its plain mean)."""
    wb = w.reshape(-1, size)
    pb = pts.reshape(-1, size, pts.shape[1])
    wsum = wb.sum(1)
    cent = (pb * wb[..., None]).sum(1) / torch.clamp(wsum, min=1e-30)[:, None]
    return wsum, torch.where(wsum[:, None] > 0, cent, pb.mean(1))


def _extrapolated(X, Y, Xs, Ys, as_log, bs_log, carry, e, tf32):
    """The four potentials of ``carry`` on the sources ``Xs``, ``Ys``
    extrapolated onto the rows ``X``, ``Y`` at temperature ``e``, all four
    from the same iterates."""
    f_ba, g_ab, f_aa, g_bb = carry
    return (
        pairs.softmin(X, Ys, bs_log + g_ab / e, e, tf32=tf32),
        pairs.softmin(Y, Xs, as_log + f_ba / e, e, tf32=tf32),
        pairs.softmin(X, Xs, as_log + f_aa / e, e, tf32=tf32),
        pairs.softmin(Y, Ys, bs_log + g_bb / e, e, tf32=tf32),
    )


def route(call, n, m, d):
    """The scheme that ``backend`` selects for an ``n x m`` problem in
    ``d`` dimensions: ``"online"`` or ``"multiscale"``."""
    backend = call.get("backend", "auto")
    if backend == "auto":
        if n * m <= 5000**2:
            raise NotImplementedError("the dense route of small clouds has no reference here")
        if d <= 3 and call.get("p", 2) == 2 and n * m > 10000**2:
            return "multiscale"
        return "online"
    if backend not in ("online", "multiscale"):
        raise NotImplementedError(f"backend {backend!r} has no reference here")
    return backend


def _descent(sweep, carry, eps_seq):
    """Averaged updates of the four potentials over ``eps_seq``."""
    f_ba, g_ab, f_aa, g_bb = carry
    for e in eps_seq:
        S_xy, S_yx, S_xx, S_yy = sweep(e, f_ba, g_ab, f_aa, g_bb)
        f_ba, g_ab = 0.5 * (f_ba + S_xy), 0.5 * (g_ab + S_yx)
        f_aa, g_bb = 0.5 * (f_aa + S_xx), 0.5 * (g_bb + S_yy)
    return f_ba, g_ab, f_aa, g_bb


def _sweeps(X, Y, a_log, b_log, tf32):
    """The four softmins of one update onto the rows of ``X`` and ``Y``
    (:class:`pairs.Tiles`) from the sources ``X``, ``Y``."""

    def sweep(e, f_ba, g_ab, f_aa, g_bb):
        return (
            pairs.softmin(X, Y, b_log + g_ab / e, e, tf32=tf32),
            pairs.softmin(Y, X, a_log + f_ba / e, e, tf32=tf32),
            pairs.softmin(X, X, a_log + f_aa / e, e, tf32=tf32),
            pairs.softmin(Y, Y, b_log + g_bb / e, e, tf32=tf32),
        )

    return sweep


def _finish(X, Y, a, b, a_log, b_log, carry, eps_last, grad_at, tf32):
    """The last extrapolation, the value and the gradient rows that
    ``grad_at`` marks (a bool mask over the points of x), in index order."""
    f_ba, g_ab, f_aa, g_bb = carry
    e = eps_last
    F_ba, w_mean = pairs.softmin(X, Y, b_log + g_ab / e, e, mean_of=grad_at, tf32=tf32)
    G_ab = pairs.softmin(Y, X, a_log + f_ba / e, e, tf32=tf32)
    F_aa, u_mean = pairs.softmin(X, X, a_log + f_aa / e, e, mean_of=grad_at, tf32=tf32)
    G_bb = pairs.softmin(Y, Y, b_log + g_bb / e, e, tf32=tf32)
    value = torch.dot(a, F_ba - F_aa) + torch.dot(b, G_ab - G_bb)
    grad = a[grad_at][:, None] * (u_mean - w_mean)
    return value, grad


def compute(inputs, call, grad_rows, dtype=torch.float64, tf32=False):
    """The value and the gradient rows ``grad_rows`` (indices into ``x``)
    of ``SamplesLoss(**call)(a, x, b, y)`` for the weighted clouds of
    ``inputs`` (``a``, ``x``, ``b``, ``y``), computed in ``dtype``
    (``tf32``: float32 with TF32 matrix products, the control).

    Returns ``(value, grad)``: a Python float and a ``(len(grad_rows), D)``
    tensor in ``grad_rows``' order.
    """
    a_in, x, b_in, y = inputs["a"], inputs["x"], inputs["b"], inputs["y"]
    if call.get("loss", "sinkhorn") != "sinkhorn" or call.get("p", 2) != 2:
        raise NotImplementedError("the reference covers the Sinkhorn loss at p = 2")
    if call.get("reach") is not None or not call.get("debias", True):
        raise NotImplementedError("the reference covers the balanced, debiased divergence")
    N, D = x.shape
    M = y.shape[0]
    p, blur, scaling = 2, call.get("blur", 0.05), call.get("scaling", 0.5)
    diameter = call["diameter"]
    eps_list = epsilon_schedule(p, diameter, blur, scaling)
    scheme = route(call, N, M, D)
    dev = x.device

    X, Y = pairs.Tiles(x.to(dtype)), pairs.Tiles(y.to(dtype))
    a, b = a_in.to(dtype), b_in.to(dtype)
    a_log, b_log = log_weights(a), log_weights(b)
    if scheme == "online":
        sweep = _sweeps(X, Y, a_log, b_log, tf32)
        zx, zy = torch.zeros_like(a), torch.zeros_like(b)
        S_xy, S_yx, S_xx, S_yy = sweep(eps_list[0], zx, zy, zx, zy)
        carry = _descent(sweep, (S_xy, S_yx, S_xx, S_yy), eps_list)
    else:
        tile = spatial.auto_tile(max(N, M))
        block = spatial.block_size_for(max(N, M), tile)
        a_s, x_s, _ = spatial.sorted_padded(a_in, x, tile)
        b_s, y_s, _ = spatial.sorted_padded(b_in, y, tile)
        a_s, x_s, b_s, y_s = a_s.to(dtype), x_s.to(dtype), b_s.to(dtype), y_s.to(dtype)
        w_x, c_x = spatial.cluster_blocks(a_s, x_s, block)
        w_y, c_y = spatial.cluster_blocks(b_s, y_s, block)
        cs = default_cluster_scale(diameter, D)
        jump = jump_index(eps_list, cs, p)
        if jump == len(eps_list) - 1:
            raise NotImplementedError("a jump at the last temperature has no reference here")

        # Coarse descent on the cluster blocks:
        Xc, Yc = pairs.Tiles(c_x), pairs.Tiles(c_y)
        ac_log, bc_log = log_weights(w_x), log_weights(w_y)
        sweep = _sweeps(Xc, Yc, ac_log, bc_log, tf32)
        zx, zy = torch.zeros_like(w_x), torch.zeros_like(w_y)
        coarse = _descent(sweep, sweep(eps_list[0], zx, zy, zx, zy), eps_list[: jump + 1])

        Xs, Ys, as_log, bs_log = Xc, Yc, ac_log, bc_log
        n_delay = mid_delay(max(N, M), eps_list, jump, scaling, p) if call.get("truncate", 5) is not None else 0
        if n_delay:
            # The intermediate scale: the coarse potentials extrapolated
            # onto pooled blocks of the sorted points, the next n_delay
            # temperatures on them, and the jump moved there.
            size = 1 << max(0, int(np.floor(np.log2(block * float(scaling) ** (2 * n_delay)))))
            w_xm, x_m = pooled(a_s, x_s, size)
            w_ym, y_m = pooled(b_s, y_s, size)
            Xs, Ys, as_log, bs_log = pairs.Tiles(x_m), pairs.Tiles(y_m), log_weights(w_xm), log_weights(w_ym)
            coarse = _extrapolated(Xs, Ys, Xc, Yc, ac_log, bc_log, coarse, eps_list[jump], tf32)
            coarse = _descent(_sweeps(Xs, Ys, as_log, bs_log, tf32), coarse, eps_list[jump + 1 : jump + n_delay + 1])
            jump += n_delay
            if jump == len(eps_list) - 1:
                raise NotImplementedError("a jump at the last temperature has no reference here")

        # Jump: the four potentials extrapolated onto the points (the
        # sorted clouds' pads, of weight 0, have no potential to carry):
        carry = _extrapolated(X, Y, Xs, Ys, as_log, bs_log, coarse, eps_list[jump], tf32)
        eps_fine = list(eps_list[jump + 1 :])
        if cs**p > 50 * blur**p:
            eps_fine = [eps_fine[0]] * 2 + eps_fine
        carry = _descent(_sweeps(X, Y, a_log, b_log, tf32), carry, eps_fine)

    at = torch.zeros(N, dtype=torch.bool, device=dev)
    at[grad_rows] = True
    value, grad = _finish(X, Y, a, b, a_log, b_log, carry, eps_list[-1], at, tf32)
    # (grad holds the marked rows in index order)
    rank = torch.cumsum(at.long(), 0) - 1
    return float(value), grad[rank[grad_rows]]

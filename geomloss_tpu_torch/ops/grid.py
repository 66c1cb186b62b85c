r"""Grid (signal/image/volume) primitives: pyramids, upsampling, separable
soft and hard C-transforms.

Counterpart of :mod:`geomloss_tpu.ops.grid`. On a regular grid with the
:math:`|x - y|^p / p` cost the D-dimensional soft C-transform factors into
D one-dimensional log-convolutions, one per axis:

.. math::
    \text{out}_i = \log \sum_j e^{A_j - c(x_i - x_j)/\varepsilon},

each an exact log-sum-exp over a dense ``(N, N)`` log-kernel (``N`` is the
grid side), with one max per output entry (see :func:`_lse_axis` for why
this differs from the JAX package's matmul form). No Pallas kernel is on
this path in the JAX package.
"""

import math

import torch
import torch.nn.functional as F

__all__ = [
    "log_dens",
    "pyramid",
    "upsample",
    "softmin_grid",
    "softmin_grid_coords",
    "axis_kernel_log",
    "C_transform",
]


def log_dens(a):
    """log(a) with zero/negative densities clamped to -10000 (the grid
    clamp; point clouds use -100000)."""
    return torch.where(a > 0, torch.log(torch.clamp(a, min=1e-30)), torch.full_like(a, -10000.0))


def _sum_pool2(a, D):
    """Sum-pool by a factor 2 over the last D axes (mass-preserving; an odd
    trailing entry is dropped, as a VALID window drops it)."""
    lead = a.shape[: a.ndim - D]
    grid = a.shape[a.ndim - D :]
    a = a[(Ellipsis,) + tuple(slice(0, 2 * (n // 2)) for n in grid)]
    split = lead + tuple(s for n in grid for s in (n // 2, 2))
    return a.reshape(split).sum(dim=tuple(len(lead) + 2 * d + 1 for d in range(D)))


def pyramid(a, D=None):
    """Multiscale decomposition (Binary/Quad/OcTree): list of sum-pooled
    grids, coarsest first.

    Args:
        a: tensor whose last ``D`` axes are the grid axes.
        D: grid dimensionality; defaults to ``a.ndim - 1`` (one batch axis).
    """
    if D is None:
        D = a.ndim - 1
    a_s = [a]
    for _ in range(int(math.log2(a.shape[-1]))):
        a = _sum_pool2(a, D)
        a_s.append(a)
    a_s.reverse()
    return a_s


_LINEAR_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def upsample(a, D=None):
    """x2 (bi/tri)linear upsampling over the last D axes
    (``align_corners=False``); every leading axis is folded into the batch."""
    if D is None:
        D = a.ndim - 1
    lead, grid = a.shape[: a.ndim - D], a.shape[a.ndim - D :]
    out = F.interpolate(
        a.reshape((-1, 1) + tuple(grid)),
        size=tuple(2 * s for s in grid),
        mode=_LINEAR_MODES[D],
        align_corners=False,
    )
    return out.reshape(tuple(lead) + tuple(out.shape[2:]))


def _axis_kernel_log(N, eps, p, dtype, device):
    """Log of the 1D Gibbs kernel on the unit interval, ``x = arange(N)/N``."""
    return axis_kernel_log(torch.arange(N, dtype=dtype, device=device) / N, eps, p)


#: Elements of the largest ``(rows, N, N)`` temporary of one chunk of an
#: axis pass (256 MB in float32).
LSE_CHUNK_ELEMS = 1 << 26


def _chunks(rows, n_out, n_in):
    step = max(1, LSE_CHUNK_ELEMS // (n_out * n_in))
    return [slice(r, min(r + step, rows)) for r in range(0, rows, step)]


class _LseAxis(torch.autograd.Function):
    """``out[r, i] = log sum_j exp(K_log[i, j] + A[r, j])`` for ``A (R, N)``,
    one max per output entry, in row chunks; the backward pass recomputes
    the softmax weights chunk by chunk instead of saving them."""

    @staticmethod
    def forward(ctx, A, K_log):
        out = A.new_empty(A.shape[0], K_log.shape[0])
        for c in _chunks(A.shape[0], *K_log.shape):
            out[c] = torch.logsumexp(A[c, None, :] + K_log, dim=-1)
        ctx.save_for_backward(A, K_log, out)
        return out

    @staticmethod
    def backward(ctx, g):
        A, K_log, out = ctx.saved_tensors
        gA = torch.empty_like(A) if ctx.needs_input_grad[0] else None
        gK = torch.zeros_like(K_log) if ctx.needs_input_grad[1] else None
        for c in _chunks(A.shape[0], *K_log.shape):
            # g_ri softmax_j(K_log[i, j] + A[r, j]), (rows, N_out, N_in):
            P = (A[c, None, :] + K_log).sub_(out[c, :, None]).exp_().mul_(g[c, :, None])
            if gA is not None:
                gA[c] = P.sum(dim=1)
            if gK is not None:
                gK += P.sum(dim=0)
        return gA, gK


def _lse_axis(A, K_log):
    """Log-convolution along the last axis:
    ``out[..., i] = log sum_j exp(K_log[i, j] + A[..., j])``, exact.

    The JAX package computes it as ``m + log(exp(A - m) @ exp(K_log).T)``
    with one max ``m`` per row of A, a form made for the TPU's matrix
    unit. At eps = one pixel^2 that form underflows: A changes by up to N
    per pixel, so every output whose neighbourhood lies far below the row's
    max gets a sum of zeros and the floor. From 128^2 at p = 2 the
    divergence it gives is wrong even in float64 (negative). This pass
    takes one max per output entry, as the reference's per-axis KeOps
    reduction does, and runs no matmul, so TF32 cannot enter it whatever
    the caller set. Elementwise work over ``(rows, N, N)`` in chunks of
    :data:`LSE_CHUNK_ELEMS`.
    """
    lead = A.shape[:-1]
    out = _LseAxis.apply(A.reshape(-1, A.shape[-1]), K_log)
    return out.reshape(lead + (K_log.shape[0],))


def axis_kernel_log(coords, eps, p, period=None):
    """Log of the 1D Gibbs kernel for arbitrary axis coordinates:
    ``K_log[i, j] = -d(x_i, x_j)^p / (p * eps)`` with the torus metric
    ``d = min(|xi - xj|, period - |xi - xj|)`` when ``period`` is given."""
    diff = (coords[:, None] - coords[None, :]).abs()
    if period is not None:
        diff = torch.minimum(diff, period - diff)
    if p == 2:
        return -(diff**2) / (2 * eps)
    if p == 1:
        return -diff / eps
    raise NotImplementedError(f"p={p} is not supported on grids.")


def _separable(h_y, D, kernel_log):
    """The separable log-convolution of the grid softmins, before their
    factor ``-eps``: one :func:`_lse_axis` pass over each of the last D
    axes, ``kernel_log(d, N)`` giving axis d's log-kernel."""
    out = h_y
    for d, axis in enumerate(range(h_y.ndim - D, h_y.ndim)):
        K_log = kernel_log(d, out.shape[axis])
        out = _lse_axis(out.movedim(axis, -1), K_log).movedim(-1, axis)
    return out


def softmin_grid_coords(eps, p, h_y, coords, periods=None, D=None):
    """Separable soft-C-transform with explicit per-axis coordinates and
    optional per-axis periodicity (see :func:`axis_kernel_log`).

    Args:
        coords: D-tuple of ``(N_d,)`` coordinate arrays or tensors.
        periods: D-tuple of floats or ``None`` entries.
    """
    if D is None:
        D = h_y.ndim - 1
    if periods is None:
        periods = (None,) * D

    def kernel_log(d, N):
        c = torch.as_tensor(coords[d], dtype=h_y.dtype, device=h_y.device)
        return axis_kernel_log(c, eps, p, period=periods[d])

    return -eps * _separable(h_y, D, kernel_log)


def softmin_grid(eps, C_xy, h_y, D=None):
    r"""Separable soft-C-transform on a regular grid over the unit cube.

    ``f = -eps * log sum_j exp(h_j - C(x_i, y_j)/eps)`` where the sum runs
    over all grid points and ``C = |x - y|^p / p`` (for p = 1 the Manhattan
    distance), as D successive 1D passes.

    Args:
        eps: temperature.
        C_xy: the integer ``p`` (the grid cost is implicit).
        h_y: ``(..., N_1, ..., N_D)`` dual tensor; all leading axes are batch.
        D: number of grid axes; defaults to ``h_y.ndim - 1``.

    Returns:
        A tensor of the same shape as ``h_y``.
    """
    if D is None:
        D = h_y.ndim - 1
    return -eps * _separable(
        h_y, D, lambda d, N: _axis_kernel_log(N, eps, C_xy, h_y.dtype, h_y.device)
    )


def C_transform(G, tau=1, p=2, D=None):
    r"""Hard (max-plus) C-transform on a grid:
    ``F(x_i) = max_j [G(x_j) - C(x_i, x_j)]`` with
    ``C(x, y) = |x - y|^p / (p * tau)``, computed separably (pixel
    coordinates 0..N-1)."""
    if D is None:
        D = G.ndim - 1
    out = G
    for axis in range(G.ndim - D, G.ndim):
        N = out.shape[axis]
        x = torch.arange(N, dtype=out.dtype, device=out.device)
        diff = x[:, None] - x[None, :]
        if p == 1:
            K = -diff.abs() / tau
        elif p == 2:
            K = -(diff**2) / (2 * tau)
        else:
            raise NotImplementedError()
        moved = out.movedim(axis, -1)
        out = (moved.unsqueeze(-2) + K).amax(dim=-1).movedim(-1, axis)
    return out

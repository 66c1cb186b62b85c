r"""Kernel (MMD) norms between sampled measures: gaussian, laplacian, energy.

Counterpart of :mod:`geomloss_tpu.models.kernel_samples`:

.. math::
    \text{Loss}(\alpha, \beta) = \tfrac12 \langle \alpha, K_{xx}\alpha\rangle
      + \tfrac12 \langle \beta, K_{yy}\beta\rangle
      - \langle \alpha, K_{xy}\beta\rangle

with the reference's gradient bookkeeping: the self-interaction matvecs
take a detached partner and a :func:`double_grad` wrapper that doubles the
incoming gradient, which makes up for the detached symmetric halves.

Three routes:

* ``kernel_tensorized`` (``use_streaming=False``): dense kernel matrices;
* ``kernel_online`` (``use_streaming=True``): the streaming matvec
  :func:`geomloss_tpu_torch.ops.softmin.gibbs_matvec` (kernel 4 on the
  card), never building the ``N x M`` matrix. The energy kernel's ``K_xx
  a`` and ``K_xy b``, whose x requires grad (with grad enabled), compute
  the gradient's channels in their forward, one pass over the pairs for
  the value and the gradient in x, so the backward makes no apply for x:
  three passes a loss and gradient instead of five. A loss computed with
  grad enabled and x requiring grad but never differentiated pays those
  two fused passes (about 1.2x a value-only pass each at D = 3); under
  ``torch.no_grad()`` it pays nothing more;
* ``kernel_multiscale``: points spatially sorted into tiles, and only the
  tile pairs within the kernel's support radius visited
  (:func:`~geomloss_tpu_torch.ops.block_sparse.masks_from_geometry`,
  :func:`~geomloss_tpu_torch.ops.block_sparse.kernel_matvec_sparse`,
  kernel 8 on the card); user ``kernel=`` callables run over the same
  kept tiles with no kernel. The energy kernel, ``truncate=None``, batched
  input and a non-callable ``kernel`` take the streaming route, as in the
  JAX package.

The ``hausdorff`` loss is an alias of these routines.
"""

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.block_sparse import CUSTOM_CHUNK_ELEMS, kernel_matvec_sparse, masks_from_geometry
from ..ops.costs import distances, squared_distances
from ..ops.softmin import gibbs_matvec
from ..solvers.sinkhorn_loop import scal
from ..utils import profiling
from .multiscale import _desort, auto_tile, spatial_sort_blocks

__all__ = [
    "double_grad",
    "kernel_tensorized",
    "kernel_online",
    "kernel_multiscale",
    "kernel_routines",
]


class _DoubleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 2 * g


def double_grad(x):
    """Identity in the forward pass, doubles the gradient in the backward."""
    return _DoubleGrad.apply(x)


# ------------------------------------------------------------------------------
#  Dense kernel matrices (tensorized path)
# ------------------------------------------------------------------------------


def gaussian_kernel(x, y, blur=0.05):
    C2 = squared_distances(x / blur, y / blur)
    return torch.exp(-C2 / 2)


def laplacian_kernel(x, y, blur=0.05):
    C = distances(x / blur, y / blur)
    return torch.exp(-C)


def energy_kernel(x, y, blur=None):
    return -distances(x, y)


kernel_routines = {
    "gaussian": gaussian_kernel,
    "laplacian": laplacian_kernel,
    "energy": energy_kernel,
}

#: ``(p, kind)`` of each named kernel on the streaming apply: gaussian =
#: exp(-sqdist/(2 blur^2)) = a Gibbs weight with p=2, eps=blur^2; laplacian
#: = exp(-dist/blur) = p=1, eps=blur; energy = -dist.
_streaming_params = {
    "gaussian": (2, "gibbs"),
    "laplacian": (1, "gibbs"),
    "energy": (1, "energy"),
}


def _kernel_matvec_streaming(name, blur, x, y, v, impl="auto"):
    """``K @ v`` without building ``K``, over a leading batch dimension when
    there is one, through the differentiable :func:`gibbs_matvec`."""
    p, kind = _streaming_params[name]
    eps = blur**p if kind == "gibbs" else 1.0
    if x.ndim == 3:
        return torch.stack([gibbs_matvec(x[i], y[i], v[i], eps, p, kind, impl) for i in range(x.shape[0])])
    return gibbs_matvec(x, y, v, eps, p, kind, impl)


def _kernel_matvec_dense(kernel, blur, x, y, v):
    K = kernel(x, y, blur=blur)
    return torch.einsum("...nm,...m->...n", K, v)


def kernel_loss(
    a,
    x,
    b,
    y,
    blur=0.05,
    kernel=None,
    name=None,
    potentials=False,
    use_streaming=False,
    impl="auto",
    **kwargs,
):
    """The MMD loss shared by the tensorized and online routes."""
    if kernel is not None or not use_streaming:
        if kernel is None:
            kernel = kernel_routines[name]
        matvec = partial(_kernel_matvec_dense, kernel, blur)
    else:
        matvec = partial(_kernel_matvec_streaming, name, blur, impl=impl)

    with profiling.span("mmd.applies"):
        # Self-interaction terms with detached partners and doubled gradients:
        a_x = matvec(double_grad(x), x.detach(), a.detach())  # (B, N)
        b_y = matvec(double_grad(y), y.detach(), b.detach())  # (B, M)
        # Cross term, differentiable in everything:
        b_x = matvec(x, y, b)  # (B, N)
        a_y = matvec(y, x, a) if potentials else None  # (B, M): K_yx a = (K_xy)^T a by symmetry

    if potentials:
        return a_x - b_x, b_y - a_y

    batch = x.ndim > 2
    return (
        0.5 * scal(double_grad(a), a_x, batch=batch)
        + 0.5 * scal(double_grad(b), b_y, batch=batch)
        - scal(a, b_x, batch=batch)
    )


kernel_tensorized = partial(kernel_loss, use_streaming=False)
kernel_online = partial(kernel_loss, use_streaming=True)


def _kernel_matvec_sparse_custom(kernel, blur, x, y, v, cols, counts, block):
    """``K @ v`` of a user ``kernel(x, y, blur=...)`` over the kept tile
    pairs of a geometry mask, with no kernel: the kept column tiles of a
    chunk of row tiles are gathered, ``kernel((c, block, D), (c, cap *
    block, D), blur=blur) -> (c, block, cap * block)`` is evaluated on
    them, and the slots past each row's count are masked out. Each chunk
    holds at most :data:`CUSTOM_CHUNK_ELEMS` kernel values and is
    recomputed in the backward pass (activation checkpointing), so
    autograd keeps no kernel block per kept slot."""
    N, D = x.shape
    nI, cap = cols.shape
    xt = x.reshape(nI, block, D)
    yt = y.reshape(-1, block, D)
    vt = v.reshape(-1, block)
    cols = cols.long()
    chunk = max(1, CUSTOM_CHUNK_ELEMS // (block * cap * block))
    slot = torch.arange(cap, device=cols.device)

    def tiles(xi, ci, ni):
        c = xi.shape[0]
        K = kernel(xi, yt[ci].reshape(c, cap * block, D), blur=blur)
        live = (slot[None, :] < ni[:, None]).repeat_interleave(block, dim=1)
        vg = torch.where(live, vt[ci].reshape(c, cap * block), 0.0)
        return torch.einsum("cnm,cm->cn", K, vg)

    outs = []
    for i0 in range(0, nI, chunk):
        args = (xt[i0 : i0 + chunk], cols[i0 : i0 + chunk], counts[i0 : i0 + chunk])
        if torch.is_grad_enabled():
            outs.append(checkpoint(tiles, *args, use_reentrant=False))
        else:
            outs.append(tiles(*args))
    return torch.cat(outs).reshape(N)


def kernel_multiscale(
    a,
    x,
    b,
    y,
    blur=0.05,
    kernel=None,
    name=None,
    truncate=5,
    diameter=None,
    cluster_scale=None,
    potentials=False,
    verbose=False,
    kernel_radius=None,
    impl="auto",
    **kwargs,
):
    """Block-sparse truncated MMD loss on unbatched clouds.

    Points are spatially sorted into tiles of :func:`auto_tile` points, and
    only the tile pairs whose smallest possible distance is below the
    kernel's support radius (``truncate * blur``, or ``kernel_radius=``)
    are visited. Falls back to the exact streaming evaluation for the
    energy kernel, ``truncate=None``, batched input or a non-callable
    ``kernel``. ``impl="blocked"`` runs the plain twins of the kernels.
    """

    def streaming_fallback():
        batched = x.ndim > 2
        a_, x_, b_, y_ = (a, x, b, y) if batched else (a[None], x[None], b[None], y[None])
        out = kernel_loss(
            a_, x_, b_, y_, blur=blur, kernel=kernel, name=name,
            potentials=potentials, use_streaming=True, impl=impl, **kwargs,
        )
        if not batched:
            if potentials:
                return out[0][0], out[1][0]
            return out[0] if out.ndim else out
        return out

    if truncate is None or name == "energy" or x.ndim > 2 or (kernel is not None and not callable(kernel)):
        return streaming_fallback()

    N, D = x.shape
    M = y.shape[0]
    if kernel is None:
        p, _ = _streaming_params[name]
        eps = blur**p
    # User kernels share the geometry-only keep rule; the default support
    # radius is the named kernels' (truncate blur units).
    radius = kernel_radius if kernel_radius is not None else truncate * blur

    # Padding is zero-weight copies of the last point: no extent needed.
    tile = auto_tile(max(N, M))
    (_, a_s), (_, x_s), perm_x = spatial_sort_blocks(a, x, None, None, tile, tile)
    (_, b_s), (_, y_s), perm_y = spatial_sort_blocks(b, y, None, None, tile, tile)

    x_sd, y_sd = x_s.detach(), y_s.detach()
    aw, bw = a_s.detach(), b_s.detach()
    mask_xy = masks_from_geometry(x_sd, y_sd, radius, tile, w_x=aw, w_y=bw)
    mask_xx = masks_from_geometry(x_sd, x_sd, radius, tile, w_x=aw, w_y=aw, sym=True)
    mask_yy = masks_from_geometry(y_sd, y_sd, radius, tile, w_x=bw, w_y=bw, sym=True)

    if verbose:
        print(
            f"{mask_xy.cols.shape[0]} tiles, keeping on average "
            f"{float(mask_xy.counts.float().mean()):.1f} neighbours (radius {radius:.3f})."
        )

    if kernel is None:

        def mv(xx, yy, vv, mask):
            return kernel_matvec_sparse(xx, yy, vv, eps, mask, p=p, block=tile, impl=impl)

    else:

        def mv(xx, yy, vv, mask):
            return _kernel_matvec_sparse_custom(kernel, blur, xx, yy, vv, mask.cols, mask.counts, tile)

    with profiling.span("mmd.applies"):
        a_x = mv(double_grad(x_s), x_sd, aw, mask_xx)
        b_y = mv(double_grad(y_s), y_sd, bw, mask_yy)
        b_x = mv(x_s, y_s, b_s, mask_xy)
        a_y = mv(y_s, x_s, a_s, mask_xy.transpose()) if potentials else None

    if potentials:
        return _desort(a_x - b_x, perm_x, N), _desort(b_y - a_y, perm_y, M)

    return 0.5 * scal(double_grad(a_s), a_x) + 0.5 * scal(double_grad(b_s), b_y) - scal(a_s, b_x)

r"""Multiscale Sinkhorn with the truncated fine phase cut into row shards.

Counterpart of :mod:`geomloss_tpu.parallel.multiscale_sharded`, on
``torch.distributed``. Every rank runs the cheap phases on the whole clouds
(the sort, the coarse and mid phases, the extrapolation onto the fine
clouds and the truncation tables: :func:`..models.multiscale.
multiscale_prologue`, the single-device solve's own code), then takes
``nI / R`` of the fine clouds' row tiles:

1. each fine step is one pass of kernel 5 over the rank's rows of the kept
   tile pairs against the whole opposite cloud, which gives the row
   softmin of its rows and partial column sums over every column; a
   ``reduce_scatter`` of those hands each rank its slice of the column
   direction. The rank first gathers the opposite potentials
   (``all_gather``);
2. a debias (symmetric) problem reads the rank's rows of the *triangle*
   table, at the global row offset ``rank * nI / R`` (kernels 5 and 6 test
   ``cols >= row_offset + I`` and the diagonal ``J == row_offset + I``):
   the union of the ranks' rows is the whole triangle, and the
   reduce-scattered column sums carry its mirrored half, so the ranks
   visit exactly the single-device solve's pairs;
3. the last extrapolation is differentiable through
   :class:`ExtrapBandedXyShard` and :class:`ExtrapBandedSymShard`, whose
   backward runs kernel 6 on the rank's rows and reduce-scatters the
   column contraction, in the ones-channel form of
   ``ops/block_sparse.py::_dx``, ``u (x R_0 - R_1:) / r``.

With one rank every collective is the identity and the solve runs the
single-device solve's operations in its order: the floats are the same.
"""

import torch

from ..models.multiscale import _desort, _iterate, fine_tables, multiscale_prologue
from ..ops.block_sparse import _absorbed_sums, _dx, _forward_sums, _gibbs_apply, _ones
from ..ops.cuda_kernels import _absorbed_update
from ..solvers.annealing import dampening
from ..solvers.sinkhorn_loop import sinkhorn_cost
from ._collectives import all_gather, gather_rows, psum_scalar, reduce_scatter, shard_rows
from .ring import points_mesh

__all__ = ["sinkhorn_multiscale_sharded"]


def _step_xy_shard(eps, x_l, y_f, a_log_l, b_log_l, b_log_f, f_l, g_l, g_f, cols, cnt, p, tile, impl, mesh):
    """One absorbed step of the xy problem on this rank's rows: the row
    softmin of its rows and its slice of the column softmin, from one pass
    of kernel 5 against the whole ``y_f`` and one reduce-scatter."""
    phi = a_log_l + f_l / eps
    psi = b_log_f + g_f / eps
    r, c_part = _absorbed_sums(x_l, y_f, phi, psi, eps, cols, cnt, p, tile, False, impl)
    c = reduce_scatter(c_part, mesh)
    return _absorbed_update(f_l, a_log_l, eps, r), _absorbed_update(g_l, b_log_l, eps, c)


def _step_sym_shard(eps, x_l, x_f, a_log_l, a_log_f, f_l, f_f, cols, cnt, p, tile, impl, mesh):
    """Symmetric absorbed step on this rank's rows of a triangle table: the
    row sums over its kept ``J >= row_offset + I`` tiles, plus its slice of
    every rank's mirrored column sums."""
    phi_l = a_log_l + f_l / eps
    phi_f = a_log_f + f_f / eps
    off = mesh.rank * cols.shape[0]
    r, c_part = _absorbed_sums(x_l, x_f, phi_l, phi_f, eps, cols, cnt, p, tile, True, impl, off)
    return _absorbed_update(f_l, a_log_l, eps, r + reduce_scatter(c_part, mesh))


class ExtrapBandedXyShard(torch.autograd.Function):
    """Sharded twin of ``ops/block_sparse.py::softmin_extrapolation_walk_banded``:
    the forward is :func:`_step_xy_shard`; the backward runs kernel 6 on
    the rank's rows against the whole ``y_f`` and reduce-scatters the
    column contraction, so both gradients (to the rank's slices ``x_l``
    and ``y_l``) come from one pass. ``y_f``, ``g_f`` and ``b_log_f`` are
    the detached whole-cloud operands."""

    @staticmethod
    def forward(ctx, x_l, y_l, y_f, f_l, g_l, g_f, a_log_l, b_log_l, b_log_f, eps, cols, cnt, p, tile, impl, mesh):
        S_xy, S_yx = _step_xy_shard(eps, x_l, y_f, a_log_l, b_log_l, b_log_f, f_l, g_l, g_f, cols, cnt, p, tile,
                                    impl, mesh)
        ctx.save_for_backward(x_l, y_l, y_f, f_l, g_l, g_f, a_log_l, b_log_l, b_log_f, cols, cnt, S_xy, S_yx)
        ctx.eps, ctx.p, ctx.tile, ctx.impl, ctx.mesh = eps, p, tile, impl, mesh
        return S_xy, S_yx

    @staticmethod
    def backward(ctx, u_f, u_g):
        x_l, y_l, y_f, f_l, g_l, g_f, a_log_l, b_log_l, b_log_f, cols, cnt, S_xy, S_yx = ctx.saved_tensors
        eps, p = ctx.eps, ctx.p
        kind = "gibbs" if p == 2 else "gibbs_grad"
        Rr, Rc_part = _gibbs_apply(
            x_l, y_f, a_log_l + f_l / eps, b_log_f + g_f / eps, _ones(y_f), _ones(x_l), eps, cols, cnt, p, kind,
            ctx.tile, False, ctx.impl,
        )
        Rc = reduce_scatter(Rc_part, ctx.mesh)
        dx = _dx(x_l, Rr, _forward_sums(f_l, a_log_l, eps, S_xy), u_f).to(x_l.dtype)
        dy = _dx(y_l, Rc, _forward_sums(g_l, b_log_l, eps, S_yx), u_g).to(y_l.dtype)
        return (dx, dy) + (None,) * 14


class ExtrapBandedSymShard(torch.autograd.Function):
    """Sharded twin of ``softmin_extrapolation_walk_banded_sym`` on this
    rank's rows of a triangle table: the forward is :func:`_step_sym_shard`,
    the backward kernel 6 with the mirrored column contraction
    reduce-scattered."""

    @staticmethod
    def forward(ctx, x_l, x_f, f_l, f_f, a_log_l, a_log_f, eps, cols, cnt, p, tile, impl, mesh):
        S = _step_sym_shard(eps, x_l, x_f, a_log_l, a_log_f, f_l, f_f, cols, cnt, p, tile, impl, mesh)
        ctx.save_for_backward(x_l, x_f, f_l, f_f, a_log_l, a_log_f, cols, cnt, S)
        ctx.eps, ctx.p, ctx.tile, ctx.impl, ctx.mesh = eps, p, tile, impl, mesh
        return S

    @staticmethod
    def backward(ctx, u):
        x_l, x_f, f_l, f_f, a_log_l, a_log_f, cols, cnt, S = ctx.saved_tensors
        eps, p, mesh = ctx.eps, ctx.p, ctx.mesh
        kind = "gibbs" if p == 2 else "gibbs_grad"
        Rr, Rc_part = _gibbs_apply(
            x_l, x_f, a_log_l + f_l / eps, a_log_f + f_f / eps, _ones(x_f), _ones(x_l), eps, cols, cnt, p, kind,
            ctx.tile, True, ctx.impl, mesh.rank * cols.shape[0],
        )
        # This rank's upper-triangle rows plus every rank's mirrored columns:
        R = Rr + reduce_scatter(Rc_part, mesh)
        dx = _dx(x_l, R, _forward_sums(f_l, a_log_l, eps, S), u).to(x_l.dtype)
        return (dx,) + (None,) * 12


def sinkhorn_multiscale_sharded(
    a,
    x,
    b,
    y,
    mesh=None,
    axis="points",
    p=2,
    blur=0.05,
    reach=None,
    diameter=None,
    scaling=0.5,
    truncate=5,
    cluster_scale=None,
    debias=True,
    potentials=False,
    labels_x=None,
    labels_y=None,
    tile="auto",
    block_size="auto",
    target_clusters=2000,
    cap=None,
    impl="auto",
    verbose=False,
):
    """Debiased multiscale Sinkhorn divergence with the truncated fine phase
    cut into row shards over a group of ranks.

    Same arguments and semantics as
    :func:`geomloss_tpu_torch.models.multiscale.sinkhorn_multiscale`, plus
    ``mesh`` as :func:`geomloss_tpu_torch.parallel.sinkhorn_ring` (``axis``
    is accepted for the JAX package's signature). Every rank passes the
    full clouds, of any sizes: they are padded to ``tile * R * 2^k`` points,
    so that each rank takes a whole number of row tiles. Differentiable in
    ``x`` and ``y`` (and the weights), with the envelope gradient.

    Returns the scalar divergence on every rank, or with
    ``potentials=True`` the ``(N,)`` and ``(M,)`` potentials, in the user's
    order, on every rank. A schedule that ends at the coarse-to-fine jump
    has no fine phase to shard: every rank then computes the whole
    (replicated) tail, with no collective.
    """
    if truncate is None:
        raise NotImplementedError(
            "The sharded fine phase is built on the truncated tile tables; truncate=None (exact fine sweeps) "
            "is only available on the single-device multiscale backend or via sinkhorn_ring."
        )
    if mesh is None:
        mesh = points_mesh()
    if x.device != mesh.device or y.device != mesh.device:
        raise ValueError(f"the clouds lie on {x.device} and {y.device}, the mesh's rank on {mesh.device}.")
    pro = multiscale_prologue(
        a, x, b, y, p, blur, reach, diameter, scaling, truncate, None, cluster_scale, debias, labels_x, labels_y,
        verbose, impl, block_size, cap, target_clusters, tile, shards=mesh.size,
    )
    eps, rho, a_s, b_s = pro.eps, pro.rho, pro.a_s, pro.b_s
    if pro.last_is_jump:
        f_ba, g_ab, f_aa, g_bb = pro.fine
        f_ba, g_ab = torch.where(a_s > 0, f_ba, 0.0), torch.where(b_s > 0, g_ab, 0.0)
        if debias:
            f_aa, g_bb = torch.where(a_s > 0, f_aa, 0.0), torch.where(b_s > 0, g_bb, 0.0)
        out = sinkhorn_cost(eps, rho, a_s, b_s, f_aa, g_bb, g_ab, f_ba, debias=debias, potentials=potentials)
        if potentials:
            return _desort(out[0], pro.perm_x, x.shape[0]), _desort(out[1], pro.perm_y, y.shape[0])
        return out

    tile = pro.tile
    sh = lambda t: shard_rows(t, mesh)  # noqa: E731
    x_s, y_s = pro.x_s, pro.y_s
    x_f, y_f = x_s.detach(), y_s.detach()
    x_l, y_l, a_l, b_l = sh(x_s), sh(y_s), sh(a_s), sh(b_s)
    x_ld, y_ld = x_l.detach(), y_l.detach()
    al_f, bl_f = pro.a_log_f, pro.b_log_f
    al_l, bl_l = sh(al_f), sh(bl_f)
    mask_xy, mask_xx, mask_yy = pro.masks
    table = fine_tables(mask_xy, pro.eps_m, pro.eps_fine, truncate)

    def rows(mask, e):
        """This rank's row tiles of a table at ``e``."""
        cols, cnt = table(mask, e)
        return sh(cols), sh(cnt)

    def step(e, f_l, g_l, faa_l, gbb_l):
        S_xy, S_yx = _step_xy_shard(e, x_ld, y_f, al_l, bl_l, bl_f, f_l, g_l, all_gather(g_l, mesh),
                                    *rows(mask_xy, e), p, tile, impl, mesh)
        if not debias:
            return S_xy, S_yx, None, None
        S_xx = _step_sym_shard(e, x_ld, x_f, al_l, al_f, faa_l, all_gather(faa_l, mesh), *rows(mask_xx, e), p,
                               tile, impl, mesh)
        S_yy = _step_sym_shard(e, y_ld, y_f, bl_l, bl_f, gbb_l, all_gather(gbb_l, mesh), *rows(mask_yy, e), p,
                               tile, impl, mesh)
        return S_xy, S_yx, S_xx, S_yy

    with torch.no_grad():
        fine = tuple(sh(v) for v in pro.fine)
        f_l, g_l, faa_l, gbb_l = _iterate(step, fine, pro.eps_fine, rho, debias)

    # --- Differentiable last extrapolation (tables at the last temperature) --
    eps_last, e = pro.eps_list[-1], pro.eps_fine[-1]
    damp = dampening(eps_last, rho)
    S_xy, S_yx = ExtrapBandedXyShard.apply(
        x_l, y_l, y_f, f_l, g_l, all_gather(g_l, mesh), al_l, bl_l, bl_f, eps_last, *rows(mask_xy, e), p, tile,
        impl, mesh,
    )
    f_ba, g_ab = damp * S_xy, damp * S_yx
    f_aa = g_bb = None
    if debias:
        f_aa = damp * ExtrapBandedSymShard.apply(
            x_l, x_f, faa_l, all_gather(faa_l, mesh), al_l, al_f, eps_last, *rows(mask_xx, e), p, tile, impl, mesh
        )
        g_bb = damp * ExtrapBandedSymShard.apply(
            y_l, y_f, gbb_l, all_gather(gbb_l, mesh), bl_l, bl_f, eps_last, *rows(mask_yy, e), p, tile, impl, mesh
        )

    # Zero-mass (padding) slots carry huge clamped potentials, which the
    # unbalanced cost's exp(-f/rho) overflows (0 * inf = NaN):
    f_ba, g_ab = torch.where(a_l > 0, f_ba, 0.0), torch.where(b_l > 0, g_ab, 0.0)
    if debias:
        f_aa, g_bb = torch.where(a_l > 0, f_aa, 0.0), torch.where(b_l > 0, g_bb, 0.0)
    out = sinkhorn_cost(eps, rho, a_l, b_l, f_aa, g_bb, g_ab, f_ba, debias=debias, potentials=potentials)
    if potentials:
        F, G = (gather_rows(v, mesh) for v in out)
        return _desort(F, pro.perm_x, x.shape[0]), _desort(G, pro.perm_y, y.shape[0])
    return psum_scalar(out, mesh)

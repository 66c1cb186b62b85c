r"""Multiscale (coarse-to-fine) Sinkhorn with block-sparse kernel truncation.

Counterpart of :mod:`geomloss_tpu.models.multiscale`:

1. points are spatially sorted (Hilbert keys, or a KD split below 4096
   points) and grouped into fixed-size blocks, padded with zero-weight
   copies of the last point;
2. the coarse measure is the per-block weighted centroid with summed
   weights; the coarse epsilon-descent runs on it (the online softmin)
   until ``eps < cluster_scale**p``, the jump rule of the reference;
3. the jump extrapolates the potentials onto the fine cloud;
4. kernel truncation: the coarse potentials give per-tile keep scores
   (``masks_from_coarse``, less the cluster blocks' seam radii,
   ``block_radii``), and the remaining fine iterations and the
   differentiable last extrapolation visit only the kept tile pairs
   (``ops/block_sparse.py``, two CUDA kernels). ``truncate=None`` runs an
   exact fine phase through the online kernels instead;
5. above ``N_FINE_OK`` points (with truncation), a pooled intermediate
   scale delays fine entry by ``mid_delay`` annealing steps
   (``run_mid_phase``): the jump is rebased onto the mid cloud, the four
   extrapolations onto the fine cloud are truncated (kernel 7,
   ``softmin_extrap_truncated``), and the fine tables are built from the
   extrapolated fine potentials (``build_tile_masks``);
6. a custom ``cost`` callable runs the coarse phase through the streaming
   custom-cost softmin, keeps tiles by the cost between centroids, and
   runs its fine phase through a gather-based truncated LSE with no kernel
   (``lse_sparse_custom``); it never takes the mid phase.

Gradient semantics match the reference: everything up to the final
extrapolation runs under ``torch.no_grad()`` (envelope theorem).
"""

import math
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..ops.block_sparse import (
    build_tile_masks,
    lse_sparse_custom,
    masks_from_coarse,
    retighten_counts,
    softmin_extrap_truncated,
    sinkhorn_step_walk_banded,
    sinkhorn_step_walk_banded_sym,
    softmin_extrapolation_walk_banded,
    softmin_extrapolation_walk_banded_sym,
)
from ..ops.softmin import (
    sinkhorn_step_points,
    softmin_extrapolation,
    softmin_extrapolation_sym,
    softmin_points,
)
from ..ops.spatial import hilbert_key
from ..solvers.annealing import dampening, scaling_parameters
from ..solvers.sinkhorn_loop import log_weights, sinkhorn_cost
from ..utils import profiling

__all__ = [
    "sinkhorn_multiscale",
    "multiscale_prologue",
    "spatial_sort_blocks",
    "default_cluster_scale",
    "jump_index",
]

#: Kernel tile size of the block-sparse fine phase. Padded cloud sizes are
#: multiples of this, and the cluster block size divides it.
TILE = 512

#: Largest point count the classic two-scale descent serves with
#: truncation; beyond it fine entry is delayed through a pooled
#: intermediate scale (``mid_delay``). Read at call time, so that tests can
#: lower it.
N_FINE_OK = 1 << 20

#: Source-tile side of the truncated coarse/mid -> fine extrapolations
#: (``softmin_extrap_truncated``): small tiles track the keep radius on the
#: source cloud, whose extent per tile is much larger than a fine tile's.
EXTRAP_BM = 128

#: Test hook: force the mid phase's pooling factor (``None``: from
#: ``block_size``, ``scaling`` and ``n_delay``).
_B_MID_OVERRIDE = None


def mid_cap(n_pad, tile):
    """Floor of the width of the mid path's fine tables: the kept tiles per
    row scale with the column tiles, so ``nJ / 16`` between 96 and 224.
    A table whose rows keep more grows to their largest count
    (``build_tile_masks``), where the JAX package's keep their best-scored
    ``mid_cap``: on data along curves half the rows or more keep more (the
    gallery's fiber bundles, ``tests/test_torch_table_widths.py``)."""
    nJ = n_pad // tile
    return min(224, max(96, nJ // 16))


def default_cluster_scale(diameter, D):
    """The reference's default coarse resolution: ~2000 clusters."""
    return diameter / (math.sqrt(D) * 2000 ** (1 / D))


def jump_index(eps_list, cluster_scale, p):
    """Index of the coarse-to-fine jump iteration: the first step (past the
    two warm-up iterations) whose temperature resolves the cluster scale,
    else the last iteration."""
    jump = len(eps_list) - 1
    for i, e in enumerate(eps_list[2:]):
        if cluster_scale**p > e:
            jump = i + 1
            break
    return jump


def kd_sort_perm(x, leaf_size):
    """Balanced KD ordering: recursively split (widest axis, median) until
    segments reach ``leaf_size``. Input length must be ``leaf_size * 2^k``."""
    N, D = x.shape
    levels = 0
    while leaf_size << (levels + 1) <= N:
        levels += 1
    if leaf_size << levels != N:
        raise ValueError("kd_sort_perm: the length must be leaf_size * 2^k")
    idx = torch.arange(N, device=x.device)
    seg = 1
    for _ in range(levels):
        seg_len = N // seg
        xs = x[idx].reshape(seg, seg_len, D)
        ax = (xs.amax(dim=1) - xs.amin(dim=1)).argmax(dim=-1)  # widest axis
        vals = xs.gather(2, ax[:, None, None].expand(seg, seg_len, 1))[..., 0]
        order = torch.argsort(vals, dim=1, stable=True)
        idx = idx.reshape(seg, seg_len).gather(1, order).reshape(-1)
        seg *= 2
    return idx


@profiling.spanned("multiscale.sort")
def spatial_sort_blocks(a, x, cluster_scale, diameter, block_size, pad_multiple=TILE, labels=None):
    """Sort a measure spatially and group it into fixed-size blocks.

    Returns ``(w_coarse, a_sorted), (centroids, x_sorted), perm`` where the
    sorted arrays are padded to ``pad_multiple * 2^k`` with zero-weight
    copies of the last point (kept in the data range: out-of-range
    sentinels would give float32 exponents that cancel into NaN) and
    ``perm`` maps each sorted slot to its original index (pad slots point
    past N).

    With integer ``labels`` (user-supplied clusters), points are ordered
    by (label, Hilbert index), so that blocks respect label boundaries up
    to block granularity.
    """
    N, D = x.shape
    x_d = x.detach()
    Npad = pad_multiple
    while Npad < N:
        Npad *= 2
    if Npad != N:
        pad = x_d[-1:].expand(Npad - N, D)
        x_full, x_full_d = torch.cat([x, pad]), torch.cat([x_d, pad])
        a_full = torch.cat([a, a.new_zeros(Npad - N)])
    else:
        x_full, x_full_d, a_full = x, x_d, a

    # ~16 points per Hilbert cell: cells stay far smaller than a block.
    bits = max(4, min(10, math.ceil(math.log2(max(Npad, 2) / 16) / D)))
    # The order is computed in float64, so that a float32 cloud and its
    # float64 copy are cut into the same blocks and tiles.
    x_key = x_full_d.double()
    if labels is not None:
        # Hilbert order within each label (two stable sorts):
        lab = torch.cat([labels.reshape(-1).long(), labels.new_zeros(Npad - N).long()])
        perm1 = torch.argsort(hilbert_key(x_key, bits=bits), stable=True)
        order = perm1[torch.argsort(lab[perm1], stable=True)]
    elif Npad > (1 << 12):
        order = torch.argsort(hilbert_key(x_key, bits=bits), stable=True)
    else:
        order = kd_sort_perm(x_key, min(block_size, pad_multiple))
    a_s = a_full[order]
    x_s = x_full[order]

    K = Npad // block_size
    ab = a_s.detach().reshape(K, block_size)
    xb = x_s.detach().reshape(K, block_size, D)
    w = ab.sum(-1)
    cent = (ab[..., None] * xb).sum(1) / torch.clamp(w, min=1e-30)[:, None]
    return (w, a_s), (cent, x_s), order


def auto_tile(n_max):
    """Kernel-tile side for an ``n_max``-point problem: 512 up to 2^19
    points, 1024 beyond (2048 past 2^23), as in the JAX package."""
    npad = 1 << max(int(np.ceil(np.log2(max(n_max, 2)))), 0)
    if npad <= (1 << 19):
        return TILE
    tile = 1024
    while npad // tile > 8192:
        tile *= 2
    return tile


def fine_cap_schedule(eps_fine, eps_j, cap0):
    """Group consecutive fine temperatures sharing a table width ``ck``:
    ``cap0 * eps / eps_jump`` rounded up to a multiple of 8, at least 24.

    Returns:
        List of ``(ck, [eps, ...])`` groups in descent order.
    """

    def cap_for(e):
        raw = int(np.ceil(cap0 * (e / eps_j)))
        return min(cap0, max(24, -(-raw // 8) * 8))

    groups = []
    for e in eps_fine:
        ck = cap_for(e)
        if groups and groups[-1][0] == ck:
            groups[-1][1].append(e)
        else:
            groups.append((ck, [e]))
    return groups


def fine_warmup(cluster_scale, p, eps_target):
    """Extra fine iterations at the entry temperature when the target blur
    resolves far below the cluster scale (``eps_target = blur**p``)."""
    return 2 if cluster_scale**p > 50 * eps_target else 0


def mid_delay(n_max, eps_list, jump, scaling, p):
    """Number of post-jump annealing steps the JAX package spends on a
    pooled intermediate scale (0 = classic two-scale descent)."""
    if n_max <= N_FINE_OK:
        return 0
    sp = float(scaling) ** p
    n_delay = int(np.ceil(np.log(n_max / N_FINE_OK) / np.log(1.0 / sp)))
    return min(n_delay, len(eps_list) - 1 - jump)


def _iterate(step, carry, eps_seg, rho, debias):
    """Symmetric averaged updates over ``eps_seg``: ``step(eps, f_ba, g_ab,
    f_aa, g_bb)`` returns the four raw softmins (the last two ``None``
    without debiasing). A ``solver.eps_loop`` span, one ``solver.eps_step``
    a temperature."""
    f_ba, g_ab, f_aa, g_bb = carry
    with profiling.span("solver.eps_loop"):
        for eps in eps_seg:
            with profiling.span("solver.eps_step"):
                damp = dampening(eps, rho)
                S_xy, S_yx, S_xx, S_yy = step(eps, f_ba, g_ab, f_aa, g_bb)
                f_ba = 0.5 * (f_ba + damp * S_xy)
                g_ab = 0.5 * (g_ab + damp * S_yx)
                if debias:
                    f_aa = 0.5 * (f_aa + damp * S_xx)
                    g_bb = 0.5 * (g_bb + damp * S_yy)
    return f_ba, g_ab, f_aa, g_bb


def _dense_step(sm, x, y, a_log, b_log, debias):
    """The four softmin sweeps of one iteration on a whole (coarse or mid)
    cloud, for :func:`_iterate`."""

    def step(e, f_ba, g_ab, f_aa, g_bb):
        S_xx = sm(e, (x, x), a_log + f_aa / e) if debias else None
        S_yy = sm(e, (y, y), b_log + g_bb / e) if debias else None
        return sm(e, (x, y), b_log + g_ab / e), sm(e, (y, x), a_log + f_ba / e), S_xx, S_yy

    return step


def _extrapolate(ext, eps, damp, x_e, y_e, src_x, src_y, a_log, b_log, carry, debias):
    """The four extrapolations of a potential carry from a source cloud
    ``(src_x, src_y)`` onto the points ``(x_e, y_e)``; the cross updates
    use the previous iterates in parallel. ``ext(rows, src, h)`` is the
    softmin."""
    f_ba, g_ab, f_aa, g_bb = carry
    f_new = damp * ext(x_e, src_y, b_log + g_ab / eps)
    g_new = damp * ext(y_e, src_x, a_log + f_ba / eps)
    if not debias:
        return f_new, g_new, torch.zeros_like(f_new), torch.zeros_like(g_new)
    return f_new, g_new, damp * ext(x_e, src_x, a_log + f_aa / eps), damp * ext(y_e, src_y, b_log + g_bb / eps)


@profiling.spanned("multiscale.mid")
def run_mid_phase(sm, carry, x_c, y_c, a_log_c, b_log_c, a_s, b_s, x_sd, y_sd, eps_list, jump, n_delay,
                  rho, debias, block_size, scaling, verbose=False):
    """Pooled intermediate scale between the coarse and fine scales
    (detached): the first ``n_delay`` post-jump temperatures run as dense
    sweeps on a cloud of pooled mid blocks of ``b_mid`` sorted points.

    Returns the potential carry on the mid cloud and the mid cloud
    ``(x_m, y_m, a_log_m, b_log_m)`` that replaces the coarse state for the
    fine extrapolation.
    """
    D = x_sd.shape[1]
    eps_j = eps_list[jump]
    # Pooled blocks whose extent tracks the entry temperature:
    # b_mid <= block_size * scaling^(2 n_delay).
    b_mid = 1 << max(0, int(np.floor(np.log2(block_size * float(scaling) ** (2 * n_delay)))))
    if _B_MID_OVERRIDE is not None:
        b_mid = _B_MID_OVERRIDE

    def pool_mid(w, pts):
        wb = w.reshape(-1, b_mid)
        pb = pts.reshape(-1, b_mid, D)
        wsum = wb.sum(1)
        cent = (pb * wb[..., None]).sum(1) / torch.clamp(wsum, min=1e-30)[:, None]
        # Zero-mass (padding) blocks: park at the plain mean.
        return wsum, torch.where(wsum[:, None] > 0, cent, pb.mean(1))

    aw_m, x_m = pool_mid(a_s.detach(), x_sd)
    bw_m, y_m = pool_mid(b_s.detach(), y_sd)
    a_log_m, b_log_m = log_weights(aw_m), log_weights(bw_m)
    if verbose:
        print(
            f"Intermediate scale: {x_m.shape[0]}x{y_m.shape[0]} pooled blocks of {b_mid} "
            f"for {n_delay} iteration(s) after the jump."
        )
    carry = _extrapolate(
        lambda rows, src, h: sm(eps_j, (rows, src), h), eps_j, dampening(eps_j, rho),
        x_m, y_m, x_c, y_c, a_log_c, b_log_c, carry, debias,
    )
    carry = _iterate(
        _dense_step(sm, x_m, y_m, a_log_m, b_log_m, debias), carry,
        eps_list[jump + 1 : jump + n_delay + 1], rho, debias,
    )
    return carry, x_m, y_m, a_log_m, b_log_m


class Prologue(NamedTuple):
    """What :func:`multiscale_prologue` hands the fine phase: the sorted
    padded clouds and their user order, the schedule, the coarse (or mid)
    state at the jump, the four potentials extrapolated onto the fine
    clouds and, for the truncated fine phase, its tables."""

    a_s: torch.Tensor
    x_s: torch.Tensor
    perm_x: torch.Tensor
    b_s: torch.Tensor
    y_s: torch.Tensor
    perm_y: torch.Tensor
    a_log_f: torch.Tensor
    b_log_f: torch.Tensor
    eps: float
    rho: object
    eps_list: list
    #: The fine temperatures, warm-up included (empty on a last-iteration jump).
    eps_fine: list
    last_is_jump: bool
    tile: int
    block_size: int
    sm: object
    #: The coarse state at the jump: centroids, weights, potential carry and
    #: temperature (the custom-cost fine phase builds its tables from it).
    x_c: torch.Tensor
    y_c: torch.Tensor
    aw_c: torch.Tensor
    bw_c: torch.Tensor
    coarse: tuple
    eps_j: float
    #: ``(f_ba, g_ab, f_aa, g_bb)`` on the fine clouds, differentiable on a
    #: last-iteration jump.
    fine: tuple
    #: ``(mask_xy, mask_xx, mask_yy)`` of the truncated fine phase (built-in
    #: costs only), else ``None``, and the temperature they were built at.
    masks: object
    eps_m: float


@profiling.spanned("multiscale.prologue")
def multiscale_prologue(a, x, b, y, p, blur, reach, diameter, scaling, truncate, cost, cluster_scale, debias,
                        labels_x, labels_y, verbose, impl, block_size, cap, target_clusters, tile, shards=1):
    """Everything of :func:`sinkhorn_multiscale` before the fine iterations:
    the spatial sort (padded to ``tile * shards * 2^k`` points), the coarse
    phase, the mid phase, the extrapolation onto the fine clouds and the
    truncation tables. The row-sharded solve
    (:mod:`geomloss_tpu_torch.parallel.multiscale_sharded`) runs the same
    function on every rank, with ``shards`` its ranks so that each takes a
    whole number of row tiles. Arguments as :func:`sinkhorn_multiscale`."""
    N, D = x.shape
    M = y.shape[0]

    diameter, eps, eps_list, rho = scaling_parameters(x, y, p, blur, reach, diameter, scaling)
    if cluster_scale is None:
        cluster_scale = default_cluster_scale(diameter, D)
    jump = jump_index(eps_list, cluster_scale, p)
    last_is_jump = jump == len(eps_list) - 1
    n_delay = 0
    if truncate is not None and not last_is_jump and cost is None:
        n_delay = mid_delay(max(N, M), eps_list, jump, scaling, p)

    if tile == "auto":
        tile = auto_tile(max(N, M))
    if block_size == "auto":
        # Largest power-of-two divisor of the tile that keeps >=
        # target_clusters coarse blocks:
        block_size = 1
        while block_size * 2 <= tile and max(N, M) // (block_size * 2) >= target_clusters:
            block_size *= 2

    (aw_c, a_s), (x_c, x_s), perm_x = spatial_sort_blocks(
        a, x, cluster_scale, diameter, block_size, pad_multiple=tile * shards, labels=labels_x
    )
    (bw_c, b_s), (y_c, y_s), perm_y = spatial_sort_blocks(
        b, y, cluster_scale, diameter, block_size, pad_multiple=tile * shards, labels=labels_y
    )

    if verbose:
        print(f"{x_c.shape[0]}x{y_c.shape[0]} cluster blocks, computed at scale = {cluster_scale:2.3f}")
        print("Successive scales : ", ", ".join(f"{e ** (1 / p):.3f}" for e in eps_list))
        print(f"Jump from coarse to fine after iteration {jump}.")

    a_log_c, b_log_c = log_weights(aw_c), log_weights(bw_c)
    a_log_f, b_log_f = log_weights(a_s.detach()), log_weights(b_s.detach())
    sm = partial(softmin_points, p=p, impl=impl, cost=cost)
    x_sd, y_sd = x_s.detach(), y_s.detach()

    with torch.no_grad():
        # --- Coarse phase -------------------------------------------------------
        with profiling.span("multiscale.coarse"):
            eps0 = eps_list[0]
            damp0 = dampening(eps0, rho)
            g_ab = damp0 * sm(eps0, (y_c, x_c), a_log_c)
            f_ba = damp0 * sm(eps0, (x_c, y_c), b_log_c)
            if debias:
                f_aa = damp0 * sm(eps0, (x_c, x_c), a_log_c)
                g_bb = damp0 * sm(eps0, (y_c, y_c), b_log_c)
            else:
                f_aa, g_bb = torch.zeros_like(f_ba), torch.zeros_like(g_ab)
            coarse = _iterate(
                _dense_step(sm, x_c, y_c, a_log_c, b_log_c, debias), (f_ba, g_ab, f_aa, g_bb),
                eps_list[: jump + 1], rho, debias,
            )

        # --- Intermediate scale -------------------------------------------------
        src_x, src_y, src_la, src_lb = x_c, y_c, a_log_c, b_log_c
        if n_delay > 0:
            coarse, src_x, src_y, src_la, src_lb = run_mid_phase(
                sm, coarse, x_c, y_c, a_log_c, b_log_c, a_s, b_s, x_sd, y_sd, eps_list, jump,
                n_delay, rho, debias, block_size, scaling, verbose,
            )
            # Rebase the jump onto the mid scale: the fine extrapolation
            # and the tables below read the mid-level state.
            jump += n_delay
            last_is_jump = jump == len(eps_list) - 1
    eps_j = eps_list[jump]
    damp_j = dampening(eps_j, rho)

    # --- Extrapolation to the fine cloud ----------------------------------------
    # On a last-iteration jump, gradients flow through the fine points. On
    # the mid path the four detached sweeps visit only the source tiles
    # within the LSE keep margin of each fine row tile (kernel 7).
    x_e = x_s if last_is_jump else x_sd
    y_e = y_s if last_is_jump else y_sd

    def extrap(rows, src, h):
        ns = src.shape[0]
        if (truncate is not None and not last_is_jump and n_delay > 0
                and ns % EXTRAP_BM == 0 and ns // EXTRAP_BM >= 64):
            return softmin_extrap_truncated(
                rows, src, h, eps_j, truncate, tile, p=p, block_m=EXTRAP_BM, cap=None, impl=impl
            )
        return sm(eps_j, (rows, src), h)

    with torch.set_grad_enabled(last_is_jump and torch.is_grad_enabled()), profiling.span("multiscale.extrapolate"):
        fine = _extrapolate(
            extrap, eps_j, damp_j, x_e, y_e, src_x, src_y, src_la, src_lb, coarse, debias
        )

    masks, eps_m = None, eps_j
    eps_fine = []
    if not last_is_jump:
        eps_fine = list(eps_list[jump + 1 :])
        # Tiny blurs resolve far below the cluster scale: extra iterations
        # at the entry temperature wash out the coarse warm-start bias.
        eps_fine = [eps_fine[0]] * fine_warmup(cluster_scale, p, eps) + eps_fine
        if cost is None and truncate is not None:
            with torch.no_grad():
                if n_delay > 0:
                    # Tables from the extrapolated fine potentials, built
                    # at the first fine temperature (they serve only the
                    # fine iterations).
                    eps_m = eps_list[jump + 1]
                    masks = _mid_tables(
                        x_sd, y_sd, a_s.detach(), b_s.detach(), fine, eps_m, p, truncate, tile, cap, debias, verbose,
                        eps_min=min(eps_fine),
                    )
                else:
                    # The cluster blocks' radii (seams), from the sorted
                    # clouds' points of positive weight:
                    masks = _coarse_tables(
                        x_c, y_c, aw_c, bw_c, coarse, eps_j, p, truncate, tile // block_size, cap, debias,
                        radii=(block_radii(a_s.detach(), x_sd, x_c, block_size),
                               block_radii(b_s.detach(), y_sd, y_c, block_size)),
                        eps_min=min(eps_fine),
                    )
    return Prologue(
        a_s, x_s, perm_x, b_s, y_s, perm_y, a_log_f, b_log_f, eps, rho, eps_list, eps_fine, last_is_jump, tile,
        block_size, sm, x_c, y_c, aw_c, bw_c, coarse, eps_j, fine, masks, eps_m,
    )


def sinkhorn_multiscale(
    a,
    x,
    b,
    y,
    p=2,
    blur=0.05,
    reach=None,
    diameter=None,
    scaling=0.5,
    truncate=5,
    cost=None,
    cluster_scale=None,
    debias=True,
    potentials=False,
    labels_x=None,
    labels_y=None,
    verbose=False,
    impl="auto",
    block_size="auto",
    cap=None,
    target_clusters=2000,
    tile="auto",
    **kwargs,
):
    """Two-scale Sinkhorn divergence on unbatched clouds ``x (N,D)``, ``y (M,D)``.

    ``truncate`` controls the block-sparse pruning margin (reference
    default 5); ``truncate=None`` disables pruning (exact fine phase).
    ``cap`` bounds the number of visited column tiles per row tile
    (default: as many as the row keeps, and at least an eighth of the
    column tiles, between 32 and 128; on the mid path, :func:`mid_cap`).
    ``cost``: a callable ``(B, N, D), (B, M, D) -> (B, N, M)`` replacing
    the built-in ``|x-y|^p / p``.
    ``impl`` selects the streaming implementation of the coarse phase and
    the exact fine phase (:mod:`..ops.softmin`), and, as ``"blocked"``, the
    plain twins of the block-sparse kernels.
    """
    pro = multiscale_prologue(
        a, x, b, y, p, blur, reach, diameter, scaling, truncate, cost, cluster_scale, debias, labels_x,
        labels_y, verbose, impl, block_size, cap, target_clusters, tile,
    )
    fine, last_is_jump, eps_fine = pro.fine, pro.last_is_jump, pro.eps_fine
    x_s, y_s, a_s, b_s, a_log_f, b_log_f = pro.x_s, pro.y_s, pro.a_s, pro.b_s, pro.a_log_f, pro.b_log_f
    eps, rho, eps_list = pro.eps, pro.rho, pro.eps_list

    if not last_is_jump:
        if cost is not None:
            fine_step, fused_extrap = _custom_fine_phase(
                pro.x_c, pro.y_c, pro.aw_c, pro.bw_c, pro.coarse, x_s, y_s, a_log_f, b_log_f, pro.eps_j, p,
                truncate, pro.tile, pro.block_size, cap, debias, cost, pro.sm,
            )
        elif truncate is not None:
            fine_step, fused_extrap = _truncated_fine_phase(
                pro.masks, pro.eps_m, x_s, y_s, a_log_f, b_log_f, eps_fine, p, truncate, pro.tile, debias, impl,
            )
        else:
            fine_step, fused_extrap = _exact_fine_phase(
                x_s, y_s, a_log_f, b_log_f, p, debias, impl
            )

        # --- Fine iterations (detached) -----------------------------------------
        with torch.no_grad():
            fine = _iterate(fine_step, fine, eps_fine, rho, debias)

        # --- Differentiable last extrapolation ----------------------------------
        eps_last = eps_list[-1]
        damp = dampening(eps_last, rho)
        with profiling.span("solver.last_extrapolation"):
            S_xy, S_yx, S_xx, S_yy = fused_extrap(eps_last, *fine)
        fine = (damp * S_xy, damp * S_yx) + ((damp * S_xx, damp * S_yy) if debias else fine[2:])

    # Zero-mass (padding) slots can carry huge potentials (the -1e5
    # log-weight clamp scaled by eps): harmless in the balanced dot
    # products, but the unbalanced cost's exp(-f/rho) overflows and
    # inf * 0 = NaN. Zero them out: their weight is exactly 0.
    f_ba_f, g_ab_f, f_aa_f, g_bb_f = fine
    f_ba_f = torch.where(a_s > 0, f_ba_f, 0.0)
    g_ab_f = torch.where(b_s > 0, g_ab_f, 0.0)
    if debias:
        f_aa_f = torch.where(a_s > 0, f_aa_f, 0.0)
        g_bb_f = torch.where(b_s > 0, g_bb_f, 0.0)

    out = sinkhorn_cost(
        eps, rho, a_s, b_s, f_aa_f, g_bb_f, g_ab_f, f_ba_f,
        batch=False, debias=debias, potentials=potentials,
    )
    if potentials:
        # De-sort back to the user's point order; pad slots map past N.
        F_x, G_y = out
        return _desort(F_x, pro.perm_x, x.shape[0]), _desort(G_y, pro.perm_y, y.shape[0])
    return out


def _desort(v, perm, n):
    keep = perm < n
    out = v.new_zeros(n)
    out[perm[keep]] = v[keep]
    return out


def block_radii(w, pts, cent, block):
    """Radii of the coarse cluster blocks: per block of ``block``
    consecutive sorted points, the largest distance of a point of positive
    weight ``w`` to the block's centroid ``cent`` (0 for a block of
    padding alone)."""
    d = torch.linalg.vector_norm(pts.reshape(cent.shape[0], block, -1) - cent[:, None, :], dim=-1)
    return torch.where(w.reshape(-1, block) > 0, d, 0.0).amax(dim=1)


@profiling.spanned("multiscale.tables")
def _coarse_tables(x_c, y_c, aw_c, bw_c, coarse, eps_j, p, truncate, bpt, cap, debias, cost=None, radii=None,
                   eps_min=None):
    """Tables of the classic path: the reference's pointwise keep rule on
    the coarse potentials and centroids at jump time
    (``kernel_truncation``), pooled to kernel tiles, less each cluster
    block's radius beyond the slack at ``eps_min`` (:func:`masks_from_coarse`;
    ``radii = (r_x, r_y)`` from :func:`block_radii`, ``eps_min`` the last
    fine temperature, so that the retightened counts serve every fine
    temperature). With no ``radii``, the JAX package's centroid rule: the
    custom-cost fine phase takes it, since a user cost gives no bound in
    the distance. Returns ``(mask_xy, mask_xx, mask_yy)``, the last two
    ``None`` without debiasing."""
    f_ba, g_ab, f_aa, g_bb = coarse
    r_x, r_y = (None, None) if radii is None else radii
    kw = dict(cap=cap, cost=cost, eps_min=eps_min)
    mask_xy = masks_from_coarse(x_c, y_c, f_ba, g_ab, aw_c, bw_c, eps_j, p, truncate, bpt, r_x=r_x, r_y=r_y, **kw)
    if not debias:
        return mask_xy, None, None
    return (
        mask_xy,
        masks_from_coarse(x_c, x_c, f_aa, f_aa, aw_c, aw_c, eps_j, p, truncate, bpt, sym=True, r_x=r_x, r_y=r_x, **kw),
        masks_from_coarse(y_c, y_c, g_bb, g_bb, bw_c, bw_c, eps_j, p, truncate, bpt, sym=True, r_x=r_y, r_y=r_y, **kw),
    )


@profiling.spanned("multiscale.tables")
def _mid_tables(x_sd, y_sd, a_w, b_w, fine, eps_b, p, truncate, tile, cap_m, debias, verbose, eps_min=None):
    """Tables of the mid path: the keep rule on tile-pooled fine potentials
    (:func:`build_tile_masks`) at the first fine temperature ``eps_b``, its
    slack set by ``eps_min``, the last fine temperature, at most ``cap_m``
    wide, or with ``cap_m=None`` :func:`mid_cap` wide and wider where a row
    keeps more. Under ``verbose``, prints how many rows fill the table
    (with ``cap_m``, their overflow degrades to best-score top-k)."""
    f_ba, g_ab, f_aa, g_bb = fine
    kw = dict(cap=cap_m, floor=mid_cap(x_sd.shape[0], tile), eps_min=eps_min)
    mask_xy = build_tile_masks(x_sd, y_sd, f_ba, g_ab, eps_b, p, truncate, tile, w_x=a_w, w_y=b_w, **kw)
    mask_xx = mask_yy = None
    if debias:
        mask_xx = build_tile_masks(x_sd, x_sd, f_aa, f_aa, eps_b, p, truncate, tile, w_x=a_w, w_y=a_w, sym=True, **kw)
        mask_yy = build_tile_masks(y_sd, y_sd, g_bb, g_bb, eps_b, p, truncate, tile, w_x=b_w, w_y=b_w, sym=True, **kw)
    if verbose:
        ov = int((mask_xy.vals[:, -1] > 0).sum())
        print(
            f"Fine tables: width {mask_xy.cols.shape[1]}, kept tiles/row mean "
            f"{float(mask_xy.counts.float().mean()):.1f} / max {int(mask_xy.counts.max())}; {ov} of "
            f"{mask_xy.counts.shape[0]} rows at the width"
            + (" (top-k clipping active)." if ov and cap_m is not None else ".")
        )
    return mask_xy, mask_xx, mask_yy


def fine_tables(mask_xy, eps_m, eps_fine, truncate):
    """``table(mask, e)``: the first ``ck`` columns of a table built at
    ``eps_m`` and its counts re-thresholded at the fine temperature ``e``.

    ``ck`` is the width :func:`fine_cap_schedule` gives ``e``, widened (in
    multiples of 8, up to the table's width) to the largest re-thresholded
    count of the table's rows, so that the slice drops no kept tile. The
    schedule assumes that the kept tiles shrink at least linearly in eps,
    which holds on surfaces and volumes, not on data along curves: on
    fiber bundles it clipped 977 of 1,024 row tiles at 1e6 points, and
    the potentials it gave made the label votes NaN
    (``examples_torch/transfer_labels_tractograms.py``). Where no row
    exceeds the schedule's width, the tables are the JAX package's. One
    host read per table (counted as ``host.reads``) gives every
    temperature's largest count; ``table`` runs in a ``multiscale.tables``
    span.
    """
    ck_of = {e: ck for ck, es in fine_cap_schedule(eps_fine, eps_m, mask_xy.cols.shape[1]) for e in es}
    widths = {}

    def width(mask, e):
        if id(mask) not in widths:
            need = torch.stack([retighten_counts(mask.vals, truncate * (f - eps_m)).max() for f in ck_of]).tolist()
            profiling.count("host.reads")
            full = mask.cols.shape[1]
            # (the mask is kept beside its widths, so that its id stays its own)
            widths[id(mask)] = mask, {f: min(full, max(ck_of[f], -(-n // 8) * 8)) for f, n in zip(ck_of, need)}
        return widths[id(mask)][1][e]

    @profiling.spanned("multiscale.tables")
    def table(mask, e):
        ck = width(mask, e)
        cnt = torch.clamp(retighten_counts(mask.vals, truncate * (e - eps_m)), max=ck)
        return mask.cols[:, :ck].contiguous(), cnt

    return table


def _truncated_fine_phase(masks, eps_m, x_s, y_s, a_log_f, b_log_f, eps_fine, p, truncate, tile, debias, impl):
    """Kernel truncation over the tables ``masks = (mask_xy, mask_xx,
    mask_yy)`` built at temperature ``eps_m``. Returns ``(step, extrap)``
    for the fine iterations and the differentiable last extrapolation.

    The keep-score order does not depend on the temperature (the score
    moves by a uniform ``truncate * (eps' - eps_m)``), so the same tables
    serve every fine iteration with re-thresholded counts, sliced to a
    per-temperature width ``ck`` (``fine_cap_schedule``).
    """
    mask_xy, mask_xx, mask_yy = masks
    x_sd, y_sd = x_s.detach(), y_s.detach()
    table = fine_tables(mask_xy, eps_m, eps_fine, truncate)

    def step(e, f_ba, g_ab, f_aa, g_bb):
        S_xy, S_yx = sinkhorn_step_walk_banded(
            e, x_sd, y_sd, a_log_f, b_log_f, f_ba, g_ab, *table(mask_xy, e), p, tile, impl
        )
        if not debias:
            return S_xy, S_yx, None, None
        S_xx = sinkhorn_step_walk_banded_sym(e, x_sd, a_log_f, f_aa, *table(mask_xx, e), p, tile, impl)
        S_yy = sinkhorn_step_walk_banded_sym(e, y_sd, b_log_f, g_bb, *table(mask_yy, e), p, tile, impl)
        return S_xy, S_yx, S_xx, S_yy

    def extrap(e_last, f_ba, g_ab, f_aa, g_bb):
        # Tables at the last fine temperature, as in the JAX package.
        e = eps_fine[-1]
        S_xy, S_yx = softmin_extrapolation_walk_banded(
            x_s, y_s, f_ba, g_ab, a_log_f, b_log_f, e_last, *table(mask_xy, e), p, tile, impl
        )
        if not debias:
            return S_xy, S_yx, None, None
        S_xx = softmin_extrapolation_walk_banded_sym(
            x_s, f_aa, a_log_f, e_last, *table(mask_xx, e), p, tile, impl
        )
        S_yy = softmin_extrapolation_walk_banded_sym(
            y_s, g_bb, b_log_f, e_last, *table(mask_yy, e), p, tile, impl
        )
        return S_xy, S_yx, S_xx, S_yy

    return step, extrap


def _custom_fine_phase(x_c, y_c, aw_c, bw_c, coarse, x_s, y_s, a_log_f, b_log_f, eps_j, p, truncate,
                       tile, block_size, cap, debias, cost, sm):
    """Fine phase of a custom cost (no kernel). With ``truncate``, the
    coarse tables (the user cost between centroids) drive a gather-based
    truncated LSE (:func:`lse_sparse_custom`) in each of the four
    directions, re-thresholded at each temperature; with
    ``truncate=None``, the streaming custom-cost softmin on whole clouds.
    The last extrapolation differentiates through the user cost by plain
    autograd, w.r.t. the row points only. Returns ``(step, extrap)``."""
    x_sd, y_sd = x_s.detach(), y_s.detach()
    if truncate is None:
        t_xy = t_yx = t_xx = t_yy = None

        def soft(e, rows, src, h, table):
            return sm(e, (rows, src), h)
    else:
        with torch.no_grad():
            mask_xy, mask_xx, mask_yy = _coarse_tables(
                x_c, y_c, aw_c, bw_c, coarse, eps_j, p, truncate, tile // block_size, cap, debias, cost
            )
        t_xy, t_yx = (mask_xy.cols, mask_xy.vals), (mask_xy.colsT, mask_xy.valsT)
        t_xx = (mask_xx.cols, mask_xx.vals) if debias else None
        t_yy = (mask_yy.cols, mask_yy.vals) if debias else None

        def soft(e, rows, src, h, table):
            cols, vals = table
            cnt = torch.clamp(retighten_counts(vals, truncate * (e - eps_j)), max=vals.shape[1])
            return -e * lse_sparse_custom(rows, src, h, e, cols, cnt, cost, tile)

    def sweeps(x_r, y_r):
        """The four softmins onto the rows ``x_r``, ``y_r`` (the sources
        stay detached)."""

        def run(e, f_ba, g_ab, f_aa, g_bb):
            S_xy = soft(e, x_r, y_sd, b_log_f + g_ab / e, t_xy)
            S_yx = soft(e, y_r, x_sd, a_log_f + f_ba / e, t_yx)
            if not debias:
                return S_xy, S_yx, None, None
            return (S_xy, S_yx, soft(e, x_r, x_sd, a_log_f + f_aa / e, t_xx),
                    soft(e, y_r, y_sd, b_log_f + g_bb / e, t_yy))

        return run

    return sweeps(x_sd, y_sd), sweeps(x_s, y_s)


def _exact_fine_phase(x_s, y_s, a_log_f, b_log_f, p, debias, impl):
    """``truncate=None``: the fine phase through the online kernels."""
    x_sd, y_sd = x_s.detach(), y_s.detach()

    def step(e, f_ba, g_ab, f_aa, g_bb):
        S_xy, S_yx = sinkhorn_step_points(e, x_sd, y_sd, a_log_f, b_log_f, f_ba, g_ab, p=p, impl=impl)
        if not debias:
            return S_xy, S_yx, None, None
        S_xx = sinkhorn_step_points(e, x_sd, x_sd, a_log_f, a_log_f, f_aa, f_aa, p=p, impl=impl, sym=True)[0]
        S_yy = sinkhorn_step_points(e, y_sd, y_sd, b_log_f, b_log_f, g_bb, g_bb, p=p, impl=impl, sym=True)[0]
        return S_xy, S_yx, S_xx, S_yy

    def extrap(e, f_ba, g_ab, f_aa, g_bb):
        S_xy, S_yx = softmin_extrapolation(x_s, y_s, f_ba, g_ab, a_log_f, b_log_f, e, p, impl)
        if not debias:
            return S_xy, S_yx, None, None
        S_xx = softmin_extrapolation_sym(x_s, f_aa, a_log_f, e, p, impl)
        S_yy = softmin_extrapolation_sym(y_s, g_bb, b_log_f, e, p, impl)
        return S_xy, S_yx, S_xx, S_yy

    return step, extrap

r"""Hand-written Hopper kernels of the multiscale fine phase, and their twins.

Three CUDA kernels (``csrc/block_sparse_kernels.cu``) replace three walk
kernels of :mod:`geomloss_tpu.ops.block_sparse`:

==========================  ==============================================
wrapper                     TPU kernel it replaces
==========================  ==============================================
:func:`absorbed_sum_tiles`  ``_absorbed_sum_walk_banded`` /
                            ``_pair_walk_banded_kernel``
:func:`gibbs_apply_tiles`   ``gibbs_apply_walk_banded`` /
                            ``_apply_walk_banded_kernel``
:func:`lse_tiles`           ``lse_walk`` / ``_lse_walk_kernel``
==========================  ==============================================

:func:`lse_tiles` is a one-direction LSE over the kept source tiles of a
``(cols, cnt)`` table with row tiles of ``block_n`` and source tiles of
``block_m`` points (the mid path's extrapolations onto the fine cloud).
The other two visit the kept tile pairs of a truncation table given as CSR lists:
row tile ``I`` (``tile`` consecutive sorted points) visits the column
tiles ``cols[I, k]`` for ``k < cnt[I]`` (the TPU's band-major packing,
``walk_plan_banded``, has no counterpart). With ``tri=True`` the problem
is symmetric and only the kept entries with ``cols[I, k] >= I`` are
visited: the column direction then supplies the mirrored lower triangle,
and a diagonal tile contributes to the row direction only.

Each wrapper takes its plain PyTorch twin (``*_blocked``, same signature, a
loop over row tiles in the input dtype) only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel, or raises. Results are raw
sums of the absorbed weights (no floor, no normalization): bitwise
reproducible, since every partial sum is written once and added up in a
fixed order.
"""

import torch

from . import cuda_kernels as ck
from .cuda_kernels import (
    LN2,
    LOG2E,
    _apply_weights_blk,
    _bias2,
    _cdiv,
    _check_cuda,
    _f32,
    _fold_norms,
    _log_weights_blk,
    _points,
)

__all__ = [
    "absorbed_sum_tiles",
    "absorbed_sum_tiles_blocked",
    "gibbs_apply_tiles",
    "gibbs_apply_tiles_blocked",
    "lse_tiles",
    "lse_tiles_blocked",
    "kept_pairs",
    "build",
    "launch_counts",
    "reset_launch_counts",
]

#: Point dimensions the block-sparse kernels are compiled for.
_KERNEL_DIMS = (1, 2, 3, 4, 8)
#: Rows per CUDA block.
_ROWS = 256

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
launch_counts = {"absorbed_sum_tiles": 0, "gibbs_apply_tiles": 0, "lse_tiles": 0}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


_P, _I, _F = ck._P, ck._I, ck._F
_LIB = ck.KernelLibrary(
    "block_sparse_kernels",
    {
        # x, y, phi, psi, slot_j, rowpart, colpart, nslots, ck, tile, D, p,
        # tri, c2, stream
        "gl_absorbed_sum_tiles": [_P] * 7 + [_I] * 6 + [_F, _P],
        # x, y, phi, psi, vyt, vx, slot_j, rowpart, colpart, M, nslots, ck,
        # tile, D, mode, tri, c2, stream
        "gl_gibbs_apply_tiles": [_P] * 9 + [_I] * 7 + [_F, _P],
        # x, y, h2, cols, cnt, out, n_rows, ck, block_n, block_m, D, p, c2,
        # stream
        "gl_lse_tiles": [_P] * 6 + [_I] * 6 + [_F, _P],
        # parts, order, offsets, out, nseg, L, nsub, stream
        "gl_segment_sum": [_P] * 4 + [_I] * 3 + [_P],
    },
    launch_counts,
)


def build():
    """Compile (once per source version) and load the block-sparse kernels."""
    return _LIB.build()


# ==============================================================================
#  Kept pairs
# ==============================================================================


def _check_table(name, x, y, cols, cnt, tile, tri):
    N, M = x.shape[0], y.shape[0]
    if N % tile or M % tile:
        raise ValueError(f"{name}: point counts ({N}, {M}) must be multiples of the tile ({tile}).")
    if cols.ndim != 2 or cols.shape[0] != N // tile or tuple(cnt.shape) != (N // tile,):
        raise ValueError(f"{name}: cols must be (N / tile, ck) and cnt (N / tile,).")
    if tri and N != M:
        raise ValueError(f"{name}: a triangle table needs a symmetric problem.")


def kept_pairs(cols, cnt, tri=False):
    """Column tile of each slot ``I * ck + k`` of a table, ``-1`` where the
    slot is dead: ``k >= cnt[I]``, or ``cols[I, k] < I`` with ``tri``.

    Returns an ``(nI * ck,)`` int32 tensor on the table's device.
    """
    nI, ck_ = cols.shape
    k = torch.arange(ck_, device=cols.device)
    live = k[None, :] < cnt.to(cols.device)[:, None]
    if tri:
        live &= cols >= torch.arange(nI, device=cols.device)[:, None]
    return torch.where(live, cols, -1).to(torch.int32).reshape(-1).contiguous()


def _column_index(slot_j, ck_, nJ, tri):
    """Slots grouped by column tile, in slot order: ``(order, offsets)``.

    Column tile ``J`` sums the partials of ``order[offsets[J]:offsets[J+1]]``;
    dead slots and (``tri``) diagonal slots are left out.
    """
    key = slot_j.long()
    rows = torch.arange(key.shape[0], device=key.device) // ck_
    out = key < 0
    if tri:
        out |= key == rows
    key = torch.where(out, nJ, key)
    key, order = torch.sort(key, stable=True)
    # Segment starts by binary search: no device-to-host sync.
    offsets = torch.searchsorted(key, torch.arange(nJ + 1, device=key.device))
    return order.to(torch.int32).contiguous(), offsets.to(torch.int32).contiguous()


def _segment_sum(parts, index, nJ, L, nsub):
    """``(nJ, L)`` column sums of ``parts`` (``(nslots, nsub, L)`` float32)
    through ``index = _column_index(...)``."""
    order, offsets = index
    out = torch.empty((nJ, L), dtype=torch.float32, device=parts.device)
    _LIB.launch(
        "segment_sum", parts.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), nJ, L, nsub,
    )
    return out


# ==============================================================================
#  Plain twins: a loop over row tiles, in the input dtype
# ==============================================================================


def _row_tiles(cols, cnt, tri):
    """``(I, J)`` for each row tile with kept tiles: ``J`` the kept column
    tiles (a long tensor on the CPU, in table order)."""
    slot_j = kept_pairs(cols.cpu(), cnt.cpu(), tri).view(cols.shape).long()
    for I in range(cols.shape[0]):
        J = slot_j[I][slot_j[I] >= 0]
        if J.numel():
            yield I, J


def absorbed_sum_tiles_blocked(x, y, phi, psi, eps, cols, cnt, p=2, tile=512, tri=False):
    """Plain twin of :func:`absorbed_sum_tiles`."""
    _check_table("absorbed_sum_tiles", x, y, cols, cnt, tile, tri)
    dt = ck._acc(x, y, phi, psi)
    x, y = x.to(dt), y.to(dt)
    phi = _fold_norms(x, phi.to(dt), eps, p)
    psi = _fold_norms(y, psi.to(dt), eps, p)
    r = torch.zeros_like(phi).view(-1, tile)
    c = torch.zeros_like(psi).view(-1, tile)
    for I, J in _row_tiles(cols, cnt, tri):
        rows = slice(I * tile, (I + 1) * tile)
        idx = (J.to(x.device)[:, None] * tile + torch.arange(tile, device=x.device)).view(-1)
        W = torch.exp(_log_weights_blk(x[rows], phi[rows], y[idx], psi[idx], eps, p))
        r[I] += W.sum(1)
        cs = W.sum(0).view(-1, tile)
        if tri:
            cs = torch.where((J == I).to(x.device)[:, None], 0.0, cs)
        # Distinct column tiles within a row tile: a plain indexed update.
        c[J.to(x.device)] += cs
    return r.view(-1).to(phi.dtype), c.view(-1).to(psi.dtype)


def gibbs_apply_tiles_blocked(
    x, y, phi, psi, Vy, Vx, eps, cols, cnt, p=2, kind="gibbs", tile=512, tri=False
):
    """Plain twin of :func:`gibbs_apply_tiles`."""
    _check_table("gibbs_apply_tiles", x, y, cols, cnt, tile, tri)
    _check_kind(kind)
    dt = ck._acc(x, y, phi, psi, Vy, Vx)
    x, y, phi, psi, Vy, Vx = (t.to(dt) for t in (x, y, phi, psi, Vy, Vx))
    if p == 2:
        phi, psi = _fold_norms(x, phi, eps, 2), _fold_norms(y, psi, eps, 2)
    C = Vy.shape[1]
    Rr = torch.zeros((x.shape[0] // tile, tile, C), dtype=dt, device=x.device)
    Rc = torch.zeros((y.shape[0] // tile, tile, C), dtype=dt, device=x.device)
    for I, J in _row_tiles(cols, cnt, tri):
        rows = slice(I * tile, (I + 1) * tile)
        idx = (J.to(x.device)[:, None] * tile + torch.arange(tile, device=x.device)).view(-1)
        w = _apply_weights_blk(x[rows], phi[rows], y[idx], psi[idx], eps, p, kind)
        Rr[I] += w @ Vy[idx]
        cs = (w.T @ Vx[rows]).view(-1, tile, C)
        if tri:
            cs = torch.where((J == I).to(x.device)[:, None, None], 0.0, cs)
        Rc[J.to(x.device)] += cs
    return Rr.view(-1, C).to(Vy.dtype), Rc.view(-1, C).to(Vx.dtype)


def _check_lse_table(x, y, h, cols, cnt, block_n, block_m):
    N, M = x.shape[0], y.shape[0]
    if block_n < 1 or block_m < 1 or N % block_n or M % block_m:
        raise ValueError(
            f"lse_tiles: point counts ({N}, {M}) must be multiples of the tiles ({block_n}, {block_m})."
        )
    if cols.ndim != 2 or cols.shape[0] != N // block_n or tuple(cnt.shape) != (N // block_n,):
        raise ValueError("lse_tiles: cols must be (N / block_n, ck) and cnt (N / block_n,).")
    if tuple(h.shape) != (M,):
        raise ValueError("lse_tiles: h must be (M,).")


def lse_tiles_blocked(x, y, h, eps, cols, cnt, block_n, block_m, p=2):
    """Plain twin of :func:`lse_tiles`: a loop over row tiles, each a
    ``logsumexp`` over its gathered kept source tiles, in the input dtype."""
    _check_lse_table(x, y, h, cols, cnt, block_n, block_m)
    dt = ck._acc(x, y, h)
    x, y = x.to(dt), y.to(dt)
    h = _fold_norms(y, h.to(dt), eps, p)
    out = torch.empty(x.shape[0], dtype=dt, device=x.device)
    zero = torch.zeros(block_n, dtype=dt, device=x.device)
    cols_c, cnt_c = cols.cpu().long(), torch.clamp(cnt.cpu().long(), max=cols.shape[1])
    lanes = torch.arange(block_m, device=x.device)
    for I in range(cols.shape[0]):
        rows = slice(I * block_n, (I + 1) * block_n)
        J = cols_c[I, : cnt_c[I]].to(x.device)
        idx = (J[:, None] * block_m + lanes).view(-1)
        arg = _log_weights_blk(x[rows], zero, y[idx], h[idx], eps, p)
        out[rows] = torch.logsumexp(arg, dim=1)
    # p=2: the row term -|x|^2/(2 eps) comes out of the LSE.
    return _fold_norms(x, out, eps, p)


def _check_kind(kind):
    if kind not in ("gibbs", "gibbs_grad"):
        raise ValueError(f"Unknown gibbs_apply_tiles kind: {kind!r}")


# ==============================================================================
#  Kernel wrappers
# ==============================================================================


def _tables(name, x, y, cols, cnt, tile, tri):
    """Checks, and the launch geometry: ``(slot_j, ck, nI, nJ, nsub)``."""
    _check_table(name, x, y, cols, cnt, tile, tri)
    if tile % 128:
        raise NotImplementedError(f"{name}: the tile must be a multiple of 128 (got {tile}).")
    _check_cuda(name, x, y, cols, cnt)
    nI, ck_ = cols.shape
    return kept_pairs(cols, cnt, tri), ck_, nI, y.shape[0] // tile, _cdiv(tile, _ROWS)


def absorbed_sum_tiles(x, y, phi, psi, eps, cols, cnt, p=2, tile=512, tri=False):
    """Absorbed row and column sums over the kept tile pairs of a table:

    ``r_i = sum_{j kept for i} W_ij``, ``c_j = sum_{i kept for j} W_ij``,
    ``W_ij = exp(phi_i + psi_j - C_p(x_i, y_j)/eps)``.

    Args: x ``(N, D)``, y ``(M, D)`` sorted and padded to multiples of
    ``tile``; phi ``(N,)``, psi ``(M,)``; cols ``(N/tile, ck)`` and cnt
    ``(N/tile,)`` the kept-tile table; ``tri`` a triangle table of a
    symmetric problem (``y`` is ``x``; ``r + c`` is then the full sum).
    Returns ``(r, c)`` in phi's and psi's dtype.
    """
    if not x.is_cuda:
        return absorbed_sum_tiles_blocked(x, y, phi, psi, eps, cols, cnt, p, tile, tri)
    slot_j, ck_, nI, nJ, nsub = _tables("absorbed_sum_tiles", x, y, cols, cnt, tile, tri)
    _check_cuda("absorbed_sum_tiles", x, phi, psi)
    eps = float(eps)
    (xf, yf), Dk = _points("absorbed_sum_tiles", x, y, dims=_KERNEL_DIMS)
    phi2, psi2 = _bias2(xf, phi, eps, p), _bias2(yf, psi, eps, p)
    f32 = dict(dtype=torch.float32, device=x.device)
    nslots = nI * ck_
    rowpart = torch.empty((ck_, nI, tile), **f32)
    colpart = torch.empty((nslots, nsub, tile), **f32)
    with torch.cuda.device(x.device):
        _LIB.launch(
            "absorbed_sum_tiles", xf.data_ptr(), yf.data_ptr(), phi2.data_ptr(),
            psi2.data_ptr(), slot_j.data_ptr(), rowpart.data_ptr(), colpart.data_ptr(),
            nslots, ck_, tile, Dk, p, int(tri), LOG2E / eps, count="absorbed_sum_tiles",
        )
        r = rowpart.sum(0).view(-1)
        index = _column_index(slot_j, ck_, nJ, tri)
        c = _segment_sum(colpart, index, nJ, tile, nsub).view(-1)
    return r.to(phi.dtype), c.to(psi.dtype)


_APPLY_MODES = {("gibbs", 2): 0, ("gibbs_grad", 2): 0, ("gibbs", 1): 1, ("gibbs_grad", 1): 2}


def gibbs_apply_tiles(
    x, y, phi, psi, Vy, Vx, eps, cols, cnt, p=2, kind="gibbs", tile=512, tri=False
):
    """Both contractions of the raw absorbed weights over the kept pairs:

    ``R_row[i] = sum_{j kept for i} w_ij Vy[j]`` and
    ``R_col[j] = sum_{i kept for j} w_ij Vx[i]``, with
    ``w_ij = exp(phi_i + psi_j - C_p(x_i, y_j)/eps)`` (``kind='gibbs'``),
    divided by ``|x_i - y_j|`` for p=1 ``kind='gibbs_grad'`` (zero below
    a squared distance of 1e-6).

    Args: as :func:`absorbed_sum_tiles`, plus Vy ``(M, C)`` and Vx
    ``(N, C)``; channels go through the kernel in groups of four.
    Returns ``(R_row (N, C), R_col (M, C))`` in Vy's and Vx's dtype.
    """
    _check_kind(kind)
    if not x.is_cuda:
        return gibbs_apply_tiles_blocked(x, y, phi, psi, Vy, Vx, eps, cols, cnt, p, kind, tile, tri)
    slot_j, ck_, nI, nJ, nsub = _tables("gibbs_apply_tiles", x, y, cols, cnt, tile, tri)
    _check_cuda("gibbs_apply_tiles", x, phi, psi, Vy, Vx)
    C = Vy.shape[1]
    if Vx.shape != (x.shape[0], C) or Vy.shape[0] != y.shape[0]:
        raise ValueError("gibbs_apply_tiles: Vy must be (M, C) and Vx (N, C).")
    mode = _APPLY_MODES[(kind, p)]
    eps = float(eps)
    (xf, yf), Dk = _points("gibbs_apply_tiles", x, y, dims=_KERNEL_DIMS)
    p_bias = 2 if mode == 0 else 1
    phi2, psi2 = _bias2(xf, phi, eps, p_bias), _bias2(yf, psi, eps, p_bias)
    G = ck._CHANNELS
    Cp = _cdiv(C, G) * G
    Vyt = torch.nn.functional.pad(_f32(Vy).T, (0, 0, 0, Cp - C)).contiguous()
    Vxp = torch.nn.functional.pad(_f32(Vx), (0, Cp - C))
    f32 = dict(dtype=torch.float32, device=x.device)
    nslots = nI * ck_
    rowpart = torch.empty((ck_, nI, tile, G), **f32)
    colpart = torch.empty((nslots, nsub, G, tile), **f32)
    rows, cols_out = [], []
    with torch.cuda.device(x.device):
        index = _column_index(slot_j, ck_, nJ, tri)
        for c0 in range(0, Cp, G):
            vx = Vxp[:, c0 : c0 + G].contiguous()
            _LIB.launch(
                "gibbs_apply_tiles", xf.data_ptr(), yf.data_ptr(), phi2.data_ptr(),
                psi2.data_ptr(), Vyt[c0 : c0 + G].data_ptr(), vx.data_ptr(),
                slot_j.data_ptr(), rowpart.data_ptr(), colpart.data_ptr(), y.shape[0],
                nslots, ck_, tile, Dk, mode, int(tri), LOG2E / eps,
                count="gibbs_apply_tiles",
            )
            rows.append(rowpart.sum(0).view(-1, G))
            out = _segment_sum(colpart, index, nJ, G * tile, nsub)
            cols_out.append(out.view(nJ, G, tile).transpose(1, 2).reshape(-1, G))
    R_row = torch.cat(rows, dim=1)[:, :C]
    R_col = torch.cat(cols_out, dim=1)[:, :C]
    return R_row.to(Vy.dtype), R_col.to(Vx.dtype)


def lse_tiles(x, y, h, eps, cols, cnt, block_n, block_m, p=2):
    """Truncated LSE over the kept source tiles of each row tile:

    ``out_i = log sum_{j in kept tiles of I} exp(h_j - C_p(x_i, y_j)/eps)``
    for row ``i`` of row tile ``I``, the kept tiles being
    ``cols[I, k]``, ``k < cnt[I]`` (every count at least 1).

    Args: x ``(N, D)`` rows in tiles of ``block_n`` points, y ``(M, D)``
    sources in tiles of ``block_m`` points, h ``(M,)``; cols
    ``(N / block_n, ck)`` and cnt ``(N / block_n,)`` the table.
    Returns ``(N,)`` in x's dtype.
    """
    if not x.is_cuda:
        return lse_tiles_blocked(x, y, h, eps, cols, cnt, block_n, block_m, p)
    _check_lse_table(x, y, h, cols, cnt, block_n, block_m)
    _check_cuda("lse_tiles", x, y, h, cols, cnt)
    eps = float(eps)
    (xf, yf), Dk = _points("lse_tiles", x, y, dims=_KERNEL_DIMS)
    h2 = _bias2(yf, h, eps, p)
    cols_i = cols.to(torch.int32).contiguous()
    cnt_i = cnt.to(torch.int32).contiguous()
    out = torch.empty(xf.shape[0], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _LIB.launch(
            "lse_tiles", xf.data_ptr(), yf.data_ptr(), h2.data_ptr(), cols_i.data_ptr(),
            cnt_i.data_ptr(), out.data_ptr(), cols.shape[0], cols.shape[1], block_n, block_m,
            Dk, p, LOG2E / eps, count="lse_tiles",
        )
    out = out * LN2
    if p == 2:
        out = out - 0.5 * (xf * xf).sum(-1) / eps
    return out.to(x.dtype)

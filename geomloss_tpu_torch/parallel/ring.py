r"""Ring softmin: Sinkhorn and kernel (MMD) losses over a group of ranks.

Counterpart of :mod:`geomloss_tpu.parallel.ring`, on ``torch.distributed``.
The source points ``x`` (rows) and the target points ``y`` (columns) are cut
into one row shard per rank. At each of ``R`` steps every rank computes the
streaming LSE of its ``x`` shard against the ``y`` shard it holds (kernel 1
on the card), merges it into its accumulator with ``logaddexp`` and passes
the shard on to the next rank (:func:`._collectives.ppermute`). After ``R``
steps every rank holds the full softmin of its rows.

Send and receive carry no autograd, so the ring LSE and the ring matvec are
``torch.autograd.Function``\ s whose backward runs the ring again: each held
shard's vector-Jacobian product is the one of ``ops/softmin.py`` (kernel 4),
weighted by the *global* LSE of the forward pass, so no partial result is
saved and no LSE is computed again. The row gradient accumulates where the
rows live; the cotangents of the ``y`` and ``h`` shards travel with their
shard and arrive back at the rank that owns it. Every rank must run the
backward (every rank calls ``backward`` on the replicated loss).

Each entry point takes the full (replicated) inputs on every rank and
returns the replicated loss, whose backward gives every rank the whole
gradient (:func:`._collectives.psum_scalar`, :func:`._collectives.shard_rows`).
"""

import os
from functools import partial

import torch
import torch.distributed as dist

from ..models.kernel_samples import _streaming_params, double_grad
from ..ops.softmin import _lse_points_raw, gibbs_apply
from ..solvers.annealing import scaling_parameters
from ..solvers.sinkhorn_loop import log_weights, scal, sinkhorn_cost, sinkhorn_loop
from ._collectives import Mesh, gather_rows, ppermute, psum_scalar, shard_rows

__all__ = [
    "ring_lse",
    "ring_softmin",
    "ring_matvec",
    "sinkhorn_ring",
    "kernel_ring",
    "points_mesh",
]


def points_mesh(group=None, device=None, backend="nccl"):
    """The 1D mesh of the ranks of ``group`` (default: the default process
    group, which must be initialized).

    ``backend`` is the backend the caller's group was started with: NCCL
    for ranks on their own cards, ``"gloo"`` for CPU ranks or for ranks
    that share a card. ``device`` defaults to ``cuda:<local rank>``
    (``$LOCAL_RANK``, else the rank modulo the visible cards) for NCCL and
    to the CPU for gloo (``"cuda"`` is the current card). Raises where no
    group is initialized or where the group's backend is not ``backend``.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "points_mesh: no torch.distributed process group. Start one on every rank first, e.g. "
            "torch.distributed.init_process_group('nccl', init_method='tcp://localhost:<port>', "
            "world_size=R, rank=r) (or with store=torch.distributed.FileStore(path, R)), "
            "and pass backend='gloo' here for a gloo group."
        )
    got = dist.get_backend(group)
    if got != backend:
        raise ValueError(f"points_mesh: the process group runs {got!r}, not {backend!r}; pass backend={got!r}.")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % max(torch.cuda.device_count(), 1)))
            device = torch.device("cuda", local)
        else:
            device = torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, size, device)


def _pad_measure(w, pts, R):
    """Pad a weighted cloud to a multiple of the ring size with zero-weight
    copies of the last point (in-range coordinates: far-away sentinels
    would overflow the folded Gibbs exponents in float32)."""
    N = w.shape[0]
    Np = -(-N // R) * R
    if Np == N:
        return w, pts
    pad = Np - N
    w = torch.cat([w, w.new_zeros(pad)])
    pts = torch.cat([pts, pts[-1:].expand(pad, *pts.shape[1:])])
    return w, pts


def _ring(mesh, shard, visit, travel):
    """Visit every rank's shard once: at step ``s`` this rank holds the
    shard of rank ``rank - s`` (a tuple of tensors) and calls
    ``visit(shard)``, which returns the contributions of this rank's rows to
    the shard's cotangents (a tuple, added into ``travel``, or ``None``),
    then passes the shard and its ``travel`` on to the next rank. After
    ``R`` steps ``travel`` is back at the shard's owner and is returned:
    the cotangents of this rank's shard from every rank's rows. The shard
    makes ``R - 1`` moves, ``travel`` one more."""
    R = mesh.size
    for s in range(R):
        add = visit(shard)
        if travel is not None:
            travel = tuple(t + a for t, a in zip(travel, add))
        if s < R - 1:
            moved = ppermute(shard + (travel or ()), 1, mesh)
            shard, travel = moved[: len(shard)], (moved[len(shard) :] or None)
        elif travel is not None:
            travel = ppermute(travel, 1, mesh)
    return travel


class RingLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, h, eps, p, mesh, impl):
        acc = torch.full_like(x[:, 0], -torch.inf)

        def visit(shard):
            nonlocal acc
            acc = torch.logaddexp(acc, _lse_points_raw(x, shard[0], shard[1], eps, p, impl))

        _ring(mesh, (y, h), visit, None)
        ctx.save_for_backward(x, y, h, acc)
        ctx.eps, ctx.p, ctx.mesh, ctx.impl = eps, p, mesh, impl
        return acc

    @staticmethod
    def backward(ctx, u):
        # ops/softmin.py::_LsePoints.backward on each held shard, with the
        # global LSE: w_ij = exp(h_j - C_ij/eps - acc_i) over every column.
        x, y, h, acc = ctx.saved_tensors
        eps, p, mesh, impl = ctx.eps, ctx.p, ctx.mesh, ctx.impl
        need_x, need_y, need_h = ctx.needs_input_grad[:3]
        phi = -acc
        kind = "gibbs" if p == 2 else "gibbs_grad"
        ones = torch.ones_like(x[:, :1])
        Vx = u[:, None] * torch.cat([ones, x], dim=-1)
        R = None

        def visit(shard):
            nonlocal R
            y_s, h_s = shard
            if need_x:
                Vy = torch.cat([torch.ones_like(y_s[:, :1]), y_s], dim=-1)
                part = gibbs_apply(x, y_s, phi, h_s, Vy, eps, p, kind=kind, impl=impl)
                R = part if R is None else R + part
            if not (need_y or need_h):
                return None
            dy_s, dh_s = torch.zeros_like(y_s), torch.zeros_like(h_s)
            if need_y or (need_h and p == 2):
                Tq = gibbs_apply(y_s, x, h_s, phi, Vx, eps, p, kind=kind, impl=impl)
                if need_y:
                    dy_s = -(1.0 / eps) * (y_s * Tq[:, :1] - Tq[:, 1:])
                if need_h and p == 2:
                    dh_s = Tq[:, 0]
            if need_h and p == 1:
                dh_s = gibbs_apply(y_s, x, h_s, phi, u[:, None], eps, p, kind="gibbs", impl=impl)[:, 0]
            return dy_s, dh_s

        travel = (torch.zeros_like(y), torch.zeros_like(h)) if (need_y or need_h) else None
        travel = _ring(mesh, (y, h), visit, travel)
        dx = dy = dh = None
        if need_x:
            dx = (-(u / eps)[:, None] * (x * R[:, :1] - R[:, 1:])).to(x.dtype)
        if need_y:
            dy = travel[0].to(y.dtype)
        if need_h:
            dh = travel[1].to(h.dtype)
        return dx, dy, dh, None, None, None, None


def ring_lse(x_local, y_local, h_local, eps, p, mesh, impl="auto"):
    """Full-row LSE of this rank's ``x`` shard against every rank's ``(y,
    h)`` shard: ``log sum_j exp(h_j - C_p(x_i, y_j)/eps)`` over the *global*
    M axis, ``(n,)``. Shapes are the local shards: ``x_local (n, D)``,
    ``y_local (m, D)``, ``h_local (m,)``; every rank calls it together.
    Differentiable in all three (the backward runs the ring again)."""
    return RingLse.apply(x_local, y_local, h_local, eps, p, mesh, impl)


def ring_softmin(eps, C_xy, h, p=2, mesh=None, impl="auto"):
    """Sharded softmin: the ``softmin`` of ``sinkhorn_loop`` over row shards,
    ``C_xy = (x_local, y_local)``."""
    if mesh is None:
        mesh = points_mesh()
    x_local, y_local = C_xy
    return -eps * ring_lse(x_local, y_local, h, eps, p, mesh, impl)


class RingMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, v, eps, p, kind, mesh, impl):
        z_n = x.new_zeros(x.shape[0])
        acc = None

        def visit(shard):
            nonlocal acc
            y_s, v_s = shard
            z_m = y_s.new_zeros(y_s.shape[0])
            part = gibbs_apply(x, y_s, z_n, z_m, v_s[:, None], eps, p, kind=kind, impl=impl)[:, 0]
            acc = part if acc is None else acc + part

        _ring(mesh, (y, v), visit, None)
        ctx.save_for_backward(x, y, v)
        ctx.eps, ctx.p, ctx.kind, ctx.mesh, ctx.impl = eps, p, kind, mesh, impl
        return acc

    @staticmethod
    def backward(ctx, u):
        # ops/softmin.py::_GibbsMatvec.backward on each held shard: only the
        # applies whose gradients autograd asks for (the MMD self terms
        # detach y and v).
        x, y, v = ctx.saved_tensors
        eps, p, kind, mesh, impl = ctx.eps, ctx.p, ctx.kind, ctx.mesh, ctx.impl
        need_x, need_y, need_v = ctx.needs_input_grad[:3]
        z_n = x.new_zeros(x.shape[0])
        if kind == "gibbs":
            wk, pp, scale, dvk = ("gibbs" if p == 2 else "gibbs_grad"), p, 1.0 / eps, "gibbs"
        elif kind == "energy":
            wk, pp, scale, dvk = "inv_dist", 1, 1.0, "energy"
        else:
            raise NotImplementedError(kind)
        dv_from_T = kind == "gibbs" and p == 2
        Ux = u[:, None] * torch.cat([torch.ones_like(x[:, :1]), x], -1)
        R = None

        def visit(shard):
            nonlocal R
            y_s, v_s = shard
            z_m = y_s.new_zeros(y_s.shape[0])
            if need_x:
                Vy = v_s[:, None] * torch.cat([torch.ones_like(y_s[:, :1]), y_s], -1)
                part = gibbs_apply(x, y_s, z_n, z_m, Vy, eps, pp, kind=wk, impl=impl)
                R = part if R is None else R + part
            if not (need_y or need_v):
                return None
            dy_s, dv_s = torch.zeros_like(y_s), torch.zeros_like(v_s)
            if need_y or (need_v and dv_from_T):
                T = gibbs_apply(y_s, x, z_m, z_n, Ux, eps, pp, kind=wk, impl=impl)
                if need_y:
                    dy_s = -(v_s * scale)[:, None] * (y_s * T[:, :1] - T[:, 1:])
                if need_v and dv_from_T:
                    dv_s = T[:, 0]
            if need_v and not dv_from_T:
                dv_s = gibbs_apply(y_s, x, z_m, z_n, u[:, None], eps, pp, kind=dvk, impl=impl)[:, 0]
            return dy_s, dv_s

        travel = (torch.zeros_like(y), torch.zeros_like(v)) if (need_y or need_v) else None
        travel = _ring(mesh, (y, v), visit, travel)
        dx = dy = dv = None
        if need_x:
            dx = (-(u * scale)[:, None] * (x * R[:, :1] - R[:, 1:])).to(x.dtype)
        if need_y:
            dy = travel[0].to(y.dtype)
        if need_v:
            dv = travel[1].to(v.dtype)
        return dx, dy, dv, None, None, None, None, None


def ring_matvec(x_local, y_local, v_local, eps, p, kind, mesh, impl="auto"):
    """Kernel matvec ``sum_j k(x_i, y_j) v_j`` over every rank's ``(y, v)``
    shard (the matvec counterpart of :func:`ring_lse`, kernel 4 forward and
    backward); ``kind`` as ``ops/softmin.py::gibbs_matvec``."""
    return RingMatvec.apply(x_local, y_local, v_local, eps, p, kind, mesh, impl)


def _shards(mesh, a, x, b, y):
    """The clouds padded to multiples of the ring size and this rank's row
    shards of each."""
    if x.device != mesh.device or y.device != mesh.device:
        raise ValueError(f"the clouds lie on {x.device} and {y.device}, the mesh's rank on {mesh.device}.")
    R = mesh.size
    a, x = _pad_measure(a, x, R)
    b, y = _pad_measure(b, y, R)
    return (a, x, b, y), [shard_rows(t, mesh) for t in (a, x, b, y)]


def kernel_ring(a, x, b, y, name="gaussian", blur=0.05, mesh=None, axis="points", potentials=False,
                impl="auto"):
    r"""Kernel (MMD) loss over a group of ranks: the three matvecs of
    :func:`geomloss_tpu_torch.models.kernel_samples.kernel_loss` as ring
    reductions, with the same detached-partner / doubled-gradient
    bookkeeping. Every rank passes the full ``a (N,)``, ``x (N, D)``, ``b
    (M,)``, ``y (M, D)``; ``N`` and ``M`` are padded to multiples of the
    ring size. ``axis`` is accepted for the JAX package's signature (a
    process group has no axis name).

    Returns the scalar loss on every rank, or with ``potentials=True`` the
    global ``(N,)`` and ``(M,)`` potentials on every rank.
    """
    if mesh is None:
        mesh = points_mesh()
    N, M = a.shape[0], b.shape[0]
    _, (a_l, x_l, b_l, y_l) = _shards(mesh, a, x, b, y)
    p, kind = _streaming_params[name]
    eps = blur**p if kind == "gibbs" else 1.0
    mv = partial(ring_matvec, eps=eps, p=p, kind=kind, mesh=mesh, impl=impl)
    a_x = mv(double_grad(x_l), x_l.detach(), a_l.detach())
    b_y = mv(double_grad(y_l), y_l.detach(), b_l.detach())
    b_x = mv(x_l, y_l, b_l)
    if potentials:
        a_y = mv(y_l, x_l, a_l)
        return gather_rows(a_x - b_x, mesh)[:N], gather_rows(b_y - a_y, mesh)[:M]
    local = 0.5 * scal(double_grad(a_l), a_x) + 0.5 * scal(double_grad(b_l), b_y) - scal(a_l, b_x)
    return psum_scalar(local, mesh)


def sinkhorn_ring(a, x, b, y, mesh=None, axis="points", p=2, blur=0.05, reach=None, diameter=None, scaling=0.5,
                  debias=True, potentials=False, impl="auto"):
    """Debiased Sinkhorn divergence with every point axis cut into row
    shards over a group of ranks: the whole annealing loop runs on each
    rank's shards (the port's ``solvers/sinkhorn_loop.py`` with
    :func:`ring_softmin`), and the only traffic between ranks is the ring.

    Args:
        a: ``(N,)``; x: ``(N, D)``; b: ``(M,)``; y: ``(M, D)``, the full
            clouds on every rank, of any sizes (padded to multiples of the
            ring size with zero-weight points).
        mesh: a :func:`points_mesh` (default: the default process group on
            NCCL). ``axis``: as :func:`kernel_ring`.

    Returns:
        The scalar divergence on every rank, or with ``potentials=True``
        the global ``(N,)`` and ``(M,)`` potentials on every rank.
    """
    if mesh is None:
        mesh = points_mesh()
    N, M = a.shape[0], b.shape[0]
    (_, x_p, _, y_p), (a_l, x_l, b_l, y_l) = _shards(mesh, a, x, b, y)
    diameter, eps, eps_list, rho = scaling_parameters(x_p, y_p, p, blur, reach, diameter, scaling)
    softmin = partial(ring_softmin, p=p, mesh=mesh, impl=impl)
    C_xy, C_yx = (x_l, y_l.detach()), (y_l, x_l.detach())
    C_xx, C_yy = ((x_l, x_l.detach()), (y_l, y_l.detach())) if debias else (None, None)
    f_aa, g_bb, g_ab, f_ba = sinkhorn_loop(
        softmin, log_weights(a_l), log_weights(b_l), C_xx, C_yy, C_xy, C_yx, eps_list, rho, debias=debias
    )
    out = sinkhorn_cost(eps, rho, a_l, b_l, f_aa, g_bb, g_ab, f_ba, debias=debias, potentials=potentials)
    if potentials:
        F, G = out
        return gather_rows(F, mesh)[:N], gather_rows(G, mesh)[:M]
    return psum_scalar(out, mesh)

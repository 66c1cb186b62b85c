"""The collectives of the ring and row-sharded solvers, over a
``torch.distributed`` group.

Every rank calls each function in the same order with tensors of the same
shape. A group of one rank needs no message: every function is then the
identity (NCCL refuses to send to itself). Where the group's backend is
``gloo`` and the tensors lie on the card (ranks that share one card: NCCL
refuses two ranks on one device), each collective is staged through host
memory here; the choice follows the backend of the caller's group.

:class:`PsumScalar` and :class:`ShardRows` carry the gradients that JAX's
``shard_map`` derives: the transpose of ``psum`` to a replicated output
hands every rank the cotangent itself (``torch.distributed.nn``'s
``all_reduce`` would sum it over the ranks, R times too large), and a
replicated input split into row shards gets back the whole gradient on
every rank.
"""

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "ppermute",
    "all_gather",
    "reduce_scatter",
    "all_reduce",
    "psum_scalar",
    "shard_rows",
    "gather_rows",
]


class Mesh(NamedTuple):
    """A 1D mesh of ranks: the process group, this process's rank in it,
    the group's size, and the device of this rank's tensors."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def _staged(mesh, t):
    """Whether ``t`` goes through host memory: a card's tensor on gloo."""
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _peer(mesh, r):
    """Global rank of the group's rank ``r`` (what point-to-point calls take)."""
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def ppermute(tensors, shift, mesh):
    """Send each tensor to rank ``(rank + shift) % size`` and receive the
    same-shaped tensors of rank ``(rank - shift) % size``: one
    ``batch_isend_irecv`` of all the sends and receives, so that no ring
    order can deadlock. Takes a tensor or a tuple of tensors and returns
    the same."""
    single = isinstance(tensors, torch.Tensor)
    ts = (tensors,) if single else tuple(tensors)
    if mesh.size == 1:
        return tensors
    dst = _peer(mesh, (mesh.rank + shift) % mesh.size)
    src = _peer(mesh, (mesh.rank - shift) % mesh.size)
    staged = [_staged(mesh, t) for t in ts]
    send = [(t.cpu() if s else t).contiguous() for t, s in zip(ts, staged)]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, dst, mesh.group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, src, mesh.group) for t in recv]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = tuple(r.to(t.device) if s else r for r, t, s in zip(recv, ts, staged))
    return out[0] if single else out


def all_gather(t, mesh):
    """The ranks' ``t`` concatenated on dim 0, in rank order."""
    if mesh.size == 1:
        return t
    staged = _staged(mesh, t)
    src = (t.cpu() if staged else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts)
    return out.to(t.device) if staged else out


def reduce_scatter(t, mesh):
    """This rank's slice (dim 0 cut into ``size`` equal slices) of the sum of
    the ranks' ``t``."""
    if mesh.size == 1:
        return t
    staged = _staged(mesh, t)
    src = (t.cpu() if staged else t).contiguous()
    out = torch.empty_like(src.chunk(mesh.size)[0])
    dist.reduce_scatter(out, list(src.chunk(mesh.size)), group=mesh.group)
    return out.to(t.device) if staged else out


def all_reduce(t, mesh):
    """The sum of the ranks' ``t`` (a new tensor)."""
    if mesh.size == 1:
        return t
    staged = _staged(mesh, t)
    out = t.cpu() if staged else t.clone()
    dist.all_reduce(out, group=mesh.group)
    return out.to(t.device) if staged else out


class PsumScalar(torch.autograd.Function):
    """The sum over the ranks; the backward hands each rank its cotangent
    unchanged, as JAX transposes ``psum`` to a replicated output."""

    @staticmethod
    def forward(ctx, local, mesh):
        return all_reduce(local, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_scalar(local, mesh):
    """``sum_r local_r`` on every rank, differentiable as :class:`PsumScalar`."""
    return PsumScalar.apply(local, mesh)


class ShardRows(torch.autograd.Function):
    """This rank's rows of a replicated tensor; the backward gathers every
    rank's slice of the gradient, so each rank gets the whole gradient of
    the replicated input."""

    @staticmethod
    def forward(ctx, full, mesh):
        ctx.mesh = mesh
        n = full.shape[0] // mesh.size
        return full[mesh.rank * n : (mesh.rank + 1) * n]

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh), None


def shard_rows(full, mesh):
    """Rows ``rank * n .. (rank + 1) * n - 1`` of ``full`` (``n = len(full) /
    size``), differentiable as :class:`ShardRows`."""
    if full.shape[0] % mesh.size:
        raise ValueError(f"shard_rows: {full.shape[0]} rows do not split into {mesh.size} equal shards.")
    return ShardRows.apply(full, mesh)


class GatherRows(torch.autograd.Function):
    """The ranks' row shards in rank order; the backward takes this rank's
    rows of the (replicated) cotangent: the inverse of :class:`ShardRows`."""

    @staticmethod
    def forward(ctx, part, mesh):
        ctx.mesh = mesh
        return all_gather(part, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        n = g.shape[0] // mesh.size
        return g[mesh.rank * n : (mesh.rank + 1) * n], None


def gather_rows(part, mesh):
    """The global array of row shards, on every rank (the reassembly of a
    ``shard_map`` output sharded by rows)."""
    return GatherRows.apply(part, mesh)

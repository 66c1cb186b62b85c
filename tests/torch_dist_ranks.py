"""CPU ranks for the tests of ``geomloss_tpu_torch.parallel``.

:class:`Ranks` spawns ``world`` processes that join one ``gloo`` group
through a ``FileStore`` under the test's ``tmp_path`` (no TCP port, so
that parallel test workers cannot collide), each with one thread. Every
rank also makes the group of each case's ranks (the whole world is the
default group), and runs the cases of the groups it belongs to, in order,
calling ``backward`` on every rank. The
results come back by a queue; :meth:`Ranks.results` waits until a deadline
and fails, terminating the ranks, past it, so that a deadlock cannot hold
the test run.

This module imports only torch and numpy (and the port): the spawned ranks
import it, and none of them imports JAX.
"""

import math
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: Seconds a spawn of ranks may take before it is terminated.
DEADLINE = 150


def _ranks(case):
    return tuple(case.get("ranks", range(case["R"])))


def _rank_main(rank, world, store, cases, q):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
        # Every rank makes every group, in the same order:
        groups = {ranks: (None if len(ranks) == world else dist.new_group(list(ranks)))
                  for ranks in sorted({_ranks(c) for c in cases})}
        out = {}
        for case in cases:
            if rank in _ranks(case):
                out[case["id"]] = run_case(case, groups[_ranks(case)])
        q.put((rank, "ok", out))
    except BaseException:  # reported to the parent, which fails the test
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """``world`` gloo ranks running ``cases`` (dicts with ``id``, ``R`` the
    size of the case's group, its ``ranks`` if not the first ``R``, and
    what :func:`run_case` reads), started at once; read them with
    :meth:`results`."""

    def __init__(self, cases, world, tmp_path):
        ctx = mp.get_context("spawn")
        self.world = world
        self.q = ctx.Queue()
        store = os.path.join(str(tmp_path), "store")
        self.procs = [
            ctx.Process(target=_rank_main, args=(r, world, store, cases, self.q), daemon=True)
            for r in range(world)
        ]
        self.t0 = time.monotonic()
        for p in self.procs:
            p.start()

    def results(self, deadline=DEADLINE):
        """``{rank: {case id: result}}``; raises if a rank failed or the
        deadline passed (the ranks are then terminated)."""
        got, errors = {}, []
        try:
            while len(got) + len(errors) < self.world:
                left = deadline - (time.monotonic() - self.t0)
                if left <= 0:
                    raise TimeoutError(f"the ranks did not finish within {deadline} s (got {sorted(got)})")
                try:
                    rank, status, out = self.q.get(timeout=min(left, 5.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs) if not p.is_alive() and r not in got]
                    if dead and all(p.exitcode not in (0, None) for p in (self.procs[r] for r in dead)):
                        raise RuntimeError(f"ranks {dead} died with exit codes "
                                           f"{[self.procs[r].exitcode for r in dead]}")
                    continue
                if status == "ok":
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
            if errors:
                raise RuntimeError("\n".join(errors))
            return got
        finally:
            for p in self.procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)


def _grads(out, leaves, argnums, cot):
    if not argnums:
        return []
    grads = torch.autograd.grad(out, [leaves[i] for i in argnums], grad_outputs=torch.tensor(cot),
                                materialize_grads=True)
    return [g.numpy() for g in grads]


def run_case(case, group):
    """One case on this rank: the function ``case["fn"]`` of
    :mod:`geomloss_tpu_torch.parallel` (``ring_lse`` and ``ring_matvec`` on
    the row shards of the inputs; or ``"sgd"``: three steps of gradient
    descent on ``sinkhorn_ring``, or ``"single"``: the single-device
    ``sinkhorn_multiscale``) on the numpy ``case["inputs"]``
    as float64 tensors, with ``case["kw"]`` (``case["n_fine_ok"]`` sets
    ``multiscale.N_FINE_OK``, a true ``case["jax_coarse_rule"]`` the JAX
    package's coarse keep rule). Returns ``(outputs, grads)``:
    the outputs as numpy arrays, and the gradients of ``<cot, output>`` in
    the inputs ``case["argnums"]``."""
    from geomloss_tpu_torch import parallel
    from geomloss_tpu_torch.models import multiscale

    mesh = parallel.points_mesh(group, backend="gloo")
    kw = dict(case.get("kw", {}))
    saved = multiscale.N_FINE_OK, multiscale.masks_from_coarse
    multiscale.N_FINE_OK = case.get("n_fine_ok", saved[0])
    if case.get("jax_coarse_rule"):
        # The classic path's coarse tables on the JAX package's keep rule
        # (the cluster centroids alone: an infinite slack).
        multiscale.masks_from_coarse = lambda *a, **k: saved[1](*a, **dict(k, eps_min=math.inf))
    try:
        if case["fn"] == "sgd":
            a, x, b, y = (torch.tensor(v) for v in case["inputs"])
            losses = []
            for _ in range(3):
                x = x.detach().requires_grad_(True)
                v = parallel.sinkhorn_ring(a, x, b, y, mesh=mesh, **kw)
                (g,) = torch.autograd.grad(v, x)
                losses.append(v.item())
                x = x - case["lr"] * g
            return np.array(losses), [x.detach().numpy()]
        argnums = case.get("argnums", ())
        leaves = [torch.tensor(v, requires_grad=i in argnums) for i, v in enumerate(case["inputs"])]
        if case["fn"] == "single":
            out = multiscale.sinkhorn_multiscale(*leaves, **kw)
        elif case["fn"] in ("ring_lse", "ring_matvec"):
            # The op on this rank's row shards, gathered into the global (N,).
            from geomloss_tpu_torch.parallel._collectives import gather_rows, shard_rows

            shards = [shard_rows(t, mesh) for t in leaves]
            out = gather_rows(getattr(parallel, case["fn"])(*shards, mesh=mesh, **kw), mesh)
        else:
            out = getattr(parallel, case["fn"])(*leaves, mesh=mesh, **kw)
        if isinstance(out, tuple):
            return [o.detach().numpy() for o in out], []
        return out.detach().numpy(), _grads(out, leaves, argnums, case.get("cot", 1.0))
    finally:
        multiscale.N_FINE_OK, multiscale.masks_from_coarse = saved

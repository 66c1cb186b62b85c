"""The ``parallel`` package's calls on R ranks, one card each (NCCL).

    python3 time_parallel.py             # R = the visible cards
    python3 time_parallel.py --ranks 2

Runs ``chip_smoke.py``'s [parallel] calls (``PARALLEL_CALLS``: the sharded
multiscale solve at 2e6 and 1e5 points, ``sinkhorn_ring`` and the gaussian
``kernel_ring`` at 1e5) first on one rank in this process, then on R
spawned ranks, rank r on card r, through an NCCL group (a ``FileStore``
under ``build/``). Each R-rank run is held to the one-rank run as
``chip_smoke.py`` holds its gloo runs (value 1e-5 relative, the MMD to its
terms' bound; gradient 1e-4 relative L2), and its launches per rank to the
same schedule; prints each run's loss + gradient time (median of 3, host
clock and CUDA events), peak memory and rank 0's idle share, beside the
cards' names and power limits. Exits non-zero if a check fails, a rank
raises or the ranks overrun ``chip_smoke.PARALLEL_DEADLINE``.
"""

import argparse
import datetime
import os
import queue
import subprocess
import sys
import time
import traceback

import torch

import chip_smoke as cs


def _rank(rank, world, store, q):
    import torch.distributed as dist

    try:
        from geomloss_tpu_torch import parallel as par

        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=cs.PARALLEL_DEADLINE), device_id=dev)
        mesh = par.points_mesh()
        out = {}
        for name in cs.PARALLEL_CALLS:
            res = cs.run_parallel_call(name, mesh, dev, profile=rank == 0)
            grad = res.pop("grad")
            res["grad_sum"] = grad.double().sum().item()
            if rank == 0:
                res["grad"] = grad.numpy()  # by value, not as a shared-memory handle
            out[name] = res
        q.put((rank, "ok", out))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn(world, store):
    """Run :func:`_rank` on ``world`` ranks; their results, or a failure."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, world, store, q)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) + len(errors) < world:
            if time.perf_counter() - t0 > cs.PARALLEL_DEADLINE:
                cs.fail(f"the {world} ranks did not finish within {cs.PARALLEL_DEADLINE} s")
            try:
                rank, status, out = q.get(timeout=10.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    cs.fail(f"ranks {dead} died, exit codes {[procs[r].exitcode for r in dead]}")
                continue
            if status == "ok":
                got[rank] = out
            else:
                errors.append(f"rank {rank}: {out}")
        if errors:
            cs.fail("a rank raised:\n" + "\n".join(errors))
        for out in got[0].values():
            out["grad"] = torch.from_numpy(out["grad"])
        return got
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=None, help="ranks, one card each (default: every card)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script runs on the cards")
    import torch.distributed as dist

    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch import parallel as par
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    world = args.ranks or torch.cuda.device_count()
    if world > torch.cuda.device_count():
        cs.fail(f"{world} ranks need {world} cards, {torch.cuda.device_count()} are visible")
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    print(f"[time_parallel] {world} ranks on {world} of the cards: {'; '.join(cards)}", flush=True)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    t0 = time.perf_counter()
    ck.build()
    cbs.build()
    print(f"[time_parallel] kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda", 0)
    store = os.path.join(build, "time_parallel_store_r1")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
    try:
        mesh = par.points_mesh()
        one = {name: cs.run_parallel_call(name, mesh, dev, profile=True) for name in cs.PARALLEL_CALLS}
        xr = torch.from_numpy(cs.sphere_cloud(cs.N_RING, 0)).to(dev)
        yr = torch.from_numpy(cs.sphere_cloud(cs.N_RING, 1)).to(dev)
        terms = cs.mmd_reference(lambda x: SamplesLoss("gaussian", blur=cs.MMD_BLUR, backend="online")(x, yr), xr)[2]
        del xr, yr
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    for name, res in one.items():
        sched = cs.ring_schedule(name, 1) if "ring" in name else res["calls"]
        cs.report_parallel(name, 1, "nccl", {0: res}, sched, cards[0])

    store = os.path.join(build, f"time_parallel_store_r{world}")
    if os.path.exists(store):
        os.remove(store)
    t0 = time.perf_counter()
    res = spawn(world, store)
    print(f"[time_parallel] {world} spawned ranks, one card each, NCCL: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, ref in one.items():
        runs = {r: out[name] for r, out in res.items()}
        sched = cs.ring_schedule(name, world) if "ring" in name else ref["calls"]
        cs.report_parallel(name, world, "nccl", runs, sched, "; ".join(cards[:world]))
        rel_v, rel_g = cs.rel_errs(torch.tensor(runs[0]["value"]), runs[0]["grad"], torch.tensor(ref["value"]),
                                   ref["grad"])
        err_v = abs(runs[0]["value"] - ref["value"])
        tol_v = cs.mmd_tolerance(terms) if name.startswith("mmd") else cs.PARALLEL_VAL_RTOL * abs(ref["value"])
        print(f"[time_parallel] {name} R={world} against R=1: loss err {err_v:.3e} (tol {tol_v:.3e}), loss rel err "
              f"{rel_v:.3e}, grad rel L2 err {rel_g:.3e} (tol {cs.PARALLEL_GRAD_RTOL:g}); loss+grad "
              f"{runs[0]['host_ms']:.3f} ms against {ref['host_ms']:.3f} ms on one rank", flush=True)
        if not (err_v <= tol_v and rel_g <= cs.PARALLEL_GRAD_RTOL):
            cs.fail(f"{name} on {world} ranks misses the run on one rank")
    print("[time_parallel] ok", flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)

"""GPU smoke run of geomloss_tpu_torch: builds the kernels, checks each
against its plain PyTorch twin, drives the online and the multiscale
Sinkhorn paths at N = M = 100,000, the multiscale mid path at
N = M = 2,000,000, 4,000,000 and 10,000,000 (tile 2048), the online path
in D = 32, the kernel (MMD) losses at 100,000 and 1,000,000 points, the
public sparse and walk Sinkhorn ops on the multiscale path's tables, the
grid path (``ImagesLoss`` at 256^2, ``VolumesLoss`` at 64^3,
``ImagesBarycenter``), the ``ot`` API (``ot.solve_sample``'s streaming
route at 100,000 points) and the ``parallel`` package (the ring at 100,000
points and the row-sharded multiscale solve at 2,000,000, on one rank
and on ranks that share the card), the examples gallery
(``examples_torch/``: every script at its full size, the label transfer
at 1,000,000 points) and the benchmark twins (``bench_torch.py``, legs of
``bench_suite_torch.py``), the program's own spans, and times them.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero without them, or if any
phase fails. An idle share is one minus the device's kernel time in one
call under ``torch.profiler`` over the host clock of the same call
unprofiled (the profiler slows the host's side of a call). Phases, one
line each:

1. device: the card's name, the device count and its power limit;
2. build: compiles ``geomloss_tpu_torch/csrc/online_kernels.cu`` and
   ``block_sparse_kernels.cu``, one ``nvcc`` each, started together, into
   the checkout's ``build/smoke_kernels`` (set as
   ``$GEOMLOSS_TPU_TORCH_BUILD_DIR`` whatever the caller set it to; emptied
   first, and the libraries must land there);
   prints the registers and spills (``-Xptxas -v``) of kernels 5 and 6 and
   of the bench.py instantiations of kernels 1-4, 7 and 8 (PTXAS_SHOWN);
3. repair: peak device memory of the two step kernels at N = M = 1e6 under
   256 MB beyond their inputs, and two calls bitwise equal;
4. parity: each online kernel against its twin on the card at N = M = 1e5
   and at a ragged size, p in {1, 2} (kernel 2's raw sums as
   ``check_sums`` reads them; kernels 1, 2 and 3 two calls bitwise equal;
   kernel 4 in every mode at C in {1, 3, 4}); the two
   block-sparse kernels
   (absorbed sums, full and triangle tables; dual apply, C = 4) against
   their twins on the truncation tables of the multiscale path at 1e5,
   p in {1, 2};
5. online path: value and gradient of ``SamplesLoss("sinkhorn", p=2,
   blur=0.05, diameter=2.0, scaling=0.5, backend="online")`` between two
   100,000-point sphere clouds, held against the same solve through the
   plain twins in float64; then one warm-started solve; the kernel launch
   counts of that run; and a small problem against the dense float64 path;
6. multiscale path (bench.py's call: ``backend="auto"``, which resolves
   to multiscale at this size): value and gradient against the same solve
   through the float64 twins; for information, against the online float64
   value of phase 5 and against ``truncate=None``; the launch counts of
   that run; kernel 1 against its twin at the shape of that run's coarse
   sweeps (4,096 points), two calls bitwise equal, timed beside its bound,
   issue floor and the dense PyTorch composition (``check_lse_shapes``);
7. timing: loss + gradient of both paths, kernels and plain float32 twins;
   each kernel against its twin and its bound (the larger of its bytes
   over the memory rate and its exp2 count over the MUFU rate), and the
   register-tiled kernels' issue floor (``pair_slots``); the
   device's idle share over one multiscale call (``torch.profiler``);
8. mid path (bench.py's call at N = M = 2e6, ``backend="auto"``: the
   pooled intermediate scale, kernel 7 on the four truncated
   extrapolations, kernels 5 and 6 at tile 1024): the launch counts of that
   run against the schedule (calls; kernels 5 and 6 launch their live
   slots in chunks), loss + gradient time, peak device memory and the
   device's idle share over one call; the extra memory of one kernel 5
   and one kernel 6 call against their scratch budget;
   kernel 1 as in phase 6 at each shape of that run (the coarse sweeps,
   the mid cloud); kernel 7 against its twin on the run's four
   extrapolation tables, and
   kernels 5 and 6 on the first 64 row tiles of its first fine tables; its
   default tables (fine and extrapolation) against the tables of every
   column tile, and whether they kept their former widths (``mid_cap``,
   ``extrap_cap``); the fine tables' kept tiles a row beside the same
   tables under the JAX package's keep rule (no radius subtracted); for
   information, how many rows JAX's walk budget would have clipped and the
   value against ``truncate=None`` (the exact fine phase, kernels 2 and
   3); the largest gap of the potentials to the same solve whose fine
   and extrapolation tables keep every tile, in eps (fails over
   ``MID_GAP_EPS``);
9. the mid path forced at N = M = 1e5 (``N_FINE_OK`` lowered for the
   call), p in {1, 2}, and one custom-cost multiscale solve at 1e5, each
   against the same call through the float64 twins;
10. MMD (``[mmd]``): the default tables of the gaussian multiscale route
    (``truncate=3``, blur 0.1) at 1e5 and 1e6 against the tables of every
    column tile (a table that drops a kept tile fails the run); kernel 8
    (``gibbs_apply_sparse``) against its twin on those tables at 1e5 and
    on the first 64 row tiles at 1e6, modes 0-4, C in {1, 4}, each with
    its time and bound, and timed at the former default width beside;
    ``softmin_sparse`` at 1e5 on the route's xy table, p in {1, 2}
    (kernel 7's CUDA kernel forward as ``lse_sparse``, kernel 8
    backward); kernel 4's energy and inv_dist modes timed at 1e5, C in
    {1, 4}, beside their bound and issue floor; the
    gaussian (online, multiscale), energy and laplacian (multiscale)
    losses at 1e5 through ``SamplesLoss``, value and gradient against the
    float64 plain versions to bounds scaled by the MMD's terms, with
    their times, launches and peak memory; the gaussian multiscale value
    against the online float64 one (within ``MMD_GAP_TOL``), and on
    tables clipped at the former widths; a user gaussian callable
    against the named route; the gaussian multiscale route at 1e6 (kernel
    8 parity, time, idle share);
11. the auto route at N = M = 4e6 (``[4m]``) and 1e7 (``[tile2048]``:
    pads to 2^24 and takes tile 2048, which the JAX banded kernels refuse):
    loss, loss + gradient time, peak memory, launches and the first fine
    table's kept tiles per row, each fine table's beside the JAX keep
    rule's; at 1e7 kernels 5 and 6 against their
    float64 twins on the first 8 row tiles of its first fine tables
    (``truncate=None`` is not run there: an O(N^2) fine phase);
12. the public sparse and walk Sinkhorn ops (``[sparse]``, run before
    ``[4m]``), on the first fine tables of the multiscale solve at 1e5
    (p in {1, 2}): kernels 12 (``absorbed_sum_sparse``), 10
    (``absorbed_sum_walk``) and 11 (``gibbs_apply_walk``, modes 0-4, C in
    {1, 4}) and kernel 8 through its row-start form against their twins,
    over walk tables at two budgets (no row clipped; half the mean kept
    count), the one-launch CUDA decode of each walk table against its
    PyTorch form on the CPU; kernels 12 and 10 two calls bitwise equal,
    and bitwise equal to each other on the unclipped walk; two fine
    iterations and the extrapolation through ``sinkhorn_step_sparse`` /
    ``softmin_extrapolation_sparse`` (+ ``_sym``) and their walk twins,
    their launches counted from zero (the decode's too), against the
    float64 twins, and walk against sparse, bitwise; kernel 5's banded
    step beside the sparse step; the kernels' and the decode's times
    beside their bound, issue floor and twin, with the device launches of
    one call (``torch.profiler``), at 1e5, then at 2e6 on the mid path's
    first fine table (parity on its first 64 row tiles);
13. ``[wide-d]`` (run before ``[mmd]``): ``SamplesLoss()`` at N = M = 1e4
    in D = 32 (the online route, through the kernels' wide
    instantiations) against the same solve through the float64 twins;
    kernels 1, 3 and 4 against their twins and kernels 1-4 timed at
    D = 32 beside their bound.
14. ``[grid]`` (run after ``[wide-d]``): the grid path, which reaches no
    kernel of the port (the JAX package runs it in XLA, outside Pallas):
    ``softmin_grid`` at (8, 256, 256) and (2, 64, 64, 64), p in {1, 2},
    at eps = 1 and one pixel^p, against float64, and again with
    ``allow_tf32`` set by the caller (bitwise the same, the setting kept);
    ``ImagesLoss`` between two batches of 8 images of 256^2 and
    ``VolumesLoss`` between two batches of 2 volumes of 64^3 (sums of
    Gaussian bumps), p = 2, p = 1, reach 0.1 and potentials, and
    ``ImagesBarycenter`` of 4 shapes of 256^2 (defaults), value and
    gradient in float32 against the same calls in float64; for each of the
    three calls with its gradient, the median of 5 timed runs (host clock
    and CUDA events), the device launches and idle share of one call
    (``torch.profiler``) and its peak memory.
15. ``[ot]`` (run after ``[grid]``): the ``ot`` API. ``ot.solve_sample(
    blur=0.05, max_iter=25, debias=True)`` between two 100,000-point
    sphere clouds (the streaming route: no cost matrix), its value,
    gradient in ``X_a``, marginals, ``a_to_b``, ``value_linear`` and
    ``lazy_plan @ V`` (C = 1 and 3): kernel 1's launches against the
    schedule (4 an iteration, 4 in the last extrapolation) and kernel 4's
    against the recorded calls; kernel 1's first and last call and kernel
    4's first call at C = 1 and C = 3 against their twins, kernel 4 timed
    at both beside its bound; loss + gradient timed (median of 3, host
    clock and CUDA events), its idle share and launches under
    ``torch.profiler`` and its peak memory. Then, float32 against the same
    calls through the float64 twins (``plain_twins``): ``solve_sample`` at
    20,000 points (value, gradient, potentials, ``a_to_b``,
    ``marginal_a``), ``solve_sample_batch`` (4 x 10,000),
    ``barycenter_sample`` (3 clouds of 10,000, ``SamplesLoss``'s online
    route: kernels 2-4), ``solve``, ``solve_batch`` and ``barycenter`` on
    4,096 x 4,096 costs (no kernel), ``solve_grid`` at 8 x 256^2 (the
    pyramid) and 2 x 128^2 (``axes=``, ``periodic=True``) and
    ``barycenter_grid`` at 4 x 128^2, each timed, within ``PATH_TOL``.
16. ``[parallel]`` (run after ``[ot]``): ``geomloss_tpu_torch.parallel``.
    (a) One rank on NCCL (a world-size-1 group through a ``FileStore``
    under ``build/``): ``sinkhorn_multiscale_sharded`` at N = M = 2e6
    (bench.py's call: the mid path, kernels 1, 7, 5 and 6) against
    ``SamplesLoss()`` at the same clouds, bitwise (the gap printed and
    explained otherwise), and at 1e5; ``sinkhorn_ring`` (kernels 1 and 4)
    and the gaussian ``kernel_ring`` (kernel 4) at 1e5 against the online
    route within ``PATH_TOL`` and the MMD's term-scaled bounds. (b) Four
    ranks on the one card through gloo, each this script run again as a
    child process (``python chip_smoke.py --parallel-rank ...``) (NCCL refuses two ranks on
    one device; ranks that share a card give no scaling figure): the
    sharded solve at 2e6 and the ring calls on the first two ranks, the
    sharded solve at 1e5 and the ring calls on all four, each against (a)
    within 1e-5 (value) and 1e-4 (gradient, relative L2); a rank that
    raises, dies or overruns ``PARALLEL_DEADLINE`` fails the phase. For
    every run: the backend, R, each rank's calls and launches of kernels
    1, 4, 5, 6 and 7 against the schedule, loss + gradient (median of 3,
    host clock and CUDA events), peak memory and rank 0's idle share.
    (c) Kernels 5 and 6 with a row offset: on shard 1 of 4 of the 1e5
    multiscale triangle tables (p in {1, 2}) against their twins, and the
    four shards' sums added up against the whole table.
17. ``[gallery]`` (before ``[bench]``): every script of
    ``examples_torch/`` once on the card, at its JAX example's full size
    (``plot_profile`` at 1e5), ``plot=False``: its seconds, result, kernel
    launches counted from zero, peak memory and the property it prints
    (``_example_utils_torch.PROPERTIES``; a script that raises or misses
    it fails the run); the steps of ``gradient_flow`` and
    ``model_fitting`` (median host-clock ms a step, device launches and
    idle share of one step under ``torch.profiler``); the label transfer
    at 36,000 points, its potentials and votes (C = 3) against the same
    call through the float64 twins (``PATH_TOL``), then at 1,000,020
    points (``n_fibers=16_667``: the multiscale potentials on the classic
    tile-1024 path, kernel 4 over 1e12 pairs at C = 3, held against its
    float64 twin on 2,048 rows and timed beside its bound), both
    accuracies, and
    its xy truncation table: width, kept tiles a row, and the rows that
    the tables' former widths (the build cap, ``fine_cap_schedule``)
    would have clipped, and its potentials' gap to the same call whose
    coarse tables (``masks_from_coarse``) keep every tile (fails over
    ``MID_GAP_EPS``); then at 2,100,000 points (``n_fibers=35_000``: the
    mid path), accuracy >= 0.99 and finite votes, its default tables (fine
    and extrapolation) against the tables of every column tile, beside
    their former widths, the fine table's kept tiles beside the JAX keep
    rule's, and its potentials' gap to the same call whose fine and
    extrapolation tables keep every tile (fails over ``MID_GAP_EPS``).
18. ``[bench]`` (last): the benchmark twins, called as functions.
    ``bench_torch.headline`` (bench.py's call at N = M = 1e5) with the
    kernel launches counted from zero (kernels 1, 5 and 6 must run), every
    key of its line, and its loss within ``PATH_TOL`` of the same call
    through the float64 twins (the loss against the online
    ``truncate=None`` value is printed: on the multiscale route it measures
    the gap between the two descents, not the kernels); the same call's
    coarse xy table, its kept tiles a row beside the JAX package's keep
    rule's, and its potentials' largest gap to the solve whose coarse
    tables keep every tile (fails over ``MID_GAP_EPS``);
    ``bench_suite_torch.py``'s tensorized legs at 1e2 and 1e3 and its
    multiscale blur .05 leg at 1e4, each within its bound against float64;
    the program's spans (``geomloss_tpu_torch.utils.profiling``) of one
    call at 1e6 under ``torch.profiler``: every phase of the classic path
    recorded, nested in its parent, the backward spans under the call's id,
    with each span's device-idle ms; and a span around one kernel launch
    and a synchronize holding that kernel's device event, the offsets of
    the two clocks under ``CLOCK_TOL_US``.

Each phase prints its seconds. Before the last lines the run fails if a
process it started (nvcc, nvidia-smi, a [parallel] rank) is still there.
The gallery's ``plot_profile`` writes its traces under the checkout's
``examples_torch/output/``.

The line before the last two is a JSON object ``{"kernels": [...]}``; the
line before the last is the card's name and power limit as ``nvidia-smi``
reports them; the last line is ``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bench_torch import PATH_TOL, card_line, plain_twins, profile_busy_ms

N_POINTS = 100_000
N_REPAIR = 1_000_000
N_MID = 2_000_000
RAGGED = (100_003, 99_991)
BLUR, DIAMETER, SCALING = 0.05, 2.0, 0.5

# Tolerances. Kernel parity: those of tests/test_pallas_kernels.py (LSE and
# step values rtol = atol = 2e-5; applies rtol 2e-3, atol 3e-5 x scale with
# scale = max_i sum_j |w_ij| |V_j|). Main path: float32 kernels against the
# float64 twins, relative error of the loss and relative L2 error of the
# gradient, each <= PATH_TOL (1e-3, bench_torch.py's).
VAL_RTOL = VAL_ATOL = 2e-5
#: Kernels 5 and 6 take one ex2.approx.ftz per pair, which flushes weights
#: below 2^-126 to zero: a sum of n kept pairs may lose up to n x 2^-126.
#: Where that is more than FLUSH_SHARE of a positive twin sum (a column
#: that only far rows reach, when a parity check keeps the first row tiles
#: alone), the raw sums are compared, within n x 2^-126 plus the relative
#: error the potentials' tolerance allows; every other sum (zero sums
#: included) is compared as the fine step reads it.
FLUSH_WEIGHT = 2.0**-126
FLUSH_SHARE = 1e-6
APPLY_RTOL, APPLY_ATOL_SCALE = 2e-3, 3e-5
#: Extra device memory one step call may take beyond its inputs at 1e6.
REPAIR_BYTES = 256e6
#: Calls of the 2e6 mid path (bench.py's settings): one fine iteration
#: (3 tables) and the last extrapolation's 3 forwards on kernel 5, the
#: backward of its xy and xx parts on kernel 6, the four extrapolations
#: onto the fine cloud on kernel 7 (one launch each; kernels 5 and 6
#: launch their live slots in chunks, one launch per chunk).
MID_CALLS = {"lse_tiles": 4, "absorbed_sum_tiles": 6, "gibbs_apply_tiles": 2}
#: The auto route at bench_suite.py's largest size (pads to 2^22 points).
N_4M = 4_000_000
#: The auto route at 1e7 points: pads to 2^24 and takes tile 2048
#: (multiscale.auto_tile), which the JAX banded kernels refuse; kernels 5
#: and 6 are held against their float64 twins on its first row tiles. At
#: blur 0.05 the pooled mid scale takes every annealing step left after
#: the jump at this size (mid_delay 2 of 2), so no fine table is visited;
#: blur 0.02 leaves one fine iteration, the schedule of bench.py's call at
#: 2e6 (MID_CALLS).
N_TILE2048 = 10_000_000
TILE2048_BLUR = 0.02
TILE2048_PARITY_TILES = 8
#: [wide-d]: SamplesLoss() at 1e4 points in D = 32.
N_WIDE, D_WIDE = 10_000, 32
#: The MMD configurations (bench_suite.py's MMD rows): blur 0.1, the
#: multiscale routes at truncate 3; the gaussian multiscale route also at
#: 1e6.
MMD_BLUR, MMD_TRUNCATE = 0.1, 3
N_MMD_LARGE = 1_000_000
#: MMD values: the loss is the small difference of three terms that nearly
#: cancel (each ~5e-3 for two samples of one sphere at blur 0.1, the loss
#: ~2e-3 of that), so a relative error of the loss measures the
#: cancellation. The float32 kernels are held to bounds scaled by the
#: terms and the gradient's parts of the float64 run:
#: |loss - ref| <= MMD_LOSS_TOL (|1/2 <a,Kxx a>| + |1/2 <b,Kyy b>| + |<a,Kxy b>|)
#: and |grad - ref|_2 <= MMD_GRAD_TOL max(|grad of 1/2 <a,Kxx a>|_2,
#: |grad of <a,Kxy b>|_2). The p = 1 noise floor of the JAX package's
#: Pallas kernels does not enter: both sides here are the port's, with
#: the same distances (sqrt(max(sq, 1e-8)) from coordinate differences).
#: A user kernel callable is held to the named route by the same loss
#: bound.
MMD_LOSS_TOL = 1e-5
MMD_GRAD_TOL = 1e-3
#: The JAX package's SMEM bound on the width of a masks_from_geometry table
#: at 1024 row tiles (400_000 // (4 * 1024)); the port keeps up to 128.
JAX_GEOMETRY_CAP = 97
#: N_FINE_OK for the mid path forced at 1e5: one mid iteration for p = 1
#: and p = 2, on a mid cloud of 16,384 points (the truncated
#: extrapolations' gate needs 64 source tiles of 128).
N_FINE_FORCED = 1 << 16
#: Row tiles of the kernel 5 and 6 parity checks on the 2e6 tables (the
#: twin's time grows with them).
MID_PARITY_TILES = 64
#: Rows of kernel 4's fused energy form held against its twin at
#: N_MMD_LARGE (spread over the rows, with the last row block).
ENERGY_GRAD_ROWS = 4096
#: [parallel]: the ring calls and the sharded solve at 1e5 on R = 4 ranks,
#: the sharded solve at 2e6 on R = 2; ranks of one card share it through
#: gloo (NCCL refuses two ranks on one device), the run on one rank takes
#: NCCL. The runs on R ranks hold the run on one to a value within 1e-5
#: relative (the MMD: within MMD_LOSS_TOL of its terms, as against the
#: online route) and a gradient within 1e-4 relative L2 (the JAX package's
#: sharded tests pin 1e-4 against one device); each spawn of ranks has
#: PARALLEL_DEADLINE seconds.
N_RING = 100_000
PARALLEL_VAL_RTOL, PARALLEL_GRAD_RTOL = 1e-5, 1e-4
PARALLEL_DEADLINE = 420
#: The first argument that makes this script run one [parallel] rank.
PARALLEL_RANK_ARG = "--parallel-rank"
#: Ranks and row offset of [parallel]'s kernel 5 and 6 parity on one shard
#: of the 1e5 triangle tables.
OFFSET_SHARDS, OFFSET_SHARD = 4, 1

# Least time of a kernel on this card: the larger of its bytes over the
# memory rate and its exponentials over the MUFU rate (16 exp2 results per
# clock per SM, 132 SMs, at the card's maximum SM clock), NVIDIA H100 SXM.
HBM_BYTES_PER_S = 3.35e12
MUFU_PER_CLOCK = 16 * 132
FP32_FLOPS_PER_S = 67e12

# TPU kernel each CUDA kernel replaces (wrapper definition, file:line).
REPLACES = {
    "lse": "geomloss_tpu/ops/pallas_kernels.py:239",
    "sinkhorn_step": "geomloss_tpu/ops/pallas_kernels.py:379",
    "sinkhorn_step_sym": "geomloss_tpu/ops/pallas_kernels.py:559",
    "gibbs_apply": "geomloss_tpu/ops/pallas_kernels.py:722",
    "absorbed_sum_tiles": "geomloss_tpu/ops/block_sparse.py:653",
    "gibbs_apply_tiles": "geomloss_tpu/ops/block_sparse.py:859",
    "lse_tiles": "geomloss_tpu/ops/block_sparse.py:1072",
    "gibbs_apply_sparse": "geomloss_tpu/ops/block_sparse.py:1797",
    "lse_sparse": "geomloss_tpu/ops/block_sparse.py:1669",
    "absorbed_sum_walk": "geomloss_tpu/ops/block_sparse.py:326",
    "gibbs_apply_walk": "geomloss_tpu/ops/block_sparse.py:1185",
    "absorbed_sum_sparse": "geomloss_tpu/ops/block_sparse.py:1944",
    # The walk tables' decode: the step reading of kernels 10 and 11's
    # Pallas kernels (the scalar-prefetched steps of _absorbed_sum_walk).
    "walk_rows": "geomloss_tpu/ops/block_sparse.py:326",
}
#: Register-tiled instantiations whose ptxas usage the build phase prints
#: (besides every one of kernels 5 and 6): kernels 1 and 7 (the LSE stage,
#: KV = cdiv(D, 4)) at p = 2 for one to three staged float4s and the wide
#: form, at p = 1 for one, and their merge; kernel 12 at p = 2 for one
#: staged float4 and wide, at p = 1 for one, its merge and the walk
#: decode; kernels 2 and 3 at p = 2 for
#: one, two, three staged float4s and the wide form, and kernels 4 and 8
#: in mode 0 at one float4, with one and four channels, and wide (kernel 4
#: also in modes 3 and 4, and its fused energy form at one float4 for
#: D <= 3 and D = 4, and wide).
PTXAS_SHOWN = ("lse_kernel<2,1>", "lse_kernel<2,2>", "lse_kernel<2,3>", "lse_kernel<2,0>", "lse_kernel<1,1>",
               "tiles_lse_kernel<2,1>", "tiles_lse_kernel<2,0>", "tiles_lse_kernel<1,1>", "lse_merge_kernel",
               "sparse_sum_kernel<2,1>", "sparse_sum_kernel<2,0>", "sparse_sum_kernel<1,1>", "sum_merge_kernel",
               "walk_rows_kernel",
               "step_kernel<2,1>", "step_kernel<2,2>", "step_kernel<2,3>", "step_kernel<2,0>",
               "sym_step_kernel<2,1>", "sym_step_kernel<2,2>", "sym_step_kernel<2,3>", "sym_step_kernel<2,0>",
               "apply_kernel<0,1,1>", "apply_kernel<0,1,4>", "apply_kernel<0,0,4>", "apply_kernel<3,1,1>",
               "apply_kernel<4,1,4>", "energy_grad_kernel<1,1>", "energy_grad_kernel<1,0>",
               "energy_grad_kernel<0,0>",
               "sparse_apply_kernel<0,1,1>", "sparse_apply_kernel<0,1,4>", "sparse_apply_kernel<0,0,4>")
#: Instructions per pair of the register-tiled kernels after the score and
#: its MUFU: two adds (kernels 2, 3 and 5: both sums), one (kernels 12 and
#: 10: the row sum alone, the row-only form of their stage), 8 FFMAs (kernel 6:
#: four channels each way); the LSE kernels 1, 7 and 9 at p = 2 the max
#: and the add (the score is relative to the running max: its last FFMA
#: takes the row's -max slot), and per row and pass of 8 pairs the compare
#: with the running max, the -inf guard and the warp's vote on a rebase (3
#: / 8 a pair); the apply kernels 4 and 8 take one FFMA per channel of a
#: group (APPLY_KERNELS).
PAIR_TAIL_SLOTS = {"sinkhorn_step": 2, "sinkhorn_step_sym": 2, "absorbed_sum_tiles": 2, "gibbs_apply_tiles": 8,
                   "lse": 2 + 3 / 8, "lse_tiles": 2 + 3 / 8, "lse_sparse": 2 + 3 / 8, "absorbed_sum_sparse": 1,
                   "absorbed_sum_walk": 1}
APPLY_KERNELS = ("gibbs_apply", "gibbs_apply_sparse")


def pair_slots(name, kv=1, ch=1, mode=0, d3=False):
    """Instructions per pair of a register-tiled kernel with kv packed
    float4s per point: at p = 2 (mode 0 of the apply kernels) 4 kv score
    FFMAs and the MUFU; in the apply kernels' modes 3 and 4 (p = 1) 8 kv
    (a subtraction and an FFMA per coordinate), the max with the floor, the
    MUFU (rsqrt) and an FMUL (mode 3) or a compare and a select (mode 4),
    both in kernel 4's fused energy form (mode 5, whose value takes one
    FFMA more than its ``ch`` channels, and whose instantiation for D <= 3,
    ``d3``, leaves out the zero fourth coordinate's two); then the tail
    (PAIR_TAIL_SLOTS; ``ch`` channels for the apply kernels). Its issue
    floor is :func:`issue_ms` of these."""
    head = {3: 8 * kv + 3, 4: 8 * kv + 4, 5: 8 * kv + 5 - 2 * d3}.get(mode, 4 * kv + 1)
    return head + (ch + (mode == 5) if name in APPLY_KERNELS else PAIR_TAIL_SLOTS[name])


SOURCES = {
    "online_kernels": "geomloss_tpu_torch/csrc/online_kernels.cu",
    "block_sparse_kernels": "geomloss_tpu_torch/csrc/block_sparse_kernels.cu",
}


def fail(msg):
    raise RuntimeError(msg)


def sphere_cloud(n, seed, d=3):
    """bench.py's clouds: n points on the unit sphere of R^d, float32."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, d)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def bound(exps, nbytes, clock_hz, flops=0):
    """``(bound_ms, bound_by)``: the larger of ``nbytes`` over the memory
    rate and the operations' time: ``exps`` exponentials over the MUFU
    rate, or ``flops`` float32 operations over the FP32 peak, whichever is
    longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(exps / (MUFU_PER_CLOCK * clock_hz), flops / FP32_FLOPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


#: Instructions an H100 SM issues per clock (4 schedulers x 32 lanes).
ISSUE_PER_CLOCK = 128 * 132


def issue_ms(slots, pairs, clock_hz):
    """The issue floor of a pair kernel, in ms: ``slots`` instructions per
    pair of its design (score FFMAs, the MUFU, the accumulating FFMAs or
    adds) over ``pairs`` pairs, at one instruction per lane and clock."""
    return 1e3 * slots * pairs / (ISSUE_PER_CLOCK * clock_hz)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@contextlib.contextmanager
def capturing(module, name):
    """Record what every call to ``module.<name>`` returns."""
    out = []
    saved = getattr(module, name)

    def call(*args, **kwargs):
        r = saved(*args, **kwargs)
        out.append(r)
        return r

    setattr(module, name, call)
    try:
        yield out
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def calls_of(module, name):
    """Record every call to ``module.<name>`` with what it returned: yields
    ``[(args, kwargs, result), ...]``."""
    calls = []
    saved = getattr(module, name)

    def call(*args, **kwargs):
        calls.append((args, kwargs, saved(*args, **kwargs)))
        return calls[-1][2]

    setattr(module, name, call)
    try:
        yield calls
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def recording(module, names):
    """Record the arguments of every call to ``module.<name>`` (the calls
    go through unchanged): yields ``{name: [(args, kwargs), ...]}``."""
    rec = {name: [] for name in names}
    saved = {name: getattr(module, name) for name in names}

    def wrap(name):
        def call(*args, **kwargs):
            rec[name].append((args, kwargs))
            return saved[name](*args, **kwargs)
        return call

    for name in names:
        setattr(module, name, wrap(name))
    try:
        yield rec
    finally:
        for name in names:
            setattr(module, name, saved[name])


def walk_budget_clips(cnt, cap, rows_per_chunk=1024):
    """Rows and kept tiles JAX's ``walk_plan`` would drop from a kernel 7
    table: a chunk of row tiles keeping more than ``rows x max(12, cap //
    2)`` tiles clips every row of it that keeps more than one."""
    c = cnt.cpu().long().clamp(max=cap)
    rows = tiles = 0
    T = max(12, cap // 2)
    for i in range(0, c.shape[0], rows_per_chunk):
        ch = c[i : i + rows_per_chunk]
        tot, n = int(ch.sum()), ch.shape[0]
        if tot > n * T:
            scale = (n * T - n) / max(tot - n, 1)
            clipped = 1 + ((ch - 1).double() * scale).long()
            rows += int((clipped < ch).sum())
            tiles += int((ch - clipped).sum())
    return rows, tiles


def kernel_label(mangled):
    """``name<a,b>`` of a mangled kernel name (the last component of its
    nested name and its integer template arguments), or the name itself."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    pos, name = m.end(), None
    while True:
        d = re.match(r"\d+", mangled[pos:])
        if not d:
            break
        n = int(d.group())
        name = mangled[pos + d.end():pos + d.end() + n]
        pos += d.end() + n
    if name is None:
        return mangled
    t = re.match(r"I((?:L[ib]-?\d+E)+)E", mangled[pos:])
    args = re.findall(r"L[ib](-?\d+)E", t.group(1)) if t else []
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_usage(log):
    """``{kernel label: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}}`` from ``nvcc -Xptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    return out


def phase_took(tag, t0):
    """Print a phase's seconds since ``t0``; returns the time now."""
    now = time.perf_counter()
    print(f"[{tag}] phase took {now - t0:.1f} s", flush=True)
    return now


def child_processes(pid=None):
    """``(pid, command line)`` of every process that descends from ``pid``
    (this one by default) and has not been reaped, read from /proc."""
    pid = os.getpid() if pid is None else pid
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    parent[int(d)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                pass  # the process ended while /proc was read
    found, todo = [], [pid]
    while todo:
        top = todo.pop()
        kids = [c for c, pp in parent.items() if pp == top]
        found += kids
        todo += kids
    cmds = []
    for c in found:
        try:
            with open(f"/proc/{c}/cmdline", "rb") as f:
                cmds.append((c, f.read().replace(b"\0", b" ").decode(errors="replace").strip()))
        except OSError:
            pass
    return cmds


def sync_ms(fn, reps):
    """Host clock around ``reps`` calls ending in a synchronize, in ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def event_ms(fn, reps):
    """CUDA-event time of ``reps`` calls after a warm-up, in ms per call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: Largest error of each kernel against its twin over the parity checks.
MAX_ERR = {}


def check_val(name, label, got, ref):
    err = (got - ref).abs()
    excess = (err - (VAL_ATOL + VAL_RTOL * ref.abs())).max().item()
    MAX_ERR[name] = max(MAX_ERR.get(name, 0.0), err.max().item())
    print(f"[parity] {name:18s} {label}: max_abs_err {err.max().item():.3e} "
          f"(tol {VAL_ATOL:g} + {VAL_RTOL:g}|ref|)", flush=True)
    if not excess <= 0:
        fail(f"{name} {label} misses its tolerance by {excess:.3e}")


def check_apply(name, label, got, ref, scale):
    """An apply against its twin: ``|got - ref| <= APPLY_ATOL_SCALE * scale
    + APPLY_RTOL |ref|``, ``scale = max_i sum_j |w_ij| |V_j|``; prints the
    largest excess over that tolerance (negative when it holds)."""
    err = (got - ref).abs()
    excess = (err - (APPLY_ATOL_SCALE * scale + APPLY_RTOL * ref.abs())).max().item()
    MAX_ERR[name] = max(MAX_ERR.get(name, 0.0), err.max().item())
    print(f"[parity] {name:18s} {label}: max_abs_err {err.max().item():.3e} "
          f"(tol {APPLY_ATOL_SCALE:g}*{scale:.3g} + {APPLY_RTOL:g}|ref|, max excess {excess:.3e})", flush=True)
    if not excess <= 0:
        fail(f"{name} {label} misses its tolerance by {excess:.3e}")


def check_sums(name, lab, a, b, pot, lw, e, pairs):
    """Raw absorbed sums ``a`` of a kernel that takes one ex2.approx.ftz per
    pair against its twin's ``b``: as a Sinkhorn step reads them, S = f +
    eps (loga - log sums), except the sums that flushed weights could move
    by more than FLUSH_SHARE of themselves (``pairs`` terms each), which are
    compared raw within pairs x 2^-126 plus the relative error the
    potentials' tolerance allows."""
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    a, pot, lw = a.to(b.dtype), pot.to(b.dtype), lw.to(b.dtype)
    flush = pairs.to(b) * FLUSH_WEIGHT
    near = (b > 0) & (flush > FLUSH_SHARE * b)
    s_got, s_ref = ck._absorbed_update(pot, lw, e, a), ck._absorbed_update(pot, lw, e, b)
    check_val(name, f"{lab} ({int(near.sum())} sums within reach of flushed weights compared raw)", s_got[~near],
              s_ref[~near])
    if near.any():
        a, b, tol = a[near], b[near], VAL_ATOL + VAL_RTOL * s_ref[near].abs()
        excess = ((a - b).abs() - (flush[near] + b * torch.expm1(tol / e))).max().item()
        print(f"[parity] {name} {lab}: {int(near.sum())} raw sums, twin sums up to {b.max().item():.3e}, max_abs_err "
              f"{(a - b).abs().max().item():.3e} (tol kept pairs x 2^-126 + the potentials' tolerance, max excess "
              f"{excess:.3e})", flush=True)
        if not excess <= 0:
            fail(f"{name} {lab}: raw sums miss their tolerance by {excess:.3e}")


def value_and_grad(fn, x):
    x = x.detach().clone().requires_grad_(True)
    v = fn(x)
    (g,) = torch.autograd.grad(v, x)
    return v.detach(), g


def rel_errs(v, g, v_ref, g_ref):
    rel_v = abs(v.item() - v_ref.item()) / abs(v_ref.item())
    rel_g = ((g.to(g_ref.dtype) - g_ref).norm() / g_ref.norm()).item()
    return rel_v, rel_g


def check_lse_shapes(tag, rec, clock, card):
    """Kernel 1 at each shape (N, M) a run launched it with (``rec``: its
    recorded ``lse`` calls), on that run's first inputs of the shape:
    against its twin, two calls bitwise equal, and timed beside its bound,
    its issue floor and, for information, the dense PyTorch composition
    ``logsumexp(h - cdist(x, y)^2 / 2 eps)`` where its matrix fits (p = 2)."""
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    shapes = {}
    for args, _ in rec:
        key = (args[0].shape[0], args[1].shape[0])
        shapes.setdefault(key, [0, args])[0] += 1
    for (N, M), (count, args) in sorted(shapes.items()):
        x, y, h, eps, p = (a.detach() if torch.is_tensor(a) else a for a in args)
        got = ck.lse(x, y, h, eps, p)
        check_val("lse", f"{tag} {N}x{M} p={p} ({count} calls)", got, ck.lse_blocked(x, y, h, eps, p))
        if not torch.equal(got, ck.lse(x, y, h, eps, p)):
            fail(f"lse {tag} {N}x{M}: two calls differ")
        pairs = N * M
        b_ms, b_by = bound(pairs, nbytes(x, y, h) + 4 * N, clock)
        slots = pair_slots("lse", math.ceil((x.shape[1] + 1) / 4))
        floor = f", issue floor {issue_ms(slots, pairs, clock):.4f} ms ({slots} slots per pair)" if p == 2 else ""
        dense = ""
        if p == 2 and N * M <= 16384**2:
            d_ms = event_ms(lambda: torch.logsumexp(h[None, :] - torch.cdist(x, y).square() / (2 * eps), dim=1), 5)
            dense = f", dense PyTorch logsumexp over cdist {d_ms:.4f} ms (for information)"
        print(f"[time] lse                {tag} {N}x{M} p={p} ({count} calls): kernel "
              f"{event_ms(lambda: ck.lse(x, y, h, eps, p), 20):.4f} ms, bound {b_ms:.4f} ms ({b_by}){floor}{dense} "
              f"(CUDA events); card {card}", flush=True)


def capture_fine_state(ms, solve):
    """Arguments of the first fine step and the first symmetric fine step
    of one multiscale solve: the sorted clouds, potentials and truncation
    tables the block-sparse kernels get on that path."""
    with recording(ms, ("sinkhorn_step_walk_banded", "sinkhorn_step_walk_banded_sym")) as rec, torch.no_grad():
        solve()
    return first_fine_steps(rec)


def first_fine_steps(rec):
    steps = rec["sinkhorn_step_walk_banded"], rec["sinkhorn_step_walk_banded_sym"]
    if not all(steps):
        fail("the multiscale solve ran no truncated fine step")
    return {"xy": steps[0][0][0], "xx": steps[1][0][0]}


def check_tile_kernels(state, label, rows=None, twin_dtype=None):
    """Kernels 5 and 6 against their twins on the tables of a fine step,
    as the fine step and the extrapolation backward call them; ``rows``:
    only the first ``rows`` row tiles keep their tiles; ``twin_dtype``: the
    twins' dtype (the inputs' by default). Two calls must be bitwise
    equal."""
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    e, xs, ys, la, lb, f, g, cols, cnt, p, tile, _ = state["xy"]
    _, _, _, f_aa, cols_xx, cnt_xx, _, _, _ = state["xx"]
    if rows is not None:
        cnt, cnt_xx = cnt.clone(), cnt_xx.clone()
        cnt[rows:], cnt_xx[rows:] = 0, 0
    label = (f"{label} p={p} tile={tile} ck={cols.shape[1]} "
             f"kept {int(cnt.sum())}/{cols.numel()} (xx {int(cnt_xx.sum())})")
    phi, psi, phx = la + f / e, lb + g / e, la + f_aa / e

    def twin(fn, args):
        if twin_dtype is None:
            return fn(*args)
        return fn(*(a.to(twin_dtype) if torch.is_tensor(a) and a.is_floating_point() else a for a in args))

    def sums_check(lab, a, b, pot, lw, pairs):
        check_sums("absorbed_sum_tiles", lab, a, b, pot, lw, e, pairs)

    for tri, args in (
        (False, (xs, ys, phi, psi, e, cols, cnt, p, tile, False)),
        (True, (xs, xs, phx, phx, e, cols_xx, cnt_xx, p, tile, True)),
    ):
        got, ref = cbs.absorbed_sum_tiles(*args), twin(cbs.absorbed_sum_tiles_blocked, args)
        same = all(torch.equal(a, b) for a, b in zip(got, cbs.absorbed_sum_tiles(*args)))
        if not same:
            fail(f"absorbed_sum_tiles {label}: two calls differ")
        got = [a.to(ref[0].dtype) for a in got]
        # Kept pairs in each row sum and each column sum.
        slot_j = cbs.kept_pairs(args[5], args[6], tri).view(args[5].shape).long()
        row_pairs = ((slot_j >= 0).sum(1) * tile).repeat_interleave(tile)
        col_pairs = (torch.bincount(slot_j[slot_j >= 0], minlength=ys.shape[0] // tile) * tile).repeat_interleave(tile)
        if tri:
            sums_check(f"{label} triangle", got[0] + got[1], ref[0] + ref[1], f_aa, la, row_pairs + col_pairs)
        else:
            for d, (a, b, pot, lw, n) in enumerate(zip(got, ref, (f, g), (la, lb), (row_pairs, col_pairs))):
                sums_check(f"{label} {'xy' if d == 0 else 'yx'}", a, b, pot, lw, n)
    # The dual apply of the extrapolation backward: raw weights, C = 4.
    kind_t = "gibbs" if p == 2 else "gibbs_grad"
    Vy = torch.cat([torch.ones_like(ys[:, :1]), ys], 1)
    Vx = torch.cat([torch.ones_like(xs[:, :1]), xs], 1)
    for tri, args in (
        (False, (xs, ys, phi, psi, Vy, Vx, e, cols, cnt, p, kind_t, tile, False)),
        (True, (xs, xs, phx, phx, Vx, Vx, e, cols_xx, cnt_xx, p, kind_t, tile, True)),
    ):
        got, ref = cbs.gibbs_apply_tiles(*args), twin(cbs.gibbs_apply_tiles_blocked, args)
        same = all(torch.equal(a, b) for a, b in zip(got, cbs.gibbs_apply_tiles(*args)))
        if not same:
            fail(f"gibbs_apply_tiles {label}: two calls differ")
        scales = twin(cbs.gibbs_apply_tiles_blocked, (*args[:4], args[4].abs(), args[5].abs(), *args[6:]))
        for d in range(2):
            check_apply("gibbs_apply_tiles", f"{label}{' triangle' if tri else ''} "
                        f"{'rows' if d == 0 else 'cols'} C=4", got[d].to(ref[d].dtype), ref[d],
                        scales[d].abs().max().item())


# ------------------------------------------------------------------------------
#  10. The MMD losses (kernel 8, kernel 9 on kernel 7's CUDA kernel)
# ------------------------------------------------------------------------------

#: Kernel 8's modes 0-4 as (p, kind). Each takes one MUFU operation per
#: pair: an ex2.approx (modes 0-2; the p = 1 Sinkhorn weights' IEEE sqrt
#: beside it is not counted) or an rsqrt.approx (energy, inv_dist).
SPARSE_MODES = [(2, "gibbs"), (1, "gibbs"), (1, "gibbs_grad"), (1, "energy"), (1, "inv_dist")]


def table_stats(cols, cnt):
    """Kept tiles per row of a table: ``(kept, mean, max, rows at cap)``."""
    c = cnt.clamp(max=cols.shape[1]).double()
    return int(c.sum()), c.mean().item(), int(c.max()), int((c >= cols.shape[1]).sum())


def mmd_reference(fn, x):
    """One MMD call through the float64 plain versions: value, gradient in
    x, the three terms (1/2 <a,Kxx a>, 1/2 <b,Kyy b>, <a,Kxy b>) and the
    larger L2 norm of the gradient's two parts (of the xx and xy terms)."""
    from geomloss_tpu_torch.models import kernel_samples as ks

    x = x.detach().clone().requires_grad_(True)
    with capturing(ks, "scal") as out:
        v = fn(x)
    t_xx, t_yy, t_xy = (t.sum() for t in out)
    (g_self,) = torch.autograd.grad(0.5 * t_xx, x, retain_graph=True)
    (g_cross,) = torch.autograd.grad(t_xy, x)
    terms = (0.5 * t_xx.item(), 0.5 * t_yy.item(), t_xy.item())
    return v.detach(), g_self - g_cross, terms, max(g_self.norm().item(), g_cross.norm().item())


def mmd_tolerance(terms):
    return MMD_LOSS_TOL * sum(abs(t) for t in terms)


def compare_mmd(label, v, g, ref):
    """The float32 kernels against the float64 run, to the term-scaled
    bounds; the plain relative errors too."""
    v_ref, g_ref, terms, g_part = ref
    if g.shape != g_ref.shape or not (torch.isfinite(v) and torch.isfinite(g).all()):
        fail(f"{label}: non-finite or misshapen output")
    err_v = abs(v.item() - v_ref.item())
    err_g = (g.to(g_ref.dtype) - g_ref).norm().item()
    tol_v, tol_g = mmd_tolerance(terms), MMD_GRAD_TOL * g_part
    rel_v, rel_g = rel_errs(v, g, v_ref, g_ref)
    print(f"[mmd] {label}: loss {v.item():.9e} (float64 {v_ref.item():.9e}; terms {terms[0]:.6e}, "
          f"{terms[1]:.6e}, {terms[2]:.6e}): loss err {err_v:.3e} (tol {tol_v:.3e}), grad L2 err {err_g:.3e} "
          f"(tol {tol_g:.3e}); plain relative errors: loss {rel_v:.3e}, grad {rel_g:.3e}", flush=True)
    if not (err_v <= tol_v and err_g <= tol_g):
        fail(f"{label} misses its tolerance")


def check_energy_grad(x, y, v, clock, card, rows=None):
    """Kernel 4's fused energy form (the energy MMD's value and gradient
    channels from one pass) on ``x, y, v``: the value and R against the
    twin (on ``rows`` rows spread over x and the last row block, against
    every column, where ``rows`` is given), R against kernel 4's inv_dist
    apply of ``v [1, y]`` to the bit, two calls bitwise equal; then timed
    beside the energy (mode 3, C = 1) and inv_dist (mode 4) applies it
    replaces, each with its issue floor."""
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    N, M, D = x.shape[0], y.shape[0], x.shape[1]
    z_x, z_y = torch.zeros_like(x[:, 0]), torch.zeros_like(y[:, 0])
    V = ck.ones_points(y, v)
    args = (x, y, z_x, z_y, v, 1.0, 1, "energy_grad")
    S = ck.apply_plan(N, M, D + 2)[1]
    label = f"N={N} M={M} D={D} ({S} column slice{'s' * (S > 1)})"
    val, R = ck.gibbs_apply(*args)
    if rows is None:
        idx = torch.arange(N, device=x.device)
    else:
        spread = torch.linspace(0, N - 1, rows, device=x.device).round().long()
        idx = torch.cat([spread, torch.arange(max(0, N - ck._CUDA_BLOCK), N, device=x.device)]).unique()
        label += f", {idx.numel()} rows held against the twin"
    xs, zs = x[idx], z_x[idx]
    ref_v, ref_R = ck.gibbs_apply_blocked(xs, y, zs, z_y, v, 1.0, 1, "energy_grad")
    check_apply("gibbs_apply", f"{label} energy_grad value", val[idx, None], ref_v[:, None],
                ck.gibbs_apply_blocked(xs, y, zs, z_y, v.abs()[:, None], 1.0, 1, "energy").abs().max().item())
    check_apply("gibbs_apply", f"{label} energy_grad R", R[idx], ref_R,
                ck.gibbs_apply_blocked(xs, y, zs, z_y, V.abs(), 1.0, 1, "inv_dist").abs().max().item())
    if not torch.equal(R, ck.gibbs_apply(x, y, z_x, z_y, V, 1.0, 1, "inv_dist")):
        fail(f"gibbs_apply {label}: the fused energy form's R differs from the inv_dist apply of v [1, y]")
    again = ck.gibbs_apply(*args)
    if not (torch.equal(val, again[0]) and torch.equal(R, again[1])):
        fail(f"gibbs_apply {label} energy_grad: two calls differ")
    kv, pairs = math.ceil(D / 4), N * M
    for what, mode, ch, call in (
        ("energy C=1", 3, 1, lambda: ck.gibbs_apply(x, y, z_x, z_y, v[:, None], 1.0, 1, "energy")),
        (f"inv_dist C={D + 1}", 4, 4, lambda: ck.gibbs_apply(x, y, z_x, z_y, V, 1.0, 1, "inv_dist")),
        (f"energy_grad C=1+{D + 1}", 5, 4, lambda: ck.gibbs_apply(*args)),
    ):
        groups = 1 if ch == 1 else math.ceil((D + 1) / 4)
        slots = pair_slots("gibbs_apply", kv, ch, mode, d3=mode == 5 and D <= 3)
        t = event_ms(call, 3)
        print(f"[time] gibbs_apply        {label} {what} (mode {mode}, {groups} group(s) of {ch}): kernel {t:.3f} ms, "
              f"issue floor {groups * issue_ms(slots, pairs, clock):.3f} ms ({slots} slots per pair and group) "
              f"(CUDA events); card {card}", flush=True)


def check_sparse_apply(label, args, clock, card, time_it=True):
    """Kernel 8 against its twin on one call's arguments; its time beside
    its bound (MUFU operations per kept pair of its mode)."""
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs

    x, y, phi, psi, V, eps, cols, cnt, p, kind, bn, bm = args
    # No autograd graph: the arguments may be a backward pass's leaves.
    with torch.no_grad():
        got = cbs.gibbs_apply_sparse(*args)
        ref = cbs.gibbs_apply_sparse_blocked(*args)
        scale = cbs.gibbs_apply_sparse_blocked(x, y, phi, psi, V.abs(), *args[5:]).abs().max().item()
    check_apply("gibbs_apply_sparse", label, got, ref, scale)
    if not time_it:
        return
    kept = table_stats(cols, cnt)[0] * bn * bm
    b_ms, b_by = bound(kept, nbytes(x, y, phi, psi, V, cols, cnt) + 4 * V.numel() * x.shape[0] // y.shape[0],
                       clock)
    print(f"[time] gibbs_apply_sparse {label}: kernel {event_ms(lambda: cbs.gibbs_apply_sparse(*args), 3):.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by}: one MUFU op x {kept:.4g} kept pairs){sparse_floor(V, p, kind, kept, clock)} "
          f"(CUDA events); card {card}", flush=True)


def sparse_floor(V, p, kind, kept, clock):
    """Kernel 8's issue floor at p = 2 (mode 0) and D <= 3, as text: a
    launch per channel group."""
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    if p != 2 or kind not in ("gibbs", "gibbs_grad"):
        return ""
    G, Cp = ck._channel_groups(V.shape[1])
    slots = pair_slots("gibbs_apply_sparse", ch=G)
    return f", issue floor {issue_ms(slots * (Cp // G), kept, clock):.3f} ms ({slots} slots per pair)"


#: [mmd]: the largest relative gap of the gaussian multiscale value at 1e5
#: (truncate 3) to the online float64 one; 5.1e-5 on the card with the
#: tables that keep every kept tile, 77.6 % with the former widths.
MMD_GAP_TOL = 1e-3


def former_geometry_width(nJ):
    """The default width of a ``masks_from_geometry`` table before it grew
    to the largest kept count (the JAX package's, without its SMEM
    clamp)."""
    return max(8, min(nJ // 8, 128))


@contextlib.contextmanager
def former_geometry_widths(ks):
    """``kernel_samples``' tables at the former default width, for the
    value they gave."""
    build = ks.masks_from_geometry

    def clipped(x, y, radius, block, cap=None, **kw):
        return build(x, y, radius, block, cap=former_geometry_width(y.shape[0] // block) if cap is None else cap, **kw)

    ks.masks_from_geometry = clipped
    try:
        yield
    finally:
        ks.masks_from_geometry = build


def check_unclipped(tag, label, counts, full, former):
    """Fails the phase unless a default table's counts (each direction's)
    equal those of the same table built with every column tile allowed;
    prints its width and kept tiles a row beside the former default width
    ``former``."""
    for got, ref in zip(counts, full):
        if not torch.equal(got, ref):
            fail(f"{label}: the default table drops kept tiles ({int((ref - got).sum())} in "
                 f"{int((got != ref).sum())} rows)")
    c = counts[0].double()
    print(f"[{tag}] {label}: {c.numel()} row tiles, kept tiles a row mean {c.mean().item():.2f} max "
          f"{int(c.max())}, {int((c > former).sum())} rows over the former default width {former}; the same counts "
          f"as the table of every column tile", flush=True)


def check_mid_tables(tag, label, tables, extraps):
    """The mid path's default tables of one solve (``build_tile_masks``'
    and ``extrap_cols``' calls as ``(args, kwargs, result)``) against the
    tables of every column tile, beside their former widths (``mid_cap``,
    ``extrap_cap``), the extrapolation tables' kept tiles beside the JAX
    package's rule's. Returns whether every table kept its former width."""
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.ops import block_sparse as tbs

    same = True
    for k, (args, kwargs, mask) in enumerate(tables):
        tile = args[7]
        nJ, former = args[1].shape[0] // tile, ms.mid_cap(args[0].shape[0], tile)
        with torch.no_grad():
            full = tbs.build_tile_masks(*args, **dict(kwargs, cap=nJ))
        check_unclipped(tag, f"{label} fine table {k} (width {mask.cols.shape[1]})", (mask.counts, mask.countsT),
                        (full.counts, full.countsT), former)
        same &= mask.cols.shape[1] == min(former, nJ)
        del full
    for k, ((x_rows, y_src, h, eps, truncate, bn, bm, *_), kwargs, (cols, counts)) in enumerate(extraps):
        n_src = y_src.shape[0] // bm
        with torch.no_grad():
            full = tbs.extrap_cols(x_rows, y_src, h, eps, truncate, bn, bm, n_src, **kwargs)[1]
            old = tbs.extrap_cols(x_rows, y_src, h, eps, truncate, bn, bm, n_src, **dict(kwargs, radii=False))[1]
        check_unclipped(tag, f"{label} extrapolation table {k} ({n_src} source tiles of {bm}, width {cols.shape[1]})",
                        (counts,), (full,), tbs.extrap_cap(n_src))
        c, o = counts.double(), old.double()
        print(f"[{tag}] {label} extrapolation table {k}: kept source tiles a row mean {c.mean().item():.2f} max "
              f"{int(c.max())}; under the JAX rule (no radius in the upper bound) mean {o.mean().item():.2f} max "
              f"{int(o.max())}: {c.mean().item() / o.mean().item():.3f}x the mean", flush=True)
        same &= cols.shape[1] == tbs.extrap_cap(n_src)
    return same


#: [mid], [gallery]: the largest gap of the multiscale potentials to the
#: same solve whose truncation tables keep every tile (the mid path's fine
#: and extrapolation tables, the classic path's coarse tables), in units of
#: the last eps: ten times the CPU bound of tests/test_torch_mid_keep_rule.py
#: and tests/test_torch_coarse_keep_rule.py (1e-2 eps), for float32 sums
#: taken in another order.
MID_GAP_EPS = 0.1


def pointwise_tiles(args, kwargs, rows, chunk_elems=1 << 26):
    """The tile pairs ``(I, J)`` of row tiles ``rows`` that hold a point
    pair the pointwise keep rule keeps, ``f_i + g_j - C_ij + truncate * eps
    > 0`` between points of positive mass: a ``(len(rows), nJ)`` bool. Only
    the tile pairs that ``build_tile_masks`` keeps with the full radii
    (``eps_min=0``: a lower bound on every pointwise distance) can hold
    one, so only those are evaluated."""
    from geomloss_tpu_torch.ops import block_sparse as tbs

    x, y, f, g, eps, p, truncate, tile = args[:8]
    w_x, w_y = kwargs.get("w_x"), kwargs.get("w_y")
    nJ, D = y.shape[0] // tile, y.shape[1]
    if w_x is not None:
        f = torch.where(w_x > 0, f, -math.inf)
    if w_y is not None:
        g = torch.where(w_y > 0, g, -math.inf)
    cand = tbs.build_tile_masks(*args, **dict(kwargs, eps_min=0.0))
    step = max(1, chunk_elems // (tile * tile))
    out = torch.zeros(len(rows), nJ, dtype=torch.bool, device=x.device)
    for k, I in enumerate(rows):
        xi, fi = x[I * tile:(I + 1) * tile], f[I * tile:(I + 1) * tile]
        js = cand.cols[I, :int(cand.counts[I])].long()
        for j0 in range(0, js.numel(), step):
            jc = js[j0:j0 + step]
            yj, gj = y.view(nJ, tile, D)[jc].reshape(-1, D), g.view(nJ, tile)[jc].reshape(-1)
            d = torch.cdist(xi, yj, compute_mode="donot_use_mm_for_euclid_dist")
            q = fi[:, None] + gj[None, :] - (d * d / 2 if p == 2 else d) + truncate * eps
            out[k, jc] = q.amax(dim=0).reshape(-1, tile).amax(dim=1) > 0
    return out


def kept_before_after(tag, label, tables, sample_rows=8):
    """The kept tiles a row (mean, max) of the mid path's fine tables of one
    solve (``build_tile_masks``' calls as ``(args, kwargs, result)``)
    beside the same tables under the JAX package's rule (``eps_min=inf``:
    no radius subtracted, the tables before the port's rule); on
    ``sample_rows`` row tiles spread over the first table, the tile pairs
    that hold a point pair the pointwise rule keeps and that each rule
    drops."""
    from geomloss_tpu_torch.ops import block_sparse as tbs

    for k, (args, kwargs, mask) in enumerate(tables):
        with torch.no_grad():
            old = tbs.build_tile_masks(*args, **dict(kwargs, eps_min=math.inf))
        c, o = mask.counts.double(), old.counts.double()
        eps_min = kwargs.get("eps_min") or args[4]
        dropped = ""
        if k == 0:
            rows = torch.linspace(0, c.numel() - 1, sample_rows).round().long().tolist()
            with torch.no_grad():
                need = pointwise_tiles(args, kwargs, rows)
            missed = []
            for table in (mask, old):
                kept = torch.zeros_like(need)
                for r, I in enumerate(rows):
                    kept[r, table.cols[I, :int(table.counts[I])].long()] = True
                missed.append(int((need & ~kept).sum()))
            dropped = (f"; on {sample_rows} row tiles spread over the table, {int(need.sum())} tile pairs hold a "
                       f"point pair the pointwise rule keeps: the port's rule drops {missed[0]}, the JAX rule "
                       f"{missed[1]}")
        print(f"[{tag}] {label} fine table {k}: kept tiles a row mean {c.mean().item():.2f} max {int(c.max())} "
              f"(width {mask.cols.shape[1]}); under the JAX rule mean {o.mean().item():.2f} max {int(o.max())} "
              f"(width {old.cols.shape[1]}): {c.mean().item() / o.mean().item():.3f}x the mean; slack "
              f"{tbs.keep_slack(eps_min, args[5], args[6]):.5f} (eps_min {eps_min:.6g}), {c.numel()} row tiles"
              f"{dropped}", flush=True)
        del old


def potential_gap(tag, label, solve, eps, card, targets, tol=None):
    """The largest gap, in units of ``eps``, of the potentials ``solve()``
    returns to those of the same call whose tables of ``targets`` (pairs
    ``(module, name)``: ``masks_from_coarse``, or ``build_tile_masks`` and
    ``extrap_cols``) keep every tile (``tools/keep_rule_gaps_torch.py``),
    with both calls' seconds; fails over ``tol`` (or on a non-finite
    potential)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    from keep_rule_gaps_torch import every_tile_gap

    gap, secs, _, finite = every_tile_gap(solve, targets, eps)
    print(f"[{tag}] {label}: the potentials' largest gap to the every-tile solve {gap:.6g} eps"
          + (f" (limit {tol:g})" if tol is not None else "") + f"; default {secs[0]:.3f} s, every tile {secs[1]:.3f} s "
          f"(host clock); card {card}", flush=True)
    if not finite or (tol is not None and not gap <= tol):
        fail(f"{label}: potentials {'not finite' if not finite else f'{gap:.6g} eps off the every-tile solve'}")
    return gap


def keeping_transfer(calls):
    """A ``gallery_script`` ``prepare`` that keeps each call of the label
    transfer as ``(transfer, args, out)``."""

    def prepare(mod):
        transfer = mod.transfer

        def kept(*args):
            out = transfer(*args)
            calls.append((transfer, args, out))
            return out

        mod.transfer = kept

    return prepare


def check_geometry_tables(label, calls, tabs):
    """Each ``masks_from_geometry`` table of an MMD solve (``calls``, the
    order of ``kernel_samples``: xy, xx, yy) against the table of every
    column tile."""
    from geomloss_tpu_torch.ops import block_sparse as tbs

    for key, (args, kwargs) in zip(("xy", "xx", "yy"), calls):
        mask = tabs[key][3]
        nJ = args[1].shape[0] // args[3]
        with torch.no_grad():
            full = tbs.masks_from_geometry(*args, **dict(kwargs, cap=nJ))
        check_unclipped("mmd", f"gaussian multiscale {label} mask_{key} (width {mask.cols.shape[1]})",
                        (mask.counts, mask.countsT), (full.counts, full.countsT), former_geometry_width(nJ))


def mmd_phase(dev, card, clock, n_small=N_POINTS, n_large=N_MMD_LARGE, large_rows=MID_PARITY_TILES,
              profile=True):
    """Kernel 8 on the real tables, ``softmin_sparse``, and the MMD
    configurations through ``SamplesLoss``. Returns the ``kernels`` entries
    of kernels 8 and 9."""
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models import kernel_samples as ks
    from geomloss_tpu_torch.ops import block_sparse as tbs
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck
    from geomloss_tpu_torch.solvers.sinkhorn_loop import log_weights

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    x0 = torch.from_numpy(sphere_cloud(n_small, 0)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(n_small, 1)).to(dev)
    w = torch.full((n_small,), 1.0 / n_small, dtype=f32, device=dev)
    w64, y64 = w.to(f64), y0.to(f64)
    kw = dict(blur=MMD_BLUR)
    ms_kw = dict(kw, truncate=MMD_TRUNCATE)

    def reset():
        ck.reset_launch_counts()
        cbs.reset_launch_counts()

    def counts():
        return {k: n for k, n in {**ck.launch_counts, **cbs.launch_counts}.items() if n}

    def tables(fn, x, y):
        """The three kernel_matvec_sparse calls of one multiscale MMD
        solve: ``{"xx": ..., "yy": ..., "xy": ...}`` as ``(x_s, y_s, v,
        mask, tile)``, each default table checked against the table of
        every column tile."""
        with recording(ks, ("kernel_matvec_sparse", "masks_from_geometry")) as rec, torch.no_grad():
            fn(x, y)
        out = {}
        for key, (args, kwargs) in zip(("xx", "yy", "xy"), rec["kernel_matvec_sparse"]):
            out[key] = (args[0].detach(), args[1].detach(), args[2].detach(), args[4], kwargs["block"])
        check_geometry_tables(f"N=M={x.shape[0]}", rec["masks_from_geometry"], out)
        return out

    def print_table(label, mask):
        kept, mean, most, at_cap = table_stats(mask.cols, mask.counts)
        print(f"[mmd] {label}: {mask.cols.shape[0]} row tiles, width {mask.cols.shape[1]}, {kept} kept tile "
              f"pairs, kept tiles per row mean {mean:.2f} max {most}, {at_cap} rows at the width", flush=True)
        return most

    # --- Kernel 8 on the real tables of the gaussian multiscale route -----------
    gauss_ms = SamplesLoss("gaussian", backend="multiscale", **ms_kw)
    tab = tables(gauss_ms, x0, y0)
    for key in ("xy", "xx"):
        xs, ys, v, mask, tile = tab[key]
        print_table(f"gaussian multiscale N=M={n_small} mask_{key}", mask)
        zx, zy = torch.zeros_like(xs[:, 0]), torch.zeros_like(ys[:, 0])
        for p, kind in SPARSE_MODES:
            for C in (1, 4):
                V = v[:, None] if C == 1 else v[:, None] * torch.cat([torch.ones_like(ys[:, :1]), ys], 1)
                args = (xs, ys, zx, zy, V, MMD_BLUR**p, mask.cols, mask.counts, p, kind, tile, tile)
                check_sparse_apply(f"N=M={n_small} mask_{key} p={p} {kind} C={C}", args, clock, card)

    # --- softmin_sparse: kernel 7 forward (lse_sparse), kernel 8 backward ---------
    # On the route's own xy table. Its backward reads the transposed table;
    # a default table, which keeps every kept tile (checked above), keeps
    # the same pairs both ways (a clipped one may keep (J, I) and not
    # (I, J): the backward would then meet pairs the forward LSE left out,
    # with weights above 1).
    xs, ys, v, mask, tile = tab["xy"]
    h = log_weights(v)
    sm_entry = {}
    for p in (2, 1):
        eps = MMD_BLUR**p
        lse_args = (xs, ys, h, eps, mask.cols, mask.counts, p, tile, tile)
        check_val("lse_sparse", f"softmin_sparse forward N=M={n_small} p={p}", cbs.lse_sparse(*lse_args),
                  cbs.lse_tiles_blocked(xs, ys, h, eps, mask.cols, mask.counts, tile, tile, p))
        grads = {}
        for impl, dt in (("auto", f32), ("blocked", f32), ("blocked", f64)):
            leaves = [t.detach().to(dt).requires_grad_(True) for t in (xs, ys, h)]
            reset()
            with recording(cbs, ("gibbs_apply_sparse",)) as rec:
                S = tbs.softmin_sparse(eps, (leaves[0], leaves[1], mask), leaves[2], p=p, block=tile, impl=impl)
                grads[impl, dt] = torch.autograd.grad((S * S.detach().sin()).sum(), leaves)
            torch.cuda.synchronize()
            if impl == "auto":
                launches = counts()
                print(f"[mmd] softmin_sparse N=M={n_small} p={p} value and gradients: launches "
                      f"{json.dumps(launches)}", flush=True)
                if not (launches.get("lse_sparse") and launches.get("gibbs_apply_sparse")):
                    fail(f"softmin_sparse p={p} did not run kernels 7 and 8: {launches}")
                if p == 2:
                    sm_entry["launches"] = launches.get("lse_sparse", 0)
                for k, (args, _) in enumerate(rec["gibbs_apply_sparse"]):
                    check_sparse_apply(f"softmin_sparse backward N=M={n_small} p={p} apply {k}", args, clock, card,
                                       time_it=False)
        # The gradients against the float64 plain backward: the kernels no
        # worse than PATH_TOL or twice the float32 plain backward (the
        # ones-channel form cancels in float32 whoever sums it).
        for d, name in enumerate("xyh"):
            ref = grads["blocked", f64][d]
            err_k, err_t = (((grads[key, f32][d].to(f64) - ref).norm() / ref.norm()).item() for key in ("auto", "blocked"))
            print(f"[mmd] softmin_sparse p={p} gradient in {name}: rel L2 err against the float64 plain backward: "
                  f"kernels {err_k:.3e}, float32 plain backward {err_t:.3e} (tol max({PATH_TOL:g}, 2 x plain))",
                  flush=True)
            if not err_k <= max(PATH_TOL, 2 * err_t):
                fail(f"softmin_sparse p={p} gradient in {name} misses its tolerance")
    lse_args = (xs, ys, h, MMD_BLUR**2, mask.cols, mask.counts, 2, tile, tile)
    kept = table_stats(mask.cols, mask.counts)[0] * tile * tile
    sm_entry.update(
        ms=event_ms(lambda: cbs.lse_sparse(*lse_args), 10),
        plain_ms=event_ms(lambda: cbs.lse_tiles_blocked(*lse_args[:6], tile, tile, 2), 1),
        bound=bound(kept, nbytes(xs, ys, h, mask.cols, mask.counts) + 4 * xs.shape[0], clock),
    )
    slots = pair_slots("lse_sparse", math.ceil((xs.shape[1] + 1) / 4))
    print(f"[time] lse_sparse softmin_sparse forward N=M={n_small} p=2 mask_xy: kernel {sm_entry['ms']:.3f} ms, "
          f"twin {sm_entry['plain_ms']:.3f} ms, bound {sm_entry['bound'][0]:.3f} ms ({sm_entry['bound'][1]}), issue "
          f"floor {issue_ms(slots, kept, clock):.3f} ms ({slots} slots per pair) (CUDA events); card {card}", flush=True)

    # Kernel 4's energy and inv_dist modes (the energy route) at n_small: one
    # MUFU operation (rsqrt) per pair.
    z = torch.zeros(n_small, dtype=f32, device=dev)
    V4 = w[:, None] * torch.cat([torch.ones_like(y0[:, :1]), y0], 1)
    for (kind, mode), V in [(km, V) for km in (("energy", 3), ("inv_dist", 4)) for V in (V4[:, :1], V4)]:
        pairs = n_small * n_small
        b_ms, b_by = bound(pairs, nbytes(x0, y0, z, z, V) + 4 * V.numel(), clock)
        slots = pair_slots("gibbs_apply", ch=V.shape[1], mode=mode)
        t = event_ms(lambda: ck.gibbs_apply(x0, y0, z, z, V, 1.0, 1, kind), 3)
        print(f"[time] gibbs_apply        N=M={n_small} {kind} C={V.shape[1]}: kernel {t:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}: 1 MUFU op per pair), issue floor {issue_ms(slots, pairs, clock):.3f} ms "
              f"({slots} slots per pair) (CUDA events); card {card}", flush=True)
    check_energy_grad(x0, y0, w, clock, card)

    # --- The configurations through SamplesLoss ----------------------------------
    configs = {
        "gaussian online": (dict(loss="gaussian", backend="online", **kw), "online", "gaussian"),
        "gaussian multiscale": (dict(loss="gaussian", backend="multiscale", **ms_kw), "multiscale", "gaussian"),
        "energy": (dict(loss="energy", **kw), "online", "energy"),
        "laplacian multiscale": (dict(loss="laplacian", backend="multiscale", **ms_kw), "multiscale", "laplacian"),
    }
    values, refs, k8_launches = {}, {}, 0
    for label, (loss_kw, route, name) in configs.items():
        loss = SamplesLoss(**loss_kw)
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        v, g = value_and_grad(lambda x: loss(x, y0), x0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = counts()
        if label == "gaussian multiscale":
            k8_launches = launches.get("gibbs_apply_sparse", 0)
        want = "gibbs_apply_sparse" if route == "multiscale" else "gibbs_apply"
        if not launches.get(want):
            fail(f"{label}: {want} was never launched ({launches})")
        times = [sync_ms(lambda: value_and_grad(lambda x: loss(x, y0), x0), 1) for _ in range(3)]
        print(f"[mmd] {label} N=M={n_small}: launches {json.dumps(launches)}, first call {first_s:.2f} s, "
              f"loss+grad host clock after the warm-up {', '.join(f'{t:.3f}' for t in times)} ms, peak extra "
              f"device memory {peak / 1e6:.1f} MB; card {card}", flush=True)
        if route == "online":
            fn64 = lambda x: ks.kernel_online(w64[None], x[None], w64[None], y64[None], name=name, impl="blocked",  # noqa: E731
                                              **kw)[0]
        else:
            fn64 = lambda x: ks.kernel_multiscale(w64, x, w64, y64, name=name, impl="blocked", **ms_kw)  # noqa: E731
        refs[label] = mmd_reference(fn64, x0.to(f64))
        compare_mmd(f"{label} N=M={n_small} against the float64 plain versions", v, g, refs[label])
        values[label] = v
    exact = refs["gaussian online"][0].item()
    rel = abs(values["gaussian multiscale"].item() - exact) / abs(exact)
    with former_geometry_widths(ks), torch.no_grad():
        clipped = gauss_ms(x0, y0).item()
    print(f"[mmd] gaussian multiscale (truncate={MMD_TRUNCATE}) against the online float64 value at N=M={n_small}: "
          f"loss rel err {rel:.3e} (the truncation's error, not the kernels'); on tables clipped at the former "
          f"default widths {abs(clipped - exact) / abs(exact):.3e}", flush=True)
    if not rel <= MMD_GAP_TOL:
        fail(f"gaussian multiscale at N=M={n_small} is {rel:.3e} from the online value, over {MMD_GAP_TOL:g}")

    # A user kernel over the same kept tiles, against the named route.
    def gauss(X, Y, blur=0.05):
        return torch.exp(-((X[..., :, None, :] - Y[..., None, :, :]) ** 2).sum(-1) / (2 * blur**2))

    custom = SamplesLoss("gaussian", backend="multiscale", kernel=gauss, **ms_kw)
    reset()
    t0 = time.perf_counter()
    v_c, _ = value_and_grad(lambda x: custom(x, y0), x0)
    torch.cuda.synchronize()
    err = abs(v_c.item() - values["gaussian multiscale"].item())
    tol = mmd_tolerance(refs["gaussian multiscale"][2])
    print(f"[mmd] custom gaussian callable, multiscale N=M={n_small} ({time.perf_counter() - t0:.2f} s, kernel "
          f"launches {sum(counts().values())}): loss {v_c.item():.9e} against the named route "
          f"{values['gaussian multiscale'].item():.9e}: err {err:.3e} (tol {tol:.3e}), relative "
          f"{err / abs(values['gaussian multiscale'].item()):.3e}", flush=True)
    if not err <= tol:
        fail("the custom gaussian callable misses the named route")

    # --- The gaussian multiscale route at n_large: kernel 8 parity only ------------
    xl = torch.from_numpy(sphere_cloud(n_large, 0)).to(dev)
    yl = torch.from_numpy(sphere_cloud(n_large, 1)).to(dev)
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with recording(ks, ("kernel_matvec_sparse", "masks_from_geometry")) as rec:
        v_l, g_l = value_and_grad(lambda x: gauss_ms(x, yl), xl)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = counts()
    check_geometry_tables(f"N=M={n_large}", rec["masks_from_geometry"], {
        key: (args[0], args[1], None, args[4], kwargs["block"])
        for key, (args, kwargs) in zip(("xx", "yy", "xy"), rec["kernel_matvec_sparse"])})
    if g_l.shape != (n_large, 3) or not (torch.isfinite(v_l) and torch.isfinite(g_l).all()):
        fail(f"gaussian multiscale N=M={n_large}: non-finite or misshapen output")
    times = [sync_ms(lambda: value_and_grad(lambda x: gauss_ms(x, yl), xl), 1) for _ in range(3)]
    print(f"[mmd] gaussian multiscale N=M={n_large}: loss {v_l.item():.9e}, launches {json.dumps(launches)}, "
          f"loss+grad host clock after the warm-up {', '.join(f'{t:.3f}' for t in times)} ms, peak extra device "
          f"memory {peak / 1e6:.1f} MB; card {card}", flush=True)
    if profile:
        wall, busy, n_launch, top = profile_busy_ms(lambda: value_and_grad(lambda x: gauss_ms(x, yl), xl))
        print(f"[time] gaussian multiscale loss+grad N=M={n_large} under torch.profiler: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms, idle share {100 * (1 - busy / statistics.median(times)):.1f} % of the median "
              f"host clock, {n_launch} kernel launches; card {card}", flush=True)
        for dev_ms, calls, key in top:
            print(f"[time]   {dev_ms:9.3f} ms {calls:5d} x {key[:90]}", flush=True)
    for key, (args, kwargs) in zip(("xx", "yy", "xy"), rec["kernel_matvec_sparse"]):
        if key == "yy":
            continue
        xs, ys, v, mask, tile = args[0].detach(), args[1].detach(), args[2].detach(), args[4], kwargs["block"]
        most = print_table(f"gaussian multiscale N=M={n_large} mask_{key}", mask)
        print(f"[mmd] for information, mask_{key} at N=M={n_large}: max kept tiles per row {most} "
              f"{'<=' if most <= JAX_GEOMETRY_CAP else '>'} {JAX_GEOMETRY_CAP}, the JAX package's SMEM bound at "
              f"{mask.cols.shape[0]} row tiles: {'its tables are these' if most <= JAX_GEOMETRY_CAP else 'it keeps fewer'}",
              flush=True)
        cnt = mask.counts.clone()
        cnt[large_rows:] = 0
        zx, zy = torch.zeros_like(xs[:, 0]), torch.zeros_like(ys[:, 0])
        for p, kind in SPARSE_MODES:
            for C in (1, 4):
                V = v[:, None] if C == 1 else v[:, None] * torch.cat([torch.ones_like(ys[:, :1]), ys], 1)
                args8 = (xs, ys, zx, zy, V, MMD_BLUR**p, mask.cols, cnt, p, kind, tile, tile)
                check_sparse_apply(f"N=M={n_large} mask_{key} first {large_rows} row tiles p={p} {kind} C={C}",
                                   args8, clock, card, time_it=False)
        if key == "xy":
            geo_args, geo_kwargs = rec["masks_from_geometry"][0]
            former = former_geometry_width(ys.shape[0] // tile)
            clipped = tbs.masks_from_geometry(*geo_args, **dict(geo_kwargs, cap=former))
            for V in (v[:, None], v[:, None] * torch.cat([torch.ones_like(ys[:, :1]), ys], 1)):
                for what, m in (("default table", mask), ("table at the former default width", clipped)):
                    kept = table_stats(m.cols, m.counts)[0] * tile * tile
                    full = (xs, ys, zx, zy, V, MMD_BLUR**2, m.cols, m.counts, 2, "gibbs", tile, tile)
                    b_ms, b_by = bound(kept, nbytes(*full[:5], m.cols, m.counts) + 4 * V.numel(), clock,
                                       flops=2 * (4 + V.shape[1]) * kept)
                    t_k = event_ms(lambda: cbs.gibbs_apply_sparse(*full), 3)
                    print(f"[time] gibbs_apply_sparse N=M={n_large} mask_xy {what} (width {m.cols.shape[1]}, "
                          f"{kept:.4g} kept pairs) p=2 gibbs C={V.shape[1]}: kernel {t_k:.3f} ms, "
                          f"{1e9 * t_k / kept:.4f} ps a kept pair, bound {b_ms:.3f} ms ({b_by})"
                          f"{sparse_floor(V, 2, 'gibbs', kept, clock)} (CUDA events); card {card}", flush=True)
                # The row tiles longest first (the wrapper's order) against their
                # own order, in turns: what the order does to the seam rows' tail.
                rows8 = cbs._dense_rows(mask.cols, mask.counts)
                own = torch.arange(rows8[2].shape[0], dtype=torch.int32, device=dev)
                turns = {"longest first": [], "row order": []}
                for _ in range(2):
                    for label, order in (("longest first", None), ("row order", own)):
                        turns[label].append(event_ms(lambda: cbs._apply_rows(
                            xs, ys, zx, zy, V, MMD_BLUR**2, rows8, 2, "gibbs", tile, tile, "gibbs_apply_sparse",
                            order=order), 3))
                print(f"[time] gibbs_apply_sparse N=M={n_large} mask_xy default table C={V.shape[1]}, in turns: "
                      + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in ts)} ms" for k, ts in turns.items())
                      + f" (CUDA events); card {card}", flush=True)
            del clipped
    del g_l, rec
    torch.cuda.empty_cache()

    # --- Kernel 4's fused energy form at n_large: the energy cell's shape ----------
    # One column slice: the kernel writes the value and R in place.
    check_energy_grad(xl, yl, torch.full((n_large,), 1.0 / n_large, dtype=f32, device=dev), clock, card,
                      rows=ENERGY_GRAD_ROWS)
    del xl, yl
    torch.cuda.empty_cache()

    # --- The kernels line: kernel 8 at the forward apply of the 1e5 route ----------
    xs, ys, v, mask, tile = tab["xy"]
    zx, zy = torch.zeros_like(xs[:, 0]), torch.zeros_like(ys[:, 0])
    fwd = (xs, ys, zx, zy, v[:, None], MMD_BLUR**2, mask.cols, mask.counts, 2, "gibbs", tile, tile)
    kept = table_stats(mask.cols, mask.counts)[0] * tile * tile
    k8_bound = bound(kept, nbytes(*fwd[:5], mask.cols, mask.counts) + 4 * xs.shape[0], clock)
    k8 = dict(ms=event_ms(lambda: cbs.gibbs_apply_sparse(*fwd), 10),
              plain_ms=event_ms(lambda: cbs.gibbs_apply_sparse_blocked(*fwd), 1))
    clipped = tbs.masks_from_geometry(xs, ys, MMD_TRUNCATE * MMD_BLUR, tile,
                                      cap=former_geometry_width(ys.shape[0] // tile), w_x=tab["xx"][2], w_y=v)
    kept_c = table_stats(clipped.cols, clipped.counts)[0] * tile * tile
    t_c = event_ms(lambda: cbs.gibbs_apply_sparse(*fwd[:6], clipped.cols, clipped.counts, *fwd[8:]), 10)
    print(f"[time] gibbs_apply_sparse gaussian multiscale forward N=M={n_small} mask_xy C=1: kernel {k8['ms']:.3f} ms "
          f"(default table, width {mask.cols.shape[1]}, {kept:.4g} kept pairs; at the former default width "
          f"{clipped.cols.shape[1]}, {kept_c:.4g} kept pairs: {t_c:.3f} ms), twin {k8['plain_ms']:.3f} ms, bound "
          f"{k8_bound[0]:.3f} ms ({k8_bound[1]}) (CUDA events); card {card}", flush=True)
    src = "geomloss_tpu_torch/csrc/block_sparse_kernels.cu"
    entries = [
        {"name": "gibbs_apply_sparse", "route": "cuda", "source": src, "replaces": REPLACES["gibbs_apply_sparse"],
         "launches": k8_launches, "max_abs_err": MAX_ERR["gibbs_apply_sparse"], "ms": k8["ms"],
         "plain_ms": k8["plain_ms"], "bound_ms": k8_bound[0], "bound_by": k8_bound[1], "library_ms": None},
        {"name": "lse_sparse", "route": "cuda", "source": src, "replaces": REPLACES["lse_sparse"],
         "launches": sm_entry["launches"], "max_abs_err": MAX_ERR["lse_sparse"], "ms": sm_entry["ms"],
         "plain_ms": sm_entry["plain_ms"], "bound_ms": sm_entry["bound"][0], "bound_by": sm_entry["bound"][1],
         "library_ms": None},
    ]
    print(f"[mmd] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return entries


# ------------------------------------------------------------------------------
#  12. The public sparse and walk Sinkhorn ops (kernels 10-12)
# ------------------------------------------------------------------------------

#: What one multiscale solve is recorded at: the fine phase's tables and its
#: first fine steps.
FINE_CALLS = ("_truncated_fine_phase", "sinkhorn_step_walk_banded", "sinkhorn_step_walk_banded_sym")


def first_step_state(rec):
    """The public ops' inputs at the first fine step of a recorded solve:
    the sorted clouds, log-weights, potentials and eps of that step, and
    its tables as ``TileMask``s, both directions of the xy table (the
    transposed one re-thresholded at that step as the fine phase does the
    other) and the full xx table."""
    from geomloss_tpu_torch.ops import block_sparse as tbs

    args = rec["_truncated_fine_phase"][0][0]
    masks, eps_m, truncate = args[0], args[1], args[8]
    e, xs, ys, la, lb, f, g, cols, cnt, p, tile, _ = rec["sinkhorn_step_walk_banded"][0][0]
    f_aa, cols_xx, cnt_xx = rec["sinkhorn_step_walk_banded_sym"][0][0][3:6]
    width = cols.shape[1]

    def at_step(vals):
        return torch.clamp(tbs.retighten_counts(vals, truncate * (e - eps_m)), max=width)

    if not torch.equal(at_step(masks[0].vals), cnt):
        fail("the recorded fine step's counts are not its table's at that temperature")
    xy = tbs.TileMask(cols, cnt, masks[0].colsT[:, :width].contiguous(), at_step(masks[0].valsT))
    xx = tbs.TileMask(cols_xx, cnt_xx, cols_xx, cnt_xx)
    return dict(e=e, xs=xs, ys=ys, la=la, lb=lb, f=f, g=g, f_aa=f_aa, xy=xy, xx=xx, p=p, tile=tile)


def public_path(st, walk, impl, dt):
    """Two fine iterations (xy, then xx) and the differentiable
    extrapolation through the public ops, over the sparse tables or, with
    ``walk = (tbl, tblT, tbl_xx)``, over walk tables: the outputs
    ``(S_xy, S_yx, S_xx)`` and the gradient in x of the sum of their means."""
    from geomloss_tpu_torch.ops import block_sparse as tbs

    e, p, tile, xy, xx = st["e"], st["p"], st["tile"], st["xy"], st["xx"]
    xs, ys, la, lb, f, g, f_aa = (st[k].to(dt) for k in ("xs", "ys", "la", "lb", "f", "g", "f_aa"))
    with torch.no_grad():
        for _ in range(2):
            if walk is None:
                f, g = tbs.sinkhorn_step_sparse(e, xs, ys, la, lb, f, g, xy, p, tile, impl=impl)
                f_aa = tbs.sinkhorn_step_sparse(e, xs, xs, la, la, f_aa, f_aa, xx, p, tile, sym=True, impl=impl)[0]
            else:
                f, g = tbs.sinkhorn_step_walk(e, xs, ys, la, lb, f, g, walk[0], walk[1], p, tile, impl=impl)
                f_aa = tbs.sinkhorn_step_walk(e, xs, xs, la, la, f_aa, f_aa, walk[2], None, p, tile, sym=True,
                                              impl=impl)[0]
    x = xs.clone().requires_grad_(True)
    if walk is None:
        S_xy, S_yx = tbs.softmin_extrapolation_sparse(x, ys, f, g, la, lb, e, *xy[:4], p, tile, impl)
        S_xx = tbs.softmin_extrapolation_sparse_sym(x, f_aa, la, e, xx.cols, xx.counts, p, tile, impl)
    else:
        S_xy, S_yx = tbs.softmin_extrapolation_walk(x, ys, f, g, la, lb, e, walk[0], walk[1], p, tile, impl)
        S_xx = tbs.softmin_extrapolation_walk_sym(x, f_aa, la, e, walk[2], p, tile, impl)
    (grad,) = torch.autograd.grad(S_xy.mean() + S_yx.mean() + S_xx.mean(), x)
    return (S_xy.detach(), S_yx.detach(), S_xx.detach()), grad


def path_errs(out, grad, ref, st):
    """Relative L2 errors of the outputs (weighted rows only: padding rows
    carry log-weights of -1e5) and of the gradient against a reference."""
    keep = (st["la"] > -1e4, st["lb"] > -1e4, st["la"] > -1e4)
    num = sum(((a.double() - b.double())[k] ** 2).sum() for a, b, k in zip(out, ref[0], keep))
    den = sum((b.double()[k] ** 2).sum() for b, k in zip(ref[0], keep))
    rel_g = ((grad.double() - ref[1].double()).norm() / ref[1].double().norm()).item()
    return (num / den).sqrt().item(), rel_g


#: Calls of each public-op kernel profiled together for its device
#: launches and time per call.
PROFILED = 3


def sparse_phase(dev, card, clock, n_small=N_POINTS, n_mid=N_MID, mid_rows=MID_PARITY_TILES):
    """Kernels 10-12 against their twins on the multiscale path's first
    fine tables, the public sparse and walk ops against their float64
    twins, and the kernels' times. Returns their ``kernels`` entries."""
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.ops import block_sparse as tbs
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    kw = dict(blur=BLUR, diameter=DIAMETER, scaling=SCALING)
    x0 = torch.from_numpy(sphere_cloud(n_small, 0)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(n_small, 1)).to(dev)
    w = torch.full((n_small,), 1.0 / n_small, dtype=f32, device=dev)
    entries = {}

    def walk_tables(st, t_mean):
        xy, xx = st["xy"], st["xx"]
        return (tbs.walk_plan(xy.cols, xy.counts, t_mean), tbs.walk_plan(xy.colsT, xy.countsT, t_mean),
                tbs.walk_plan(xx.cols, xx.counts, t_mean))

    def sums_check(name, label, got, ref, pot, lw, e):
        # As the Sinkhorn step reads them: S = f + eps (loga - log sums).
        check_val(name, label, ck._absorbed_update(pot, lw, e, got), ck._absorbed_update(pot, lw, e, ref))

    def apply_check(name, label, fn, twin, args):
        with torch.no_grad():
            got, ref = fn(*args), twin(*args)
            scale = twin(*args[:4], args[4].abs(), *args[5:]).abs().max().item()
        check_apply(name, label, got, ref, scale)

    def kernel_parity(st, label, rows=None):
        """Kernels 12, 10, 11 and 8 (dense row-start form) against their
        twins; ``rows``: the sub-problem of the first ``rows`` row tiles."""
        e, p, tile, xy, xx = st["e"], st["p"], st["tile"], st["xy"], st["xx"]
        xs, ys = st["xs"], st["ys"]
        phi, psi, phx = st["la"] + st["f"] / e, st["lb"] + st["g"] / e, st["la"] + st["f_aa"] / e
        dirs = {"xy": (xs, ys, phi, psi, xy.cols, xy.counts, st["f"], st["la"]),
                "yx": (ys, xs, psi, phi, xy.colsT, xy.countsT, st["g"], st["lb"]),
                "xx": (xs, xs, phx, phx, xx.cols, xx.counts, st["f_aa"], st["la"])}
        width = xy.cols.shape[1]
        mean_kept = table_stats(xy.cols, xy.counts)[1]
        for d, (a, b, pa, pb, cols, cnt, pot, lw) in dirs.items():
            if rows is not None:
                n = rows * tile
                a, pa, pot, lw, cols, cnt = a[:n], pa[:n], pot[:n], lw[:n], cols[:rows], cnt[:rows]
            lab = f"{label} p={p} tile={tile} mask_{d} kept {int(cnt.sum())}/{cols.numel()}"
            args = (a, b, pa, pb, e, cols, cnt, p, tile)
            got = cbs.absorbed_sum_sparse(*args)
            sums_check("absorbed_sum_sparse", lab, got, cbs.absorbed_sum_sparse_blocked(*args), pot, lw, e)
            if not torch.equal(got, cbs.absorbed_sum_sparse(*args)):
                fail(f"{lab}: two absorbed_sum_sparse calls differ")
            for t_mean in (width, max(1, int(mean_kept // 2))):
                tbl = tbs.walk_plan(cols, cnt, t_mean)
                nI = cols.shape[0]
                on_card, on_host = cbs._walk_rows(tbl, nI), cbs._walk_rows_plain(tbl.cpu(), nI)
                if not all(u.dtype == v.dtype and torch.equal(u.cpu(), v) for u, v in zip(on_card, on_host)):
                    fail(f"{lab}: the CUDA decode of a walk table differs from the CPU decode")
                clipped = int((on_card[2] < torch.clamp(cnt, max=width)).sum())
                wlab = f"{lab} walk t_mean={t_mean} ({clipped} rows clipped)"
                wargs = (a, b, pa, pb, e, tbl, p, tile)
                got_w = cbs.absorbed_sum_walk(*wargs)
                sums_check("absorbed_sum_walk", wlab, got_w, cbs.absorbed_sum_walk_blocked(*wargs), pot, lw, e)
                if not torch.equal(got_w, cbs.absorbed_sum_walk(*wargs)):
                    fail(f"{wlab}: two absorbed_sum_walk calls differ")
                if clipped == 0 and not torch.equal(got_w, got):
                    fail(f"{wlab}: kernel 10 on an unclipped walk differs from kernel 12 on its table")
                if d != "xy":
                    continue
                for pp, kind in SPARSE_MODES:
                    if pp != p and kind in ("gibbs", "gibbs_grad"):
                        continue  # the other p's weights: that solve's state checks them
                    for C in (1, 4):
                        V = torch.ones_like(b[:, :1]) if C == 1 else torch.cat([torch.ones_like(b[:, :1]), b], 1)
                        apply_check("gibbs_apply_walk", f"{wlab} {kind} C={C}", cbs.gibbs_apply_walk,
                                    cbs.gibbs_apply_walk_blocked, (a, b, pa, pb, V, e, tbl, p, kind, tile, tile))
                        if t_mean == width:
                            apply_check("gibbs_apply_sparse", f"{lab} row-start form {kind} C={C}",
                                        cbs.gibbs_apply_sparse, cbs.gibbs_apply_sparse_blocked,
                                        (a, b, pa, pb, V, e, cols, cnt, p, kind, tile, tile))

    def timings(st, where, twin_reps):
        """Kernels 12, 10 and 11 on the xy table (unclipped walk), with
        their bound (one exp2 per kept pair) and issue floor, and the walk
        table's decode (bound: its bytes); the device kernels one call of
        each wrapper launches (torch.profiler), PyTorch's and its own."""
        e, p, tile, xy = st["e"], st["p"], st["tile"], st["xy"]
        xs, ys = st["xs"], st["ys"]
        phi, psi = st["la"] + st["f"] / e, st["lb"] + st["g"] / e
        tbl = tbs.walk_plan(xy.cols, xy.counts, xy.cols.shape[1])
        nI = xy.cols.shape[0]
        V = torch.cat([torch.ones_like(ys[:, :1]), ys], 1)  # the backward's [1, y]
        kept = table_stats(xy.cols, xy.counts)[0] * tile * tile
        out_n = 4 * xs.shape[0]
        kv = math.ceil((xs.shape[1] + 1) / 4)
        calls = {
            "absorbed_sum_sparse": ((xs, ys, phi, psi, e, xy.cols, xy.counts, p, tile), cbs.absorbed_sum_sparse,
                                    cbs.absorbed_sum_sparse_blocked, nbytes(xs, ys, phi, psi, xy.cols, xy.counts) + out_n,
                                    kept, pair_slots("absorbed_sum_sparse", kv)),
            "absorbed_sum_walk": ((xs, ys, phi, psi, e, tbl, p, tile), cbs.absorbed_sum_walk,
                                  cbs.absorbed_sum_walk_blocked, nbytes(xs, ys, phi, psi, tbl) + out_n, kept,
                                  pair_slots("absorbed_sum_walk", kv)),
            "gibbs_apply_walk": ((xs, ys, phi, psi, V, e, tbl, p, "gibbs", tile, tile), cbs.gibbs_apply_walk,
                                 cbs.gibbs_apply_walk_blocked, nbytes(xs, ys, phi, psi, V, tbl) + 4 * out_n, kept,
                                 pair_slots("gibbs_apply_sparse", kv, 4)),
            "walk_rows": ((tbl, nI), cbs._walk_rows, cbs._walk_rows_plain, nbytes(tbl) * 2 + 8 * nI, 0, None),
        }
        out = {}
        for name, (args, fn, twin, nb, exps, slots) in calls.items():
            k_ms = event_ms(lambda: fn(*args), 5)
            t_ms = event_ms(lambda: twin(*args), 1) if twin_reps or name == "walk_rows" else None
            b_ms, b_by = bound(exps, nb, clock)
            # The wrappers' own launches per call, counted exactly, and the
            # device kernels of PROFILED calls under torch.profiler, per call
            # (on the card it has missed some of the decode's short launches).
            cbs.reset_launch_counts()
            fn(*args)
            counted = {k: n for k, n in cbs.launch_counts.items() if n}
            _, dev_ms, n_dev, rows = profile_busy_ms(lambda: [fn(*args) for _ in range(PROFILED)], top=None)
            dev_ms, n_dev = dev_ms / PROFILED, n_dev / PROFILED
            own = {}
            for _, n, key in rows:
                m = re.search(r"\b(sparse_sum_kernel|sum_merge_kernel|walk_rows_kernel|sparse_apply_kernel)\b", key)
                if m:
                    own[m.group(1)] = own.get(m.group(1), 0) + n / PROFILED
            out[name] = dict(ms=k_ms, plain_ms=t_ms, bound_ms=b_ms, bound_by=b_by)
            twin_txt = f"twin {t_ms:.3f} ms, " if t_ms is not None else ""
            floor = f", issue floor {issue_ms(slots, exps, clock):.3f} ms ({slots} slots per pair)" if slots else ""
            print(f"[time] {name:19s} {where} p={p} mask_xy, kept {kept:.4g} pairs of tile {tile}: kernel {k_ms:.4g} ms, "
                  f"{twin_txt}bound {b_ms:.4g} ms ({b_by}: {exps:.4g} exp2, {nb:.4g} bytes){floor} (CUDA events); "
                  f"one call: wrapper launches {json.dumps(counted)}; {n_dev:g} device launches, {dev_ms:.4g} ms of "
                  f"device time, the library's kernels "
                  f"{json.dumps(own)} (torch.profiler); card {card}", flush=True)
        return out

    for p in (2, 1):
        with recording(ms, FINE_CALLS) as rec, torch.no_grad():
            ms.sinkhorn_multiscale(w, x0, w, y0, p=p, **kw)
        st = first_step_state(rec)
        del rec
        xy = st["xy"]
        for key, mask in (("xy rows", (xy.cols, xy.counts)), ("xy cols", (xy.colsT, xy.countsT)),
                          ("xx", (st["xx"].cols, st["xx"].counts))):
            kept, mean, most, at_cap = table_stats(*mask)
            print(f"[sparse] N=M={n_small} p={p} first fine table {key}: {mask[0].shape[0]} row tiles x width "
                  f"{mask[0].shape[1]}, {kept} kept, per row mean {mean:.2f} max {most}, {at_cap} rows at the width",
                  flush=True)
        kernel_parity(st, f"N=M={n_small}")

        # The public path, its kernels counted from zero, against the float64 twins.
        tables = walk_tables(st, xy.cols.shape[1])
        ck.reset_launch_counts()
        cbs.reset_launch_counts()
        out_s = public_path(st, None, "auto", f32)
        out_w = public_path(st, tables, "auto", f32)
        torch.cuda.synchronize()
        launches = {k: n for k, n in cbs.launch_counts.items() if n}
        print(f"[sparse] public sparse and walk ops N=M={n_small} p={p}: launches {json.dumps(launches)}", flush=True)
        for name in ("absorbed_sum_sparse", "absorbed_sum_walk", "gibbs_apply_walk", "gibbs_apply_sparse", "walk_rows"):
            if not launches.get(name):
                fail(f"the public ops at p={p} did not launch {name}: {launches}")
        if p == 2:
            path_launches = launches
        ref = public_path(st, None, "blocked", f64)
        for label, out in (("sparse", out_s), ("walk", out_w)):
            rel_v, rel_g = path_errs(*out, ref, st)
            print(f"[sparse] {label} ops N=M={n_small} p={p} (2 iterations + extrapolation) against the float64 twins: "
                  f"outputs rel L2 err {rel_v:.3e}, grad rel L2 err {rel_g:.3e} (tol {PATH_TOL:g})", flush=True)
            if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
                fail(f"the public {label} ops at p={p} miss their tolerance")
        same = all(torch.equal(a, b) for a, b in zip(out_s[0] + (out_s[1],), out_w[0] + (out_w[1],)))
        rel_v, rel_g = path_errs(*out_w, out_s, st)
        print(f"[sparse] walk ops against sparse ops N=M={n_small} p={p}: bitwise equal {same}, outputs rel L2 "
              f"{rel_v:.3e}, grad rel L2 {rel_g:.3e} (an unclipped walk: required bitwise)", flush=True)
        if not same:
            fail(f"the walk ops at p={p} differ from the sparse ops on an unclipped walk")

        # For information: kernel 5's banded step on the same tables.
        e = st["e"]
        capped = any(bool((c >= m.shape[1]).any()) for m, c in
                     ((xy.cols, xy.counts), (xy.colsT, xy.countsT), (st["xx"].cols, st["xx"].counts)))
        args = (e, st["xs"], st["ys"], st["la"], st["lb"], st["f"], st["g"])
        banded = tbs.sinkhorn_step_walk_banded(*args, xy.cols, xy.counts, p, st["tile"])
        sparse = tbs.sinkhorn_step_sparse(*args, xy, p, st["tile"])
        banded_xx = tbs.sinkhorn_step_walk_banded_sym(e, st["xs"], st["la"], st["f_aa"], st["xx"].cols,
                                                      st["xx"].counts, p, st["tile"])
        sparse_xx = tbs.sinkhorn_step_sparse(e, st["xs"], st["xs"], st["la"], st["la"], st["f_aa"], st["f_aa"],
                                             st["xx"], p, st["tile"], sym=True)[0]
        diffs = [(a - b).abs().max().item() for a, b in zip(banded + (banded_xx,), sparse + (sparse_xx,))]
        print(f"[sparse] for information, kernel 5's banded step against the sparse step on the same tables, "
              f"N=M={n_small} p={p}: max abs diff xy {diffs[0]:.3e}, yx {diffs[1]:.3e}, xx {diffs[2]:.3e}; "
              f"{'a row of a table sits at its width: the two may visit different pairs' if capped else 'no row at its width: the same pairs, asserted to VAL_TOL'}",
              flush=True)
        if not capped and not all(torch.allclose(b, a, rtol=VAL_RTOL, atol=VAL_ATOL) for a, b in
                                  zip(banded + (banded_xx,), sparse + (sparse_xx,))):
            fail(f"the sparse step misses kernel 5's on tables with no row at its width, p={p}")
        if p == 2:
            entries.update(timings(st, f"N=M={n_small}", True))
        del st, tables, out_s, out_w, ref
    del x0, y0, w
    torch.cuda.empty_cache()

    # The first fine table of bench.py's call at n_mid (the mid path).
    xm = torch.from_numpy(sphere_cloud(n_mid, 0)).to(dev)
    ym = torch.from_numpy(sphere_cloud(n_mid, 1)).to(dev)
    auto = SamplesLoss("sinkhorn", p=2, **kw)
    with recording(ms, FINE_CALLS) as rec, torch.no_grad():
        auto(xm, ym)
    st = first_step_state(rec)
    del rec, xm, ym
    kernel_parity(st, f"N=M={n_mid} first {mid_rows} row tiles", rows=mid_rows)
    timings(st, f"N=M={n_mid} full table", False)
    del st
    torch.cuda.empty_cache()

    src = SOURCES["block_sparse_kernels"]
    print(f"[sparse] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return [
        {"name": name, "route": "cuda", "source": src, "replaces": REPLACES[name], "launches": path_launches.get(name, 0),
         "max_abs_err": MAX_ERR[name], **entries[name], "library_ms": None}
        for name in ("gibbs_apply_walk", "absorbed_sum_walk", "absorbed_sum_sparse", "walk_rows")
    ]


# ------------------------------------------------------------------------------
#  11. The auto route at N = M = 4e6 and 1e7 (tile 2048)
# ------------------------------------------------------------------------------


def auto_route_phase(dev, card, n, tag, reps, blur=BLUR, tile=1024, parity_rows=None):
    """bench.py's call at ``n`` points (the mid path, kernels 5 and 6 in
    bounded chunks), at ``blur``: loss, loss + gradient time after the
    warm-up, peak memory, launches and the first fine table's kept tiles
    per row; the fine tables must have tiles of ``tile`` points; with
    ``parity_rows``, kernels 5 and 6 against their float64 twins on that
    many first row tiles of the first fine tables."""
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    auto = SamplesLoss("sinkhorn", p=2, blur=blur, diameter=DIAMETER, scaling=SCALING)
    x = torch.from_numpy(sphere_cloud(n, 0)).to(dev)
    y = torch.from_numpy(sphere_cloud(n, 1)).to(dev)
    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(cbs, tuple(MID_CALLS)) as rec, recording(
            ms, ("sinkhorn_step_walk_banded", "sinkhorn_step_walk_banded_sym")) as rec_ms, calls_of(
            ms, "build_tile_masks") as tables:
        v, g = value_and_grad(lambda x: auto(x, y), x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: n_ for k, n_ in {**ck.launch_counts, **cbs.launch_counts}.items() if n_}
    calls = {k: len(r) for k, r in rec.items()}
    if g.shape != (n, 3) or not (torch.isfinite(v) and torch.isfinite(g).all()):
        fail(f"auto route N=M={n}: non-finite or misshapen output")
    if not all(calls.values()):
        fail(f"auto route N=M={n} did not take the mid path's kernels: {calls}")
    del rec, g
    wall = []
    for _ in range(reps):  # the counted call above was the warm-up
        t0 = time.perf_counter()
        value_and_grad(lambda x: auto(x, y), x)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    state = first_fine_steps(rec_ms)
    cols, cnt = state["xy"][7], state["xy"][8]
    if state["xy"][10] != tile:
        fail(f"auto route N=M={n}: fine tiles of {state['xy'][10]} points, not {tile}")
    kept, mean, most, at_cap = table_stats(cols, cnt)
    print(f"[{tag}] auto route N=M={n} blur {blur} (padded to {cols.shape[0] * tile}, tile {tile}): "
          f"loss {v.item():.9e}, finite gradient; launches {json.dumps(launches)}, calls {json.dumps(calls)}; "
          f"first call {first_s:.2f} s; loss+grad host clock, {reps} reps after the warm-up: "
          f"{', '.join(f'{t:.3f}' for t in wall)} ms; peak device memory {peak_gb:.3f} GB; first fine table "
          f"{cols.shape[0]} row tiles x width {cols.shape[1]}, {kept} kept ({kept * tile * tile:.4g} pairs), per row "
          f"mean {mean:.2f} max {most}, {at_cap} rows at the width; card {card}", flush=True)
    kept_before_after(tag, f"N=M={n}", tables)
    del x, y, rec_ms, tables
    torch.cuda.empty_cache()
    if parity_rows is not None:
        check_tile_kernels(state, f"N=M={n} first {parity_rows} row tiles, float64 twins", rows=parity_rows,
                           twin_dtype=torch.float64)
        print(f"[{tag}] truncate=None is not run at N=M={n}: its fine phase is exact, O(N^2) = "
              f"{float(cols.shape[0] * tile) ** 2:.3g} pairs per step", flush=True)
    del state
    torch.cuda.empty_cache()
    print(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


# ------------------------------------------------------------------------------
#  13. A point dimension above the compiled widths (the wide instantiations)
# ------------------------------------------------------------------------------


def wide_dim_phase(dev, card, clock, n=N_WIDE, d=D_WIDE):
    """``SamplesLoss()`` at D = 32 (the auto route takes the online backend
    for D > 3): its kernels launched, value and gradient against the same
    solve through the float64 twins; kernels 3 and 4 held against their
    twins and kernels 1-4 timed at D = 32."""
    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models.sinkhorn_samples import sinkhorn_online
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    kw = dict(p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING)
    x = torch.from_numpy(sphere_cloud(n, 0, d)).to(dev)
    y = torch.from_numpy(sphere_cloud(n, 1, d)).to(dev)
    loss = SamplesLoss("sinkhorn", **kw)
    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    v, g = value_and_grad(lambda x: loss(x, y), x)
    torch.cuda.synchronize()
    launches = {k: n_ for k, n_ in ck.launch_counts.items() if n_}
    if not all(launches.get(k) for k in ("sinkhorn_step", "sinkhorn_step_sym", "gibbs_apply")):
        fail(f"SamplesLoss at D={d} did not run the online kernels: {launches}")
    w64 = torch.full((1, n), 1.0 / n, dtype=torch.float64, device=dev)
    v_r, g_r = value_and_grad(
        lambda x: sinkhorn_online(w64, x[None], w64, y.double()[None], impl="blocked", **kw)[0], x.double())
    if g.shape != (n, d) or not (torch.isfinite(v) and torch.isfinite(g).all()):
        fail(f"SamplesLoss at D={d}: non-finite or misshapen output")
    rel_v, rel_g = rel_errs(v, g, v_r, g_r)
    t_call = sync_ms(lambda: value_and_grad(lambda x: loss(x, y), x), 3)
    print(f"[wide-d] SamplesLoss() N=M={n} D={d} (kernels 1-4: {math.ceil((d + 1) / 4)} packed float4s a point, "
          f"read from global memory): launches "
          f"{json.dumps(launches)}; loss {v.item():.9e} (float64 twins {v_r.item():.9e}), loss rel err {rel_v:.3e}, "
          f"grad rel L2 err {rel_g:.3e} (tol {PATH_TOL:g}); loss+grad host clock {t_call:.3f} ms (3 reps); "
          f"card {card}", flush=True)
    if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
        fail(f"SamplesLoss at D={d} misses its tolerance")
    la = torch.full((n,), -math.log(n), dtype=torch.float32, device=dev)
    z = torch.zeros_like(la)
    ones_y = torch.cat([torch.ones_like(y[:, :1]), y], 1)
    # Kernels 3 and 4 (wide form) against their twins on the inputs timed
    # below: kernel 3 at p = 1 and 2; kernel 4 in mode 0 (p = 2) and modes
    # 1-4 (p = 1), at C = 1, 4 and 1 + D (the backward's channels).
    for p in (1, 2):
        e = BLUR**p
        label = f"N=M={n} D={d} p={p}"
        check_val("sinkhorn_step_sym", label, ck.sinkhorn_step_sym(x, z, la, e, p),
                  ck.sinkhorn_step_sym_blocked(x, z, la, e, p))
        lse_p = ck.lse_blocked(x, y, la, e, p)
        lse_k = ck.lse(x, y, la, e, p)
        check_val("lse", label, lse_k, lse_p)
        if not torch.equal(lse_k, ck.lse(x, y, la, e, p)):
            fail(f"lse {label}: two calls differ")
        for kind in ("gibbs", "gibbs_grad", "energy", "inv_dist") if p == 1 else ("gibbs",):
            for C in (1, 4, 1 + d):
                V = ones_y[:, 1:2] if C == 1 else ones_y[:, :C]
                if kind in ("energy", "inv_dist"):
                    V = la.exp()[:, None] * V
                args = (x, y, -lse_p, la, V, e, p, kind)
                scale = ck.gibbs_apply_blocked(x, y, -lse_p, la, V.abs(), e, p, kind).abs().max().item()
                check_apply("gibbs_apply", f"{label} {kind} C={C}", ck.gibbs_apply(*args),
                            ck.gibbs_apply_blocked(*args), scale)
    eps = BLUR**2
    lse_ref = ck.lse_blocked(x, y, la, eps, 2)
    # (name, call, bytes, FFMAs per pair: the D of the score, and the
    # apply's C channels)
    for name, call, nb, fma in (
        ("lse", lambda: ck.lse(x, y, la, eps, 2), nbytes(x, y, la) + 4 * n, d),
        ("sinkhorn_step", lambda: ck.sinkhorn_step(x, y, z, z, la, la, eps, 2), nbytes(x, y, z, z, la, la) + 8 * n,
         d),
        ("sinkhorn_step_sym", lambda: ck.sinkhorn_step_sym(x, z, la, eps, 2), nbytes(x, z, la) + 4 * n, d),
        *((f"gibbs_apply C={C}", lambda V=ones_y[:, :C]: ck.gibbs_apply(x, y, -lse_ref, la, V, eps, 2),
           nbytes(x, y, la, la, ones_y[:, :C]) + 4 * C * n, d + C) for C in (4, 1 + d)),
    ):
        pairs = n * (n + 1) // 2 if name == "sinkhorn_step_sym" else n * n
        b_ms, b_by = bound(pairs, nb, clock, flops=2 * fma * pairs)
        print(f"[time] {name:18s} N=M={n} D={d} p=2: kernel {event_ms(call, 5):.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}: {pairs:.4g} exp2, {2 * fma * pairs:.4g} FP32 flops of the {fma} FFMAs per pair) "
              f"(CUDA events); card {card}", flush=True)
    check_energy_grad(x, y, la.exp(), clock, card)
    print(f"[wide-d] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


#: [grid]: ImagesLoss between two batches of 8 images of 256^2 and
#: VolumesLoss between two batches of 2 volumes of 64^3 (BASELINE.json's
#: "256² images and 64³ volumes"), ImagesBarycenter of 4 shapes of 256^2.
GRID_IMAGES = (8, 256, 256)
GRID_VOLUMES = (2, 64, 64, 64)
GRID_BARYCENTER = (1, 4, 256, 256)
GRID_WEIGHTS = (0.4, 0.3, 0.2, 0.1)


def grid_densities(shape, seed, D):
    """float32 sums of three Gaussian bumps (centres in [0.2, 0.8]^D,
    widths 0.04-0.12) on the unit grid of the last D axes, one per leading
    entry, normalized."""
    rng = np.random.RandomState(seed)
    lead, grid = shape[: len(shape) - D], shape[len(shape) - D :]
    axes = np.meshgrid(*[(np.arange(n) + 0.5) / n for n in grid], indexing="ij")
    out = np.zeros(shape)
    for idx in np.ndindex(*lead):
        for _ in range(3):
            c, w = 0.2 + 0.6 * rng.rand(D), 0.04 + 0.08 * rng.rand()
            out[idx] += (0.5 + rng.rand()) * np.exp(-sum((x - ci) ** 2 for x, ci in zip(axes, c)) / (2 * w * w))
        out[idx] /= out[idx].sum()
    return out.astype(np.float32)


def timed_call(fn, reps=5):
    """Medians over ``reps`` calls after a warm-up, in ms: the host clock
    around each call ending in a synchronize, and CUDA events."""
    fn()
    torch.cuda.synchronize()
    host, events = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return float(np.median(host)), float(np.median(events))


def grid_phase(dev, card):
    """The grid path: ``softmin_grid`` at 256^2 and 64^3 against float64
    (and with TF32 enabled by the caller); ``ImagesLoss`` (8 x 256^2),
    ``VolumesLoss`` (2 x 64^3) and ``ImagesBarycenter`` (4 x 256^2), value
    and gradient in float32 against the same calls in float64; the three
    calls timed, with their device launches, idle share and peak memory."""
    from geomloss_tpu_torch import ImagesBarycenter, ImagesLoss, VolumesLoss
    from geomloss_tpu_torch.ops.grid import softmin_grid

    t_phase = time.perf_counter()
    f64 = torch.float64

    # --- softmin_grid, and the caller's TF32 setting -----------------------------------
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    for shape in (GRID_IMAGES, GRID_VOLUMES):
        N = shape[-1]
        h = torch.from_numpy(np.random.RandomState(N).randn(*shape).astype(np.float32)).to(dev)
        for p in (1, 2):
            for eps in (1.0, (1 / N) ** p):
                got = softmin_grid(eps, p, h)
                ref = softmin_grid(eps, p, h.to(f64))
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    got_tf32 = softmin_grid(eps, p, h)
                    kept = torch.backends.cuda.matmul.allow_tf32
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = saved_tf32
                err = (got.to(f64) - ref).abs()
                excess = (err - (VAL_ATOL + VAL_RTOL * ref.abs())).max().item()
                print(f"[grid] softmin_grid {tuple(shape)} p={p} eps={eps:.4g}: max_abs_err {err.max().item():.3e} "
                      f"against float64 (tol {VAL_ATOL:g} + {VAL_RTOL:g}|ref|); with allow_tf32 set by the caller: "
                      f"{'bitwise equal' if torch.equal(got_tf32, got) else 'DIFFERENT'}, setting kept {kept}",
                      flush=True)
                if not excess <= 0:
                    fail(f"softmin_grid {tuple(shape)} p={p} eps={eps:g} misses its tolerance by {excess:.3e}")
                if not torch.equal(got_tf32, got) or kept is not True:
                    fail(f"softmin_grid {tuple(shape)} p={p}: the caller's TF32 setting changed the result or was lost")
    del h, got, ref, got_tf32

    # --- ImagesLoss and VolumesLoss -------------------------------------------------------
    def value_grad(loss, a, b):
        a = a.detach().clone().requires_grad_(True)
        v = loss(a, b)
        (g,) = torch.autograd.grad(v.sum(), a)
        return v.detach(), g

    calls = {}
    for tag, cls, shape in (("images", ImagesLoss, GRID_IMAGES), ("volumes", VolumesLoss, GRID_VOLUMES)):
        a = torch.from_numpy(grid_densities(shape, 0, len(shape) - 1)).to(dev)
        b = torch.from_numpy(grid_densities(shape, 1, len(shape) - 1)).to(dev)
        a64, b64 = a.to(f64), b.to(f64)
        for label, kw in (("p=2", dict(p=2)), ("p=1", dict(p=1)), ("p=2 reach=0.1", dict(p=2, reach=0.1))):
            loss = cls(scaling=0.5, **kw)
            v, g = value_grad(loss, a, b)
            v_r, g_r = value_grad(loss, a64, b64)
            if v.shape != (shape[0],) or not (torch.isfinite(v).all() and torch.isfinite(g).all()):
                fail(f"{cls.__name__} {label}: non-finite or misshapen output")
            rel_v = ((v.to(f64) - v_r).abs() / v_r.abs()).max().item()
            rel_g = ((g.to(f64) - g_r).norm() / g_r.norm()).item()
            print(f"[grid] {cls.__name__}(scaling=0.5, {label}) {tuple(shape)}: losses {v.tolist()} (float64 "
                  f"{v_r.tolist()}), largest loss rel err {rel_v:.3e}, grad rel L2 err {rel_g:.3e} (tol {PATH_TOL:g})",
                  flush=True)
            if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
                fail(f"{cls.__name__} {label} misses its tolerance")
        loss = cls(scaling=0.5, p=2, potentials=True)
        pots, pots_r = loss(a, b), loss(a64, b64)
        rel_p = [((u.to(f64) - r).norm() / r.norm()).item() for u, r in zip(pots, pots_r)]
        print(f"[grid] {cls.__name__}(potentials=True) {tuple(shape)}: rel L2 err of F, G against float64 "
              f"{rel_p[0]:.3e}, {rel_p[1]:.3e} (tol {PATH_TOL:g})", flush=True)
        if not (pots[0].shape == a.shape and max(rel_p) <= PATH_TOL):
            fail(f"{cls.__name__} potentials miss their tolerance")
        calls[f"{cls.__name__} loss+grad {tuple(shape)} p=2"] = (
            lambda loss=cls(scaling=0.5, p=2), a=a, b=b: value_grad(loss, a, b))

    # --- ImagesBarycenter -------------------------------------------------------------------
    m = torch.from_numpy(grid_densities(GRID_BARYCENTER, 2, 2)).to(dev)
    w = torch.tensor([GRID_WEIGHTS], dtype=torch.float32, device=dev)
    cot = torch.from_numpy(np.random.RandomState(3).rand(1, 1, *GRID_BARYCENTER[2:]).astype(np.float32)).to(dev)

    def bar_grad(m, w):
        w = w.detach().clone().requires_grad_(True)
        bar = ImagesBarycenter(m, w)
        (g,) = torch.autograd.grad(bar, w, cot.to(bar.dtype))
        return bar.detach(), g

    bar, g_w = bar_grad(m, w)
    bar_r, g_w_r = bar_grad(m.to(f64), w.to(f64))
    rel_l1 = ((bar.to(f64) - bar_r).abs().sum() / bar_r.abs().sum()).item()
    rel_g = ((g_w.to(f64) - g_w_r).norm() / g_w_r.norm()).item()
    # The mass is held to the float64 run's, not to 1: with the default
    # iteration counts the debiased barycenter has not converged in mass at
    # 256^2, in float64 too (the float64 mass is printed).
    mass, mass_r = bar.sum().item(), bar_r.sum().item()
    rel_m = abs(mass - mass_r) / mass_r
    print(f"[grid] ImagesBarycenter {tuple(GRID_BARYCENTER)} weights {GRID_WEIGHTS} (scaling_N=10, "
          f"backward_iterations=5): rel L1 err {rel_l1:.3e}, weights' grad rel L2 err {rel_g:.3e}, mass {mass:.6f} "
          f"rel err {rel_m:.3e} against float64 (mass {mass_r:.6f}; tol {PATH_TOL:g})", flush=True)
    if not (bar.shape == (1, 1) + GRID_BARYCENTER[2:] and torch.isfinite(bar).all() and torch.isfinite(g_w).all()):
        fail("ImagesBarycenter: non-finite or misshapen output")
    if not (rel_l1 <= PATH_TOL and rel_g <= PATH_TOL and rel_m <= PATH_TOL):
        fail("ImagesBarycenter misses its tolerance against float64")
    calls[f"ImagesBarycenter+grad {tuple(GRID_BARYCENTER)}"] = lambda: bar_grad(m, w)
    del bar_r, g_w_r

    # --- Times, launches, idle share, peak memory ------------------------------------
    for name, fn in calls.items():
        host_ms, event_ms_ = timed_call(fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        wall, busy, n_launch, top = profile_busy_ms(fn, top=4)
        print(f"[time] {name}: median of 5 after a warm-up, host clock {host_ms:.3f} ms, CUDA events "
              f"{event_ms_:.3f} ms; one call under torch.profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
              f"idle share {100 * (1 - busy / host_ms):.1f} % of the host clock, {n_launch} kernel launches; peak "
              f"memory beyond its "
              f"inputs {peak / 1e9:.3f} GB; card {card}", flush=True)
        for dev_ms, n_calls, key in top:
            print(f"[time]   {dev_ms:9.3f} ms {n_calls:5d} x {key[:90]}", flush=True)
    print(f"[grid] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


#: [ot]: ot.solve_sample's streaming route (above 5000^2 cost entries) at
#: N = M = 1e5 in float32 (25 iterations, debias: 4 softmins an iteration
#: and 4 in the last extrapolation, each one launch of kernel 1; the eps =
#: inf initialization is a closed form), and against the float64 twins at
#: 2e4; solve_sample_batch (B = 4) at 1e4; barycenter_sample (K = 3 clouds
#: of 1e4 in D = 3, SamplesLoss's online route); ot.solve, solve_batch and
#: barycenter on dense 4,096 x 4,096 costs; solve_grid at 8 x 256^2 (the
#: pyramid), 2 x 128^2 (axes= / periodic=) and barycenter_grid at 4 x 128^2.
OT_POINTS = 100_000
OT_PARITY_POINTS = 20_000
OT_BATCH = (4, 10_000)
OT_BARYCENTER = (3, 10_000)
OT_DENSE = 4096
OT_ITERS = 25
#: The grid calls run at blur 0.1: a float32 marginal carries the error of
#: f + g - C over eps (one ulp of the potentials is 6e-8 x their size), so
#: eps = 0.01 keeps it near 1e-5, where one pixel of 256 (eps 1.5e-5)
#: would put it at the percent in float32 whatever the solver.
OT_GRID_BLUR = 0.1


def rel_l2(got, ref):
    ref = ref.detach().double()
    return ((got.detach().double() - ref).norm() / ref.norm()).item()


def check_rel(tag, label, errs, tol=PATH_TOL):
    """Print relative errors ``{name: err}`` against float64; fail above
    ``tol``."""
    text = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    print(f"[{tag}] {label}: relative errors against float64: {text} (tol {tol:g})", flush=True)
    bad = [k for k, v in errs.items() if not v <= tol]
    if bad:
        fail(f"{label}: {', '.join(bad)} miss the tolerance {tol:g}")


def ot_phase(dev, card, clock):
    """The ``ot`` API on the card: ``solve_sample``'s streaming route at
    1e5 (kernels 1 and 4, launches against the schedule, both kernels
    against their twins at the route's shapes, loss + gradient time, idle
    share, peak memory), float32 against the float64 twins at 2e4,
    ``solve_sample_batch``, ``barycenter_sample`` (kernels 2-4), the dense
    solvers and the grid solvers, each float32 against float64."""
    from geomloss_tpu_torch import ot
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck
    from geomloss_tpu_torch.solvers.annealing import annealing_parameters, max_diameter

    t_phase = time.perf_counter()
    f64 = torch.float64
    kw = dict(blur=BLUR, max_iter=OT_ITERS, debias=True)

    def apply_launches(args):
        """Launches of one kernel 4 call: one per chunk of row blocks."""
        N, M, C = args[0].shape[0], args[1].shape[0], args[4].shape[1]
        return -(-(-(-N // 256)) // ck.apply_plan(N, M, C)[0])

    # --- solve_sample's streaming route at 1e5 ------------------------------------------
    xa = torch.from_numpy(sphere_cloud(OT_POINTS, 0)).to(dev).requires_grad_()
    xb = torch.from_numpy(sphere_cloud(OT_POINTS, 1)).to(dev)
    V1 = torch.from_numpy(np.random.RandomState(5).randn(OT_POINTS).astype(np.float32)).to(dev)
    V3 = torch.from_numpy(np.random.RandomState(6).randn(OT_POINTS, 3).astype(np.float32)).to(dev)

    def route():
        res = ot.solve_sample(xa, xb, **kw)
        (g,) = torch.autograd.grad(res.value, xa)
        outs = (res.value, g, res.marginal_a, res.marginal_b, res.a_to_b, res.value_linear,
                res.lazy_plan @ V1, res.lazy_plan @ V3)
        return res, outs

    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    t0 = time.perf_counter()
    with recording(ck, ("lse", "gibbs_apply")) as rec:
        res, outs = route()
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {**ck.launch_counts, **{k: v for k, v in cbs.launch_counts.items() if v}}
    n_sched = len(annealing_parameters(maxmin_cost=max_diameter(xa.detach(), xb) ** 2, eps=2 * BLUR**2,
                                       n_iter=OT_ITERS).eps_list)
    want_lse = 4 * n_sched + 4
    want_apply = sum(apply_launches(a) for a, _ in rec["gibbs_apply"])
    widths = sorted({a[4].shape[1] for a, _ in rec["gibbs_apply"]})
    print(f"[ot] solve_sample(blur={BLUR}, max_iter={OT_ITERS}, debias=True) N=M={OT_POINTS} streaming, value, "
          f"grad in X_a, marginal_a/b, a_to_b, value_linear, lazy_plan @ V (C = 1, 3): {first_s:.2f} s (first "
          f"call), launches {json.dumps(launches)}; schedule {n_sched} iterations -> kernel 1 expected {want_lse} "
          f"({len(rec['lse'])} lse calls), kernel 4 expected {want_apply} ({len(rec['gibbs_apply'])} calls, "
          f"channels {widths})", flush=True)
    if not (launches["lse"] == want_lse == len(rec["lse"]) and launches["gibbs_apply"] == want_apply > 0):
        fail(f"ot.solve_sample at N=M={OT_POINTS}: launches {launches} do not match the schedule "
             f"(kernel 1 {want_lse}, kernel 4 {want_apply})")
    if any(n for k, n in launches.items() if k not in ("lse", "gibbs_apply")):
        fail(f"ot.solve_sample launched a kernel off its route: {launches}")
    v, g = outs[0], outs[1]
    shapes_ok = (v.shape == () and g.shape == (OT_POINTS, 3) and outs[4].shape == (OT_POINTS, 3)
                 and outs[7].shape == (OT_POINTS, 3))
    if not (shapes_ok and all(bool(torch.isfinite(t).all()) for t in outs)):
        fail("ot.solve_sample at 1e5: non-finite or misshapen outputs")
    mass = (outs[2].sum().item(), outs[3].sum().item())
    print(f"[ot] value {v.item():.9e}, value_linear {outs[5].item():.9e}, marginal masses {mass[0]:.6f} / "
          f"{mass[1]:.6f}; card {card}", flush=True)
    if not all(abs(m - 1) <= 1e-2 for m in mass):
        fail(f"ot.solve_sample at 1e5: the plan's marginals carry mass {mass}, not 1")

    # Kernels 1 and 4 against their twins at the route's shapes (not counted):
    # kernel 1's first call (the first iteration) and last (the last
    # extrapolation, at the final eps), kernel 4's first at C = 1 and 3.
    for which, (args, _) in (("first", rec["lse"][0]), ("last", rec["lse"][-1])):
        check_val("lse", f"ot.solve_sample route, {which} call {args[0].shape[0]}x{args[1].shape[0]} "
                  f"eps={args[3]:.4g}", ck.lse(*args), ck.lse_blocked(*args))
    N = OT_POINTS
    k_ms = event_ms(lambda: ck.lse(*args), 5)
    b_ms, b_by = bound(N * N, nbytes(*args[:3]) + 4 * N, clock)
    print(f"[time] lse                ot route N=M={N}: kernel {k_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}) (CUDA "
          f"events); card {card}", flush=True)
    timed = {}
    for C in (1, 3):
        a = next(a for a, _ in rec["gibbs_apply"] if a[4].shape[1] == C)
        scale = ck.gibbs_apply_blocked(*a[:4], a[4].abs(), *a[5:]).abs().max().item()
        check_apply("gibbs_apply", f"ot.solve_sample route {a[0].shape[0]}x{a[1].shape[0]} {a[7]} C={C}",
                    ck.gibbs_apply(*a), ck.gibbs_apply_blocked(*a), scale)
        timed[C] = a
    del rec, args
    for C, a in timed.items():
        k_ms = event_ms(lambda: ck.gibbs_apply(*a), 10)
        t_ms = event_ms(lambda: ck.gibbs_apply_blocked(*a), 2)
        b_ms, b_by = bound(N * N, nbytes(*a[:5]) + 4 * N * C, clock)
        slots = pair_slots("gibbs_apply", ch=ck._channel_groups(C)[0])
        print(f"[time] gibbs_apply        ot route N=M={N} C={C}: kernel {k_ms:.3f} ms, twin {t_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}), issue floor {issue_ms(slots, N * N, clock):.3f} ms ({slots} slots per pair) "
              f"(CUDA events); card {card}", flush=True)
    del timed, a

    def loss_grad():
        r = ot.solve_sample(xa, xb, **kw)
        return torch.autograd.grad(r.value, xa)

    host_ms, ev_ms = timed_call(loss_grad, reps=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss_grad()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    wall, busy, n_launch, top = profile_busy_ms(loss_grad, top=4)
    print(f"[time] ot.solve_sample loss+grad N=M={OT_POINTS} (streaming, {n_sched} iterations, debias): median of 3 "
          f"after a warm-up, host clock {host_ms:.3f} ms, CUDA events {ev_ms:.3f} ms; one call under "
          f"torch.profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share {100 * (1 - busy / host_ms):.1f} "
          f"% of the host clock, {n_launch} kernel launches; peak memory beyond its inputs {peak / 1e9:.3f} GB; card "
          f"{card}",
          flush=True)
    for dev_ms, n_calls, key in top:
        print(f"[time]   {dev_ms:9.3f} ms {n_calls:5d} x {key[:90]}", flush=True)
    del res, outs, xa, xb, V1, V3
    torch.cuda.empty_cache()

    # --- float32 kernels against the float64 twins at 2e4 (still streaming) -----------
    def sample_outputs(x, y):
        x = x.detach().clone().requires_grad_()
        r = ot.solve_sample(x, y, **kw)
        (g,) = torch.autograd.grad(r.value, x)
        return {"value": r.value, "grad": g, "potential_a": r.potential_a, "potential_b": r.potential_b,
                "a_to_b": r.a_to_b, "marginal_a": r.marginal_a}

    x = torch.from_numpy(sphere_cloud(OT_PARITY_POINTS, 2)).to(dev)
    y = torch.from_numpy(sphere_cloud(OT_PARITY_POINTS, 3)).to(dev)
    ck.reset_launch_counts()
    got = sample_outputs(x, y)
    n1, n4 = ck.launch_counts["lse"], ck.launch_counts["gibbs_apply"]
    with plain_twins():
        ref = sample_outputs(x.to(f64), y.to(f64))
    if not (n1 and n4) or ck.launch_counts["lse"] != n1:
        fail(f"solve_sample at 2e4: kernels 1/4 launched {n1}/{n4} times, or a twin run launched a kernel")
    check_rel("ot", f"solve_sample N=M={OT_PARITY_POINTS} float32 kernels (kernel 1 x {n1}, kernel 4 x {n4}); "
              f"loss, then relative L2", {k: rel_l2(got[k], ref[k]) for k in got})

    # --- solve_sample_batch at B = 4 x 1e4 (streaming) ----------------------------------
    B, n = OT_BATCH
    X = torch.from_numpy(np.stack([sphere_cloud(n, 10 + i) for i in range(B)])).to(dev)
    Y = torch.from_numpy(np.stack([sphere_cloud(n, 20 + i) for i in range(B)])).to(dev)

    def batch_outputs(X, Y):
        rs = ot.solve_sample_batch(X, Y, **kw)
        return {"values": torch.stack([r.value for r in rs]), "potential_a": torch.stack([r.potential_a for r in rs]),
                "marginal_b": torch.stack([r.marginal_b for r in rs])}

    ck.reset_launch_counts()
    host_ms, ev_ms = timed_call(lambda: batch_outputs(X, Y), reps=1)
    got = batch_outputs(X, Y)
    n1 = ck.launch_counts["lse"]
    with plain_twins():
        ref = batch_outputs(X.to(f64), Y.to(f64))
    errs = {"values (largest)": ((got["values"].double() - ref["values"]).abs() / ref["values"].abs()).max().item(),
            "potential_a": rel_l2(got["potential_a"], ref["potential_a"]),
            "marginal_b": rel_l2(got["marginal_b"], ref["marginal_b"])}
    check_rel("ot", f"solve_sample_batch B={B} N=M={n} (kernel 1 x {n1} over 3 calls; one call {host_ms:.1f} ms "
              f"host, {ev_ms:.1f} ms events; card {card})", errs)
    del X, Y

    # --- barycenter_sample: K = 3 clouds of 1e4, SamplesLoss online (kernels 2-4) -------
    K, n = OT_BARYCENTER
    rng = np.random.RandomState(7)
    xs = np.stack([sphere_cloud(n, 30 + k) * (0.5 + 0.5 * k) + rng.randn(3) for k in range(K)]).astype(np.float32)
    xs = torch.from_numpy(xs).to(dev)
    w = torch.tensor([0.5, 0.3, 0.2], device=dev)
    bkw = dict(blur=BLUR, n_iter=3)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    bar = ot.barycenter_sample(xs, weights=w, **bkw)
    torch.cuda.synchronize()
    bar_s = time.perf_counter() - t0
    bl = dict(ck.launch_counts)
    with plain_twins():
        bar_r = ot.barycenter_sample(xs.to(f64), weights=w.to(f64), **bkw)
    if not all(bl[k] > 0 for k in ("sinkhorn_step", "sinkhorn_step_sym", "gibbs_apply")):
        fail(f"barycenter_sample did not run the online route's kernels 2-4: {bl}")
    if bar.samples.shape != (n, 3) or not bool(torch.isfinite(bar.samples).all()):
        fail("barycenter_sample: non-finite or misshapen support")
    check_rel("ot", f"barycenter_sample K={K} N={n} n_iter=3 ({bar_s:.2f} s, launches {json.dumps(bl)}; card "
              f"{card})", {"samples": rel_l2(bar.samples, bar_r.samples)})
    del xs, bar, bar_r

    # --- Dense solvers: 4,096 x 4,096 costs (no kernel) ---------------------------------
    def sqd(u, v):
        return ((u[:, None, :] - v[None, :, :]) ** 2).sum(-1)

    pts = [torch.from_numpy(sphere_cloud(OT_DENSE, 40 + i)).to(dev) for i in range(4)]
    C = sqd(pts[0], pts[1])
    Cb = torch.stack([C, sqd(pts[2], pts[3])])
    cost = torch.stack([sqd(pts[1], pts[0]), sqd(pts[2], pts[0])])  # (K, N, M) onto pts[0]
    cost_bar = sqd(pts[0], pts[0])
    dense = {
        "solve": lambda dt: (lambda r: {"value": r.value, "plan": r.plan, "potential_a": r.potential_a})(
            ot.solve(C.to(dt), reg=0.01, max_iter=100)),
        "solve_batch": lambda dt: (lambda r: {"values": r.value, "marginal_a": r.marginal_a})(
            ot.solve_batch(Cb.to(dt), reg=0.01, max_iter=100)),
        "barycenter": lambda dt: {"masses": ot.barycenter(cost.to(dt), reg=0.01, max_iter=100,
                                                          cost_bar=cost_bar.to(dt)).masses},
    }
    ck.reset_launch_counts()
    for name, fn in dense.items():
        host_ms, ev_ms = timed_call(lambda: fn(torch.float32), reps=1)
        got, ref = fn(torch.float32), fn(f64)
        check_rel("ot", f"{name} {OT_DENSE}x{OT_DENSE} ({host_ms:.1f} ms host, {ev_ms:.1f} ms events; card {card})",
                  {k: rel_l2(got[k], ref[k]) for k in got})
    if any(ck.launch_counts.values()):
        fail(f"the dense solvers launched a kernel: {ck.launch_counts}")
    del pts, C, Cb, cost, cost_bar, got, ref

    # --- Grid solvers ---------------------------------------------------------------------
    a8 = torch.from_numpy(grid_densities(GRID_IMAGES, 0, 2)).to(dev)
    b8 = torch.from_numpy(grid_densities(GRID_IMAGES, 1, 2)).to(dev)
    a2 = torch.from_numpy(grid_densities((2, 128, 128), 2, 2)).to(dev)
    b2 = torch.from_numpy(grid_densities((2, 128, 128), 3, 2)).to(dev)
    m4 = torch.from_numpy(grid_densities((1, 4, 128, 128), 4, 2)).to(dev)
    grid = {
        f"solve_grid pyramid {tuple(a8.shape)}": lambda dt: (lambda r: {"values": r.value, "marginal_a": r.marginal_a})(
            ot.solve_grid(a8.to(dt), b8.to(dt), blur=OT_GRID_BLUR)),
        f"solve_grid axes=(0, 2), periodic {tuple(a2.shape)}": lambda dt: (
            lambda r: {"values": r.value, "marginal_a": r.marginal_a, "potential_a": r.potential_a})(
            ot.solve_grid(a2.to(dt), b2.to(dt), axes=(0.0, 2.0), periodic=True, blur=2 * OT_GRID_BLUR)),
        f"barycenter_grid {tuple(m4.shape)}": lambda dt: {"barycenter": ot.barycenter_grid(
            m4.to(dt), torch.tensor([GRID_WEIGHTS], dtype=dt, device=dev))},
    }
    for name, fn in grid.items():
        host_ms, ev_ms = timed_call(lambda: fn(torch.float32), reps=1)
        got, ref = fn(torch.float32), fn(f64)
        errs = {k: (((got[k].double() - ref[k]).abs() / ref[k].abs()).max().item() if k == "values"
                    else rel_l2(got[k], ref[k])) for k in got}
        check_rel("ot", f"{name} ({host_ms:.1f} ms host, {ev_ms:.1f} ms events; card {card})", errs)
    print(f"[ot] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


# ------------------------------------------------------------------------------
#  16. parallel: the ring and the row-sharded multiscale solve
# ------------------------------------------------------------------------------

#: The calls of [parallel] and their points; each runs on one rank, then on
#: the spawned ranks of PARALLEL_RUNS (call, ranks), the first two first.
PARALLEL_CALLS = {"sharded 2e6": N_MID, "sharded 1e5": N_POINTS, "ring 1e5": N_RING, "mmd ring 1e5": N_RING}
PARALLEL_RUNS = [("sharded 2e6", 2), ("ring 1e5", 2), ("mmd ring 1e5", 2), ("sharded 1e5", 4), ("ring 1e5", 4),
                 ("mmd ring 1e5", 4)]


def parallel_fn(name, mesh, dev):
    """``(x0, loss of x)`` of one [parallel] call on ``mesh``: bench.py's
    clouds and Sinkhorn settings (the gaussian MMD at MMD_BLUR)."""
    from geomloss_tpu_torch import parallel as par

    n = PARALLEL_CALLS[name]
    x0 = torch.from_numpy(sphere_cloud(n, 0)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(n, 1)).to(dev)
    w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    kw = dict(p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING)
    if name.startswith("sharded"):
        return x0, lambda x: par.sinkhorn_multiscale_sharded(w, x, w, y0, mesh=mesh, **kw)
    if name.startswith("ring"):
        return x0, lambda x: par.sinkhorn_ring(w, x, w, y0, mesh=mesh, **kw)
    return x0, lambda x: par.kernel_ring(w, x, w, y0, name="gaussian", blur=MMD_BLUR, mesh=mesh)


def run_parallel_call(name, mesh, dev, profile):
    """One [parallel] call on this rank, as every rank of ``mesh`` runs it:
    value and gradient with the launches and the calls of kernels 1, 4, 5,
    6 and 7 counted from zero and the peak memory, then the median of 3
    timed calls (host clock and CUDA events) and, where ``profile``, the
    idle share of one call under torch.profiler (the other ranks run it
    plainly)."""
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    x0, fn = parallel_fn(name, mesh, dev)
    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(cbs, tuple(MID_CALLS)) as rec_cbs, recording(ck, ("lse", "gibbs_apply")) as rec_ck:
        v, g = value_and_grad(fn, x0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    out = {
        "value": v.item(), "grad": g.cpu(), "first_s": first_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": {k: n for k, n in {**ck.launch_counts, **cbs.launch_counts}.items()
                     if k in ("lse", "gibbs_apply", *MID_CALLS)},
        "calls": {k: len(c) for k, c in {**rec_ck, **rec_cbs}.items()},
    }
    del rec_cbs, rec_ck
    out["host_ms"], out["event_ms"] = timed_call(lambda: value_and_grad(fn, x0), reps=3)
    if profile:
        wall, busy, n_launch, _ = profile_busy_ms(lambda: value_and_grad(fn, x0))
        out["idle"] = (wall, busy, n_launch)
    else:
        value_and_grad(fn, x0)
        torch.cuda.synchronize()
    return out


def _parallel_rank(rank, world, store, out_path, dev):
    """A [parallel] rank on the card ``dev``, run as ``python chip_smoke.py
    PARALLEL_RANK_ARG rank world store out_path dev``: gloo, the groups of
    the first two ranks and of all four, every run of PARALLEL_RUNS on its
    group; pickles ``("ok", results)`` or ``("error", traceback)`` to
    ``out_path`` and returns whether it ran."""
    import datetime
    import pickle
    import traceback

    import torch.distributed as dist

    dev = torch.device(dev)
    try:
        from geomloss_tpu_torch import parallel as par

        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=PARALLEL_DEADLINE))
        groups = {2: dist.new_group([0, 1]), world: None}
        out = {}
        for size in sorted(groups):
            dist.barrier()  # the other ranks stay off the card while a group runs
            if rank >= size:
                continue
            mesh = par.points_mesh(groups[size], device=dev, backend="gloo")
            for name, r in PARALLEL_RUNS:
                if r == size:
                    res = run_parallel_call(name, mesh, dev, profile=rank == 0)
                    grad = res.pop("grad")
                    res["grad_sum"] = grad.double().sum().item()
                    if rank == 0:
                        res["grad"] = grad.numpy()
                    out[name, r] = res
        dist.barrier()
        result = ("ok", out)
    except BaseException:
        result = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".part", out_path)
    return result[0] == "ok"


def spawn_parallel_ranks(world, store, dev):
    """Run ``world`` ranks of :func:`_parallel_rank`, each a child process
    of this script (``subprocess``: no helper process of ``multiprocessing``
    outlives the phase), and collect their results within
    PARALLEL_DEADLINE; fails if a rank raises, dies or overruns. Every rank
    has exited, or been terminated and waited for, when this returns."""
    import pickle

    outs = [f"{store}_rank{r}.pkl" for r in range(world)]
    for path in outs:
        if os.path.exists(path):
            os.remove(path)
    script = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, script, PARALLEL_RANK_ARG, str(r), str(world), store, outs[r],
                               str(dev)]) for r in range(world)]
    t0 = time.perf_counter()

    def errors():
        """The tracebacks that the ranks wrote."""
        found = []
        for r, path in enumerate(outs):
            if os.path.exists(path):
                with open(path, "rb") as f:
                    status, out = pickle.load(f)
                if status != "ok":
                    found.append(f"rank {r}: {out}")
        return found

    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() - t0 > PARALLEL_DEADLINE:
                fail(f"[parallel] the {world} ranks did not finish within {PARALLEL_DEADLINE} s")
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
        codes = [p.returncode for p in procs]
        if any(c != 0 for c in codes):
            fail(f"[parallel] ranks exited with codes {codes}:\n" + "\n".join(errors()))
        got = {}
        for r, path in enumerate(outs):
            with open(path, "rb") as f:
                got[r] = pickle.load(f)[1]
        for out in got[0].values():
            out["grad"] = torch.from_numpy(out["grad"])
        return got
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def report_parallel(name, R, backend, res, schedule, card):
    """Print one [parallel] run of rank 0 (launches and calls per rank
    against the schedule, times, peak memory, idle share); fails where a
    rank's calls differ from the schedule."""
    r0 = res[0]
    print(f"[parallel] {name} backend {backend} R={R}: loss {r0['value']:.9e}; loss+grad median of 3 "
          f"{r0['host_ms']:.3f} ms host clock, {r0['event_ms']:.3f} ms CUDA events (first call "
          f"{r0['first_s']:.2f} s), peak device memory {r0['peak_gb']:.3f} GB (rank 0's process); card {card}",
          flush=True)
    if "idle" in r0:
        wall, busy, n_launch = r0["idle"]
        print(f"[parallel] {name} R={R} rank 0 under torch.profiler: wall {wall:.3f} ms, its device busy "
              f"{busy:.3f} ms, idle share {100 * (1 - busy / r0['host_ms']):.1f} % of the host clock, {n_launch} "
              f"kernel launches", flush=True)
    for rank, rr in sorted(res.items()):
        print(f"[parallel] {name} R={R} rank {rank}: launches {json.dumps(rr['launches'])}, calls "
              f"{json.dumps(rr['calls'])} (schedule: calls {json.dumps(schedule)})", flush=True)
        if any(rr["calls"].get(k, 0) != n for k, n in schedule.items()):
            fail(f"[parallel] {name} R={R} rank {rank}: calls {rr['calls']} differ from the schedule {schedule}")
        if any(rr["launches"][k] < n for k, n in schedule.items()):
            fail(f"[parallel] {name} R={R} rank {rank}: launches {rr['launches']} below the schedule {schedule}")
        if rr["value"] != r0["value"] or rr.get("grad_sum", 0.0) != r0.get("grad_sum", 0.0):
            fail(f"[parallel] {name} R={R}: rank {rank}'s loss or gradient differs from rank 0's")


def ring_schedule(name, R):
    """Calls of kernels 1 and 4 on each rank of a ring call with the
    gradient in x: a softmin is R kernel-1 calls, 4 at eps0, 4 an
    iteration and 4 in the last extrapolation; its backward takes R kernel-4
    calls for each of the two softmins of x (f_ba, f_aa). The MMD: three
    matvecs of R calls, two of them differentiated in x."""
    from geomloss_tpu_torch.solvers.annealing import epsilon_schedule

    if name.startswith("mmd"):
        return {"lse": 0, "gibbs_apply": 5 * R}
    n_softmin = 4 * (len(epsilon_schedule(2, DIAMETER, BLUR, SCALING)) + 2)
    return {"lse": n_softmin * R, "gibbs_apply": 2 * R}


def check_offset_kernels(state, card):
    """Kernels 5 and 6 on shard OFFSET_SHARD of OFFSET_SHARDS of a fine
    step's triangle table (row offset > 0, against the whole cloud) against
    their twins; then every shard's sums added up against the whole
    table's, kernels only."""
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs

    e, xs, _, la, _, _, _, _, _, p, tile, _ = state["xy"]
    f_aa, cols, cnt = state["xx"][3:6]
    nI = cols.shape[0]
    n_l = nI // OFFSET_SHARDS
    phx = la + f_aa / e

    def shard_args(r):
        """Kernel 5's arguments as rank ``r`` makes them."""
        rows, pts = slice(r * n_l, (r + 1) * n_l), slice(r * n_l * tile, (r + 1) * n_l * tile)
        return (xs[pts], xs, phx[pts], phx, e, cols[rows], cnt[rows], p, tile, True, r * n_l)

    args = shard_args(OFFSET_SHARD)
    x_l, _, ph_l, _, _, c_l, n_cnt, _, _, _, off = args
    pts = slice(off * tile, (off + n_l) * tile)
    label = f"N=M={N_POINTS} p={p} triangle shard {OFFSET_SHARD} of {OFFSET_SHARDS} (row offset {off} of {nI} tiles)"
    got, ref = cbs.absorbed_sum_tiles(*args), cbs.absorbed_sum_tiles_blocked(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, cbs.absorbed_sum_tiles(*args))):
        fail(f"absorbed_sum_tiles {label}: two calls differ")
    slot_j = cbs.kept_pairs(c_l, n_cnt, True, off).view(c_l.shape).long()
    row_pairs = ((slot_j >= 0).sum(1) * tile).repeat_interleave(tile)
    diag = slot_j == (off + torch.arange(n_l, device=slot_j.device))[:, None]
    off_diag = slot_j[(slot_j >= 0) & ~diag]
    col_pairs = (torch.bincount(off_diag, minlength=nI) * tile).repeat_interleave(tile)
    check_sums("absorbed_sum_tiles", f"{label} rows", got[0], ref[0], f_aa[pts], la[pts], e, row_pairs)
    check_sums("absorbed_sum_tiles", f"{label} cols", got[1], ref[1], f_aa, la, e, col_pairs)
    kind = "gibbs" if p == 2 else "gibbs_grad"
    V_f = torch.cat([torch.ones_like(xs[:, :1]), xs], 1)
    a_args = (x_l, xs, ph_l, phx, V_f, V_f[pts], e, c_l, n_cnt, p, kind, tile, True, off)
    got, ref = cbs.gibbs_apply_tiles(*a_args), cbs.gibbs_apply_tiles_blocked(*a_args)
    if not all(torch.equal(a, b) for a, b in zip(got, cbs.gibbs_apply_tiles(*a_args))):
        fail(f"gibbs_apply_tiles {label}: two calls differ")
    scales = cbs.gibbs_apply_tiles_blocked(*a_args[:4], V_f.abs(), V_f[pts].abs(), *a_args[6:])
    for d in range(2):
        check_apply("gibbs_apply_tiles", f"{label} {'rows' if d == 0 else 'cols'} C=4", got[d], ref[d],
                    scales[d].abs().max().item())
    # The shards' row sums laid end to end plus their column sums added up
    # are the whole table's r + c (kernels only, each call as a rank makes it).
    whole = sum(cbs.absorbed_sum_tiles(xs, xs, phx, phx, e, cols, cnt, p, tile, True))
    parts = [cbs.absorbed_sum_tiles(*shard_args(r)) for r in range(OFFSET_SHARDS)]
    summed = torch.cat([r for r, _ in parts]) + sum(c for _, c in parts)
    slot_all = cbs.kept_pairs(cols, cnt, True).view(cols.shape).long()
    all_pairs = ((slot_all >= 0).sum(1) * tile).repeat_interleave(tile) + (
        torch.bincount(slot_all[slot_all >= 0], minlength=nI) * tile).repeat_interleave(tile)
    check_sums("absorbed_sum_tiles", f"N=M={N_POINTS} p={p} {OFFSET_SHARDS} triangle shards summed against the "
               f"whole table", summed, whole, f_aa, la, e, all_pairs)
    print(f"[parallel] kernels 5 and 6 with a row offset: parity on {label}; card {card}", flush=True)


def parallel_phase(dev, card):
    """[parallel]: (a) on one rank (NCCL), ``sinkhorn_multiscale_sharded``
    at 2e6 against ``SamplesLoss()`` (the same solve: bitwise), and at 1e5,
    ``sinkhorn_ring`` and the gaussian ``kernel_ring`` at 1e5 against the
    online route; (b) the same calls on 2 and 4 ranks that share the card
    (gloo) against (a); (c) kernels 5 and 6 with a row offset against their
    twins. Every run's launches per rank against the schedule, times, peak
    memory and rank 0's idle share."""
    import torch.distributed as dist

    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch import parallel as par
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    print(f"[parallel] ranks that share one card take turns on it: these runs check the ring and sharded paths "
          f"and time them, and give no scaling figure; card {card}", flush=True)
    kw = dict(p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING)

    # --- (a) one rank, NCCL ------------------------------------------------------
    store = os.path.join(build, "parallel_store_r1")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
    one = {}
    try:
        mesh = par.points_mesh()
        print(f"[parallel] (a) backend {dist.get_backend()} R={mesh.size} on {mesh.device}", flush=True)
        for name in PARALLEL_CALLS:
            one[name] = run_parallel_call(name, mesh, dev, profile=True)
        # The sharded solve on one rank is SamplesLoss()'s solve: the same floats.
        x0, _ = parallel_fn("sharded 2e6", mesh, dev)
        y0 = torch.from_numpy(sphere_cloud(N_MID, 1)).to(dev)
        with recording(ck, ("lse", "gibbs_apply")) as rec_ck, recording(cbs, tuple(MID_CALLS)) as rec_cbs:
            v_a, g_a = value_and_grad(lambda x: SamplesLoss("sinkhorn", **kw)(x, y0), x0)
        calls_auto = {k: len(c) for k, c in {**rec_ck, **rec_cbs}.items()}
        del rec_ck, rec_cbs, x0, y0
        sh = one["sharded 2e6"]
        same = v_a.item() == sh["value"] and torch.equal(g_a.cpu(), sh["grad"])
        rel_v, rel_g = rel_errs(torch.tensor(sh["value"]), sh["grad"], v_a.cpu(), g_a.cpu())
        print(f"[parallel] sharded 2e6 R=1 against SamplesLoss(backend='auto') (sinkhorn_multiscale): bitwise "
              f"equal {same} (loss rel err {rel_v:.3e}, grad rel L2 err {rel_g:.3e}); calls {json.dumps(calls_auto)}",
              flush=True)
        if not same:
            print("[parallel] why: the sharded solve on one rank runs multiscale_prologue and the single-device "
                  "fine steps' operations in their order; a gap means an operation differs", flush=True)
            if not (rel_v <= PARALLEL_VAL_RTOL and rel_g <= PARALLEL_GRAD_RTOL):
                fail("sharded 2e6 on one rank misses SamplesLoss()")
        del g_a
        report_parallel("sharded 2e6", 1, "nccl", {0: sh}, calls_auto, card)
        report_parallel("sharded 1e5", 1, "nccl", {0: one["sharded 1e5"]}, one["sharded 1e5"]["calls"], card)
        for name in ("ring 1e5", "mmd ring 1e5"):
            report_parallel(name, 1, "nccl", {0: one[name]}, ring_schedule(name, 1), card)
        # The ring against the online route (kernels 2-4), the MMD to the
        # bounds of its terms.
        xr = torch.from_numpy(sphere_cloud(N_RING, 0)).to(dev)
        yr = torch.from_numpy(sphere_cloud(N_RING, 1)).to(dev)
        v_o, g_o = value_and_grad(lambda x: SamplesLoss("sinkhorn", backend="online", **kw)(x, yr), xr)
        rel_v, rel_g = rel_errs(torch.tensor(one["ring 1e5"]["value"]), one["ring 1e5"]["grad"], v_o.cpu(),
                                g_o.cpu())
        print(f"[parallel] ring 1e5 R=1 against SamplesLoss(backend='online'): loss rel err {rel_v:.3e}, grad rel "
              f"L2 err {rel_g:.3e} (tol {PATH_TOL:g})", flush=True)
        if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
            fail("ring 1e5 misses the online route")
        v_m, g_m, mmd_terms, g_part = mmd_reference(
            lambda x: SamplesLoss("gaussian", blur=MMD_BLUR, backend="online")(x, yr), xr)
        mm = one["mmd ring 1e5"]
        err_v, err_g = abs(mm["value"] - v_m.item()), (mm["grad"] - g_m.cpu()).norm().item()
        tol_v, tol_g = mmd_tolerance(mmd_terms), MMD_GRAD_TOL * g_part
        print(f"[parallel] mmd ring 1e5 R=1 against SamplesLoss('gaussian', backend='online'): loss err "
              f"{err_v:.3e} (tol {tol_v:.3e}), grad L2 err {err_g:.3e} (tol {tol_g:.3e})", flush=True)
        if not (err_v <= tol_v and err_g <= tol_g):
            fail("mmd ring 1e5 misses the online route")
        del xr, yr, g_o, g_m
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # --- (b) 2 and 4 ranks on the one card, gloo -----------------------------------
    store = os.path.join(build, "parallel_store_r4")
    if os.path.exists(store):
        os.remove(store)
    t0 = time.perf_counter()
    res = spawn_parallel_ranks(4, store, dev)
    print(f"[parallel] (b) 4 spawned ranks on the one card, backend gloo (tensors staged through host memory), "
          f"groups of 2 and 4 ranks: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, R in PARALLEL_RUNS:
        runs = {r: out[name, R] for r, out in res.items() if (name, R) in out}
        ref = one[name]
        sched = ring_schedule(name, R) if "ring" in name else ref["calls"]
        report_parallel(name, R, "gloo", runs, sched, card)
        rel_v, rel_g = rel_errs(torch.tensor(runs[0]["value"]), runs[0]["grad"], torch.tensor(ref["value"]),
                                ref["grad"])
        # The MMD is a difference of three terms that nearly cancel (the loss
        # ~1e-3 of their sum here): its float32 runs are held to the bound
        # scaled by the terms, as in (a); a relative bound on the loss would
        # lie below the rounding of the terms.
        err_v, tol_v = abs(runs[0]["value"] - ref["value"]), (
            mmd_tolerance(mmd_terms) if name.startswith("mmd") else PARALLEL_VAL_RTOL * abs(ref["value"]))
        bound = "the terms' bound" if name.startswith("mmd") else f"{PARALLEL_VAL_RTOL:g} relative"
        print(f"[parallel] {name} R={R} against R=1: loss err {err_v:.3e} (tol {tol_v:.3e}, {bound}), loss rel err "
              f"{rel_v:.3e}, grad rel L2 err {rel_g:.3e} (tol {PARALLEL_GRAD_RTOL:g})", flush=True)
        if not (err_v <= tol_v and rel_g <= PARALLEL_GRAD_RTOL):
            fail(f"[parallel] {name} on {R} ranks misses the run on one rank")
    del res, one

    # --- (c) kernels 5 and 6 with a row offset ------------------------------------
    w = torch.full((N_POINTS,), 1.0 / N_POINTS, dtype=torch.float32, device=dev)
    x0 = torch.from_numpy(sphere_cloud(N_POINTS, 0)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(N_POINTS, 1)).to(dev)
    for p in (1, 2):
        kwp = dict(kw, p=p)
        state = capture_fine_state(ms, lambda: ms.sinkhorn_multiscale(w, x0, w, y0, **kwp))
        check_offset_kernels(state, card)
    phase_took("parallel", t_phase)


#: [gallery]: the gallery's scripts in the order of its README (those that
#: reach the kernels first), each at its JAX example's full size (its
#: ``main()`` defaults) except where GALLERY_SIZES says; the label transfer
#: again at GALLERY_FIBERS_1E6 fibers a bundle (3 x 20 points a fiber:
#: 1,000,020 points), kernel 4's call there held against its float64 twin
#: on GALLERY_APPLY_ROWS rows; the steps of the training loops of
#: GALLERY_STEPS timed.
GALLERY_ORDER = ("transfer_labels_tractograms", "plot_optimal_transport_labels", "plot_optimal_transport_cluster",
                 "plot_kernel_truncation", "plot_interpolation_3D", "plot_profile", "gradient_flow",
                 "plot_gradient_flows_1D", "plot_gradient_flows_2D", "track_barycenter", "model_fitting",
                 "plot_optimal_transport_2D", "plot_optimal_transport_color", "plot_barycenter_samples",
                 "plot_epsilon_scaling", "plot_transport_blur", "plot_wasserstein_barycenters_1D",
                 "plot_wasserstein_barycenters_2D")
GALLERY_SIZES = {"plot_profile": dict(N=100_000)}
GALLERY_FIBERS_1E6 = 16_667
#: ... and at GALLERY_FIBERS_MID fibers a bundle (2,100,000 points: the
#: mid path, whose default tables are checked to keep every kept tile).
GALLERY_FIBERS_MID = 35_000
GALLERY_APPLY_ROWS = 2048
GALLERY_STEPS = {"gradient_flow": "flow_step", "model_fitting": "train_step"}


def _gallery_result(out):
    if isinstance(out, dict):
        return "{" + ", ".join(f"{k}: {float(v):.6g}" for k, v in out.items()) + "}"
    return "None" if out is None else f"{float(out):.9g}"


def gallery_script(gallery, name, dev, card, prepare=None, **sizes):
    """One gallery script on the card (``prepare`` gets its module first),
    its output kept and printed only if it misses its property: prints its
    seconds, result, kernel launches counted from zero and peak memory,
    and for a script of GALLERY_STEPS its steps' median time, device
    launches, idle share. Returns ``(out, launches)``."""
    import contextlib
    import inspect
    import io

    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    mod = gallery.load(name)
    if prepare is not None:
        prepare(mod)
    kw = dict(GALLERY_SIZES.get(name, {}), **sizes)
    sizes_txt = ", ".join(f"{k}={v}" for k, v in kw.items()) or "full size"
    kw["device"] = dev.type
    if "plot" in inspect.signature(mod.main).parameters:
        kw["plot"] = False
    steps, step_args = [], []
    if name in GALLERY_STEPS:
        step = getattr(mod, GALLERY_STEPS[name])

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = step(*args)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            step_args[:] = [args]
            return r

        setattr(mod, GALLERY_STEPS[name], timed)
    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out, text, values = gallery.run(mod, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: n for k, n in {**ck.launch_counts, **cbs.launch_counts}.items() if n}
    peak = torch.cuda.max_memory_allocated() / 1e9
    ok, what = gallery.check(name, out, text, values)
    print(f"[gallery] {name} ({sizes_txt}): {secs:.2f} s, result {_gallery_result(out)}, kernel launches "
          f"{json.dumps(launches)}, peak memory {peak:.3f} GB; {what}: {ok}; card {card}", flush=True)
    if not ok:
        print(text, flush=True)
        fail(f"gallery script {name} misses its property: {what}")
    if steps:
        _, busy, n_dev, _ = profile_busy_ms(lambda: step(*step_args[0]))
        med = statistics.median(steps)
        print(f"[gallery] {name}: {len(steps)} steps, median {med:.3f} ms a step (host clock, synchronized); one step "
              f"under torch.profiler: {n_dev} device launches, busy {busy:.3f} ms, idle share "
              f"{100 * (1 - busy / med):.1f} %; peak memory {peak:.3f} GB; card {card}", flush=True)
    return out, launches


def gallery_phase(dev, card, clock):
    """[gallery]: every script of examples_torch/ once on the card (its
    JAX example's full size; plot_profile at 1e5), each with its seconds,
    result, kernel launches counted from zero and property (a script that
    raises or misses it fails the run); the steps of gradient_flow and
    model_fitting timed; the label transfer's potentials and votes at
    36,000 points against the same call through the float64 twins; then
    the label transfer at 1e6 points (the multiscale potentials on the
    classic tile-1024 path, kernel 4 over 1e12 pairs at C = 3, held
    against its float64 twin on GALLERY_APPLY_ROWS rows and timed beside
    its bound) and at 2.1e6 points (the mid path: its accuracy, finite
    votes, and its default tables against the tables of every column
    tile)."""
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.ops import block_sparse as tbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck
    from geomloss_tpu_torch.ops.block_sparse import retighten_counts

    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch"))
    import _example_utils_torch as gallery

    if sorted(GALLERY_ORDER) != sorted(gallery.SMOKE):
        fail("GALLERY_ORDER does not list the gallery's scripts")
    labels = "transfer_labels_tractograms"
    for name in GALLERY_ORDER:
        if name != labels:
            gallery_script(gallery, name, dev, card)
            continue
        # At 36,000 points, the script's transfer() kept for the float64 twins:
        calls = []

        def keep(mod):
            transfer = mod.transfer

            def kept(*args):
                calls.append((args, transfer(*args)))
                return calls[-1][1]

            mod.transfer = kept

        acc, _ = gallery_script(gallery, name, dev, card, prepare=keep)
        (x, y, lab_y), got = calls[0]
        n_small = x.shape[0]
        mod = gallery.load(name)
        with plain_twins():
            ref = mod.transfer(x.double(), y.double(), lab_y)
        errs = {k: rel_l2(g, r) for k, g, r in zip(("F", "G", "votes"), got, ref)}
        same = (got[2].argmax(-1) == ref[2].argmax(-1)).double().mean().item()
        check_rel("gallery", f"{name} at {x.shape[0]:,} points: the potentials and votes (C = 3) against the float64 "
                  f"twins (pointwise labels equal to the float64 ones: {100 * same:.3f} %)", errs)
        del calls, x, y, lab_y, got, ref

        # At 1e6 points, kernel 4's call and the truncation tables recorded:
        transfers = []
        with recording(ck, ["gibbs_apply"]) as rec, recording(ms, ["_truncated_fine_phase"]) as rec_ms:
            acc_1e6, launches = gallery_script(gallery, name, dev, card, prepare=keeping_transfer(transfers),
                                               n_fibers=GALLERY_FIBERS_1E6)
        args = next(a for a, _ in rec["gibbs_apply"] if a[4].shape[1] == 3)  # the votes
        N, M, C = args[0].shape[0], args[1].shape[0], args[4].shape[1]
        print(f"[gallery] {name}: fiber-vote accuracy {acc_1e6:.6f} at {N:,} points, {acc:.6f} at {n_small:,} "
              f"points; card {card}", flush=True)
        # The rows that the tables' former widths (the build cap, an eighth
        # of the column tiles up to 128, and fine_cap_schedule's slices)
        # would have clipped:
        masks, eps_m, _, _, _, _, eps_fine, _, truncate = rec_ms["_truncated_fine_phase"][0][0][:9]
        mask = masks[0]
        nI, width = mask.cols.shape
        old_cap = max(32, min(mask.colsT.shape[0] // 8, 128))
        over = []
        for ck_e, es in ms.fine_cap_schedule(eps_fine, eps_m, old_cap):
            for e in es:
                over.append((int((retighten_counts(mask.vals, truncate * (e - eps_m)) > ck_e).sum()), ck_e))
        print(f"[gallery] {name} at {N:,} points, the xy truncation table: {nI} row tiles, width {width}, kept tiles a "
              f"row mean {mask.counts.float().mean().item():.1f}, max {int(mask.counts.max())}; "
              f"{int((mask.counts > old_cap).sum())} rows keep more than the former build cap {old_cap}; at the "
              f"{len(eps_fine)} fine temperatures {min(o for o, _ in over)}-{max(o for o, _ in over)} rows keep "
              f"more than fine_cap_schedule's width ({min(c for _, c in over)}-{max(c for _, c in over)}): "
              f"both widths now grow to the largest count", flush=True)
        del rec_ms, masks, mask

        if not (launches.get("gibbs_apply") and launches.get("absorbed_sum_tiles") and launches.get("lse")):
            fail(f"the label transfer at {N:,} points did not run kernels 1, 4 and 5: {launches}")
        # Its rows of kernel 4's call against the float64 twin on those rows:
        rows = torch.linspace(0, N - 1, GALLERY_APPLY_ROWS, device=dev).round().long()
        sub = (args[0][rows].double(), args[1].double(), args[2][rows].double(), args[3].double(),
               args[4].double(), *args[5:])
        scale = ck.gibbs_apply_blocked(*sub[:4], sub[4].abs(), *sub[5:]).abs().max().item()
        check_apply("gibbs_apply", f"label transfer {N:,} x {M:,} {args[7]} C={C}, {GALLERY_APPLY_ROWS} rows against "
                    f"the float64 twin", ck.gibbs_apply(*args)[rows], ck.gibbs_apply_blocked(*sub), scale)
        k_ms = event_ms(lambda: ck.gibbs_apply(*args), 2)
        b_ms, b_by = bound(N * M, nbytes(*args[:5]) + 4 * N * C, clock)
        print(f"[time] gibbs_apply        label transfer N={N:,} M={M:,} C={C}: kernel {k_ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}) (CUDA events); card {card}", flush=True)
        del rec, args, sub
        torch.cuda.empty_cache()
        # The classic path's coarse keep rule: the label transfer against
        # the same call whose masks_from_coarse keeps every tile.
        transfer, t_args, _ = transfers[0]
        potential_gap("gallery", f"{name} at {N:,} points (the classic path, accuracy {acc_1e6:.6f}): "
                      f"masks_from_coarse keeping every tile", lambda: transfer(*t_args)[:2], mod.BLUR**2, card,
                      [(ms, "masks_from_coarse")], tol=MID_GAP_EPS)
        del transfers, transfer, t_args
        torch.cuda.empty_cache()

        # At 2.1e6 points, the mid path: its default tables and the votes.
        transfers = []
        with calls_of(ms, "build_tile_masks") as mid_tables, calls_of(tbs, "extrap_cols") as extraps:
            acc_mid, launches = gallery_script(gallery, name, dev, card, prepare=keeping_transfer(transfers),
                                               n_fibers=GALLERY_FIBERS_MID)
        votes = transfers[0][2][2]
        n_mid, finite = votes.shape[0], bool(torch.isfinite(votes).all())
        print(f"[gallery] {name}: fiber-vote accuracy {acc_mid:.6f} at {n_mid:,} points (the mid path), votes finite: "
              f"{finite}; card {card}", flush=True)
        if not (finite and acc_mid >= 0.99):
            fail(f"the label transfer at {n_mid:,} points: accuracy {acc_mid:.6f}, votes finite {finite}")
        if not (mid_tables and launches.get("lse_tiles") and launches.get("absorbed_sum_tiles")
                and launches.get("gibbs_apply")):
            fail(f"the label transfer at {n_mid:,} points did not take the mid path on kernels 4, 5 and 7: {launches}")
        check_mid_tables("gallery", f"{name} at {n_mid:,} points", mid_tables, extraps)
        kept_before_after("gallery", f"{name} at {n_mid:,} points", mid_tables)
        del votes, mid_tables, extraps
        torch.cuda.empty_cache()
        # The keep rules: the potentials against the same call whose fine
        # tables (the 2,051 data column tiles of 4,096 dense) and
        # extrapolation tables keep every tile.
        transfer, t_args, _ = transfers[0]
        potential_gap("gallery", f"{name} at {n_mid:,} points, the mid path's potentials (fine and extrapolation "
                      f"tables)", lambda: transfer(*t_args)[:2], mod.BLUR**2, card,
                      [(ms, "build_tile_masks"), (tbs, "extrap_cols")], tol=MID_GAP_EPS)
        del transfers, transfer, t_args
        torch.cuda.empty_cache()
    phase_took("gallery", t_phase)


#: [bench]: the legs of bench_suite_torch.py it runs, and the size of its
#: profile by the program's spans.
BENCH_SUITE_LEGS = {"sinkhorn_tensorized_blur.05": [100, 1_000], "sinkhorn_multiscale_blur.05": [10_000]}
BENCH_PROFILE_N = 1_000_000
#: The spans of one classic-path call at BENCH_PROFILE_N (at least these
#: counts).
BENCH_SPANS = {"loss": 1, "multiscale.prologue": 1, "multiscale.sort": 2, "multiscale.coarse": 1,
               "multiscale.extrapolate": 1, "multiscale.tables": 1, "solver.eps_loop": 2, "solver.eps_step": 2,
               "solver.last_extrapolation": 1, "backward.SoftminExtrapolationWalkBanded": 1,
               "backward.SoftminExtrapolationWalkBandedSym": 1}
#: Largest offset (us) between the host clock of the spans and the
#: profiler's host events.
CLOCK_TOL_US = 50.0
#: Keys of bench_torch.py's line (bench.py's, and the CUDA timing fields).
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "events_ms", "busy_ms", "profiled_wall_ms", "idle_share",
              "launches", "peak_mem_gb", "loss_value", "loss_exact", "loss_rel_err_vs_exact", "loss_float64",
              "loss_rel_err_vs_float64", "device")


def coarse_keep_rule(dev, card, n=N_POINTS):
    """[bench]: the classic path's coarse keep rule at bench.py's size. The
    coarse xy table's kept tiles a row beside the same table under the JAX
    package's rule (the centroids alone), and the potentials' largest gap
    to the same solve whose coarse tables keep every tile (fails over
    ``MID_GAP_EPS``)."""
    import bench_torch
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.ops import block_sparse as tbs

    x, y = (torch.from_numpy(bench_torch.sphere_cloud(n, seed)).to(dev) for seed in (0, 1))
    w = torch.full((n,), 1.0 / n, device=dev)
    kw = {k: v for k, v in bench_torch.CALL.items() if k != "loss"}

    def solve():
        return ms.sinkhorn_multiscale(w, x, w, y, potentials=True, **kw)

    with calls_of(ms, "masks_from_coarse") as coarse, torch.no_grad():
        solve()
        args, kwargs, mask = coarse[0]
        old = tbs.masks_from_coarse(*args, **dict(kwargs, eps_min=math.inf))
    c, o = mask.counts.double(), old.counts.double()
    print(f"[bench] bench.py's call at N=M={n}, the coarse xy table: kept tiles a row mean {c.mean().item():.2f} max "
          f"{int(c.max())} (width {mask.cols.shape[1]}); under the JAX rule mean {o.mean().item():.2f} max "
          f"{int(o.max())} (width {old.cols.shape[1]}): {c.mean().item() / o.mean().item():.3f}x the mean, "
          f"{c.numel()} row tiles; card {card}", flush=True)
    potential_gap("bench", f"bench.py's call at N=M={n} (the classic path): masks_from_coarse keeping every tile",
                  solve, kw["blur"] ** kw["p"], card, [(ms, "masks_from_coarse")], tol=MID_GAP_EPS)
    del x, y, w, coarse, mask, old


def span_profile(dev, card, n=BENCH_PROFILE_N):
    """[bench]: one call of bench.py's (the classic multiscale path at
    ``n``) under ``torch.profiler`` with the device's activity: the
    program's spans, each of BENCH_SPANS recorded, every child inside its
    parent, one call id (the backward spans' too), and each span's
    device-idle ms (its length less the device events inside it)."""
    import bench_torch
    from torch.profiler import ProfilerActivity, profile

    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.utils import profiling

    x, y = (torch.from_numpy(bench_torch.sphere_cloud(n, seed)).to(dev) for seed in (0, 1))
    loss = SamplesLoss(**bench_torch.CALL, backend="multiscale")
    bench_torch.loss_and_grad(loss, x, y)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        v, g = bench_torch.loss_and_grad(loss, x, y)
        torch.cuda.synchronize()
    busy = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA)
    spans = profiling.spans()
    names = collections.Counter(s.name for s in spans)
    idle = collections.Counter()
    for s in spans:
        covered, end = 0, s.start_ns
        for b0, b1 in busy:
            b0, b1 = max(b0, end), min(b1, s.end_ns)
            if b1 > b0:
                covered += b1 - b0
                end = b1
        idle[s.name] += (s.end_ns - s.start_ns - covered) / 1e6
    print(f"[bench] spans of one call at N=M={n} (loss {v.item()!r}): "
          + json.dumps({k: [names[k], round(idle[k], 3)] for k in sorted(names)})
          + f" ([count, device-idle ms]); counts {json.dumps(profiling.counts())}; card {card}", flush=True)
    missing = {k: names[k] for k, c in BENCH_SPANS.items() if names[k] < c}
    if missing:
        fail(f"the spans of one call at N={n} lack {missing}: {dict(names)}")
    by_seq = {s.seq: s for s in spans}
    outside = [s.name for s in spans if s.parent is not None and not (
        by_seq[s.parent].start_ns <= s.start_ns and s.end_ns <= by_seq[s.parent].end_ns)]
    if outside or len({s.call_id for s in spans}) != 1:
        fail(f"spans outside their parents {outside} or calls {sorted({s.call_id for s in spans})}")
    if not (math.isfinite(v.item()) and bool(torch.isfinite(g).all())):
        fail("the profiled call is not finite")
    profiling.reset()


def span_clock(dev, card, n=N_POINTS, reps=5):
    """[bench]: ``reps`` spans, each around one launch of kernel 1 and a
    synchronize, under ``torch.profiler`` with host and device activity
    (after a few launches of warm-up in the session: a session that follows
    one of other activities can miss its first device events). Each span
    must hold the device event of the kernel it launched, found by time.
    The clocks: a ``record_function`` event opened between two
    ``time.time_ns()`` reads must start between them (its offset, 0
    inside), and each kernel must start after the start of the runtime
    call that launched it (found by its correlation id), by the launch's
    latency (printed: 6-59 us on an H100); fails where the offset reaches
    ``CLOCK_TOL_US`` or a kernel starts before its launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from geomloss_tpu_torch.ops import cuda_kernels as ck
    from geomloss_tpu_torch.utils import profiling

    x, y = (torch.from_numpy(sphere_cloud(n, seed)).to(dev) for seed in (0, 1))
    h = torch.zeros(n, device=dev)
    ck.lse(x, y, h, 0.1)
    torch.cuda.synchronize()
    profiling.reset()
    brackets = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ck.lse(x, y, h, 0.1)
            torch.cuda.synchronize()
        for _ in range(reps):
            with profiling.span("clock.probe"):
                ck.lse(x, y, h, 0.1)
                torch.cuda.synchronize()
            t0 = time.time_ns()
            with record_function("clock.mark"):
                t1 = time.time_ns()
            brackets.append((t0, t1))
    events = list(prof.profiler.kineto_results.events())
    probes = [s for s in profiling.spans() if s.name == "clock.probe"]
    marks = sorted(e.start_ns() for e in events if e.name() == "clock.mark" and e.device_type() == DeviceType.CPU)
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA and "lse_kernel" in e.name()
               and "merge" not in e.name()]
    calls = {e.correlation_id(): e for e in events if e.device_type() == DeviceType.CPU and e.name().startswith("cuda")}
    rows = []
    for s, (t0, t1), mark in zip(probes, brackets, marks):
        mine = [k for k in kernels if s.start_ns <= k.start_ns() <= s.end_ns]
        call = calls.get(mine[0].correlation_id()) if len(mine) == 1 else None
        rows.append({
            "kernels": len(mine),
            "inside": len(mine) == 1 and mine[0].start_ns() + mine[0].duration_ns() <= s.end_ns,
            "span_to_kernel_us": mine[0].start_ns() / 1e3 - s.start_ns / 1e3 if mine else None,
            "mark_offset_us": max(0, t0 - mark, mark - t1) / 1e3, "bracket_us": (t1 - t0) / 1e3,
            "launch_to_kernel_us": None if call is None else (mine[0].start_ns() - call.start_ns()) / 1e3,
        })
    print(f"[bench] span clock (kernel 1 at N=M={n}, {reps} spans): {json.dumps(rows)}; card {card}", flush=True)
    if len(rows) != reps or not all(r["inside"] for r in rows):
        fail(f"a span does not hold the device event of the kernel it launched: {rows} ({len(probes)} spans, "
             f"{len(marks)} marks, {len(kernels)} kernels of {len(events)} events)")
    latency = [r["launch_to_kernel_us"] for r in rows if r["launch_to_kernel_us"] is not None]
    if max(r["mark_offset_us"] for r in rows) >= CLOCK_TOL_US or (latency and min(latency) < 0):
        fail(f"the clocks disagree: {rows} (tolerance {CLOCK_TOL_US} us)")
    profiling.reset()


def bench_phase(dev, card):
    """[bench]: the benchmark twins, as functions. bench_torch.py's call
    (bench.py's, at 1e5: the multiscale route) with its launches counted
    from zero, its line's keys, and its loss within PATH_TOL of the same
    call through the float64 twins (``loss_rel_err_vs_exact`` printed: it
    measures the multiscale scheme against the online one); the suite's
    BENCH_SUITE_LEGS, each within its bound; the program's spans at
    BENCH_PROFILE_N (:func:`span_profile`) and their clock
    (:func:`span_clock`)."""
    import bench_suite_torch
    import bench_torch
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    line = bench_torch.headline(N_POINTS, dev.type)
    launches = {k: n for k, n in {**ck.launch_counts, **cbs.launch_counts}.items() if n}
    print(f"[bench] bench_torch.py N={N_POINTS}: launches {json.dumps(launches)}; median {line['value']:.3f} ms, "
          f"events {line['events_ms']:.3f} ms, idle share {100 * line['idle_share']:.1f} %; loss "
          f"{line['loss_value']!r}, rel err against "
          f"the float64 twins {line['loss_rel_err_vs_float64']:.3e} (tol {PATH_TOL:g}), against the online "
          f"truncate=None value {line['loss_rel_err_vs_exact']:.3e} (the multiscale scheme's gap, for "
          f"information); card {card}", flush=True)
    missing = [k for k in BENCH_KEYS if k not in line or line[k] is None]
    if missing:
        fail(f"bench_torch.py's line lacks {missing}")
    if not all(launches.get(k, 0) > 0 for k in ("lse", "absorbed_sum_tiles", "gibbs_apply_tiles")):
        fail(f"a kernel of the multiscale path was never launched by bench_torch.py's call: {launches}")
    if not line["loss_rel_err_vs_float64"] <= PATH_TOL:
        fail("bench_torch.py's loss misses the float64 twins")
    coarse_keep_rule(dev, card)

    results = {}
    for name, kw, _ in bench_suite_torch.CONFIGS:
        if name in BENCH_SUITE_LEGS:
            for leg in bench_suite_torch.run_config(name, kw, BENCH_SUITE_LEGS[name], dev, card, results):
                if not leg["within_bound"]:
                    fail(f"{leg['metric']}: loss error {leg['err_vs_float64']:.3e} (bound "
                         f"{leg['bound_vs_float64']:.3e}) or gradient error {leg['grad_err_vs_float64']:.3e} (bound "
                         f"{leg['grad_bound_vs_float64']:.3e}) against float64 over its bound")
    print(f"[bench] suite legs within their bounds: {json.dumps(results)} (median ms)", flush=True)

    span_profile(dev, card)
    span_clock(dev, card)
    phase_took("bench", t_phase)


def main():
    # --- 1. Device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    dev = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line(dev)
    clock = sm_clock_hz()
    print(f"[device] {kind} x{count}; nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from geomloss_tpu_torch import SamplesLoss
    from geomloss_tpu_torch.models import multiscale as ms
    from geomloss_tpu_torch.models.sinkhorn_samples import sinkhorn_online
    from geomloss_tpu_torch.ops import block_sparse as tbs
    from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
    from geomloss_tpu_torch.ops import cuda_kernels as ck

    # --- 2. Build, from the sources of this checkout -----------------------------
    # Into the checkout's build/smoke_kernels, named by GEOMLOSS_TPU_TORCH_BUILD_DIR
    # (whatever the caller set it to) and emptied first.
    os.environ[ck.BUILD_DIR_ENV] = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_kernels")
    out_dir = ck.build_dir()
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(ck.build), pool.submit(cbs.build)]:
            fut.result()
    libs = [ck._LIB.path, cbs._LIB.path]
    print(f"[build] {', '.join(SOURCES.values())} -> {', '.join(map(str, libs))} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if any(lib.parent != out_dir for lib in libs):
        fail(f"the libraries were not built into {ck.BUILD_DIR_ENV}={out_dir}")
    usage = {}
    for lib in (ck._LIB, cbs._LIB):
        usage.update(ptxas_usage(lib.path.with_suffix(".log").read_text()))
    for name in sorted(usage):
        if name.startswith(("tiles_step_kernel", "tiles_apply_kernel")) or name in PTXAS_SHOWN:
            print(f"[build] ptxas {name}: {json.dumps(usage[name])}", flush=True)

    f32, f64 = torch.float32, torch.float64
    MAX_ERR.update({name: 0.0 for name in REPLACES})

    # --- 3. Repair: bounded, deterministic step kernels at 1e6 --------------------
    t_sec = time.perf_counter()
    xr = torch.from_numpy(sphere_cloud(N_REPAIR, 2)).to(dev)
    yr = torch.from_numpy(sphere_cloud(N_REPAIR, 3)).to(dev)
    lr = torch.full((N_REPAIR,), -math.log(N_REPAIR), dtype=f32, device=dev)
    zr = torch.zeros(N_REPAIR, dtype=f32, device=dev)
    for name, call in (
        ("sinkhorn_step", lambda: ck.sinkhorn_step(xr, yr, zr, zr, lr, lr, BLUR**2, 2)),
        ("sinkhorn_step_sym", lambda: (ck.sinkhorn_step_sym(xr, zr, lr, BLUR**2, 2),)),
    ):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        first = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        extra = torch.cuda.max_memory_allocated() - base
        same = all(torch.equal(a, b) for a, b in zip(first, call()))
        finite = all(bool(torch.isfinite(a).all()) for a in first)
        print(f"[repair] {name:17s} N=M={N_REPAIR}: peak extra memory {extra / 1e6:.1f} MB "
              f"(limit {REPAIR_BYTES / 1e6:.0f} MB), two calls bitwise equal: {same}, "
              f"{secs:.3f} s; card {card}", flush=True)
        if not (extra < REPAIR_BYTES and same and finite):
            fail(f"{name} at N=M={N_REPAIR}: scratch over budget, nondeterministic or not finite")
    del xr, yr, lr, zr, first
    t_sec = phase_took("repair", t_sec)

    # --- 4. Kernel parity on the card --------------------------------------------
    x0 = torch.from_numpy(sphere_cloud(N_POINTS, 0)).to(dev)
    y0 = torch.from_numpy(sphere_cloud(N_POINTS, 1)).to(dev)

    for N, M in [(N_POINTS, N_POINTS), RAGGED]:
        x = torch.from_numpy(sphere_cloud(N, 0)).to(dev)
        y = torch.from_numpy(sphere_cloud(M, 1)).to(dev)
        for p in (1, 2):
            eps = BLUR**p
            label = f"N={N} M={M} p={p}"
            la = torch.full((N,), -math.log(N), dtype=f32, device=dev)
            lb = torch.full((M,), -math.log(M), dtype=f32, device=dev)
            f = torch.zeros(N, dtype=f32, device=dev)
            g = torch.zeros(M, dtype=f32, device=dev)
            lse_ref = ck.lse_blocked(x, y, lb, eps, p)
            lse_k = ck.lse(x, y, lb, eps, p)
            check_val("lse", label, lse_k, lse_ref)
            if not torch.equal(lse_k, ck.lse(x, y, lb, eps, p)):
                fail(f"lse {label}: two calls differ")
            # Kernel 2's raw sums (M terms in a row sum, N in a column sum).
            got = ck._step_sums(x, y, f, g, la, lb, eps, p)
            ref = ck._step_sums_blocked(x, y, f, g, la, lb, eps, p)
            for d, (a, b, pot, lw, n) in enumerate(zip(got, ref, (f, g), (la, lb), (M, N))):
                check_sums("sinkhorn_step", f"{label} {'xy' if d == 0 else 'yx'}", a, b, pot, lw, eps,
                           torch.full_like(b, n))
            for a, b in zip(ck.sinkhorn_step(x, y, f, g, la, lb, eps, p), ck.sinkhorn_step(x, y, f, g, la, lb, eps, p)):
                if not torch.equal(a, b):
                    fail(f"sinkhorn_step {label}: two calls differ")
            sym = ck.sinkhorn_step_sym(x, f, la, eps, p)
            check_val("sinkhorn_step_sym", label, sym, ck.sinkhorn_step_sym_blocked(x, f, la, eps, p))
            if not torch.equal(sym, ck.sinkhorn_step_sym(x, f, la, eps, p)):
                fail(f"sinkhorn_step_sym {label}: two calls differ")
            # Every mode of kernel 4: the Gibbs kinds with row-normalized
            # weights, as in the softmin backward passes; the distance kinds
            # (modes 3 and 4, which ignore p: checked at p = 1) with the
            # weights b, as in the energy MMD.
            kinds = ("gibbs", "gibbs_grad", "energy", "inv_dist") if p == 1 else ("gibbs", "gibbs_grad")
            ones_y = torch.cat([torch.ones_like(y[:, :1]), y], 1)
            for kind_c in kinds:
                for C in (1, 3, 4):
                    V = {1: ones_y[:, 1:2], 3: y, 4: ones_y}[C]
                    if kind_c in ("energy", "inv_dist"):
                        V = lb.exp()[:, None] * V
                    args = (x, y, -lse_ref, lb, V, eps, p, kind_c)
                    scale = ck.gibbs_apply_blocked(x, y, -lse_ref, lb, V.abs(), eps, p, kind_c).abs().max().item()
                    check_apply("gibbs_apply", f"{label} {kind_c} C={C}", ck.gibbs_apply(*args),
                                ck.gibbs_apply_blocked(*args), scale)

    # The block-sparse kernels on the tables of the multiscale path at 1e5.
    kw = dict(blur=BLUR, diameter=DIAMETER, scaling=SCALING)
    w = torch.full((N_POINTS,), 1.0 / N_POINTS, dtype=f32, device=dev)
    fine = {}
    for p in (1, 2):
        fine[p] = capture_fine_state(ms, lambda: ms.sinkhorn_multiscale(w, x0, w, y0, p=p, **kw))
        check_tile_kernels(fine[p], f"N=M={N_POINTS}")

    t_sec = phase_took("parity", t_sec)

    # --- 5. Online path ----------------------------------------------------------
    loss = SamplesLoss("sinkhorn", p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING, backend="online")
    kw2 = dict(p=2, **kw)
    wb = w[None]

    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    t0 = time.perf_counter()
    v_k, g_k = value_and_grad(lambda x: loss(x, y0), x0)
    raw = sinkhorn_online(wb, x0[None], wb, y0[None], potentials="raw", **kw2)
    x1 = (x0 - 0.5 * N_POINTS * g_k).detach()  # one gradient-flow step
    v_w, g_w = value_and_grad(
        lambda x: sinkhorn_online(wb, x[None], wb, y0[None], init_potentials=raw, warm_start_iters=3, **kw2)[0],
        x1,
    )
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(ck.launch_counts)
    print(f"[online] launches {json.dumps(launches)} in {path_s:.2f} s (first call, build excluded)", flush=True)
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the online path was never launched: {launches}")

    # Reference: the same solves through the plain twins, in float64.
    w64 = wb.to(f64)
    v_r, g_r = value_and_grad(
        lambda x: sinkhorn_online(w64, x[None], w64, y0.to(f64)[None], impl="blocked", **kw2)[0],
        x0.to(f64),
    )
    raw64 = sinkhorn_online(w64, x0.to(f64)[None], w64, y0.to(f64)[None], potentials="raw", impl="blocked", **kw2)
    v_wr, g_wr = value_and_grad(
        lambda x: sinkhorn_online(w64, x[None], w64, y0.to(f64)[None], init_potentials=raw64,
                                  warm_start_iters=3, impl="blocked", **kw2)[0],
        x1.to(f64),
    )

    def compare(tag, label, v, g, v_ref, g_ref):
        if g.shape != (N_POINTS, 3) or not (torch.isfinite(v) and torch.isfinite(g).all()):
            fail(f"{label}: non-finite or misshapen output")
        rel_v, rel_g = rel_errs(v, g, v_ref, g_ref)
        print(f"[{tag}] {label}: loss {v.item():.9e} (float64 twins {v_ref.item():.9e}), "
              f"loss rel err {rel_v:.3e}, grad rel L2 err {rel_g:.3e} (tol {PATH_TOL:g})", flush=True)
        if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
            fail(f"{label} misses its tolerance")

    compare("online", f"online N=M={N_POINTS} cold", v_k, g_k, v_r, g_r)
    compare("online", f"online N=M={N_POINTS} warm start", v_w, g_w, v_wr, g_wr)

    # Small problem: kernels against the dense float64 path (no twin involved).
    xs5, ys5 = x0[:5000], y0[:5000]
    v_s, g_s = value_and_grad(lambda x: loss(x, ys5), xs5)
    dense = SamplesLoss("sinkhorn", p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING, backend="tensorized")
    v_d, g_d = value_and_grad(lambda x: dense(x, ys5.to(f64)), xs5.to(f64))
    rel_v, rel_g = rel_errs(v_s, g_s, v_d, g_d)
    print(f"[online] online N=M={xs5.shape[0]} vs tensorized float64: loss rel err {rel_v:.3e}, "
          f"grad rel L2 err {rel_g:.3e} (tol {PATH_TOL:g})", flush=True)
    if not (rel_v <= PATH_TOL and rel_g <= PATH_TOL):
        fail("small online problem misses the dense float64 reference")

    t_sec = phase_took("online", t_sec)

    # --- 6. Multiscale path: bench.py's call, backend "auto" ---------------------
    auto = SamplesLoss("sinkhorn", p=2, blur=BLUR, diameter=DIAMETER, scaling=SCALING)
    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    t0 = time.perf_counter()
    with recording(ck, ("lse",)) as rec_lse:
        v_m, g_m = value_and_grad(lambda x: auto(x, y0), x0)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches_ms = {**ck.launch_counts, **cbs.launch_counts}
    print(f"[multiscale] launches {json.dumps(launches_ms)} in {path_s:.2f} s (first call)", flush=True)
    if not all(launches_ms[k] > 0 for k in ("lse", "absorbed_sum_tiles", "gibbs_apply_tiles")):
        fail(f"a kernel of the multiscale path was never launched: {launches_ms}")
    w64 = w.to(f64)
    v_mr, g_mr = value_and_grad(
        lambda x: ms.sinkhorn_multiscale(w64, x, w64, y0.to(f64), impl="blocked", **kw2), x0.to(f64)
    )
    compare("multiscale", f"multiscale (auto) N=M={N_POINTS}", v_m, g_m, v_mr, g_mr)
    # Kernel 1 at the coarse sweeps' shape of that run (4,096 points).
    check_lse_shapes(f"multiscale (auto) N=M={N_POINTS}", rec_lse["lse"], clock, card)
    del rec_lse
    v_n, g_n = value_and_grad(lambda x: ms.sinkhorn_multiscale(w, x, w, y0, truncate=None, **kw2), x0)
    for label, (v_ref, g_ref) in (("online float64 twins (phase 5)", (v_r, g_r)),
                                  ("truncate=None kernels", (v_n, g_n))):
        rel_v, rel_g = rel_errs(v_m, g_m, v_ref, g_ref)
        print(f"[multiscale] for information, against {label}: loss rel err {rel_v:.3e}, "
              f"grad rel L2 err {rel_g:.3e}", flush=True)

    t_sec = phase_took("multiscale", t_sec)

    # --- 7. Timing -----------------------------------------------------------------
    reps = 5
    plain = lambda x: sinkhorn_online(wb, x[None], wb, y0[None], impl="blocked", **kw2)[0]  # noqa: E731
    ms_plain = lambda x: ms.sinkhorn_multiscale(w, x, w, y0, impl="blocked", **kw2)  # noqa: E731
    path = {
        "online": (lambda: value_and_grad(lambda x: loss(x, y0), x0),
                   lambda: value_and_grad(plain, x0)),
        "multiscale": (lambda: value_and_grad(lambda x: auto(x, y0), x0),
                       lambda: value_and_grad(ms_plain, x0)),
    }
    host = {}
    for name, (kern, twin) in path.items():
        ms_path = sync_ms(kern, reps)
        ms_twin = sync_ms(twin, 2)
        ms_path2 = sync_ms(kern, reps)
        print(f"[time] loss+grad N=M={N_POINTS} {name}, host clock, {reps} reps: kernels {ms_path:.3f} / "
              f"{ms_path2:.3f} ms, plain float32 twins {ms_twin:.3f} ms (2 reps); card {card}", flush=True)
        host[name] = ms_path2

    wall, busy, n_launch, top = profile_busy_ms(path["multiscale"][0])
    print(f"[time] multiscale loss+grad under torch.profiler: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {100 * (1 - busy / host['multiscale']):.1f} % of the host clock, {n_launch} kernel launches; "
          f"card {card}", flush=True)
    for dev_ms, calls, key in top:
        print(f"[time]   {dev_ms:9.3f} ms {calls:5d} x {key[:90]}", flush=True)

    eps = BLUR**2
    la = torch.full((N_POINTS,), -math.log(N_POINTS), dtype=f32, device=dev)
    z = torch.zeros(N_POINTS, dtype=f32, device=dev)
    lse_ref = ck.lse_blocked(x0, y0, la, eps, 2)
    V1 = torch.cat([torch.ones_like(y0[:, :1]), y0], 1)  # C = 4, as in the backward
    e, xs, ys, la_f, lb_f, f, g, cols, cnt, _, tile, _ = fine[2]["xy"]
    t_args = (xs, ys, la_f + f / e, lb_f + g / e, e, cols, cnt, 2, tile, False)
    Vy = torch.cat([torch.ones_like(ys[:, :1]), ys], 1)
    Vx = torch.cat([torch.ones_like(xs[:, :1]), xs], 1)
    a_args = (*t_args[:4], Vy, Vx, e, cols, cnt, 2, "gibbs", tile, False)
    cases = {
        "lse": (lambda: ck.lse(x0, y0, la, eps, 2), lambda: ck.lse_blocked(x0, y0, la, eps, 2)),
        "sinkhorn_step": (lambda: ck.sinkhorn_step(x0, y0, z, z, la, la, eps, 2),
                          lambda: ck.sinkhorn_step_blocked(x0, y0, z, z, la, la, eps, 2)),
        "sinkhorn_step_sym": (lambda: ck.sinkhorn_step_sym(x0, z, la, eps, 2),
                              lambda: ck.sinkhorn_step_sym_blocked(x0, z, la, eps, 2)),
        "gibbs_apply": (lambda: ck.gibbs_apply(x0, y0, -lse_ref, la, V1, eps, 2),
                        lambda: ck.gibbs_apply_blocked(x0, y0, -lse_ref, la, V1, eps, 2)),
        "absorbed_sum_tiles": (lambda: cbs.absorbed_sum_tiles(*t_args),
                               lambda: cbs.absorbed_sum_tiles_blocked(*t_args)),
        "gibbs_apply_tiles": (lambda: cbs.gibbs_apply_tiles(*a_args),
                              lambda: cbs.gibbs_apply_tiles_blocked(*a_args)),
    }
    # Work of each timed call: exponentials (one per pair it visits: a
    # triangle for the symmetric step, the kept tile pairs for kernels 5
    # and 6) and bytes (each input read once, each output written once).
    NP, kept = N_POINTS, int(cnt.sum()) * tile * tile
    work = {
        "lse": (NP * NP, nbytes(x0, y0, la) + 4 * NP),
        "sinkhorn_step": (NP * NP, nbytes(x0, y0, z, z, la, la) + 8 * NP),
        "sinkhorn_step_sym": (NP * (NP + 1) // 2, nbytes(x0, z, la) + 4 * NP),
        "gibbs_apply": (NP * NP, nbytes(x0, y0, lse_ref, la, V1) + 16 * NP),
        "absorbed_sum_tiles": (kept, nbytes(*t_args[:4], cols, cnt) + 4 * (xs.shape[0] + ys.shape[0])),
        "gibbs_apply_tiles": (kept, nbytes(*a_args[:6], cols, cnt) + 16 * (xs.shape[0] + ys.shape[0])),
    }
    src = {name: SOURCES["block_sparse_kernels" if name.endswith("_tiles") else "online_kernels"]
           for name in REPLACES}
    all_launches = {**launches, **{k: launches_ms[k] for k in cbs.launch_counts}}
    kernels = []

    def kernel_entry(name, where, kern, twin, twin_reps, launches_n):
        ms_k = event_ms(kern, 10)
        plain_ms = event_ms(twin, twin_reps)
        bound_ms, bound_by = bound(*work[name], clock)
        # Kernel 4 is timed at C = 4 (V1).
        slots = pair_slots(name, ch=4) if name in (*PAIR_TAIL_SLOTS, "gibbs_apply") else None
        floor = (f", issue floor {issue_ms(slots, work[name][0], clock):.3f} ms ({slots} slots per pair)"
                 if slots else "")
        print(f"[time] {name:18s} {where}: kernel {ms_k:.3f} ms, twin {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({bound_by}: {work[name][0]:.4g} exp2, {work[name][1]:.4g} bytes, SM clock {clock / 1e6:.0f} MHz)"
              f"{floor} (CUDA events); card {card}", flush=True)
        # No single PyTorch call computes these functions: each needs the
        # dense (N, M) matrix (40 GB at 1e5) or a gather of kept tiles.
        kernels.append({
            "name": name, "route": "cuda", "source": src[name], "replaces": REPLACES[name],
            "launches": launches_n, "max_abs_err": MAX_ERR[name],
            "ms": ms_k, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })

    for name, (kern, twin) in cases.items():
        where = (f"N=M={N_POINTS} p=2" if name in ck.launch_counts
                 else f"first fine step's table, kept {int(cnt.sum())} tile pairs of {tile}")
        kernel_entry(name, where, kern, twin, 3, all_launches[name])
    del fine, cases, t_args, a_args, lse_ref, V1, xs, ys, cols, cnt, f, g, la_f, lb_f, Vx, Vy

    phase_took("time", t_sec)

    # --- 8. Mid path: bench.py's call at N = M = 2e6, backend "auto" -------------
    t_mid = time.perf_counter()
    xm = torch.from_numpy(sphere_cloud(N_MID, 0)).to(dev)
    ym = torch.from_numpy(sphere_cloud(N_MID, 1)).to(dev)
    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(cbs, tuple(MID_CALLS)) as rec_cbs, recording(ck, ("lse",)) as rec_ck, recording(
        ms, ("run_mid_phase", "sinkhorn_step_walk_banded", "sinkhorn_step_walk_banded_sym")
    ) as rec_ms, calls_of(ms, "build_tile_masks") as mid_tables, calls_of(tbs, "extrap_cols") as extraps:
        v_2m, g_2m = value_and_grad(lambda x: auto(x, ym), xm)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches_mid = {**ck.launch_counts, **cbs.launch_counts}
    calls_mid = {k: len(v) for k, v in rec_cbs.items()}
    print(f"[mid] N=M={N_MID} launches {json.dumps(launches_mid)}, calls {json.dumps(calls_mid)} in "
          f"{first_s:.2f} s (first call), peak device memory {peak_gb:.3f} GB; card {card}", flush=True)
    if len(rec_ms["run_mid_phase"]) != 1:
        fail(f"the mid phase ran {len(rec_ms['run_mid_phase'])} times at N=M={N_MID}, not once")
    if calls_mid != MID_CALLS or any(launches_mid[k] < n for k, n in MID_CALLS.items()):
        fail(f"mid path calls {calls_mid} differ from the schedule {MID_CALLS}, or launches {launches_mid}")
    if g_2m.shape != (N_MID, 3) or not (torch.isfinite(v_2m) and torch.isfinite(g_2m).all()):
        fail("mid path: non-finite or misshapen output")
    wall = []
    for _ in range(3):  # the counted call above was the warm-up
        t0 = time.perf_counter()
        value_and_grad(lambda x: auto(x, ym), xm)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    print(f"[mid] loss {v_2m.item():.9e}; loss+grad N=M={N_MID}, host clock, 3 reps after the warm-up: "
          f"{', '.join(f'{t:.3f}' for t in wall)} ms; card {card}", flush=True)
    wall_p, busy, n_launch, top = profile_busy_ms(lambda: value_and_grad(lambda x: auto(x, ym), xm))
    print(f"[time] mid path loss+grad N=M={N_MID} under torch.profiler: wall {wall_p:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {100 * (1 - busy / statistics.median(wall)):.1f} % of the median host clock, "
          f"{n_launch} kernel launches; card {card}",
          flush=True)
    for dev_ms, calls, key in top:
        print(f"[time]   {dev_ms:9.3f} ms {calls:5d} x {key[:90]}", flush=True)
    same = check_mid_tables("mid", f"N=M={N_MID}", mid_tables, extraps)
    print(f"[mid] the sphere tables at N=M={N_MID} kept the former widths (mid_cap, extrap_cap): {same}", flush=True)
    kept_before_after("mid", f"N=M={N_MID}", mid_tables)
    del mid_tables, extraps

    # Kernel 7 on the four extrapolation tables of that run.
    tables = [args for args, _ in rec_cbs["lse_tiles"]]
    for k, args in enumerate(tables):
        xr, src_pts, h7, e7, cols7, cnt7, bn, bm, p7 = args
        kept7 = int(cnt7.clamp(max=cols7.shape[1]).sum())
        rows_c, tiles_c = walk_budget_clips(cnt7, cols7.shape[1])
        check_val("lse_tiles", f"N={xr.shape[0]} src={src_pts.shape[0]} tiles {bn}x{bm} ck={cols7.shape[1]} "
                  f"kept {kept7}/{cols7.numel()} extrapolation {k}", cbs.lse_tiles(*args), cbs.lse_tiles_blocked(*args))
        print(f"[mid] for information, extrapolation {k}: JAX's walk budget (max(12, ck // 2) per row) would "
              f"clip {rows_c} of {cnt7.shape[0]} row tiles, dropping {tiles_c} of {kept7} kept tiles", flush=True)
    # Kernel 1 at the shapes of that run: the coarse sweeps and the mid cloud.
    check_lse_shapes(f"mid path N=M={N_MID}", rec_ck["lse"], clock, card)
    args7 = tables[0]
    work["lse_tiles"] = (
        int(args7[5].clamp(max=args7[4].shape[1]).sum()) * args7[6] * args7[7],
        nbytes(*args7[:3], args7[4], args7[5]) + 4 * args7[0].shape[0],
    )
    kernel_entry("lse_tiles", f"first extrapolation table at N=M={N_MID}",
                 lambda: cbs.lse_tiles(*args7), lambda: cbs.lse_tiles_blocked(*args7), 1, launches_mid["lse_tiles"])

    # Kernels 5 and 6 at tile 1024, on the first fine tables of that run.
    state = first_fine_steps(rec_ms)
    check_tile_kernels(state, f"N=M={N_MID} first {MID_PARITY_TILES} row tiles", rows=MID_PARITY_TILES)
    e, xs, ys, la_f, lb_f, f, g, cols, cnt, _, tile, _ = state["xy"]
    t_args = (xs, ys, la_f + f / e, lb_f + g / e, e, cols, cnt, 2, tile, False)
    Vy = torch.cat([torch.ones_like(ys[:, :1]), ys], 1)
    Vx = torch.cat([torch.ones_like(xs[:, :1]), xs], 1)
    a_args = (*t_args[:4], Vy, Vx, e, cols, cnt, 2, "gibbs", tile, False)
    kept = int(cnt.sum()) * tile * tile
    for name, call in (("absorbed_sum_tiles", lambda: cbs.absorbed_sum_tiles(*t_args)),
                       ("gibbs_apply_tiles", lambda: cbs.gibbs_apply_tiles(*a_args))):
        nb = (nbytes(*t_args[:4], cols, cnt) + 4 * (xs.shape[0] + ys.shape[0]) if name == "absorbed_sum_tiles"
              else nbytes(*a_args[:6], cols, cnt) + 16 * (xs.shape[0] + ys.shape[0]))
        b_ms, b_by = bound(kept, nb, clock)
        # Extra device memory of one call: the chunk's partial sums (under
        # the budget), plus O(N + M) outputs and copies and O(table) indices.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        n0 = cbs.launch_counts[name]
        call()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        limit = cbs.TILES_SCRATCH_BYTES + 160 * (xs.shape[0] + ys.shape[0]) + 64 * cols.numel()
        print(f"[time] {name:18s} first fine step's table at N=M={N_MID}, kept {int(cnt.sum())} tile pairs of "
              f"{tile}: kernel {event_ms(call, 3):.3f} ms, bound {b_ms:.3f} ms ({b_by}) (CUDA events); "
              f"{cbs.launch_counts[name] - n0} launches per call, peak extra memory {extra / 1e6:.1f} MB (limit "
              f"{limit / 1e6:.1f} MB: scratch budget {cbs.TILES_SCRATCH_BYTES / 1e6:.1f} MB + O(N + M) + O(table)); "
              f"card {card}", flush=True)
        if extra > limit:
            fail(f"{name} at N=M={N_MID}: {extra} bytes of extra memory, over {limit}")
    del rec_cbs, rec_ck, rec_ms, tables, args7, state, t_args, a_args, Vx, Vy, xs, ys, f, g, cols, cnt
    torch.cuda.empty_cache()

    # For information: the exact fine phase (kernels 2 and 3) at 2e6.
    w2 = torch.full((N_MID,), 1.0 / N_MID, dtype=f32, device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        v_ex = ms.sinkhorn_multiscale(w2, xm, w2, ym, truncate=None, **kw2)
        torch.cuda.synchronize()
        ex_s = time.perf_counter() - t0
    print(f"[mid] for information, against truncate=None at N=M={N_MID} (exact fine phase, {ex_s:.2f} s): "
          f"loss {v_ex.item():.9e}, rel err {abs(v_2m.item() - v_ex.item()) / abs(v_ex.item()):.3e}", flush=True)
    # The keep rules: the potentials against the same solve whose fine
    # tables (the 1,954 data column tiles of 2,048 dense) and extrapolation
    # tables keep every tile.
    potential_gap("mid", f"N=M={N_MID} spheres, the mid path's potentials (fine and extrapolation tables)",
                  lambda: ms.sinkhorn_multiscale(w2, xm, w2, ym, potentials=True, **kw2), BLUR**2, card,
                  [(ms, "build_tile_masks"), (tbs, "extrap_cols")], tol=MID_GAP_EPS)
    del xm, ym, w2, g_2m
    torch.cuda.empty_cache()

    # --- 9. Mid path forced at 1e5, and a custom cost --------------------------
    saved = ms.N_FINE_OK
    ms.N_FINE_OK = N_FINE_FORCED
    try:
        for p in (1, 2):
            kwp = dict(p=p, **kw)
            cbs.reset_launch_counts()
            v_f, g_f = value_and_grad(lambda x: ms.sinkhorn_multiscale(w, x, w, y0, **kwp), x0)
            torch.cuda.synchronize()
            n7 = cbs.launch_counts["lse_tiles"]
            if n7 != MID_CALLS["lse_tiles"]:
                fail(f"mid path forced at N=M={N_POINTS} p={p}: kernel 7 launched {n7} times")
            v_fr, g_fr = value_and_grad(
                lambda x: ms.sinkhorn_multiscale(w64, x, w64, y0.to(f64), impl="blocked", **kwp), x0.to(f64)
            )
            compare("mid", f"mid path forced (N_FINE_OK={N_FINE_FORCED}) N=M={N_POINTS} p={p}, "
                    f"launches {json.dumps(dict(cbs.launch_counts))}", v_f, g_f, v_fr, g_fr)
    finally:
        ms.N_FINE_OK = saved

    def half_sqdist(X, Y):
        return ((X[:, :, None, :] - Y[:, None, :, :]) ** 2).sum(-1) / 2

    ck.reset_launch_counts()
    cbs.reset_launch_counts()
    t0 = time.perf_counter()
    v_c, g_c = value_and_grad(lambda x: ms.sinkhorn_multiscale(w, x, w, y0, cost=half_sqdist, **kw2), x0)
    torch.cuda.synchronize()
    custom_s = time.perf_counter() - t0
    launches_c = {**ck.launch_counts, **cbs.launch_counts}
    v_cr, g_cr = value_and_grad(
        lambda x: ms.sinkhorn_multiscale(w64, x, w64, y0.to(f64), cost=half_sqdist, **kw2), x0.to(f64)
    )
    compare("custom", f"custom cost |x-y|^2/2 multiscale N=M={N_POINTS} ({custom_s:.2f} s, kernel launches "
            f"{sum(launches_c.values())})", v_c, g_c, v_cr, g_cr)
    print(f"[mid] phases 8 and 9 took {time.perf_counter() - t_mid:.1f} s", flush=True)
    del x0, y0, w, w64
    torch.cuda.empty_cache()

    # --- 10. MMD losses, 12. the public sparse and walk ops, 11. the auto route at 4e6 --
    wide_dim_phase(dev, card, clock)
    grid_phase(dev, card)
    ot_phase(dev, card, clock)
    parallel_phase(dev, card)
    kernels += mmd_phase(dev, card, clock)
    kernels += sparse_phase(dev, card, clock)
    auto_route_phase(dev, card, N_4M, "4m", reps=2)
    auto_route_phase(dev, card, N_TILE2048, "tile2048", reps=1, blur=TILE2048_BLUR, tile=2048,
                     parity_rows=TILE2048_PARITY_TILES)
    gallery_phase(dev, card, clock)
    bench_phase(dev, card)

    card = card_line(dev)
    # Every process this run started (nvcc, nvidia-smi, the [parallel]
    # ranks) has ended and been waited for.
    left = child_processes()
    if left:
        fail(f"processes started by this run are still there: {left}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == [PARALLEL_RANK_ARG]:
        rank, world, store, out_path, dev = sys.argv[2:7]
        sys.exit(0 if _parallel_rank(int(rank), int(world), store, out_path, dev) else 1)
    main()
    sys.exit(0)

// Block-sparse pair-interaction kernels of the multiscale fine phase, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// geomloss_tpu_torch/ops/cuda_block_sparse.py, which also holds each
// kernel's plain PyTorch twin, folds the biases (base-2 units) and builds
// the slot tables before launch. Shared device code: pair_common.cuh.
//
// The truncation tables are CSR lists of kept tiles: row tile I (`tile`
// consecutive sorted points) visits the column tiles cols[I, k] for
// k < cnt[I]. For kernels 5 and 6 the wrapper compacts them on the device
// into the live slots (the kept pairs (I, J), in row-major table order,
// with the entries below the diagonal of a triangle table left out)
// followed by the dead ones (J = -1), and launches that list in chunks
// whose partial sums stay under a fixed scratch budget
// (TILES_SCRATCH_BYTES in ops/cuda_block_sparse.py): the blocks of a dead
// slot return at once and write nothing, and the host never waits for the
// live count.
//
// What bounds these kernels on an H100: the exponential, as for the online
// kernels (one exp2 per kept pair, 16 MUFU results per clock per SM), and,
// once the few FFMAs of a pair come near it, instruction issue; a kept pair
// reads nothing but the two tiles' coordinates and biases. Every kernel
// here runs register-tiled pair blocks (pair_common.cuh) to stay near that
// bound: kernels 5, 6, 8 and 12 over packed points, kernel 7 over the raw
// points (lse_stage, shared with kernel 1).
//
// Kernels 5 and 6 serve square tiles of a symmetric tiling; kernels 7, 8
// and 12 read a (cols, cnt) table directly, with row tiles of block_n
// points and source tiles of block_m points. Kernels 8 and 12 read it in
// CSR form, row tile I visiting cols[row_start[I] + k] for k < cnt[I]:
// the wrapper passes row_start = I * ck for a dense (nI, ck) table (with
// cnt clamped at ck), or the row starts of a walk table it decoded on the
// device (walk_rows_kernel; kernels 10 and 11 of the JAX package run on
// these two).
//
// The TPU walked the kept pairs in order and carried the column sums in
// VMEM from one grid step to the next, flushing them at band markers. CUDA
// blocks run in no order, so here block (q, h) takes the 256 rows h of
// live slot q's row tile against all columns of its column tile, keeps the
// row direction in registers, and writes both directions' partial sums to
// the slot's own scratch: rowpart[q] (the tile's rows) and colpart[q, h]
// (the tile's columns). Every scratch entry of a launch is written exactly
// once, the column direction of a triangle table's diagonal tiles as
// zeros. segment_sum_kernel then adds the row partials of each row tile
// and the column partials of each column tile, in slot order, into the
// outputs: deterministic, no atomics, scratch bounded by the chunk.
//
// A triangle table may be one rank's shard of its symmetric problem's
// (parallel/multiscale_sharded.py): its row tile I is then the global tile
// row_off + I against the whole cloud, and the diagonal is J == row_off + I
// (row_off is 0 for a whole table).
//
// Each entry point returns cudaGetLastError() after its launches.

#include "pair_common.cuh"

namespace {

// -----------------------------------------------------------------------------
// 5. Absorbed sums over the kept tile pairs. Replaces
//    geomloss_tpu/ops/block_sparse.py::_absorbed_sum_walk_banded
//    (_pair_walk_banded_kernel): r_i = sum_j W_ij and c_j = sum_i W_ij over
//    the kept pairs, W_ij = exp2(phi_i + psi_j + arg_ij), no max pass.
//    Bound: one exp2 per kept pair gives both directions (MUFU: 16 per
//    clock per SM); at p = 2, D = 3 a pair also takes D + 1 FFMAs and two
//    adds, about 8 issue slots, which the MUFU rate just balances.
//    Design: one block per (live slot, 256-row slice of the tile), the
//    register-tiled pair blocks of pair_common.cuh (step_stage, shared with
//    kernel 2), kStepCols columns per lane and pass: per pair one LDS.128
//    shared by 8 rows (per kv float4 of the packed points), D + 1 FFMAs,
//    one MUFU.EX2 and the two adds. Points of up to kStepStaged float4s
//    (D <= 11 at p = 2, D <= 12 at p = 1) are staged, the lane's rows in
//    registers and the columns in shared memory; wider points (KV = 0) are
//    read from global memory, a float4 of each at a time, the scores built
//    up in registers. Row sums stay in 8 registers per lane over the whole
//    column tile and are added over the 8 warps once at the end; column
//    sums stay in kStepCols registers over a lane's 8 rows and go to shared
//    memory, where each 256-column stage adds its 32 lanes once, in a fixed
//    order. No shuffles, no atomics: deterministic.
// -----------------------------------------------------------------------------
template <int P, int KV>
__global__ void __launch_bounds__(kThreads)
tiles_step_kernel(const float4* __restrict__ xv, const float4* __restrict__ yv,
                  const float* __restrict__ rb, const float* __restrict__ cb,
                  const int* __restrict__ slot_i, const int* __restrict__ slot_j,
                  float* __restrict__ rowpart, float* __restrict__ colpart, int tile,
                  int tri, int row_off, int kv, float c2) {
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  __shared__ StepSmem<P, KS, WIDE> sm;
  const int lane = threadIdx.x & 31;
  const int64_t q = blockIdx.x;
  const int h = blockIdx.y;
  const int I = slot_i[q];
  const int J = slot_j[q];
  if (J < 0) return;  // a dead slot: left out of the sums
  const int rows = min(kThreads, tile - h * kThreads);
  const int64_t i0 = (int64_t)I * tile + h * kThreads;
  float* rp = rowpart + q * tile + h * kThreads;
  float* cp = colpart + (q * gridDim.y + h) * tile;
  const bool cols = !(tri && I + row_off == J);
  float4 xr[kPairRows][KS];
  float br[kPairRows], racc[kPairRows];
  load_pair_rows<P, KS, WIDE>(xr, br, xv, rb, i0, rows, lane);
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) racc[r] = 0.f;
  for (int c0 = 0; c0 < tile; c0 += kTile) {
    const int n = min(kTile, tile - c0);
    step_stage<P, KV>(sm, xr, br, racc, xv, i0, rows, kv, yv, cb, (int64_t)J * tile + c0, n, n, cols,
                      cp + c0, c2);
  }
  const float sum = block_row_sum(sm, racc);
  if (threadIdx.x < rows) rp[threadIdx.x] = sum;
}

// -----------------------------------------------------------------------------
// 6. Dual apply over the kept tile pairs. Replaces
//    block_sparse.py::gibbs_apply_walk_banded (_apply_walk_banded_kernel):
//    R_row[i] = sum_j w_ij Vy[j] and R_col[j] = sum_i w_ij Vx[i] in one
//    visit of each kept pair, four channels, raw absorbed weights of
//    packed_weight's modes 0-2 (pair_common.cuh).
//    Bound: one exp2 per kept pair (p = 1 adds a sqrt and, for gibbs_grad,
//    a division); at p = 2, D = 3 a pair takes D + 1 FFMAs, the MUFU.EX2
//    and 8 FFMAs for the two directions: about 13 issue slots, so issue,
//    not the MUFU rate, bounds it.
//    Design: kernel 5's register-tiled pair blocks with kApplyCols columns
//    per lane and pass; a lane keeps its 8 rows' Vx and their four row
//    accumulators in registers, and each column's Vy (a float4) is staged
//    beside its coordinates. Column partials (kApplyCols x 4 per lane) go
//    to shared memory once per pass, double-buffered, and 128 threads add
//    the 32 lanes of each (column, channel) in a fixed order. Row partials
//    go to rowpart[q, i, c] (4 channels interleaved), column partials to
//    colpart[q, h, c, j].
//    No tensor cores: the contractions could go to mma.sync, but TF32
//    rounding of V = [1, y] would undo the ones-channel cancellation the
//    backward relies on, unless each operand were split into a high and a
//    low part.
// -----------------------------------------------------------------------------
constexpr int kApplyCols = 4;
constexpr int kApplyPass = kWarps * kApplyCols;  // columns per pass
constexpr int kApplyBlocksPerSM = 2;             // the register cap of kv = 1

template <int MODE, bool WIDE>
__global__ void __launch_bounds__(kThreads, WIDE ? 1 : kApplyBlocksPerSM)
tiles_apply_kernel(const float4* __restrict__ xv, const float4* __restrict__ yv,
                   const float* __restrict__ rb, const float* __restrict__ cb,
                   const float4* __restrict__ vy, const float4* __restrict__ vx,
                   const int* __restrict__ slot_i, const int* __restrict__ slot_j,
                   float* __restrict__ rowpart, float* __restrict__ colpart, int tile,
                   int tri, int row_off, int kv, float c2) {
  constexpr int P = MODE == 0 ? 2 : 1;
  constexpr int R = kPairRows, C = kApplyCols;
  __shared__ float4 ys[WIDE ? 1 : kTile];
  __shared__ float ycb[kTile];
  __shared__ float4 vys[kTile];
  __shared__ float4 red[2][32][kApplyPass + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t q = blockIdx.x;
  const int h = blockIdx.y;
  const int I = slot_i[q];
  const int J = slot_j[q];
  if (J < 0) return;  // a dead slot: left out of the sums
  const int rows = min(kThreads, tile - h * kThreads);
  const int64_t i0 = (int64_t)I * tile + h * kThreads;
  float4* rp = reinterpret_cast<float4*>(rowpart) + q * tile + h * kThreads;
  float* cp = colpart + (q * gridDim.y + h) * 4 * tile;
  const bool cols = !(tri && I + row_off == J);
  // Column reduction: lane l stores its pass partials at red[buf][l][warp C
  // ..]; thread t then adds column o / 4, channel o % 4 (o = t / 2) over
  // the lanes of its half (t % 2).
  static_assert(4 * kApplyPass == kThreads / 2, "one (column, channel) per thread pair");
  constexpr int kRedPitch4 = 4 * (kApplyPass + 1);  // floats per lane row
  constexpr int kRedBuf = 32 * (kApplyPass + 1);    // float4s per buffer
  const int half = threadIdx.x & 1, o = threadIdx.x >> 1;
  float4* red_w = &red[0][lane][warp * C];
  const float* red_r = &red[0][half * 4][o >> 2].x + (o & 3);
  float* cpo = cp + (o & 3) * tile + (o >> 2);
  float4 xr[R], ux[R], racc[R];
  float br[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int il = lane + 32 * r;
    const bool ok = il < rows;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    xr[r] = (!WIDE && ok) ? xv[i0 + il] : zero;
    if constexpr (P == 2) xr[r].w = 1.f;  // the packed row's last slot: the column bias's factor
    ux[r] = ok ? vx[i0 + il] : zero;
    br[r] = ok ? rb[i0 + il] : -INFINITY;
    racc[r] = zero;
  }
  int buf = 0;
  for (int c0 = 0; c0 < tile; c0 += kTile) {
    const int n = min(kTile, tile - c0);
    const int64_t j0 = (int64_t)J * tile + c0;
    __syncthreads();  // the last stage's reads of ys, ycb and vys are done
    for (int k = threadIdx.x; k < n; k += kThreads) {
      if constexpr (!WIDE) ys[k] = yv[j0 + k];
      if constexpr (P == 1) ycb[k] = cb[j0 + k];
      vys[k] = vy[j0 + k];
    }
    __syncthreads();
    for (int b = 0; b < n; b += kApplyPass) {
      const int cb0 = b + warp * C;
      float4 cacc[C];
      float s[WIDE ? R : 1][C];
      if constexpr (WIDE) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int c = 0; c < C; ++c) s[r][c] = P == 2 ? br[r] : 0.f;
        }
        for (int k = 0; k < kv; ++k) {
          float4 xk[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int il = lane + 32 * r;
            xk[r] = il < rows ? xv[(i0 + il) * kv + k] : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float4 y = yv[(j0 + cb0 + c) * kv + k];
#pragma unroll
            for (int r = 0; r < R; ++r) s[r][c] = packed_acc<P>(xk[r], y, s[r][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 v = vys[cb0 + c];
        const float bc = P == 1 ? ycb[cb0 + c] : 0.f;
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (!WIDE) y = ys[cb0 + c];
        float4 ca = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float sc;
          if constexpr (WIDE) sc = s[r][c];
          else sc = packed_acc<P>(xr[r], y, P == 2 ? br[r] : 0.f);
          const float w = packed_weight<P, MODE>(sc, br[r] + bc, c2);
          racc[r].x = fmaf(w, v.x, racc[r].x);
          racc[r].y = fmaf(w, v.y, racc[r].y);
          racc[r].z = fmaf(w, v.z, racc[r].z);
          racc[r].w = fmaf(w, v.w, racc[r].w);
          ca.x = fmaf(w, ux[r].x, ca.x);
          ca.y = fmaf(w, ux[r].y, ca.y);
          ca.z = fmaf(w, ux[r].z, ca.z);
          ca.w = fmaf(w, ux[r].w, ca.w);
        }
        cacc[c] = ca;
      }
      if (cols) {
#pragma unroll
        float4* w = red_w + buf * kRedBuf;
#pragma unroll
        for (int c = 0; c < C; ++c) w[c] = cacc[c];
        __syncthreads();
        // Threads 2 o and 2 o + 1 add column o / 4, channel o % 4 of the
        // pass over 16 lanes each (lanes 4 rows apart, so the two halves
        // read other banks), then combine; the next pass writes the other
        // buffer.
        const float* rd = red_r + buf * 4 * kRedBuf;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 16; ++k) sum[k & 3] += rd[((k >> 2) * 8 + (k & 3)) * kRedPitch4];
        const float part = (sum[0] + sum[1]) + (sum[2] + sum[3]);
        const float other = __shfl_xor_sync(kFullMask, part, 1);
        if (half == 0) cpo[c0 + b] = part + other;
        buf ^= 1;
      } else if (half == 0) {
        cpo[c0 + b] = 0.f;
      }
    }
  }
  // Row sums: the 8 warps' partials of each row, added in warp order.
  static_assert(sizeof(red) >= sizeof(float4) * kWarps * kThreads, "row buffer");
  __syncthreads();
  float4* rr = &red[0][0][0];
#pragma unroll
  for (int r = 0; r < R; ++r) rr[warp * kThreads + lane + 32 * r] = racc[r];
  __syncthreads();
  if (threadIdx.x < rows) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 v = rr[w * kThreads + threadIdx.x];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    rp[threadIdx.x] = sum;
  }
}

// -----------------------------------------------------------------------------
// 7. Truncated LSE over kept source tiles. Replaces
//    geomloss_tpu/ops/block_sparse.py::lse_walk (_lse_walk_kernel), the
//    detached coarse/mid -> fine extrapolations of the mid path, and serves
//    block_sparse.py::lse_sparse (_lse_sparse_kernel, kernel 9), the same
//    function over the same table: out_i = log sum_j exp(h_j - C_p(x_i,
//    y_j) / eps) over the source tiles cols[I, k], k < cnt[I], of row i's
//    tile I; rows come in tiles of block_n points, sources in tiles of
//    block_m points (any sizes).
//    Bound: one exp2 per kept pair (p = 1 adds a sqrt), as kernel 1.
//    Design: kernel 1's register-tiled LSE (lse_stage, pair_common.cuh)
//    over a virtual column range: a row tile's kept tiles laid end to end,
//    virtual column v being column v % block_m of kept tile v / block_m.
//    Stages of 256 virtual columns take two kept tiles of 128 at once, or a
//    quarter of one of 1024. Block (I, h, q) takes the 256-row slice h of
//    row tile I against kept tiles q span .. (q + 1) span - 1 (those below
//    cnt[I]): a long row is split across blocks, so a table with one long
//    row among short ones still fills the card; a range past cnt[I] is
//    empty and gives (-inf, 0). With one range (gridDim.z == 1) the block
//    writes out_i itself; with more, each writes its rows' (m, s) to part[q,
//    i] and lse_merge_kernel merges them in range order: deterministic, no
//    atomics. The mid path reads its (cols, cnt) tables directly, not
//    packed into walk_plan step lists, so their per-chunk budget, which
//    clipped kept tiles, does not apply: every kept tile is visited.
// -----------------------------------------------------------------------------
template <int P, int KV>
__global__ void __launch_bounds__(kThreads, KV == 1 ? 2 : 1)
tiles_lse_kernel(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ h,
                 const int* __restrict__ cols, const int* __restrict__ cnt, float* __restrict__ out,
                 float2* __restrict__ part, int N, int ck, int block_n, int block_m, int span, int ld, int D, int kv,
                 float c2) {
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  __shared__ LseSmem<KS, WIDE> sm;
  const int I = blockIdx.x;
  const int rows = min(kThreads, block_n - (int)blockIdx.y * kThreads);
  const int64_t i0 = (int64_t)I * block_n + (int64_t)blockIdx.y * kThreads;
  float m[kPairRows], s[kPairRows];
  load_lse_rows<KS, WIDE>(sm, x, ld, D, i0, rows, P == 2 ? c2 : 1.f);
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  const int t0 = blockIdx.z * span;
  const int t1 = min(min(cnt[I], ck), t0 + span);
  const int* row_cols = cols + (int64_t)I * ck + t0;
  const int nv = max(0, t1 - t0) * block_m;  // virtual columns of the range
  for (int v0 = 0; v0 < nv; v0 += kTile) {
    const auto col = [=](int k) {
      const int v = v0 + k;
      return (int64_t)row_cols[v / block_m] * block_m + v % block_m;
    };
    lse_stage<P, KV>(sm, m, s, x, i0, rows, y, h, ld, D, kv, col, min(kTile, nv - v0), c2);
  }
  const float2 ms = block_lse_merge(sm, m, s);
  const int64_t i = i0 + threadIdx.x;
  if (threadIdx.x < rows) {
    if (gridDim.z == 1) out[i] = lse_out(ms, x, i, ld, D, P, c2);
    else part[(int64_t)blockIdx.z * N + i] = ms;
  }
}

// -----------------------------------------------------------------------------
// 8. Truncated apply over kept source tiles. Replaces
//    geomloss_tpu/ops/block_sparse.py::gibbs_apply_sparse
//    (_apply_sparse_kernel), the truncated MMD matvecs and the backward of
//    the truncated softmin: O_i = sum_j w_ij V_j over the source tiles
//    cols[row_start[I] + k], k < cnt[I], of row i's tile I, CH = 1 or 4
//    channels (the wrapper sends one channel alone and wider V in groups of
//    four), with the weights of packed_weight's modes 0-4
//    (pair_common.cuh). Rows come in tiles of block_n points, sources in
//    tiles of block_m points (any sizes). Also serves
//    block_sparse.py::gibbs_apply_walk (_apply_walk_kernel), the same
//    function over a walk table: the walk is only the TPU's traversal
//    order, and the wrapper decodes it into row starts and counts.
//    Bound: one MUFU operation per kept pair (an exp2; p = 1 adds an IEEE
//    sqrt and, for gibbs_grad, a division; energy and inv_dist take one
//    rsqrt.approx, no exp2), then CH FFMAs: at p = 2, D = 3 a pair takes 4
//    FFMAs, the MUFU.EX2 and CH FFMAs, 6 issue slots at CH = 1 (the MUFU
//    rate binds) and 9 at CH = 4 (issue binds, just above the MUFU rate).
//    Design: the register-tiled pair blocks with the row direction only.
//    One block per (row tile, 256-row slice) walks the row tile's kept
//    tiles (a CSR indirection); a lane owns 8 rows (packed points and CH accumulators in
//    registers). Block (slot, h, q) takes the 256-row slice h of row tile
//    I = order[slot] against its kept tiles floor(q cnt / S) ..
//    floor((q + 1) cnt / S) - 1, S = gridDim.y: kernel 12's ranges
//    (cuda_block_sparse.sum_rows_plan), so that a table whose seam rows
//    keep six to ten times the mean count (the gaussian MMD's) does not
//    end on a few long blocks. The row tiles go out in the order `order`
//    gives (the wrapper's: decreasing kept count), the slices of a row
//    tile side by side, so that where the launch is wide enough for S = 1
//    the longest rows start first. Each kept source tile goes through the
//    row-contraction stage shared with kernel 4 (apply_stage,
//    pair_common.cuh) kTile columns at a time. With S = 1 each row is
//    written once; with more, each range writes its rows' partial to
//    part[q, i] (an empty range writes 0) and sum_merge_kernel adds the S
//    partials in range order: no atomics, bitwise reproducible, and the
//    same for a (cols, counts) table and its unclipped walk, whose rows
//    keep the same counts. Points of up to kStepStaged float4s are
//    staged; wider ones (KV = 0) are read from global memory per pass, as
//    kernel 5's. The TPU's bf16 split of wide V (the mxu path, C >= 9) has
//    no counterpart: every channel is an exact float32 FFMA.
// -----------------------------------------------------------------------------
template <int MODE, int KV, int CH>
__global__ void __launch_bounds__(kThreads, KV == 1 ? 2 : 1)
sparse_apply_kernel(const float4* __restrict__ xv, const float4* __restrict__ yv,
                    const float* __restrict__ rb, const float* __restrict__ cb,
                    const typename Chan<CH>::T* __restrict__ v, const int* __restrict__ cols,
                    const int* __restrict__ row_start, const int* __restrict__ cnt,
                    const int* __restrict__ order, typename Chan<CH>::T* __restrict__ out,
                    typename Chan<CH>::T* __restrict__ part, int64_t N, int block_n, int block_m,
                    int kv, float c2) {
  using VT = typename Chan<CH>::T;
  constexpr int P = MODE == 0 ? 2 : 1;
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  __shared__ ApplySmem<KS, CH, WIDE> sm;
  const int lane = threadIdx.x & 31;
  const int slices = (block_n + kThreads - 1) / kThreads;
  const int I = order[blockIdx.x / slices];
  const int h = blockIdx.x % slices;
  const int rows = min(kThreads, block_n - h * kThreads);
  const int64_t i0 = (int64_t)I * block_n + (int64_t)h * kThreads;
  const int S = gridDim.y;
  const int64_t n_kept = cnt[I];
  const int t0 = (int)(blockIdx.y * n_kept / S);
  const int t1 = (int)((blockIdx.y + 1) * n_kept / S);
  VT* dst = (S == 1 ? out : part + (int64_t)blockIdx.y * N) + i0;
  if (t1 <= t0) {  // an empty range (or row)
    VT zero;
    chan_zero(zero);
    if (threadIdx.x < rows) dst[threadIdx.x] = zero;
    return;
  }
  float4 xr[kPairRows][KS];
  float br[kPairRows];
  load_pair_rows<P, KS, WIDE>(xr, br, xv, rb, i0, rows, lane);
  VT acc[kPairRows];
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) chan_zero(acc[r]);
  const int* row_cols = cols + row_start[I];
  for (int k = t0; k < t1; ++k) {
    const int64_t j_tile = (int64_t)row_cols[k] * block_m;
    for (int c0 = 0; c0 < block_m; c0 += kTile)
      apply_stage<MODE, KV, CH>(sm, xr, br, acc, xv, i0, rows, kv, yv, cb, v, j_tile + c0,
                                min(kTile, block_m - c0), c2);
  }
  const VT sum = block_apply_sum(sm, acc);
  if (threadIdx.x < rows) dst[threadIdx.x] = sum;
}

// -----------------------------------------------------------------------------
// 12. Absorbed row sums over kept source tiles. Replaces
//    geomloss_tpu/ops/block_sparse.py::_absorbed_sum (_row_sum_sparse_kernel)
//    and, over a decoded walk table, ::_absorbed_sum_walk
//    (_row_sum_walk_kernel): r_i = sum_j exp2(phi_i + psi_j + arg_ij) over
//    the source tiles cols[row_start[I] + k], k < cnt[I], of row i's tile
//    I, the raw sums of the public sparse and walk Sinkhorn steps (the
//    wrapper floors them and takes the log). No max pass: the annealing
//    bounds the absorbed weights (block_sparse.py, "Single-pass absorbed
//    sparse softmin"), and phi_i stays inside the exponent.
//    Bound: one exp2 per kept pair (MUFU: 16 per clock per SM); at p = 2,
//    D = 3 a pair also takes D + 1 FFMAs and one add, about 6 issue slots,
//    under the MUFU rate's 8.
//    Design: kernel 5's register-tiled stage in its row-only form
//    (step_stage<P, KV, false>, pair_common.cuh) over kernel 8's CSR
//    indirection: packed float4 points, 8 rows a lane in registers, one
//    ex2.approx and one add per pair, row sums in registers over the
//    block's kept tiles, added over the 8 warps once at the end. A source
//    tile of any block_m goes through in stages of kTile columns, the
//    ragged last pass padded with columns of bias -inf. Block (I, h, q)
//    takes the 256-row slice h of row tile I against its kept tiles
//    floor(q cnt / S) .. floor((q + 1) cnt / S) - 1, S = gridDim.z: every
//    row, long or short, is cut into S ranges of about equal length, so a
//    table whose rows differ widely in length still keeps the card's SMs
//    busy to the end. The ranges depend on the row's count alone, which a
//    (cols, counts) table and its unclipped walk share, so the two forms
//    give bitwise-equal sums. With S = 1 the block writes out_i itself;
//    with more, each writes its rows' partial to part[q, i] (an empty range
//    writes 0) and sum_merge_kernel adds the S partials in range order.
//    Every entry written once, no atomics: bitwise reproducible. Points of
//    up to kStepStaged float4s (D <= 11 at p = 2, D <= 12 at p = 1) are
//    staged; wider ones (KV = 0) are read from global memory per pass. One
//    float4 a point (D <= 3 at p = 2) is held to 85 registers, three blocks
//    an SM: 80 registers, no spill, against 115 and two blocks unbounded,
//    8 % faster on an H100 (PERF.md, PR 10); 64 registers (four) spill.
// -----------------------------------------------------------------------------
template <int P, int KV>
__global__ void __launch_bounds__(kThreads, KV == 1 ? 3 : 1)
sparse_sum_kernel(const float4* __restrict__ xv, const float4* __restrict__ yv,
                  const float* __restrict__ rb, const float* __restrict__ cb,
                  const int* __restrict__ cols, const int* __restrict__ row_start,
                  const int* __restrict__ cnt, float* __restrict__ out, float* __restrict__ part,
                  int N, int block_n, int block_m, int kv, float c2) {
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  __shared__ StepSmem<P, KS, WIDE> sm;
  const int lane = threadIdx.x & 31;
  const int I = blockIdx.x;
  const int rows = min(kThreads, block_n - (int)blockIdx.y * kThreads);
  const int64_t i0 = (int64_t)I * block_n + (int64_t)blockIdx.y * kThreads;
  const int S = gridDim.z;
  const int64_t n_kept = cnt[I];
  const int t0 = (int)(blockIdx.z * n_kept / S);
  const int t1 = (int)((blockIdx.z + 1) * n_kept / S);
  float* dst = (S == 1 ? out : part + (int64_t)blockIdx.z * N) + i0;
  if (t1 <= t0) {  // an empty range (or row)
    if (threadIdx.x < rows) dst[threadIdx.x] = 0.f;
    return;
  }
  float4 xr[kPairRows][KS];
  float br[kPairRows], racc[kPairRows];
  load_pair_rows<P, KS, WIDE>(xr, br, xv, rb, i0, rows, lane);
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) racc[r] = 0.f;
  const int* row_cols = cols + row_start[I];
  for (int k = t0; k < t1; ++k) {
    const int64_t j_tile = (int64_t)row_cols[k] * block_m;
    for (int c0 = 0; c0 < block_m; c0 += kTile)
      step_stage<P, KV, false>(sm, xr, br, racc, xv, i0, rows, kv, yv, cb, j_tile + c0,
                               min(kTile, block_m - c0), 0, false, nullptr, c2);
  }
  const float sum = block_row_sum(sm, racc);
  if (threadIdx.x < rows) dst[threadIdx.x] = sum;
}

// Second pass of kernel 12 when its rows are cut into S > 1 ranges: out[i]
// = the S partials part[q, i], added in range order from 0. One thread per
// row. Bound: reading the partials once.
__global__ void __launch_bounds__(kThreads)
sum_merge_kernel(const float* __restrict__ part, float* __restrict__ out, int N, int S) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  float sum = 0.f;
  for (int q = 0; q < S; ++q) sum += part[(int64_t)q * N + i];
  out[i] = sum;
}

// -----------------------------------------------------------------------------
// Decode of a walk table (cuda_block_sparse.walk_plan) into the CSR form of
// kernels 8 and 12, for kernels 10 and 11: the flat column tiles, each row
// tile's first step and its live steps. A step packs fl << 26 | row << 13
// | jt (fl 1 a row's first step, 0 a continuation, 2 dead padding; row the
// row tile within its chunk of rows_c rows and T_c steps). walk_plan lays
// a chunk's steps out in row order, a row's live steps consecutive from
// its first one, so thread I finds row tile I's first step by binary
// search over its chunk's row fields and counts the live steps after it;
// a row tile with no first step keeps nothing (start 0, count 0). Thread
// t also writes flat column t. One launch, no atomics, no host read; the
// same result as the PyTorch form (cuda_block_sparse._walk_rows_plain).
// Bound: reading the table once.
// -----------------------------------------------------------------------------
constexpr int kWalkBits = 13;
constexpr int kWalkMask = (1 << kWalkBits) - 1;

__device__ __forceinline__ int walk_row(int w) { return (w >> kWalkBits) & kWalkMask; }
__device__ __forceinline__ int walk_flag(int w) { return (w >> 26) & 3; }

__global__ void __launch_bounds__(kThreads)
walk_rows_kernel(const int* __restrict__ tbl, int* __restrict__ cols, int* __restrict__ start,
                 int* __restrict__ cnt, int64_t steps, int T_c, int rows_c, int nI) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t < steps) cols[t] = tbl[t] & kWalkMask;
  if (t >= nI) return;
  const int r = (int)(t % rows_c);
  const int* ch = tbl + (t / rows_c) * T_c;
  int lo = 0, hi = T_c;  // the first step of the chunk whose row field is >= r
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (walk_row(ch[mid]) < r) lo = mid + 1;
    else hi = mid;
  }
  int s = 0, n = 0;
  if (lo < T_c && walk_row(ch[lo]) == r && walk_flag(ch[lo]) == 1) {
    s = (int)((t / rows_c) * T_c + lo);
    n = 1;
    while (lo + n < T_c && walk_row(ch[lo + n]) == r && walk_flag(ch[lo + n]) == 0) ++n;
  }
  start[t] = s;
  cnt[t] = n;
}

// -----------------------------------------------------------------------------
// Second pass of kernels 5 and 6: out[g, l] += sum over the slots s of
// segment g (order[offsets[g]] .. order[offsets[g + 1] - 1], in that order)
// of sum_h parts[s, h, l], for l < L; an empty segment leaves out[g]
// untouched. One thread per (segment, lane); a fixed summation order, and
// the chunks of a call are added in order, so the result is deterministic.
// Bound: reading the partials once.
// -----------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ parts, const int* __restrict__ order,
                   const int* __restrict__ offsets, float* __restrict__ out, int L,
                   int nsub) {
  const int g = blockIdx.y;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const int q0 = offsets[g], q1 = offsets[g + 1];
  if (l >= L || q0 == q1) return;
  float acc = 0.f;
  for (int q = q0; q < q1; ++q) {
    const float* row = parts + (int64_t)order[q] * nsub * L + l;
    for (int h = 0; h < nsub; ++h) acc += row[(int64_t)h * L];
  }
  out[(int64_t)g * L + l] += acc;
}

}  // namespace

extern "C" {

// nslots slots (slot_i, slot_j: their row and column tiles, slot_j = -1
// for a dead slot), nsub = ceil(tile / 256) row slices per slot; xv and yv
// the packed points (kv float4 each, pair_common.cuh), rb and cb the row
// and column biases (cb read for p = 1 only).
int gl_absorbed_sum_tiles(const float* xv, const float* yv, const float* rb,
                          const float* cb, const int* slot_i, const int* slot_j,
                          float* rowpart, float* colpart, int nslots, int tile, int kv,
                          int p, int tri, int row_off, float c2, void* stream) {
  if (nslots == 0) return (int)cudaSuccess;
  if ((p != 1 && p != 2) || kv < 1 || tile % 128) return (int)cudaErrorInvalidValue;
  const dim3 grid(nslots, cdiv(tile, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  const float4* y4 = reinterpret_cast<const float4*>(yv);
#define GL_STEP(P, KV) \
  tiles_step_kernel<P, KV><<<grid, kThreads, 0, s>>>(x4, y4, rb, cb, slot_i, slot_j, rowpart, colpart, tile, tri, row_off, kv, c2)
#define GL_STEP_KV(P)                                  \
  switch (kv) {                                        \
    case 1: GL_STEP(P, 1); break;                      \
    case 2: GL_STEP(P, 2); break;                      \
    case kStepStaged: GL_STEP(P, kStepStaged); break;  \
    default: GL_STEP(P, 0); break;                     \
  }
  if (p == 2) GL_STEP_KV(2)
  else GL_STEP_KV(1)
#undef GL_STEP_KV
#undef GL_STEP
  return (int)cudaGetLastError();
}

// vy (M, 4) and vx (N, 4): one channel group of Vy and Vx.
int gl_gibbs_apply_tiles(const float* xv, const float* yv, const float* rb,
                         const float* cb, const float* vy, const float* vx,
                         const int* slot_i, const int* slot_j, float* rowpart,
                         float* colpart, int nslots, int tile, int kv, int mode,
                         int tri, int row_off, float c2, void* stream) {
  if (nslots == 0) return (int)cudaSuccess;
  if (mode < 0 || mode > 2 || kv < 1 || tile % 128) return (int)cudaErrorInvalidValue;
  const dim3 grid(nslots, cdiv(tile, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  const float4* y4 = reinterpret_cast<const float4*>(yv);
  const float4* vy4 = reinterpret_cast<const float4*>(vy);
  const float4* vx4 = reinterpret_cast<const float4*>(vx);
#define GL_APPLY(MODE, WIDE)                                                                  \
  tiles_apply_kernel<MODE, WIDE><<<grid, kThreads, 0, s>>>(x4, y4, rb, cb, vy4, vx4, slot_i, \
                                                           slot_j, rowpart, colpart, tile, tri, row_off, kv, c2)
  const bool wide = kv > 1;
  switch (mode) {
    case 0: if (wide) GL_APPLY(0, true); else GL_APPLY(0, false); break;
    case 1: if (wide) GL_APPLY(1, true); else GL_APPLY(1, false); break;
    default: if (wide) GL_APPLY(2, true); else GL_APPLY(2, false); break;
  }
#undef GL_APPLY
  return (int)cudaGetLastError();
}

// n_rows = N / block_n row tiles, ck the table width, n_split ranges of
// span kept tiles; x (N, D) and y (M, D) with row stride ld floats (ld =
// 4 kv above kStepStaged float4s), h (M,) in nats; part (n_split, N) (m, s)
// pairs where n_split > 1.
int gl_lse_tiles(const float* x, const float* y, const float* h, const int* cols, const int* cnt, float* out,
                 float* part, int n_rows, int ck, int block_n, int block_m, int n_split, int span, int ld, int D,
                 int kv, int p, float c2, void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  if ((p != 1 && p != 2) || kv < 1 || D < 1 || block_n < 1 || block_m < 1 || n_split < 1 ||
      (kv > kStepStaged && ld != 4 * kv))
    return (int)cudaErrorInvalidValue;
  const int N = n_rows * block_n;
  const dim3 grid(n_rows, cdiv(block_n, kThreads), n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part2 = reinterpret_cast<float2*>(part);
#define GL_LSE(P, KV)                                                                                        \
  tiles_lse_kernel<P, KV><<<grid, kThreads, 0, s>>>(x, y, h, cols, cnt, out, part2, N, ck, block_n, block_m, \
                                                    span, ld, D, kv, c2)
#define GL_LSE_KV(P)                                  \
  switch (kv) {                                       \
    case 1: GL_LSE(P, 1); break;                      \
    case 2: GL_LSE(P, 2); break;                      \
    case kStepStaged: GL_LSE(P, kStepStaged); break;  \
    default: GL_LSE(P, 0); break;                     \
  }
  if (p == 2) GL_LSE_KV(2)
  else GL_LSE_KV(1)
#undef GL_LSE_KV
#undef GL_LSE
  const int err = (int)cudaGetLastError();
  if (err) return err;
  launch_lse_merge(part2, x, out, N, n_split, ld, D, p, c2, s);
  return (int)cudaGetLastError();
}

// n_rows = N / block_n row tiles of a CSR table (cols, row_start, cnt),
// visited in the order of `order` (a permutation of the row tiles); xv and
// yv the packed points (kv float4 each), rb and cb their biases (cb read
// for modes 1 and 2), v (M, ch) one channel group of V, ch 1 or 4; n_split
// ranges of each row's kept tiles, part (n_split, N, ch) where n_split >
// 1; out (N, ch).
int gl_gibbs_apply_sparse(const float* xv, const float* yv, const float* rb,
                          const float* cb, const float* v, const int* cols,
                          const int* row_start, const int* cnt, const int* order, float* out,
                          float* part, int n_rows, int block_n, int block_m, int n_split, int kv,
                          int ch, int mode, float c2, void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  if (mode < 0 || mode > 4 || kv < 1 || (ch != 1 && ch != 4) || block_n < 1 || block_m < 1 ||
      n_split < 1 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)n_rows * cdiv(block_n, kThreads);
  const int64_t N = (int64_t)n_rows * block_n;
  if (blocks > INT32_MAX || N * ch > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  const float4* y4 = reinterpret_cast<const float4*>(yv);
#define GL_SPARSE(MODE, KV, CH)                                                             \
  sparse_apply_kernel<MODE, KV, CH><<<grid, kThreads, 0, s>>>(                              \
      x4, y4, rb, cb, reinterpret_cast<const Chan<CH>::T*>(v), cols, row_start, cnt, order, \
      reinterpret_cast<Chan<CH>::T*>(out), reinterpret_cast<Chan<CH>::T*>(part), N, block_n,  \
      block_m, kv, c2)
#define GL_SPARSE_KV(MODE, CH)                             \
  switch (kv) {                                            \
    case 1: GL_SPARSE(MODE, 1, CH); break;                 \
    case 2: GL_SPARSE(MODE, 2, CH); break;                 \
    case kStepStaged: GL_SPARSE(MODE, kStepStaged, CH); break; \
    default: GL_SPARSE(MODE, 0, CH); break;                \
  }
#define GL_SPARSE_CH(MODE) \
  if (ch == 1) {           \
    GL_SPARSE_KV(MODE, 1)  \
  } else {                 \
    GL_SPARSE_KV(MODE, 4)  \
  }
  switch (mode) {
    case 0: GL_SPARSE_CH(0) break;
    case 1: GL_SPARSE_CH(1) break;
    case 2: GL_SPARSE_CH(2) break;
    case 3: GL_SPARSE_CH(3) break;
    default: GL_SPARSE_CH(4) break;
  }
#undef GL_SPARSE_CH
#undef GL_SPARSE_KV
#undef GL_SPARSE
  const int err = (int)cudaGetLastError();
  if (err || n_split == 1) return err;
  const int n_out = (int)(N * ch);
  sum_merge_kernel<<<cdiv(n_out, kThreads), kThreads, 0, s>>>(part, out, n_out, n_split);
  return (int)cudaGetLastError();
}

// n_rows = N / block_n row tiles of a CSR table (cols, row_start, cnt); xv
// and yv the packed points (kv float4 each), rb and cb their biases (cb
// read for p = 1 only); n_split ranges of each row's kept tiles, part
// (n_split, N) where n_split > 1; out (N,).
int gl_absorbed_sum_sparse(const float* xv, const float* yv, const float* rb,
                           const float* cb, const int* cols, const int* row_start,
                           const int* cnt, float* out, float* part, int n_rows, int block_n,
                           int block_m, int n_split, int kv, int p, float c2, void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  if ((p != 1 && p != 2) || kv < 1 || block_n < 1 || block_m < 1 || n_split < 1 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const int N = n_rows * block_n;
  const dim3 grid(n_rows, cdiv(block_n, kThreads), n_split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  const float4* y4 = reinterpret_cast<const float4*>(yv);
#define GL_SUM(P, KV)                                                                                       \
  sparse_sum_kernel<P, KV><<<grid, kThreads, 0, s>>>(x4, y4, rb, cb, cols, row_start, cnt, out, part, N, \
                                                     block_n, block_m, kv, c2)
#define GL_SUM_KV(P)                                  \
  switch (kv) {                                       \
    case 1: GL_SUM(P, 1); break;                      \
    case 2: GL_SUM(P, 2); break;                      \
    case kStepStaged: GL_SUM(P, kStepStaged); break;  \
    default: GL_SUM(P, 0); break;                     \
  }
  if (p == 2) GL_SUM_KV(2)
  else GL_SUM_KV(1)
#undef GL_SUM_KV
#undef GL_SUM
  const int err = (int)cudaGetLastError();
  if (err || n_split == 1) return err;
  sum_merge_kernel<<<cdiv(N, kThreads), kThreads, 0, s>>>(part, out, N, n_split);
  return (int)cudaGetLastError();
}

// tbl (nc, T_c) int32 walk steps of nI row tiles in chunks of rows_c;
// cols (nc T_c,), start (nI,) and cnt (nI,) int32.
int gl_walk_rows(const int* tbl, int* cols, int* start, int* cnt, int nc, int T_c, int rows_c, int nI,
                 void* stream) {
  const int64_t steps = (int64_t)nc * T_c;
  const int64_t n = steps > nI ? steps : nI;
  if (n == 0) return (int)cudaSuccess;
  if (T_c < 1 || rows_c < 1 || (int64_t)cdiv(nI, rows_c) > nc) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  walk_rows_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(tbl, cols, start, cnt, steps, T_c,
                                                                                  rows_c, nI);
  return (int)cudaGetLastError();
}

int gl_segment_sum(const float* parts, const int* order, const int* offsets,
                   float* out, int nseg, int L, int nsub, void* stream) {
  if (nseg == 0) return (int)cudaSuccess;
  const dim3 grid(cdiv(L, kThreads), nseg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  segment_sum_kernel<<<grid, kThreads, 0, s>>>(parts, order, offsets, out, L, nsub);
  return (int)cudaGetLastError();
}

}  // extern "C"

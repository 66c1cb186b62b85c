// Block-sparse pair-interaction kernels of the multiscale fine phase, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// geomloss_tpu_torch/ops/cuda_block_sparse.py, which also holds each
// kernel's plain PyTorch twin, folds the biases (base-2 units) and builds
// the slot tables before launch. Shared device code: pair_common.cuh.
//
// The truncation tables are CSR lists of kept tiles: row tile I (`tile`
// consecutive sorted points) visits the column tiles cols[I, k] for
// k < cnt[I]. The wrapper flattens them into slots s = I * ck + k with
// slot_j[s] the column tile, or -1 for a dead slot (k >= cnt[I], or below
// the diagonal of a triangle table).
//
// What bounds these kernels on an H100: the exponential, as for the online
// kernels (one exp2 per kept pair, 16 MUFU results per clock per SM); a
// kept pair reads nothing but the two tiles' coordinates and biases.
//
// Kernels 5 and 6 serve square tiles of a symmetric tiling; kernel 7 (the
// mid path's extrapolations) reads its (cols, cnt) table directly, with
// row tiles of block_n points and source tiles of block_m points.
//
// The TPU walked the kept pairs in order and carried the column sums in
// VMEM from one grid step to the next, flushing them at band markers. CUDA
// blocks run in no order, so here block (s, h) takes the 256 rows h of
// slot s's row tile against all columns of its column tile, keeps the row
// direction in registers, and writes both directions' partial sums to the
// slot's own scratch: rowpart[k, I] (the tile's rows) and colpart[s, h]
// (the tile's columns). Every scratch entry is written exactly once, dead
// slots and the column direction of a triangle table's diagonal tiles as
// zeros. The wrapper sums the row partials over k, and segment_sum_kernel sums
// each column tile's partials in slot order through an index built with a
// stable argsort: deterministic, no atomics, O(kept pairs x tile) scratch.
//
// Each entry point returns cudaGetLastError() after its launch.

#include "pair_common.cuh"

namespace {

// -----------------------------------------------------------------------------
// 5. Absorbed sums over the kept tile pairs. Replaces
//    geomloss_tpu/ops/block_sparse.py::_absorbed_sum_walk_banded
//    (_pair_walk_banded_kernel): r_i = sum_j W_ij and c_j = sum_i W_ij over
//    the kept pairs, W_ij = exp2(phi_i + psi_j + arg_ij), no max pass.
//    Bound: one exp2 per kept pair gives both directions. Design: one block
//    per (slot, 256-row slice of the tile), column tiles staged 256 columns
//    at a time, column sums by the transposed warp reduction.
// -----------------------------------------------------------------------------
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
tiles_step_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ phi, const float* __restrict__ psi,
                  const int* __restrict__ slot_j, float* __restrict__ rowpart,
                  float* __restrict__ colpart, int ck, int tile, int tri, float c2) {
  __shared__ Tile<D> t;
  __shared__ float wsum[kWarps][kTile];
  const int64_t s = blockIdx.x;
  const int h = blockIdx.y;
  const int I = (int)(s / ck);
  const int64_t pos = s - (int64_t)I * ck;  // k of slot s
  const int J = slot_j[s];
  const int rows = min(kThreads, tile - h * kThreads);
  const bool valid = threadIdx.x < rows;
  float* rp = rowpart + (pos * (gridDim.x / ck) + I) * tile + h * kThreads;
  float* cp = colpart + (s * gridDim.y + h) * tile;
  if (J < 0) {
    if (valid) rp[threadIdx.x] = 0.f;
    for (int k = threadIdx.x; k < tile; k += kThreads) cp[k] = 0.f;
    return;
  }
  const bool cols = !(tri && I == J);
  const Row<D> r = load_row<D>(x, phi, (int64_t)I * tile + h * kThreads + threadIdx.x,
                               valid, P == 2 ? c2 : 1.f);
  float rsum = 0.f;
  for (int c0 = 0; c0 < tile; c0 += kTile) {
    const int n = min(kTile, tile - c0);
    __syncthreads();
    load_tile<D>(t, y, psi, (int64_t)J * tile + c0, n);
    __syncthreads();
    if (cols) {
      rsum += absorbed_tile<D, P, true>(r, t, n, valid, c2, wsum);
      __syncthreads();
      if (threadIdx.x < n) cp[c0 + threadIdx.x] = sum_warps(wsum, threadIdx.x);
    } else {
      rsum += absorbed_tile<D, P, false>(r, t, n, valid, c2, wsum);
      if (threadIdx.x < n) cp[c0 + threadIdx.x] = 0.f;
    }
  }
  if (valid) rp[threadIdx.x] = rsum;
}

// -----------------------------------------------------------------------------
// 6. Dual apply over the kept tile pairs. Replaces
//    block_sparse.py::gibbs_apply_walk_banded (_apply_walk_banded_kernel):
//    R_row[i] = sum_j w_ij Vy[j] and R_col[j] = sum_i w_ij Vx[i] in one
//    visit of each kept pair, four channels, raw absorbed weights of
//    apply_weight's modes 0-2 (pair_common.cuh).
//    Bound: one exp2 per kept pair (p = 1 adds a sqrt and a division),
//    then 4 FFMAs for the rows and 4 x 31 shuffles per 32 x 32 pairs for
//    the columns. Design: as kernel 5, with Vy's column tile staged beside
//    y's and each row's Vx in registers; the column direction runs one
//    transposed warp reduction per channel. Row partials go to
//    rowpart[k, I, i, c] (4 channels interleaved), column partials to
//    colpart[s, h, c, j].
// -----------------------------------------------------------------------------
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
tiles_apply_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ phi, const float* __restrict__ psi,
                   const float* __restrict__ vyt, const float* __restrict__ vx,
                   const int* __restrict__ slot_j, float* __restrict__ rowpart,
                   float* __restrict__ colpart, int M, int ck, int tile, int tri,
                   float c2) {
  __shared__ Tile<D> t;
  __shared__ float v[4][kTile];
  __shared__ float wsum[4][kWarps][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s = blockIdx.x;
  const int h = blockIdx.y;
  const int I = (int)(s / ck);
  const int64_t pos = s - (int64_t)I * ck;  // k of slot s
  const int J = slot_j[s];
  const int rows = min(kThreads, tile - h * kThreads);
  const bool valid = threadIdx.x < rows;
  float* rp = rowpart + ((pos * (gridDim.x / ck) + I) * tile + h * kThreads + threadIdx.x) * 4;
  float* cp = colpart + (s * gridDim.y + h) * 4 * tile;
  if (J < 0) {
    if (valid) {
#pragma unroll
      for (int c = 0; c < 4; ++c) rp[c] = 0.f;
    }
    for (int k = threadIdx.x; k < 4 * tile; k += kThreads) cp[k] = 0.f;
    return;
  }
  const bool cols = !(tri && I == J);
  const int64_t i = (int64_t)I * tile + h * kThreads + threadIdx.x;
  const Row<D> r = load_row<D>(x, phi, i, valid, MODE == 0 ? c2 : 1.f);
  float u[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) u[c] = valid ? vx[i * 4 + c] : 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < tile; c0 += kTile) {
    const int n = min(kTile, tile - c0);
    const int64_t j0 = (int64_t)J * tile + c0;
    __syncthreads();
    load_tile<D>(t, y, psi, j0, n);
    for (int k = threadIdx.x; k < n; k += kThreads) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c][k] = vyt[(int64_t)c * M + j0 + k];
    }
    __syncthreads();
    for (int g0 = 0; g0 < n; g0 += 32) {
      float w[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int col = g0 + k;
        w[k] = (valid && col < n) ? apply_weight<D, MODE>(r, t, col, c2) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(w[k], v[c][col < n ? col : 0], acc[c]);
      }
      if (cols) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float wc[32];
#pragma unroll
          for (int k = 0; k < 32; ++k) wc[k] = w[k] * u[c];
          warp_transpose_sum(wc, lane);
          wsum[c][warp][g0 + lane] = wc[0];
        }
      }
    }
    if (cols) {
      __syncthreads();
      if (threadIdx.x < n) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          cp[c * tile + c0 + threadIdx.x] = sum_warps(wsum[c], threadIdx.x);
      }
    } else if (threadIdx.x < n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) cp[c * tile + c0 + threadIdx.x] = 0.f;
    }
  }
  if (valid) {
#pragma unroll
    for (int c = 0; c < 4; ++c) rp[c] = acc[c];
  }
}

// -----------------------------------------------------------------------------
// 7. Truncated LSE over kept source tiles. Replaces
//    geomloss_tpu/ops/block_sparse.py::lse_walk (_lse_walk_kernel), the
//    detached coarse/mid -> fine extrapolations of the mid path:
//    out_i = log2 sum_j exp2(h2_j + arg_ij) in base-2 units over the
//    source tiles cols[I, k], k < cnt[I], of row i's tile I; rows come in
//    tiles of block_n points, sources in tiles of block_m points (any
//    sizes: block_m < kTile stages a partial tile).
//    Bound: one exp2 per kept pair (p = 1 adds a sqrt). Design: the online
//    LSE of kernel 1 (lse_tile, pair_common.cuh) with a column-tile
//    indirection. One block per (row tile, 256-row slice), one thread per
//    row, running max and sum in registers; each kept source tile is
//    staged in shared memory kTile points at a time. Each output row is
//    written once: no scratch, no atomics, bitwise reproducible. The
//    TPU's step-list packing (walk_plan) and its per-chunk budget, which
//    clipped kept tiles, have no counterpart: every kept tile is visited.
// -----------------------------------------------------------------------------
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
tiles_lse_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ h2, const int* __restrict__ cols,
                 const int* __restrict__ cnt, float* __restrict__ out, int ck,
                 int block_n, int block_m, float c2) {
  __shared__ Tile<D> t;
  const int I = blockIdx.x;
  const int rows = min(kThreads, block_n - (int)blockIdx.y * kThreads);
  const bool valid = threadIdx.x < rows;
  const int64_t i = (int64_t)I * block_n + (int64_t)blockIdx.y * kThreads + threadIdx.x;
  const Row<D> r = load_row<D>(x, nullptr, i, valid, P == 2 ? c2 : 1.f);
  const int* row_cols = cols + (int64_t)I * ck;
  const int n_kept = min(cnt[I], ck);
  float m = -INFINITY;
  float s = 0.f;
  for (int k = 0; k < n_kept; ++k) {
    const int64_t j0 = (int64_t)row_cols[k] * block_m;
    for (int c0 = 0; c0 < block_m; c0 += kTile) {
      const int n = min(kTile, block_m - c0);
      __syncthreads();
      load_tile<D>(t, y, h2, j0 + c0, n);
      __syncthreads();
      lse_tile<D, P>(r, t, n, c2, m, s);
    }
  }
  if (valid) out[i] = m + log2f(s);
}

// -----------------------------------------------------------------------------
// Second pass of kernels 5 and 6: out[g, l] = sum over the slots s of
// segment g (order[offsets[g]] .. order[offsets[g + 1] - 1], in that order)
// of sum_h parts[s, h, l], for l < L. One thread per (segment, lane); a
// fixed summation order, so the result is deterministic.
// Bound: reading the partials once.
// -----------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ parts, const int* __restrict__ order,
                   const int* __restrict__ offsets, float* __restrict__ out, int L,
                   int nsub) {
  const int g = blockIdx.y;
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  float acc = 0.f;
  for (int q = offsets[g]; q < offsets[g + 1]; ++q) {
    const float* row = parts + (int64_t)order[q] * nsub * L + l;
    for (int h = 0; h < nsub; ++h) acc += row[(int64_t)h * L];
  }
  out[(int64_t)g * L + l] = acc;
}

}  // namespace

extern "C" {

// nslots = nI * ck slots, nsub = ceil(tile / 256) row slices per slot.
int gl_absorbed_sum_tiles(const float* x, const float* y, const float* phi,
                          const float* psi, const int* slot_j, float* rowpart,
                          float* colpart, int nslots, int ck, int tile, int D, int p,
                          int tri, float c2, void* stream) {
  const dim3 grid(nslots, cdiv(tile, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p != 1 && p != 2) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_D8(D,
    if (p == 2) tiles_step_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, phi, psi, slot_j, rowpart, colpart, ck, tile, tri, c2);
    else tiles_step_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, phi, psi, slot_j, rowpart, colpart, ck, tile, tri, c2))
  return (int)cudaGetLastError();
}

int gl_gibbs_apply_tiles(const float* x, const float* y, const float* phi,
                         const float* psi, const float* vyt, const float* vx,
                         const int* slot_j, float* rowpart, float* colpart, int M,
                         int nslots, int ck, int tile, int D, int mode, int tri,
                         float c2, void* stream) {
  const dim3 grid(nslots, cdiv(tile, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GL_DISPATCH_D8(D,
    switch (mode) {
      case 0: tiles_apply_kernel<D, 0><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vyt, vx, slot_j, rowpart, colpart, M, ck, tile, tri, c2); break;
      case 1: tiles_apply_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vyt, vx, slot_j, rowpart, colpart, M, ck, tile, tri, c2); break;
      case 2: tiles_apply_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vyt, vx, slot_j, rowpart, colpart, M, ck, tile, tri, c2); break;
      default: return (int)cudaErrorInvalidValue;
    })
  return (int)cudaGetLastError();
}

// n_rows = N / block_n row tiles, ck the table width.
int gl_lse_tiles(const float* x, const float* y, const float* h2, const int* cols,
                 const int* cnt, float* out, int n_rows, int ck, int block_n,
                 int block_m, int D, int p, float c2, void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  const dim3 grid(n_rows, cdiv(block_n, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p != 1 && p != 2) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_D8(D,
    if (p == 2) tiles_lse_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, h2, cols, cnt, out, ck, block_n, block_m, c2);
    else tiles_lse_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, h2, cols, cnt, out, ck, block_n, block_m, c2))
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

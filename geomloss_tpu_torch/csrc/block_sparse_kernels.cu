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
// kernels (one exp2 per kept pair, 16 MUFU results per clock per SM); a
// kept pair reads nothing but the two tiles' coordinates and biases.
//
// Kernels 5 and 6 serve square tiles of a symmetric tiling; kernels 7, 8
// and 12 read a (cols, cnt) table directly, with row tiles of block_n
// points and source tiles of block_m points. Kernels 8 and 12 read it in
// CSR form, row tile I visiting cols[row_start[I] + k] for k < cnt[I]:
// the wrapper passes row_start = I * ck for a dense (nI, ck) table (with
// cnt clamped at ck), or the row starts of a walk table it decoded on the
// device (kernels 10 and 11 of the JAX package run on these two).
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
// Each entry point returns cudaGetLastError() after its launch.

#include "pair_common.cuh"

namespace {

// -----------------------------------------------------------------------------
// 5. Absorbed sums over the kept tile pairs. Replaces
//    geomloss_tpu/ops/block_sparse.py::_absorbed_sum_walk_banded
//    (_pair_walk_banded_kernel): r_i = sum_j W_ij and c_j = sum_i W_ij over
//    the kept pairs, W_ij = exp2(phi_i + psi_j + arg_ij), no max pass.
//    Bound: one exp2 per kept pair gives both directions. Design: one block
//    per (live slot, 256-row slice of the tile), column tiles staged 256
//    columns at a time, column sums by the transposed warp reduction.
// -----------------------------------------------------------------------------
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
tiles_step_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ phi, const float* __restrict__ psi,
                  const int* __restrict__ slot_i, const int* __restrict__ slot_j,
                  float* __restrict__ rowpart, float* __restrict__ colpart, int tile,
                  int tri, float c2) {
  __shared__ Tile<D> t;
  __shared__ float wsum[kWarps][kTile];
  const int64_t q = blockIdx.x;
  const int h = blockIdx.y;
  const int I = slot_i[q];
  const int J = slot_j[q];
  if (J < 0) return;  // a dead slot: left out of the sums
  const int rows = min(kThreads, tile - h * kThreads);
  const bool valid = threadIdx.x < rows;
  float* rp = rowpart + q * tile + h * kThreads;
  float* cp = colpart + (q * gridDim.y + h) * tile;
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
//    rowpart[q, i, c] (4 channels interleaved), column partials to
//    colpart[q, h, c, j].
// -----------------------------------------------------------------------------
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
tiles_apply_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ phi, const float* __restrict__ psi,
                   const float* __restrict__ vyt, const float* __restrict__ vx,
                   const int* __restrict__ slot_i, const int* __restrict__ slot_j,
                   float* __restrict__ rowpart, float* __restrict__ colpart, int M,
                   int tile, int tri, float c2) {
  __shared__ Tile<D> t;
  __shared__ float v[4][kTile];
  __shared__ float wsum[4][kWarps][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t q = blockIdx.x;
  const int h = blockIdx.y;
  const int I = slot_i[q];
  const int J = slot_j[q];
  if (J < 0) return;  // a dead slot: left out of the sums
  const int rows = min(kThreads, tile - h * kThreads);
  const bool valid = threadIdx.x < rows;
  float* rp = rowpart + (q * tile + h * kThreads + threadIdx.x) * 4;
  float* cp = colpart + (q * gridDim.y + h) * 4 * tile;
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
//    written once: no scratch, no atomics, bitwise reproducible. The mid
//    path reads its (cols, cnt) tables directly, not packed into walk_plan
//    step lists, so their per-chunk budget, which clipped kept tiles, does
//    not apply: every kept tile is visited.
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
// 8. Truncated apply over kept source tiles. Replaces
//    geomloss_tpu/ops/block_sparse.py::gibbs_apply_sparse
//    (_apply_sparse_kernel), the truncated MMD matvecs and the backward of
//    the truncated softmin: O_i = sum_j w_ij V_j over the source tiles
//    cols[I, k], k < cnt[I], of row i's tile I, four channels (the wrapper
//    pads V and loops over channel groups), with the weights of
//    apply_weight's modes 0-4 (pair_common.cuh). Rows come in tiles of
//    block_n points, sources in tiles of block_m points. Also serves
//    block_sparse.py::gibbs_apply_walk (_apply_walk_kernel), the same
//    function over a walk table: the walk is only the TPU's traversal
//    order, and the wrapper decodes it into row starts and counts.
//    Bound: one exp2 per kept pair (p = 1 adds a sqrt and, for gibbs_grad,
//    a division; energy and inv_dist take a sqrt and a reciprocal, no
//    exp2), then four FFMAs into float32 accumulators. Design: kernel 7's
//    CSR indirection (one block per (row tile, 256-row slice), one thread
//    per row, each kept source tile staged in shared memory kTile points at
//    a time) around kernel 4's per-pair body, V's four channels staged
//    beside y. Each output row is written once: no scratch, no atomics,
//    bitwise reproducible. The TPU's bf16 split of wide V (the mxu path,
//    C >= 9) has no counterpart: every channel is an exact float32 FFMA.
// -----------------------------------------------------------------------------
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
sparse_apply_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ phi, const float* __restrict__ psi,
                    const float* __restrict__ vt, const int* __restrict__ cols,
                    const int* __restrict__ row_start, const int* __restrict__ cnt,
                    float* __restrict__ out, int M, int block_n, int block_m, float c2) {
  __shared__ Tile<D> t;
  __shared__ float v[4][kTile];
  const int I = blockIdx.x;
  const int rows = min(kThreads, block_n - (int)blockIdx.y * kThreads);
  const bool valid = threadIdx.x < rows;
  const int64_t i = (int64_t)I * block_n + (int64_t)blockIdx.y * kThreads + threadIdx.x;
  const Row<D> r = load_row<D>(x, phi, i, valid, MODE == 0 ? c2 : 1.f);
  const int* row_cols = cols + row_start[I];
  const int n_kept = cnt[I];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < n_kept; ++k) {
    const int64_t j_tile = (int64_t)row_cols[k] * block_m;
    for (int c0 = 0; c0 < block_m; c0 += kTile) {
      const int n = min(kTile, block_m - c0);
      const int64_t j0 = j_tile + c0;
      __syncthreads();
      load_tile<D>(t, y, psi, j0, n);
      for (int kk = threadIdx.x; kk < n; kk += kThreads) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c][kk] = vt[(int64_t)c * M + j0 + kk];
      }
      __syncthreads();
      // One partial sum per staged tile, added once: the rounding error
      // grows with the tiles of a row, not its kept points.
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < n; ++kk) {
        const float w = apply_weight<D, MODE>(r, t, kk, c2);
#pragma unroll
        for (int c = 0; c < 4; ++c) part[c] = fmaf(w, v[c][kk], part[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += part[c];
    }
  }
  if (valid) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[i * 4 + c] = acc[c];
  }
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
//    Bound: one exp2 per kept pair (p = 1 adds a sqrt). Design: kernel 8's
//    CSR indirection and staging with kernel 5's absorbed weight
//    (absorbed_tile, pair_common.cuh), no V: one float32 accumulator per
//    row taking one partial per staged tile. Each output row is written
//    once: no scratch, no atomics, bitwise reproducible.
// -----------------------------------------------------------------------------
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
sparse_sum_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ phi, const float* __restrict__ psi,
                  const int* __restrict__ cols, const int* __restrict__ row_start,
                  const int* __restrict__ cnt, float* __restrict__ out, int block_n,
                  int block_m, float c2) {
  __shared__ Tile<D> t;
  const int I = blockIdx.x;
  const int rows = min(kThreads, block_n - (int)blockIdx.y * kThreads);
  const bool valid = threadIdx.x < rows;
  const int64_t i = (int64_t)I * block_n + (int64_t)blockIdx.y * kThreads + threadIdx.x;
  const Row<D> r = load_row<D>(x, phi, i, valid, P == 2 ? c2 : 1.f);
  const int* row_cols = cols + row_start[I];
  const int n_kept = cnt[I];
  float acc = 0.f;
  for (int k = 0; k < n_kept; ++k) {
    const int64_t j_tile = (int64_t)row_cols[k] * block_m;
    for (int c0 = 0; c0 < block_m; c0 += kTile) {
      const int n = min(kTile, block_m - c0);
      __syncthreads();
      load_tile<D>(t, y, psi, j_tile + c0, n);
      __syncthreads();
      acc += absorbed_tile<D, P, false>(r, t, n, valid, c2, nullptr);
    }
  }
  if (valid) out[i] = acc;
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
// for a dead slot), nsub = ceil(tile / 256) row slices per slot.
int gl_absorbed_sum_tiles(const float* x, const float* y, const float* phi,
                          const float* psi, const int* slot_i, const int* slot_j,
                          float* rowpart, float* colpart, int nslots, int tile, int D,
                          int p, int tri, float c2, void* stream) {
  if (nslots == 0) return (int)cudaSuccess;
  const dim3 grid(nslots, cdiv(tile, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p != 1 && p != 2) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_D8(D,
    if (p == 2) tiles_step_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, phi, psi, slot_i, slot_j, rowpart, colpart, tile, tri, c2);
    else tiles_step_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, phi, psi, slot_i, slot_j, rowpart, colpart, tile, tri, c2))
  return (int)cudaGetLastError();
}

int gl_gibbs_apply_tiles(const float* x, const float* y, const float* phi,
                         const float* psi, const float* vyt, const float* vx,
                         const int* slot_i, const int* slot_j, float* rowpart,
                         float* colpart, int M, int nslots, int tile, int D, int mode,
                         int tri, float c2, void* stream) {
  if (nslots == 0) return (int)cudaSuccess;
  const dim3 grid(nslots, cdiv(tile, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GL_DISPATCH_D8(D,
    switch (mode) {
      case 0: tiles_apply_kernel<D, 0><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vyt, vx, slot_i, slot_j, rowpart, colpart, M, tile, tri, c2); break;
      case 1: tiles_apply_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vyt, vx, slot_i, slot_j, rowpart, colpart, M, tile, tri, c2); break;
      case 2: tiles_apply_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vyt, vx, slot_i, slot_j, rowpart, colpart, M, tile, tri, c2); break;
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

// n_rows = N / block_n row tiles of a CSR table (cols, row_start, cnt),
// vt (4, M) with row stride M.
int gl_gibbs_apply_sparse(const float* x, const float* y, const float* phi,
                          const float* psi, const float* vt, const int* cols,
                          const int* row_start, const int* cnt, float* out, int M,
                          int n_rows, int block_n, int block_m, int D, int mode, float c2,
                          void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  const dim3 grid(n_rows, cdiv(block_n, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GL_DISPATCH_D8(D,
    switch (mode) {
      case 0: sparse_apply_kernel<D, 0><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, cols, row_start, cnt, out, M, block_n, block_m, c2); break;
      case 1: sparse_apply_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, cols, row_start, cnt, out, M, block_n, block_m, c2); break;
      case 2: sparse_apply_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, cols, row_start, cnt, out, M, block_n, block_m, c2); break;
      case 3: sparse_apply_kernel<D, 3><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, cols, row_start, cnt, out, M, block_n, block_m, c2); break;
      case 4: sparse_apply_kernel<D, 4><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, cols, row_start, cnt, out, M, block_n, block_m, c2); break;
      default: return (int)cudaErrorInvalidValue;
    })
  return (int)cudaGetLastError();
}

// n_rows = N / block_n row tiles of a CSR table (cols, row_start, cnt).
int gl_absorbed_sum_sparse(const float* x, const float* y, const float* phi,
                           const float* psi, const int* cols, const int* row_start,
                           const int* cnt, float* out, int n_rows, int block_n, int block_m,
                           int D, int p, float c2, void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  const dim3 grid(n_rows, cdiv(block_n, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p != 1 && p != 2) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_D8(D,
    if (p == 2) sparse_sum_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, phi, psi, cols, row_start, cnt, out, block_n, block_m, c2);
    else sparse_sum_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, phi, psi, cols, row_start, cnt, out, block_n, block_m, c2))
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

// Streaming pair-interaction kernels of the online Sinkhorn path, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// geomloss_tpu_torch/ops/cuda_kernels.py, which also holds each kernel's
// plain PyTorch twin and folds the biases (base-2 units) before launch.
// The shared design (row state in registers, column tiles in shared
// memory, explicit float32 pair scores) is in pair_common.cuh.
//
// What bounds these kernels on an H100: the exponential. At N = M = 1e5 a
// sweep is 1e10 pairs and reads a few bytes per point, so memory traffic
// is negligible; an SM issues 16 MUFU (ex2) results per clock against 128
// FP32 lanes, so the few FFMAs of a pair fit under the one exp2 it needs
// (p = 1 adds a sqrt, a second MUFU operation). The designs therefore
// spend FFMAs to save exponentials: LSE recomputes each tile's scores for
// a max pass instead of rescaling per pair, the fused step reads both
// softmin directions off one exponential, and the symmetric step visits
// each off-diagonal pair once. The fused step runs the register-tiled pair
// blocks of kernel 5 (pair_common.cuh) over packed points; the others keep
// one thread per row.
//
// Each entry point returns cudaGetLastError() after its launch.

#include "pair_common.cuh"

namespace {

// Coordinates per chunk of the wide instantiation (D above 16).
constexpr int kWideChunk = 16;

// -----------------------------------------------------------------------------
// 1. Streaming LSE. Replaces geomloss_tpu/ops/pallas_kernels.py::lse_pallas
//    (_lse_kernel). out_i = log2 sum_j exp2(h2_j + arg_ij) in base-2 units;
//    the wrapper converts to nats and adds the p=2 row term.
//    Bound: one exp2 per pair. Design: per tile, a max pass that only
//    recomputes scores (FFMAs), then one exp2-sum pass against the running
//    max (lse_tile, pair_common.cuh); the running sum is rescaled once per
//    tile, not once per pair. The ragged edge is an explicit bound on the
//    tile width, not padding.
// -----------------------------------------------------------------------------
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
lse_kernel(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ h2, float* __restrict__ out, int N, int M,
           int dw, float c2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < N;
  float m = -INFINITY;
  float s = 0.f;
  if constexpr (D == 0) {
    __shared__ WideStage<kWideChunk> st;
    for (int j0 = 0; j0 < M; j0 += kGroup) {
      const int n = min(kGroup, M - j0);
      float a[kGroup];
      wide_scores<kWideChunk, P == 1>(x, i, valid, P == 2 ? c2 : 1.f, y, h2, j0, n, dw, st, a);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) a[k] = k < n ? wide_arg<P>(a[k], st.bias[k], c2) : -INFINITY;
      lse_group(a, m, s);
    }
  } else {
    __shared__ Tile<D> t;
    const Row<D> r = load_row<D>(x, nullptr, i, valid, P == 2 ? c2 : 1.f);
    for (int j0 = 0; j0 < M; j0 += kTile) {
      const int n = min(kTile, M - j0);
      __syncthreads();
      load_tile<D>(t, y, h2, j0, n);
      __syncthreads();
      lse_tile<D, P>(r, t, n, c2, m, s);
    }
  }
  if (valid) out[i] = m + log2f(s);
}

// -----------------------------------------------------------------------------
// 2. Fused Sinkhorn step. Replaces pallas_kernels.py::sinkhorn_step_pallas
//    (_pair_step_kernel). W_ij = exp2(phi_i + psi_j + arg_ij), no max pass
//    (W is bounded after an averaged update; see the JAX block comment).
//    Row sums of W give S_xy, column sums give S_yx.
//    Bound: one exp2 per pair gives both directions (MUFU: 16 per clock per
//    SM); at p = 2, D = 3 a pair also takes D + 1 FFMAs and two adds, about
//    8 issue slots, which the MUFU rate just balances. Design: the TPU's
//    sequential column carry has no counterpart between blocks, so block
//    (b, s) takes the 256 rows of row block row_blk0 + b against column
//    slice s ([s * width, (s + 1) * width)) and writes its column sums to
//    colpart[b, slice] (gridDim.x, M) and its row sums to
//    rowpart[s, b * 256 + t] (gridDim.y, gridDim.x * 256): every entry is
//    written exactly once, and the wrapper sums them in a fixed order, so
//    the result is deterministic without atomics. The wrapper launches
//    row blocks in chunks sized to a fixed scratch budget and slices the
//    columns so that each launch still fills the card. Inside the block,
//    kernel 5's register-tiled stage (step_stage, pair_common.cuh) runs
//    over 256-column stages of the slice: packed float4 points, 8 rows per
//    lane in registers, one ex2.approx per pair, row sums in registers and
//    column sums through shared memory once per stage. The wrapper pads
//    the columns to whole stages with bias -inf (weight 0); only columns
//    below M are written. Points wider than kStepStaged float4s (D > 11 at
//    p = 2) are read from global memory per pass (KV = 0).
// -----------------------------------------------------------------------------
template <int P, int KV>
__global__ void __launch_bounds__(kThreads)
step_kernel(const float4* __restrict__ xv, const float4* __restrict__ yv,
            const float* __restrict__ rb, const float* __restrict__ cb,
            float* __restrict__ rowpart, float* __restrict__ colpart, int N, int M,
            int row_blk0, int width, int kv, float c2) {
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  __shared__ StepSmem<P, KS, WIDE> sm;
  const int lane = threadIdx.x & 31;
  const int64_t i0 = (int64_t)(row_blk0 + blockIdx.x) * kThreads;
  const int64_t left = (int64_t)N - i0;
  const int rows = left < kThreads ? (int)left : kThreads;
  float* cp = colpart + (int64_t)blockIdx.x * M;
  const int j_end = min(M, (int)(blockIdx.y + 1) * width);
  float4 xr[kPairRows][KS];
  float br[kPairRows], racc[kPairRows];
  load_pair_rows<P, KS, WIDE>(xr, br, xv, rb, i0, rows, lane);
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) racc[r] = 0.f;
  for (int j0 = blockIdx.y * width; j0 < j_end; j0 += kTile)
    step_stage<P, KV>(sm, xr, br, racc, xv, i0, rows, kv, yv, cb, j0, kTile, min(kTile, j_end - j0), true,
                      cp + j0, c2);
  const float sum = block_row_sum(sm, racc);
  rowpart[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + threadIdx.x] = sum;
}

// -----------------------------------------------------------------------------
// 3. Symmetric (debias) step. Replaces
//    pallas_kernels.py::sinkhorn_step_sym_pallas (_sym_step_kernel).
//    Only the upper triangle of tile pairs (I <= J) is visited. W is
//    symmetric, so an off-diagonal tile's column sums are the row sums of
//    its mirror (J, I); diagonal tiles contribute rows only.
//    Bound: exp2, as above. Design: half the pairs of a full sweep. Block
//    (b, s) takes row tile I = tile0 + b against the column tiles J >= I of
//    slice s (wt tiles from tile0 + s * wt), keeping its row sums in a
//    register: they go to rowpart[s, b] ((gridDim.y, gridDim.x, 256)), and
//    each tile's column sums to colpart[b, J - tile0] ((gridDim.x,
//    nb - tile0, 256)), the tiles below the diagonal and the diagonal's
//    column sums as zeros. Every entry is written exactly once, and the
//    wrapper sums both over their short leading axis in a fixed order:
//    deterministic, no atomics, scratch bounded by the row tiles per launch.
// -----------------------------------------------------------------------------
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
sym_step_kernel(const float* __restrict__ x, const float* __restrict__ phi,
                float* __restrict__ rowpart, float* __restrict__ colpart, int N,
                int tile0, int wt, int nb, int dw, float c2) {
  __shared__ float wsum[kWarps][kTile];
  const int I = tile0 + blockIdx.x;
  const int64_t i = (int64_t)I * kThreads + threadIdx.x;
  const bool valid = i < N;
  float* cp = colpart + (int64_t)blockIdx.x * (nb - tile0) * kTile + threadIdx.x;
  float rsum = 0.f;
  const int J_end = min(nb, tile0 + (int)(blockIdx.y + 1) * wt);
  if constexpr (D == 0) {
    __shared__ WideStage<kWideChunk> st;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const float bi = valid ? phi[i] : 0.f;
    for (int J = tile0 + blockIdx.y * wt; J < J_end; ++J) {
      float* cj = cp + (int64_t)(J - tile0) * kTile;
      if (J < I) {
        *cj = 0.f;
        continue;
      }
      const int64_t j0 = (int64_t)J * kTile;
      const int n = (int)min((int64_t)kTile, N - j0);
      for (int g = 0; g < n; g += kGroup) {
        const int ng = min(kGroup, n - g);
        float w[kGroup];
        wide_scores<kWideChunk, P == 1>(x, i, valid, P == 2 ? c2 : 1.f, x, phi, j0 + g, ng, dw, st, w);
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          w[k] = (valid && k < ng) ? exp2f(wide_arg<P>(w[k], bi + st.bias[k], c2)) : 0.f;
          rsum += w[k];
        }
        if (J != I) {
          warp_transpose_sum(w, lane);
          wsum[warp][g + lane] = w[0];
        }
      }
      if (J == I) {
        *cj = 0.f;
      } else {
        __syncthreads();
        *cj = threadIdx.x < n ? sum_warps(wsum, threadIdx.x) : 0.f;
      }
    }
  } else {
    __shared__ Tile<D> t;
    const Row<D> r = load_row<D>(x, phi, i, valid, P == 2 ? c2 : 1.f);
    for (int J = tile0 + blockIdx.y * wt; J < J_end; ++J) {
      float* cj = cp + (int64_t)(J - tile0) * kTile;
      if (J < I) {
        *cj = 0.f;
        continue;
      }
      const int64_t j0 = (int64_t)J * kTile;
      const int n = (int)min((int64_t)kTile, N - j0);
      __syncthreads();
      load_tile<D>(t, x, phi, j0, n);
      __syncthreads();
      if (J == I) {
        rsum += absorbed_tile<D, P, false>(r, t, n, valid, c2, wsum);
        *cj = 0.f;
      } else {
        rsum += absorbed_tile<D, P, true>(r, t, n, valid, c2, wsum);
        __syncthreads();
        *cj = threadIdx.x < n ? sum_warps(wsum, threadIdx.x) : 0.f;
      }
    }
  }
  rowpart[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + threadIdx.x] = rsum;
}

// -----------------------------------------------------------------------------
// 4. Gibbs apply. Replaces pallas_kernels.py::gibbs_apply_pallas
//    (_apply_kernel + _gibbs_weights). O_i = sum_j w_ij V_j for four
//    channels (the wrapper pads V and loops over channel groups), with the
//    weight kinds of apply_weight (pair_common.cuh).
//    Bound: one exp2 per pair plus four FFMAs into float32 accumulators.
//    Design: V's tile sits in shared memory beside y's; no weight block is
//    ever stored.
// -----------------------------------------------------------------------------
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ phi, const float* __restrict__ psi,
             const float* __restrict__ vt, float* __restrict__ out, int N, int M,
             int dw, float c2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < N;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (D == 0) {
    __shared__ WideStage<kWideChunk> st;
    const float bi = valid ? phi[i] : 0.f;
    for (int j0 = 0; j0 < M; j0 += kGroup) {
      const int n = min(kGroup, M - j0);
      float a[kGroup];
      wide_scores<kWideChunk, MODE != 0>(x, i, valid, MODE == 0 ? c2 : 1.f, y, psi, j0, n, dw, st, a);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (k < n) {
          const float w = wide_weight<MODE>(a[k], bi + st.bias[k], c2);
#pragma unroll
          for (int c = 0; c < 4; ++c) part[c] = fmaf(w, vt[(int64_t)c * M + j0 + k], part[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += part[c];
    }
  } else {
    __shared__ Tile<D> t;
    __shared__ float v[4][kTile];
    const Row<D> r = load_row<D>(x, phi, i, valid, MODE == 0 ? c2 : 1.f);
    for (int j0 = 0; j0 < M; j0 += kTile) {
      const int n = min(kTile, M - j0);
      __syncthreads();
      load_tile<D>(t, y, psi, j0, n);
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c][k] = vt[(int64_t)c * M + j0 + k];
      }
      __syncthreads();
      // One partial sum per staged tile, added once: the rounding error
      // grows with the tiles, not the columns.
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const float w = apply_weight<D, MODE>(r, t, k, c2);
#pragma unroll
        for (int c = 0; c < 4; ++c) part[c] = fmaf(w, v[c][k], part[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += part[c];
    }
  }
  if (valid) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(int64_t)i * 4 + c] = acc[c];
  }
}

}  // namespace

extern "C" {

int gl_lse(const float* x, const float* y, const float* h2, float* out, int N,
           int M, int D, int p, float c2, void* stream) {
  const dim3 grid(cdiv(N, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p != 1 && p != 2) return (int)cudaErrorInvalidValue;
  const int dw = D;
  GL_DISPATCH_D(D,
    if (p == 2) lse_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, h2, out, N, M, dw, c2);
    else lse_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, h2, out, N, M, dw, c2))
  return (int)cudaGetLastError();
}

// Row blocks row_blk0 .. row_blk0 + n_blk of x against all of y, in
// n_slices column slices of `width` columns (a multiple of 256); xv and yv
// the packed points (kv float4 each, pair_common.cuh), yv's columns padded
// to a multiple of 256 with bias -inf; rb and cb the row and column biases
// (cb read for p = 1 only).
int gl_sinkhorn_step(const float* xv, const float* yv, const float* rb,
                     const float* cb, float* rowpart, float* colpart, int N, int M,
                     int row_blk0, int n_blk, int n_slices, int width, int kv, int p,
                     float c2, void* stream) {
  if ((p != 1 && p != 2) || kv < 1 || width % kTile) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blk, n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  const float4* y4 = reinterpret_cast<const float4*>(yv);
#define GL_STEP(P, KV) \
  step_kernel<P, KV><<<grid, kThreads, 0, s>>>(x4, y4, rb, cb, rowpart, colpart, N, M, row_blk0, width, kv, c2)
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

// Row tiles tile0 .. tile0 + n_rows against column tiles tile0 .. nb, in
// n_slices slices of cdiv(nb - tile0, n_slices) tiles.
int gl_sinkhorn_step_sym(const float* x, const float* phi, float* rowpart,
                         float* colpart, int N, int tile0, int n_rows, int n_slices,
                         int nb, int D, int p, float c2, void* stream) {
  const dim3 grid(n_rows, n_slices);
  const int wt = cdiv(nb - tile0, n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p != 1 && p != 2) return (int)cudaErrorInvalidValue;
  const int dw = D;
  GL_DISPATCH_D(D,
    if (p == 2) sym_step_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, phi, rowpart, colpart, N, tile0, wt, nb, dw, c2);
    else sym_step_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, phi, rowpart, colpart, N, tile0, wt, nb, dw, c2))
  return (int)cudaGetLastError();
}

int gl_gibbs_apply(const float* x, const float* y, const float* phi,
                   const float* psi, const float* vt, float* out, int N, int M,
                   int D, int mode, float c2, void* stream) {
  const dim3 grid(cdiv(N, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dw = D;
  GL_DISPATCH_D(D,
    switch (mode) {
      case 0: apply_kernel<D, 0><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, dw, c2); break;
      case 1: apply_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, dw, c2); break;
      case 2: apply_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, dw, c2); break;
      case 3: apply_kernel<D, 3><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, dw, c2); break;
      case 4: apply_kernel<D, 4><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, dw, c2); break;
      default: return (int)cudaErrorInvalidValue;
    })
  return (int)cudaGetLastError();
}

}  // extern "C"

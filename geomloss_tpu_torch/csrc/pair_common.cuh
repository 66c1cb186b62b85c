// Device code shared by the pair-interaction kernels of geomloss_tpu_torch
// (online_kernels.cu, block_sparse_kernels.cu), for Hopper (sm_90a).
//
// x is (N, D) and y is (M, D), float32, row-major, with D zero-padded to a
// compiled width. One thread owns one row i and keeps its coordinates in
// registers; the block stages kTile columns of y (coordinates and column
// bias) in shared memory, where every thread of the block reads the same
// address (broadcast, no bank conflicts). Pair scores are explicit float32
// FFMAs, never TF32:
//   p = 2: arg = bias_i + bias_j + <c2 x_i, y_j>, the squared norms being
//          folded into the biases (D FFMAs and one add);
//   p = 1: d = sqrt(max(|x_i - y_j|^2, 1e-8)) from coordinate differences,
//          so a near pair carries no cancellation noise, and
//          arg = bias_i + bias_j - c2 d.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows per block, one thread per row
constexpr int kTile = 256;     // columns per shared-memory tile (== kThreads)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr float kSqdistFloor = 1e-8f;  // clamp before sqrt
constexpr float kGradCut = 1e-6f;      // distance-gradient weights vanish below

// Row state: coordinates (scaled by c2 for p = 2) and base-2 row bias.
template <int D>
struct Row {
  float x[D];
  float bias;
};

template <int D>
__device__ __forceinline__ Row<D> load_row(const float* __restrict__ x,
                                           const float* __restrict__ bias,
                                           int64_t i, bool valid, float scale) {
  Row<D> r;
#pragma unroll
  for (int d = 0; d < D; ++d) r.x[d] = valid ? scale * x[i * D + d] : 0.f;
  r.bias = (valid && bias != nullptr) ? bias[i] : 0.f;
  return r;
}

// Column tile in shared memory.
template <int D>
struct Tile {
  float y[D][kTile];
  float bias[kTile];
};

template <int D>
__device__ __forceinline__ void load_tile(Tile<D>& t, const float* __restrict__ y,
                                          const float* __restrict__ bias, int64_t j0,
                                          int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int64_t j = j0 + k;
#pragma unroll
    for (int d = 0; d < D; ++d) t.y[d][k] = y[j * D + d];
    t.bias[k] = bias != nullptr ? bias[j] : 0.f;
  }
}

// |x_i - y_j|^2 from coordinate differences.
template <int D>
__device__ __forceinline__ float pair_sq(const Row<D>& r, const Tile<D>& t, int k) {
  float sq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float diff = r.x[d] - t.y[d][k];
    sq = fmaf(diff, diff, sq);
  }
  return sq;
}

// Base-2 log of the absorbed weight of pair (i, j).
template <int D, int P>
__device__ __forceinline__ float pair_arg(const Row<D>& r, const Tile<D>& t, int k,
                                          float c2) {
  if constexpr (P == 2) {
    float a = r.bias + t.bias[k];
#pragma unroll
    for (int d = 0; d < D; ++d) a = fmaf(r.x[d], t.y[d][k], a);
    return a;
  } else {
    const float dist = sqrtf(fmaxf(pair_sq<D>(r, t, k), kSqdistFloor));
    return fmaf(-dist, c2, r.bias + t.bias[k]);
  }
}

// Weight of pair (i, j) for the apply kernels, with d = sqrt(max(sq, 1e-8)):
//   MODE 0: gibbs, p=2          w = exp2(phi + psi + <c2 x, y>)
//   MODE 1: gibbs, p=1          w = exp2(phi + psi - c2 d)
//   MODE 2: gibbs_grad, p=1     w = exp2(phi + psi - c2 d) / d
//   MODE 3: energy              w = -d
//   MODE 4: inv_dist            w = 1 / d
// Modes 2 and 4 vanish where sq <= 1e-6.
template <int D, int MODE>
__device__ __forceinline__ float apply_weight(const Row<D>& r, const Tile<D>& t, int k,
                                              float c2) {
  if constexpr (MODE == 0) {
    return exp2f(pair_arg<D, 2>(r, t, k, c2));
  } else {
    const float sq = pair_sq<D>(r, t, k);
    const float d = sqrtf(fmaxf(sq, kSqdistFloor));
    if constexpr (MODE == 3) {
      return -d;
    } else if constexpr (MODE == 4) {
      return sq > kGradCut ? 1.f / d : 0.f;
    } else {
      const float w = exp2f(fmaf(-d, c2, r.bias + t.bias[k]));
      if constexpr (MODE == 2) return sq > kGradCut ? w / d : 0.f;
      return w;
    }
  }
}

// One staged tile of n columns of an online LSE in base 2, against the
// running max m and sum s (m = -inf, s = 0 before the first tile): a max
// pass that only recomputes scores (FFMAs), then one exp2-sum pass against
// the new running max; the running sum is rescaled once per tile, not
// once per pair. A tile whose weights are all exactly 0 so far is skipped.
// The tile's terms go into four partial sums, added to the running sum once
// per tile: a row of many kept tiles (91k terms of a heavy p = 1 tail)
// then carries a float32 rounding error that grows with its tiles, not
// its terms.
template <int D, int P>
__device__ __forceinline__ void lse_tile(const Row<D>& r, const Tile<D>& t, int n, float c2,
                                         float& m, float& s) {
  float tmax = -INFINITY;
  for (int k = 0; k < n; ++k) tmax = fmaxf(tmax, pair_arg<D, P>(r, t, k, c2));
  const float m_new = fmaxf(m, tmax);
  if (m_new == -INFINITY) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int k = 0;
  for (; k + 4 <= n; k += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += exp2f(pair_arg<D, P>(r, t, k + q, c2) - m_new);
  }
  for (; k < n; ++k) acc[0] += exp2f(pair_arg<D, P>(r, t, k, c2) - m_new);
  s = s * exp2f(m - m_new) + ((acc[0] + acc[1]) + (acc[2] + acc[3]));
  m = m_new;
}

// One butterfly step of warp_transpose_sum: lanes whose OFF bit is set
// keep the upper half of their values, the others the lower half.
template <int OFF>
__device__ __forceinline__ void transpose_step(float (&w)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int k = 0; k < OFF; ++k) {
    const float send = upper ? w[k] : w[k + OFF];
    const float keep = upper ? w[k + OFF] : w[k];
    w[k] = keep + __shfl_xor_sync(kFullMask, send, OFF);
  }
}

// Sums 32 per-lane column values over the warp, transposed: afterwards
// lane l holds, in w[0], the warp's sum of column l. 31 shuffles per lane
// for 32 x 32 pairs (a per-column tree would take 5 x 32).
__device__ __forceinline__ void warp_transpose_sum(float (&w)[32], int lane) {
  transpose_step<16>(w, lane);
  transpose_step<8>(w, lane);
  transpose_step<4>(w, lane);
  transpose_step<2>(w, lane);
  transpose_step<1>(w, lane);
}

// Row sums of exp2(arg) over one staged tile of n columns; with COLS, each
// warp's column sums of the tile go to wsum[warp][0..n) in shared memory
// (read after a __syncthreads()).
template <int D, int P, bool COLS>
__device__ __forceinline__ float absorbed_tile(const Row<D>& r, const Tile<D>& t,
                                               int n, bool valid, float c2,
                                               float (*wsum)[kTile]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float rsum = 0.f;
  for (int c0 = 0; c0 < n; c0 += 32) {
    float w[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int col = c0 + k;
      const float v = (valid && col < n) ? exp2f(pair_arg<D, P>(r, t, col, c2)) : 0.f;
      w[k] = v;
      rsum += v;
    }
    if constexpr (COLS) {
      warp_transpose_sum(w, lane);
      wsum[warp][c0 + lane] = w[0];
    }
  }
  return rsum;
}

// Column c's sum over the block's warps of wsum (after a __syncthreads()).
__device__ __forceinline__ float sum_warps(const float (*wsum)[kTile], int c) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += wsum[w][c];
  return s;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Template dispatch on the (padded) point dimension.
#define GL_DISPATCH_D(D_RUNTIME, ...)                      \
  switch (D_RUNTIME) {                                     \
    case 1: { constexpr int D = 1; __VA_ARGS__; break; }   \
    case 2: { constexpr int D = 2; __VA_ARGS__; break; }   \
    case 3: { constexpr int D = 3; __VA_ARGS__; break; }   \
    case 4: { constexpr int D = 4; __VA_ARGS__; break; }   \
    case 8: { constexpr int D = 8; __VA_ARGS__; break; }   \
    case 16: { constexpr int D = 16; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;            \
  }

// The same, for kernels compiled up to D = 8 (their shared memory holds
// more per column).
#define GL_DISPATCH_D8(D_RUNTIME, ...)                     \
  switch (D_RUNTIME) {                                     \
    case 1: { constexpr int D = 1; __VA_ARGS__; break; }   \
    case 2: { constexpr int D = 2; __VA_ARGS__; break; }   \
    case 3: { constexpr int D = 3; __VA_ARGS__; break; }   \
    case 4: { constexpr int D = 4; __VA_ARGS__; break; }   \
    case 8: { constexpr int D = 8; __VA_ARGS__; break; }   \
    default: return (int)cudaErrorInvalidValue;            \
  }

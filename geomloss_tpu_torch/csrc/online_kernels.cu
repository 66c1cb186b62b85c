// Streaming pair-interaction kernels of the online Sinkhorn path, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// geomloss_tpu_torch/ops/cuda_kernels.py, which also holds each kernel's
// plain PyTorch twin and folds the biases (base-2 units) before launch.
//
// Shared design. x is (N, D) and y is (M, D), float32, row-major, with D
// zero-padded to a compiled width (1, 2, 3, 4, 8 or 16). One thread owns
// one row i and keeps its coordinates in registers; the block stages
// kTile columns of y (coordinates and column bias) in shared memory, where
// every thread of the block reads the same address (broadcast, no bank
// conflicts). Pair scores are explicit float32 FFMAs, never TF32:
//   p = 2: arg = bias_i + bias_j + <c2 x_i, y_j>, the squared norms being
//          folded into the biases (D FFMAs and one add);
//   p = 1: d = sqrt(max(|x_i - y_j|^2, 1e-8)) from coordinate differences,
//          so a near pair carries no cancellation noise, and
//          arg = bias_i + bias_j - c2 d.
//
// What bounds these kernels on an H100: the exponential. At N = M = 1e5 a
// sweep is 1e10 pairs and reads a few bytes per point, so memory traffic
// is negligible; an SM issues 16 MUFU (ex2) results per clock against 128
// FP32 lanes, so the few FFMAs of a pair fit under the one exp2 it needs
// (p = 1 adds a sqrt, a second MUFU operation). The designs therefore
// spend FFMAs to save exponentials: LSE recomputes each tile's scores for
// a max pass instead of rescaling per pair, the fused step reads both
// softmin directions off one exponential, and the symmetric step visits
// each off-diagonal pair once.
//
// Each entry point returns cudaGetLastError() after its launch.

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
                                           int i, bool valid, float scale) {
  Row<D> r;
#pragma unroll
  for (int d = 0; d < D; ++d) r.x[d] = valid ? scale * x[(int64_t)i * D + d] : 0.f;
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
                                          const float* __restrict__ bias, int j0,
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

// -----------------------------------------------------------------------------
// 1. Streaming LSE. Replaces geomloss_tpu/ops/pallas_kernels.py::lse_pallas
//    (_lse_kernel). out_i = log2 sum_j exp2(h2_j + arg_ij) in base-2 units;
//    the wrapper converts to nats and adds the p=2 row term.
//    Bound: one exp2 per pair. Design: per tile, a max pass that only
//    recomputes scores (FFMAs), then one exp2-sum pass against the running
//    max; the running sum is rescaled once per tile, not once per pair.
//    The ragged edge is an explicit bound on the tile width, not padding.
// -----------------------------------------------------------------------------
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
lse_kernel(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ h2, float* __restrict__ out, int N, int M,
           float c2) {
  __shared__ Tile<D> t;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < N;
  const Row<D> r = load_row<D>(x, nullptr, i, valid, P == 2 ? c2 : 1.f);
  float m = -INFINITY;
  float s = 0.f;
  for (int j0 = 0; j0 < M; j0 += kTile) {
    const int n = min(kTile, M - j0);
    __syncthreads();
    load_tile<D>(t, y, h2, j0, n);
    __syncthreads();
    float tmax = -INFINITY;
    for (int k = 0; k < n; ++k) tmax = fmaxf(tmax, pair_arg<D, P>(r, t, k, c2));
    const float m_new = fmaxf(m, tmax);
    if (m_new == -INFINITY) continue;  // every weight so far is exactly 0
    float acc = s * exp2f(m - m_new);
    for (int k = 0; k < n; ++k) acc += exp2f(pair_arg<D, P>(r, t, k, c2) - m_new);
    s = acc;
    m = m_new;
  }
  if (valid) out[i] = m + log2f(s);
}

// -----------------------------------------------------------------------------
// 2. Fused Sinkhorn step. Replaces pallas_kernels.py::sinkhorn_step_pallas
//    (_pair_step_kernel). W_ij = exp2(phi_i + psi_j + arg_ij), no max pass
//    (W is bounded after an averaged update; see the JAX block comment).
//    Row sums of W give S_xy, column sums give S_yx.
//    Bound: one exp2 per pair gives both directions. Design: each block
//    loops over all columns for its rows (row sums in a register); the
//    TPU's sequential column carry has no counterpart between blocks, so
//    each block writes its column sums to its own row of colpart
//    (gridDim.x, M), summed afterwards by the wrapper: deterministic, no
//    atomics. Column sums inside a block use a transposed warp reduction.
// -----------------------------------------------------------------------------
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
step_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ phi, const float* __restrict__ psi,
            float* __restrict__ rows, float* __restrict__ colpart, int N, int M,
            float c2) {
  __shared__ Tile<D> t;
  __shared__ float wsum[kWarps][kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < N;
  const Row<D> r = load_row<D>(x, phi, i, valid, P == 2 ? c2 : 1.f);
  float rsum = 0.f;
  float* cp = colpart + (int64_t)blockIdx.x * M;
  for (int j0 = 0; j0 < M; j0 += kTile) {
    const int n = min(kTile, M - j0);
    __syncthreads();
    load_tile<D>(t, y, psi, j0, n);
    __syncthreads();
    rsum += absorbed_tile<D, P, true>(r, t, n, valid, c2, wsum);
    __syncthreads();
    if (threadIdx.x < n) {
      float c = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += wsum[w][threadIdx.x];
      cp[j0 + threadIdx.x] = c;
    }
  }
  if (valid) rows[i] = rsum;
}

// -----------------------------------------------------------------------------
// 3. Symmetric (debias) step. Replaces
//    pallas_kernels.py::sinkhorn_step_sym_pallas (_sym_step_kernel).
//    One block per upper-triangle tile pair (I <= J), from the tables
//    it/jt. W is symmetric, so an off-diagonal tile's column sums are the
//    row sums of its mirror (J, I); diagonal tiles contribute rows only.
//    Bound: exp2, as above. Design: half the pairs of a full sweep. The
//    block writes its row sums to part[I][J] and, off the diagonal, its
//    column sums to part[J][I]; every entry of part (nb, nb, kTile) is
//    written exactly once and the wrapper sums over J: deterministic.
// -----------------------------------------------------------------------------
template <int D, int P>
__global__ void __launch_bounds__(kThreads)
sym_step_kernel(const float* __restrict__ x, const float* __restrict__ phi,
                const int* __restrict__ it, const int* __restrict__ jt,
                float* __restrict__ part, int N, int nb, float c2) {
  __shared__ Tile<D> t;
  __shared__ float wsum[kWarps][kTile];
  const int I = it[blockIdx.x];
  const int J = jt[blockIdx.x];
  const int i = I * kThreads + threadIdx.x;
  const bool valid = i < N;
  const Row<D> r = load_row<D>(x, phi, i, valid, P == 2 ? c2 : 1.f);
  const int j0 = J * kTile;
  const int n = min(kTile, N - j0);
  load_tile<D>(t, x, phi, j0, n);
  __syncthreads();
  float rsum;
  if (I == J) {
    rsum = absorbed_tile<D, P, false>(r, t, n, valid, c2, wsum);
  } else {
    rsum = absorbed_tile<D, P, true>(r, t, n, valid, c2, wsum);
  }
  part[((int64_t)I * nb + J) * kTile + threadIdx.x] = rsum;
  if (I != J) {
    __syncthreads();
    float c = 0.f;
    if (threadIdx.x < n) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += wsum[w][threadIdx.x];
    }
    part[((int64_t)J * nb + I) * kTile + threadIdx.x] = c;
  }
}

// -----------------------------------------------------------------------------
// 4. Gibbs apply. Replaces pallas_kernels.py::gibbs_apply_pallas
//    (_apply_kernel + _gibbs_weights). O_i = sum_j w_ij V_j for four
//    channels (the wrapper pads V and loops over channel groups), with
//    d = sqrt(max(sq, 1e-8)):
//    MODE 0: gibbs, p=2          w = exp2(phi + psi + <c2 x, y>)
//    MODE 1: gibbs, p=1          w = exp2(phi + psi - c2 d)
//    MODE 2: gibbs_grad, p=1     w = exp2(phi + psi - c2 d) / d
//    MODE 3: energy              w = -d
//    MODE 4: inv_dist            w = 1 / d
//    Modes 2 and 4 vanish where sq <= 1e-6.
//    Bound: one exp2 per pair plus four FFMAs into float32 accumulators.
//    Design: V's tile sits in shared memory beside y's; no weight block is
//    ever stored.
// -----------------------------------------------------------------------------
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ phi, const float* __restrict__ psi,
             const float* __restrict__ vt, float* __restrict__ out, int N, int M,
             float c2) {
  __shared__ Tile<D> t;
  __shared__ float v[4][kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < N;
  const Row<D> r = load_row<D>(x, phi, i, valid, MODE == 0 ? c2 : 1.f);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < M; j0 += kTile) {
    const int n = min(kTile, M - j0);
    __syncthreads();
    load_tile<D>(t, y, psi, j0, n);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c][k] = vt[(int64_t)c * M + j0 + k];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      float w;
      if constexpr (MODE == 0) {
        w = exp2f(pair_arg<D, 2>(r, t, k, c2));
      } else {
        const float sq = pair_sq<D>(r, t, k);
        const float d = sqrtf(fmaxf(sq, kSqdistFloor));
        if constexpr (MODE == 3) {
          w = -d;
        } else if constexpr (MODE == 4) {
          w = sq > kGradCut ? 1.f / d : 0.f;
        } else {
          w = exp2f(fmaf(-d, c2, r.bias + t.bias[k]));
          if constexpr (MODE == 2) w = sq > kGradCut ? w / d : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = fmaf(w, v[c][k], acc[c]);
    }
  }
  if (valid) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[(int64_t)i * 4 + c] = acc[c];
  }
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

extern "C" {

int gl_lse(const float* x, const float* y, const float* h2, float* out, int N,
           int M, int D, int p, float c2, void* stream) {
  const dim3 grid(cdiv(N, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p != 1 && p != 2) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_D(D,
    if (p == 2) lse_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, h2, out, N, M, c2);
    else lse_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, h2, out, N, M, c2))
  return (int)cudaGetLastError();
}

int gl_sinkhorn_step(const float* x, const float* y, const float* phi,
                     const float* psi, float* rows, float* colpart, int N, int M,
                     int D, int p, float c2, void* stream) {
  const dim3 grid(cdiv(N, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p != 1 && p != 2) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_D(D,
    if (p == 2) step_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, phi, psi, rows, colpart, N, M, c2);
    else step_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, phi, psi, rows, colpart, N, M, c2))
  return (int)cudaGetLastError();
}

int gl_sinkhorn_step_sym(const float* x, const float* phi, const int* it,
                         const int* jt, float* part, int N, int T, int nb, int D,
                         int p, float c2, void* stream) {
  const dim3 grid(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p != 1 && p != 2) return (int)cudaErrorInvalidValue;
  GL_DISPATCH_D(D,
    if (p == 2) sym_step_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, phi, it, jt, part, N, nb, c2);
    else sym_step_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, phi, it, jt, part, N, nb, c2))
  return (int)cudaGetLastError();
}

int gl_gibbs_apply(const float* x, const float* y, const float* phi,
                   const float* psi, const float* vt, float* out, int N, int M,
                   int D, int mode, float c2, void* stream) {
  const dim3 grid(cdiv(N, kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GL_DISPATCH_D(D,
    switch (mode) {
      case 0: apply_kernel<D, 0><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, c2); break;
      case 1: apply_kernel<D, 1><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, c2); break;
      case 2: apply_kernel<D, 2><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, c2); break;
      case 3: apply_kernel<D, 3><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, c2); break;
      case 4: apply_kernel<D, 4><<<grid, kThreads, 0, s>>>(x, y, phi, psi, vt, out, N, M, c2); break;
      default: return (int)cudaErrorInvalidValue;
    })
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// Above the compiled widths, D is padded to a multiple of the widest and
// the kernels' wide instantiation (D = 0) builds the scores of a group of
// columns up over coordinate chunks (wide_scores). Kernels 2, 5, 6 and 8
// use the register-tiled pair blocks at the end of this file instead, over
// points packed by the wrapper.

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

// -----------------------------------------------------------------------------
// Wide point dimensions. Above a library's compiled widths, D is zero-padded
// to a multiple of a chunk of DW coordinates (the widest build; padding adds
// 0 to dot products and to squared differences). The scores of a group of
// kGroup columns build up in a per-thread buffer over the coordinate chunks
// (wide_scores), each chunk of the group's columns staged in shared memory;
// then the kernel's own epilogue runs on the buffer: the LSE max/sum pass
// (lse_group), the absorbed sums or the apply weights (wide_arg,
// wide_weight), with the same kSqdistFloor and kGradCut rules.
// -----------------------------------------------------------------------------
constexpr int kGroup = 32;

template <int DW>
struct WideStage {
  float y[DW][kGroup];
  float bias[kGroup];
};

// s[k] = <scale x_i, y_j> (SQ false) or |x_i - y_j|^2 (SQ true) for the
// columns j = j0 + k, k < n <= kGroup (s[k] = 0 past n), each point dw
// floats (a multiple of DW); the group's column biases go to st.bias (0
// without `bias`). Every thread of the block calls it: it synchronises.
template <int DW, bool SQ>
__device__ __forceinline__ void wide_scores(const float* __restrict__ x, int64_t i, bool valid,
                                            float scale, const float* __restrict__ y,
                                            const float* __restrict__ bias, int64_t j0, int n,
                                            int dw, WideStage<DW>& st, float (&s)[kGroup]) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) s[k] = 0.f;
  for (int d0 = 0; d0 < dw; d0 += DW) {
    __syncthreads();
    for (int e = threadIdx.x; e < DW * kGroup; e += blockDim.x) {
      const int k = e / DW, d = e % DW;
      st.y[d][k] = k < n ? y[(j0 + k) * dw + d0 + d] : 0.f;
    }
    if (d0 == 0 && threadIdx.x < kGroup)
      st.bias[threadIdx.x] = (bias != nullptr && (int)threadIdx.x < n) ? bias[j0 + threadIdx.x] : 0.f;
    __syncthreads();
    float xr[DW];
#pragma unroll
    for (int d = 0; d < DW; ++d) xr[d] = valid ? scale * x[i * dw + d0 + d] : 0.f;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
#pragma unroll
      for (int d = 0; d < DW; ++d) {
        if constexpr (SQ) {
          const float diff = xr[d] - st.y[d][k];
          s[k] = fmaf(diff, diff, s[k]);
        } else {
          s[k] = fmaf(xr[d], st.y[d][k], s[k]);
        }
      }
    }
  }
}

// Base-2 log weight from a wide score: p = 2 (s = <c2 x, y>) or p = 1
// (s = |x - y|^2), `bias` the sum of both biases.
template <int P>
__device__ __forceinline__ float wide_arg(float s, float bias, float c2) {
  if constexpr (P == 2) return bias + s;
  else return fmaf(-sqrtf(fmaxf(s, kSqdistFloor)), c2, bias);
}

// apply_weight's modes from a wide score (mode 0: s = <c2 x, y>; modes 1-4:
// s = |x - y|^2).
template <int MODE>
__device__ __forceinline__ float wide_weight(float s, float bias, float c2) {
  if constexpr (MODE == 0) {
    return exp2f(bias + s);
  } else {
    const float d = sqrtf(fmaxf(s, kSqdistFloor));
    if constexpr (MODE == 3) {
      return -d;
    } else if constexpr (MODE == 4) {
      return s > kGradCut ? 1.f / d : 0.f;
    } else {
      const float w = exp2f(fmaf(-d, c2, bias));
      if constexpr (MODE == 2) return s > kGradCut ? w / d : 0.f;
      return w;
    }
  }
}

// lse_tile's two passes over a group's log weights a[k] (-inf past the
// group's columns).
__device__ __forceinline__ void lse_group(const float (&a)[kGroup], float& m, float& s) {
  float tmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) tmax = fmaxf(tmax, a[k]);
  const float m_new = fmaxf(m, tmax);
  if (m_new == -INFINITY) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kGroup; k += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += exp2f(a[k + q] - m_new);
  }
  s = s * exp2f(m - m_new) + ((acc[0] + acc[1]) + (acc[2] + acc[3]));
  m = m_new;
}

// -----------------------------------------------------------------------------
// Register-tiled pair blocks (kernels 2, 5, 6 and 8). A block's 256 threads
// form a 32 x 8 grid over its 256 rows and a pass of 8 C columns: lane l
// owns rows l + 32 r (r < kPairRows) and warp w the columns w C + c (c < C)
// of each pass, so every shared-memory load of a column serves all rows of
// a lane and is a broadcast across the warp. Points are packed by the
// wrapper (cuda_kernels._pair_vectors) as float4 vectors, kv of them per
// point:
//   p = 2: row [c2 x, 0..., 1], column [y, 0..., bias]: a score is the row
//          bias plus D + 1 FFMAs (the column bias rides as a coordinate);
//   p = 1: row [x, 0...], column [y, 0...], the column bias apart:
//          sqrt(max(|x - y|^2, 1e-8)) as pair_arg's.
// A column the wrapper pads (kernel 2's ragged last stage) has bias -inf,
// so its weights are 0. Points of up to kStepStaged float4s are staged: a
// lane keeps its rows' vectors in registers and the block stages kTile
// columns in shared memory. A wider point (the wide instantiation, KV = 0)
// builds its R x C scores up in registers over the kv chunks, read from
// global memory.
// -----------------------------------------------------------------------------
constexpr int kPairRows = kThreads / 32;  // rows per lane: 8

// exp2 as one MUFU.EX2 (ex2.approx.ftz): results below 2^-126 flush to 0,
// weights far below the sums they join.
__device__ __forceinline__ float fast_exp2(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ float sqdiff4(float4 a, float4 b, float s) {
  const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z, dw = a.w - b.w;
  s = fmaf(dx, dx, s);
  s = fmaf(dy, dy, s);
  s = fmaf(dz, dz, s);
  return fmaf(dw, dw, s);
}

// Score accumulator of one packed chunk: p = 2 a dot product, p = 1 a sum
// of squared differences.
template <int P>
__device__ __forceinline__ float packed_acc(float4 x, float4 y, float s) {
  if constexpr (P == 2) return dot4(x, y, s);
  else return sqdiff4(x, y, s);
}

// Weight of a pair from its accumulated score s (p = 2: the base-2 log
// weight; p = 1: the squared distance), `bias` the row bias plus (p = 1)
// the column bias: MODE as apply_weight's 0-4 (3 and 4 take s only), or -1
// for the absorbed weight exp2(arg) of kernels 2 and 5.
template <int P, int MODE>
__device__ __forceinline__ float packed_weight(float s, float bias, float c2) {
  if constexpr (P == 2) {
    return fast_exp2(s);
  } else {
    const float d = sqrtf(fmaxf(s, kSqdistFloor));
    if constexpr (MODE == 3) {
      return -d;
    } else if constexpr (MODE == 4) {
      return s > kGradCut ? 1.f / d : 0.f;
    } else {
      const float w = fast_exp2(fmaf(-d, c2, bias));
      if constexpr (MODE == 2) return s > kGradCut ? w / d : 0.f;
      return w;
    }
  }
}

// The lane's rows of a block whose first `rows` rows from i0 are valid,
// KS float4s each (WIDE: left out, the passes read them from global
// memory): an invalid row gets bias -inf, so its weights are 0.
template <int P, int KS, bool WIDE>
__device__ __forceinline__ void load_pair_rows(float4 (&xr)[kPairRows][KS], float (&br)[kPairRows],
                                               const float4* __restrict__ xv,
                                               const float* __restrict__ rb, int64_t i0, int rows,
                                               int lane) {
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) {
    const int il = lane + 32 * r;
    const bool ok = il < rows;
#pragma unroll
    for (int k = 0; k < KS; ++k)
      xr[r][k] = (!WIDE && ok) ? xv[(i0 + il) * KS + k] : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (P == 2) xr[r][KS - 1].w = 1.f;  // the packed row's last slot: the column bias's factor
    br[r] = ok ? rb[i0 + il] : -INFINITY;
  }
}

// -----------------------------------------------------------------------------
// The absorbed-sum stage of kernels 2 and 5: the lane's 8 rows against a
// stage of n <= kTile columns in passes of kStepPass, kStepCols columns per
// lane and pass: per pair one LDS.128 shared by 8 rows (per staged float4),
// D + 1 FFMAs, one MUFU.EX2 and two adds (the row sum and the column sum).
// Row sums stay in registers (racc) over the caller's stages and are added
// over the 8 warps once at the end (block_row_sum); column sums stay in
// kStepCols registers over a lane's 8 rows and go to shared memory, where
// the stage adds its 32 lanes once, in a fixed order. No shuffles, no
// atomics: deterministic.
// -----------------------------------------------------------------------------
constexpr int kStepCols = 8;
constexpr int kStepPass = kWarps * kStepCols;  // columns per pass: 64
constexpr int kStepStaged = 3;        // the widest staged points, in float4s (46 KB of shared memory)
constexpr int kRedPitch = kTile + 4;  // keeps a lane's float4 stores off each other's banks

// Shared memory of the stage: kTile packed columns (KS float4s each; none
// for the wide instantiation), their p = 1 biases, and the lanes' column
// partials (at the end, the warps' row partials).
template <int P, int KS, bool WIDE>
struct StepSmem {
  float4 ys[KS][WIDE ? 1 : kTile];
  float ycb[P == 1 ? kTile : 1];
  __align__(16) float red[32][kRedPitch];
};

// One stage: the columns j0 .. j0 + n of yv (n a multiple of kStepPass),
// against the lane's rows (xr, br; WIDE: xv's `rows` rows from i0, kv
// float4s each). Adds the row sums into racc; with `cols`, writes the
// column sums of the first n_out columns to cp[0 .. n_out), else zeros.
// Every thread of the block calls it: it synchronises.
template <int P, int KV>
__device__ __forceinline__ void step_stage(StepSmem<P, KV == 0 ? 1 : KV, KV == 0>& sm,
                                           const float4 (&xr)[kPairRows][KV == 0 ? 1 : KV],
                                           const float (&br)[kPairRows], float (&racc)[kPairRows],
                                           const float4* __restrict__ xv, int64_t i0, int rows,
                                           int kv, const float4* __restrict__ yv,
                                           const float* __restrict__ cb, int64_t j0, int n,
                                           int n_out, bool cols, float* __restrict__ cp,
                                           float c2) {
  constexpr int R = kPairRows, C = kStepCols;
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the last stage's reads of ys, ycb and red are done
  for (int k = threadIdx.x; k < n; k += kThreads) {
    if constexpr (!WIDE) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) sm.ys[kk][k] = yv[(j0 + k) * KS + kk];
    }
    if constexpr (P == 1) sm.ycb[k] = cb[j0 + k];
  }
  __syncthreads();
  for (int b = 0; b < n; b += kStepPass) {
    const int cb0 = b + warp * C;
    float cacc[C];
    if constexpr (!WIDE) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float4 y[KS];
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) y[kk] = sm.ys[kk][cb0 + c];
        const float bc = P == 1 ? sm.ycb[cb0 + c] : 0.f;
        float cs = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float sc = P == 2 ? br[r] : 0.f;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) sc = packed_acc<P>(xr[r][kk], y[kk], sc);
          const float w = packed_weight<P, -1>(sc, br[r] + bc, c2);
          racc[r] += w;
          cs += w;
        }
        cacc[c] = cs;
      }
    } else {
      float s[R][C];
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
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float bc = P == 1 ? sm.ycb[cb0 + c] : 0.f;
        float cs = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float w = packed_weight<P, -1>(s[r][c], br[r] + bc, c2);
          racc[r] += w;
          cs += w;
        }
        cacc[c] = cs;
      }
    }
    if (cols) {
#pragma unroll
      for (int c = 0; c < C; c += 4)
        *reinterpret_cast<float4*>(&sm.red[lane][cb0 + c]) =
            make_float4(cacc[c], cacc[c + 1], cacc[c + 2], cacc[c + 3]);
    }
  }
  if (cols) {
    __syncthreads();
    if (threadIdx.x < n_out) {
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int l = 0; l < 32; ++l) sum[l & 3] += sm.red[l][threadIdx.x];
      cp[threadIdx.x] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
    }
  } else if (threadIdx.x < n_out) {
    cp[threadIdx.x] = 0.f;
  }
}

// Row sums of the block: the 8 warps' partials racc of each row, added in
// warp order; thread t returns row t's. Every thread calls it.
template <int P, int KS, bool WIDE>
__device__ __forceinline__ float block_row_sum(StepSmem<P, KS, WIDE>& sm, const float (&racc)[kPairRows]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  float* rr = &sm.red[0][0];
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) rr[warp * kThreads + lane + 32 * r] = racc[r];
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += rr[w * kThreads + threadIdx.x];
  return sum;
}

}  // namespace

// Template dispatch on the (padded) point dimension; D = 0 is the wide
// instantiation, for a multiple of 16 above 16 (the kernel reads the
// runtime width).
#define GL_DISPATCH_D(D_RUNTIME, ...)                                    \
  switch (D_RUNTIME) {                                                   \
    case 1: { constexpr int D = 1; __VA_ARGS__; break; }                 \
    case 2: { constexpr int D = 2; __VA_ARGS__; break; }                 \
    case 3: { constexpr int D = 3; __VA_ARGS__; break; }                 \
    case 4: { constexpr int D = 4; __VA_ARGS__; break; }                 \
    case 8: { constexpr int D = 8; __VA_ARGS__; break; }                 \
    case 16: { constexpr int D = 16; __VA_ARGS__; break; }               \
    default:                                                             \
      if ((D_RUNTIME) > 16 && (D_RUNTIME) % 16 == 0) {                   \
        constexpr int D = 0; __VA_ARGS__; break;                         \
      }                                                                  \
      return (int)cudaErrorInvalidValue;                                 \
  }

// The same, for kernels compiled up to D = 8 (their shared memory holds
// more per column); the wide instantiation takes multiples of 8 above 8.
#define GL_DISPATCH_D8(D_RUNTIME, ...)                                   \
  switch (D_RUNTIME) {                                                   \
    case 1: { constexpr int D = 1; __VA_ARGS__; break; }                 \
    case 2: { constexpr int D = 2; __VA_ARGS__; break; }                 \
    case 3: { constexpr int D = 3; __VA_ARGS__; break; }                 \
    case 4: { constexpr int D = 4; __VA_ARGS__; break; }                 \
    case 8: { constexpr int D = 8; __VA_ARGS__; break; }                 \
    default:                                                             \
      if ((D_RUNTIME) > 8 && (D_RUNTIME) % 8 == 0) {                     \
        constexpr int D = 0; __VA_ARGS__; break;                         \
      }                                                                  \
      return (int)cudaErrorInvalidValue;                                 \
  }

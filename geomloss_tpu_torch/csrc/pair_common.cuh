// Device code shared by the pair-interaction kernels of geomloss_tpu_torch
// (online_kernels.cu, block_sparse_kernels.cu), for Hopper (sm_90a).
//
// Two designs. Kernels 2-6 and 8 (and 11, on kernel 8) run the
// register-tiled pair blocks in the second half of this file, over points
// packed by the wrapper (cuda_kernels._pair_vectors). Kernels 1, 7 and 12
// keep one thread per row, in the first half:
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
// columns up over coordinate chunks (wide_scores).

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

// Row sums of exp2(arg) over one staged tile of n columns (kernel 12).
template <int D, int P>
__device__ __forceinline__ float absorbed_tile(const Row<D>& r, const Tile<D>& t, int n,
                                               bool valid, float c2) {
  float rsum = 0.f;
  if (valid) {
#pragma unroll 4
    for (int col = 0; col < n; ++col) rsum += exp2f(pair_arg<D, P>(r, t, col, c2));
  }
  return rsum;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// -----------------------------------------------------------------------------
// Wide point dimensions. Above a library's compiled widths, D is zero-padded
// to a multiple of a chunk of DW coordinates (the widest build; padding adds
// 0 to dot products and to squared differences). The scores of a group of
// kGroup columns build up in a per-thread buffer over the coordinate chunks
// (wide_scores), each chunk of the group's columns staged in shared memory;
// then the kernel's own epilogue runs on the buffer: the LSE max/sum pass
// (lse_group) or the absorbed sums (wide_arg), with the same kSqdistFloor
// rule.
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
// Register-tiled pair blocks (kernels 2-6 and 8). A block's 256 threads
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
// A column the wrapper pads (the ragged last stage of kernels 2 and 3) has
// bias -inf, so its weights are 0; so has a row past the end. Points of up
// to kStepStaged float4s are staged: a lane keeps its rows' vectors in
// registers and the block stages kTile columns in shared memory. A wider
// point (the wide instantiation, KV = 0) builds its R x C scores up in
// registers over the kv chunks, read from global memory. Two stages serve
// them: the absorbed sums (step_stage: kernels 2, 3 and 5) and the row
// contraction with V (apply_stage: kernels 4 and 8).
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

// 1 / sqrt(a) as one MUFU.RSQ (rsqrt.approx.ftz; a >= kSqdistFloor here).
__device__ __forceinline__ float fast_rsqrt(float a) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// Weight of a pair from its accumulated score s (p = 2: the base-2 log
// weight; p = 1: the squared distance), `bias` the row bias plus (p = 1)
// the column bias, d = sqrt(max(s, 1e-8)):
//   MODE -1: the absorbed weight of kernels 2, 3 and 5   exp2(arg)
//   MODE 0:  gibbs, p = 2                                exp2(arg)
//   MODE 1:  gibbs, p = 1                                exp2(bias - c2 d)
//   MODE 2:  gibbs_grad, p = 1                           exp2(bias - c2 d) / d
//   MODE 3:  energy                                      -d
//   MODE 4:  inv_dist                                    1 / d
// Modes 2 and 4 vanish where s <= 1e-6. Modes 3 and 4 take one MUFU from
// r = rsqrt(max(s, 1e-8)): d = max(s, 1e-8) r, 1 / d = r. The Sinkhorn
// modes 1 and 2 keep an IEEE sqrtf.
template <int P, int MODE>
__device__ __forceinline__ float packed_weight(float s, float bias, float c2) {
  if constexpr (P == 2) {
    return fast_exp2(s);
  } else if constexpr (MODE == 3 || MODE == 4) {
    const float m = fmaxf(s, kSqdistFloor);
    const float r = fast_rsqrt(m);
    if constexpr (MODE == 3) return -m * r;
    else return s > kGradCut ? r : 0.f;
  } else {
    const float d = sqrtf(fmaxf(s, kSqdistFloor));
    const float w = fast_exp2(fmaf(-d, c2, bias));
    if constexpr (MODE == 2) return s > kGradCut ? w / d : 0.f;
    return w;
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
// The absorbed-sum stage of kernels 2, 3 and 5: the lane's 8 rows against a
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

// -----------------------------------------------------------------------------
// The row contraction of kernels 4 and 8: O_i += sum_j w_ij V_j for the
// lane's 8 rows against a stage of n <= kTile columns, with CH = 1 or 4
// channels and the weights of packed_weight's modes 0-4. A warp takes C
// columns of each pass: 4 where a pass holds four channels or wide scores
// in registers, else 8. The stage is padded to whole passes
// with copies of its last column whose V is 0 (they add nothing, so a
// stage may be any width). Per pair: one LDS.128 per staged float4 and one
// V load, each shared by 8 rows, the score FFMAs, the weight's MUFU and CH
// FFMAs into a stage partial, added to the row's accumulator once per
// stage: a float32 chain grows with the stages of a row, not its columns.
// The 8 warps' accumulators of each row are added in warp order at the end
// (block_apply_sum): no atomics, bitwise reproducible.
// -----------------------------------------------------------------------------
template <int CH> struct Chan;
template <> struct Chan<1> { using T = float; };
template <> struct Chan<4> { using T = float4; };

__device__ __forceinline__ void chan_zero(float& a) { a = 0.f; }
__device__ __forceinline__ void chan_zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void chan_fma(float w, float v, float& a) { a = fmaf(w, v, a); }
__device__ __forceinline__ void chan_fma(float w, float4 v, float4& a) {
  a.x = fmaf(w, v.x, a.x);
  a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z);
  a.w = fmaf(w, v.w, a.w);
}
__device__ __forceinline__ void chan_add(float& a, float b) { a += b; }
__device__ __forceinline__ void chan_add(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Shared memory of the stage: kTile packed columns, their p = 1 biases and
// V, and (after the last stage) the warps' row partials.
template <int KS, int CH, bool WIDE>
union ApplySmem {
  struct {
    float4 ys[KS][WIDE ? 1 : kTile];
    typename Chan<CH>::T vs[kTile];
    float ycb[kTile];
  } st;
  typename Chan<CH>::T red[kWarps * kThreads];
};

// One stage: the columns j0 .. j0 + n of yv, cb and v (1 <= n <= kTile)
// against the lane's rows (xr, br; WIDE: xv's `rows` rows from i0, kv
// float4s each), added into acc. Every thread of the block calls it: it
// synchronises.
template <int MODE, int KV, int CH>
__device__ __forceinline__ void apply_stage(ApplySmem<KV == 0 ? 1 : KV, CH, KV == 0>& sm,
                                            const float4 (&xr)[kPairRows][KV == 0 ? 1 : KV],
                                            const float (&br)[kPairRows],
                                            typename Chan<CH>::T (&acc)[kPairRows],
                                            const float4* __restrict__ xv, int64_t i0, int rows, int kv,
                                            const float4* __restrict__ yv, const float* __restrict__ cb,
                                            const typename Chan<CH>::T* __restrict__ v, int64_t j0, int n,
                                            float c2) {
  using VT = typename Chan<CH>::T;
  constexpr int P = MODE == 0 ? 2 : 1;
  constexpr int R = kPairRows;
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  constexpr int C = (CH == 4 || WIDE) ? 4 : 8;  // columns per lane and pass
  constexpr int PASS = kWarps * C;  // columns per pass
  static_assert(kTile % PASS == 0, "a padded stage fits the staging buffers");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_pad = (n + PASS - 1) / PASS * PASS;
  __syncthreads();  // the last stage's reads are done
  for (int kk = threadIdx.x; kk < n_pad; kk += kThreads) {
    // A padded column repeats the last one with V = 0: it adds nothing.
    const int64_t j = j0 + min(kk, n - 1);
    if constexpr (!WIDE) {
#pragma unroll
      for (int q = 0; q < KS; ++q) sm.st.ys[q][kk] = yv[j * KS + q];
    }
    if constexpr (P == 1) sm.st.ycb[kk] = cb[j];
    VT vj;
    chan_zero(vj);
    if (kk < n) vj = v[j];
    sm.st.vs[kk] = vj;
  }
  __syncthreads();
  VT part[R];
#pragma unroll
  for (int r = 0; r < R; ++r) chan_zero(part[r]);
  for (int b = 0; b < n_pad; b += PASS) {
    const int cb0 = b + warp * C;
    float s[WIDE ? R : 1][C];
    if constexpr (WIDE) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < C; ++c) s[r][c] = P == 2 ? br[r] : 0.f;
      }
      for (int q = 0; q < kv; ++q) {
        float4 xk[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int il = lane + 32 * r;
          xk[r] = il < rows ? xv[(i0 + il) * kv + q] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 y = yv[(j0 + min(cb0 + c, n - 1)) * kv + q];
#pragma unroll
          for (int r = 0; r < R; ++r) s[r][c] = packed_acc<P>(xk[r], y, s[r][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const VT vc = sm.st.vs[cb0 + c];
      const float bc = P == 1 ? sm.st.ycb[cb0 + c] : 0.f;
      float4 y[KS];
      if constexpr (!WIDE) {
#pragma unroll
        for (int q = 0; q < KS; ++q) y[q] = sm.st.ys[q][cb0 + c];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sc;
        if constexpr (WIDE) {
          sc = s[r][c];
        } else {
          sc = P == 2 ? br[r] : 0.f;
#pragma unroll
          for (int q = 0; q < KS; ++q) sc = packed_acc<P>(xr[r][q], y[q], sc);
        }
        chan_fma(packed_weight<P, MODE>(sc, br[r] + bc, c2), vc, part[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) chan_add(acc[r], part[r]);
}

// Rows of the block: the 8 warps' accumulators of each row, added in warp
// order; thread t returns row t's. Every thread calls it.
template <int KS, int CH, bool WIDE>
__device__ __forceinline__ typename Chan<CH>::T block_apply_sum(ApplySmem<KS, CH, WIDE>& sm,
                                                                const typename Chan<CH>::T (&acc)[kPairRows]) {
  using VT = typename Chan<CH>::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the last stage's reads of st are done
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) sm.red[warp * kThreads + lane + 32 * r] = acc[r];
  __syncthreads();
  VT sum;
  chan_zero(sum);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) chan_add(sum, sm.red[w * kThreads + threadIdx.x]);
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

// Device code shared by the pair-interaction kernels of geomloss_tpu_torch
// (online_kernels.cu, block_sparse_kernels.cu), for Hopper (sm_90a).
//
// Every kernel (1-8 and 12; 9, 10 and 11 run on kernels 7, 12 and 8) is a
// register-tiled pair block: kernels 2-6, 8 and 12 over points packed by
// the wrapper (cuda_kernels._pair_vectors), kernels 1 and 7 (the LSE
// stage) over the raw points, packed as they are loaded. Pair scores are
// explicit float32 FFMAs, never TF32:
//   p = 2: arg = bias_i + bias_j + <c2 x_i, y_j>, the squared norms being
//          folded into the biases;
//   p = 1: d = sqrt(max(|x_i - y_j|^2, 1e-8)) from coordinate differences,
//          so a near pair carries no cancellation noise, and
//          arg = bias_i + bias_j - c2 d.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows per block
constexpr int kTile = 256;     // columns per shared-memory tile (== kThreads)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr float kSqdistFloor = 1e-8f;  // clamp before sqrt
constexpr float kGradCut = 1e-6f;      // distance-gradient weights vanish below

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// -----------------------------------------------------------------------------
// Register-tiled pair blocks (kernels 1-8 and 12). A block's 256 threads
// form a 32 x 8 grid over its 256 rows and a pass of 8 C columns: lane l
// owns rows l + 32 r (r < kPairRows) and warp w the columns w C + c (c < C)
// of each pass, so every shared-memory load of a column serves all rows of
// a lane and is a broadcast across the warp. Points are packed by the
// wrapper (cuda_kernels._pair_vectors) as float4 vectors, kv of them per
// point:
//   p = 2: row [c2 x, 0..., 1], column [y, 0..., bias]: a score is the row
//          bias plus D + 1 FFMAs (the column bias rides as a coordinate);
//   p = 1: row [x, 0...], column [y, 0...], the column bias apart.
// A column the wrapper pads (the ragged last stage of kernels 2 and 3), or
// the row-only stage pads (a ragged pass of kernel 12), has bias -inf, so
// its weights are 0; so has a row past the end. Points of up
// to kStepStaged float4s are staged: a lane keeps its rows' vectors in
// registers and the block stages kTile columns in shared memory. A wider
// point (the wide instantiation, KV = 0) builds its R x C scores up in
// registers over the kv chunks, read from global memory. Three stages serve
// them: the absorbed sums (step_stage: kernels 2, 3 and 5; its row-only
// form kernel 12), the row
// contraction with V (apply_stage: kernels 4 and 8) and the online
// log-sum-exp (lse_stage: kernels 1 and 7), which packs the raw points
// itself (its column bias apart at either p).
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

// sqdiff4 of points of at most three coordinates (the fourth slot zero in
// both): the same sum, to the bit (fmaf(0, 0, s) = s), two instructions
// fewer.
__device__ __forceinline__ float sqdiff3(float4 a, float4 b, float s) {
  const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  s = fmaf(dx, dx, s);
  s = fmaf(dy, dy, s);
  return fmaf(dz, dz, s);
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
// atomics: deterministic. The row-only form (COLS false, kernel 12) has no
// column sums: per pair the FFMAs, the MUFU.EX2 and one add. It takes any
// n: a ragged last pass is padded with columns of bias -inf.
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

// One stage: the columns j0 .. j0 + n of yv (COLS: n a multiple of
// kStepPass), against the lane's rows (xr, br; WIDE: xv's `rows` rows from
// i0, kv float4s each). Adds the row sums into racc; with COLS and `cols`,
// writes the column sums of the first n_out columns to cp[0 .. n_out),
// with COLS alone zeros there; without COLS, n_out, cols and cp are not
// read. Every thread of the block calls it: it synchronises.
template <int P, int KV, bool COLS = true>
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
  const int n_pad = COLS ? n : (n + kStepPass - 1) / kStepPass * kStepPass;
  __syncthreads();  // the last stage's reads of ys, ycb and red are done
  for (int k = threadIdx.x; k < n_pad; k += kThreads) {
    if (COLS || k < n) {
      if constexpr (!WIDE) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) sm.ys[kk][k] = yv[(j0 + k) * KS + kk];
      }
      if constexpr (P == 1) sm.ycb[k] = cb[j0 + k];
    } else {
      // A padded column: coordinates 0 and bias -inf (at p = 2 the bias
      // rides in the last slot, whose row factor is 1).
      if constexpr (!WIDE) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          sm.ys[kk][k] = make_float4(0.f, 0.f, 0.f, (P == 2 && kk == KS - 1) ? -INFINITY : 0.f);
      }
      if constexpr (P == 1) sm.ycb[k] = -INFINITY;
    }
  }
  __syncthreads();
  for (int b = 0; b < n_pad; b += kStepPass) {
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
          if constexpr (COLS) cs += w;
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
          // A padded column of the row-only form reads the stage's last one.
          const float4 y = yv[(j0 + (COLS ? cb0 + c : min(cb0 + c, n - 1))) * kv + k];
#pragma unroll
          for (int r = 0; r < R; ++r) s[r][c] = packed_acc<P>(xk[r], y, s[r][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float bc = P == 1 ? sm.ycb[cb0 + c] : 0.f;
        // At p = 2 the bias rides in the packed point: a padded column's
        // scores are set to -inf here (at p = 1 its staged bias is -inf).
        const bool pad = !COLS && P == 2 && cb0 + c >= n;
        float cs = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float w = packed_weight<P, -1>(pad ? -INFINITY : s[r][c], br[r] + bc, c2);
          racc[r] += w;
          if constexpr (COLS) cs += w;
        }
        cacc[c] = cs;
      }
    }
    if constexpr (COLS) {
      if (cols) {
#pragma unroll
        for (int c = 0; c < C; c += 4)
          *reinterpret_cast<float4*>(&sm.red[lane][cb0 + c]) =
              make_float4(cacc[c], cacc[c + 1], cacc[c + 2], cacc[c + 3]);
      }
    }
  }
  if constexpr (COLS) {
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
// channels and the weights of packed_weight's modes 0-4 (or modes 3 and 4
// together, MODE 5: kernel 4's energy value and gradient). A warp takes C
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
__device__ __forceinline__ float chan_first(float a) { return a; }
__device__ __forceinline__ float chan_first(float4 a) { return a.x; }
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
//
// MODE 5 (kernel 4's energy_grad, CH = 4) is modes 3 and 4 in one pass:
// acc takes channel group g of the energy gradient's r V_j, V_j = v_j [1,
// y_j] built from vcol (M,) and the packed columns as they are staged (no
// V in global memory), with mode 4's weight r = rsqrt(max(s, 1e-8)), cut
// to 0 where s <= 1e-6, in mode 4's order; with VAL, accv takes the value
// sum_j -max(s, 1e-8) r v_j (mode 3's weight, v_j being channel 0 of group
// 0) through a stage partial of its own. cb and v are not read. D3 (MODE
// 5, KV = 1): the points have at most three coordinates, and the score
// leaves out the packed float4's zero fourth slot (sqdiff3).
template <int MODE, int KV, int CH, bool VAL = false, bool D3 = false>
__device__ __forceinline__ void apply_stage(ApplySmem<KV == 0 ? 1 : KV, CH, KV == 0>& sm,
                                            const float4 (&xr)[kPairRows][KV == 0 ? 1 : KV],
                                            const float (&br)[kPairRows],
                                            typename Chan<CH>::T (&acc)[kPairRows],
                                            const float4* __restrict__ xv, int64_t i0, int rows, int kv,
                                            const float4* __restrict__ yv, const float* __restrict__ cb,
                                            const typename Chan<CH>::T* __restrict__ v, int64_t j0, int n,
                                            float c2, const float* __restrict__ vcol = nullptr, int g = 0,
                                            float* accv = nullptr) {
  using VT = typename Chan<CH>::T;
  constexpr bool FUSED = MODE == 5;
  static_assert(!FUSED || CH == 4, "the fused energy mode takes groups of four channels");
  static_assert(FUSED || !VAL, "only the fused energy mode carries the value");
  static_assert(!D3 || (FUSED && KV == 1), "three coordinates: the fused energy mode, one float4 a point");
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
    if constexpr (FUSED) {
      // Channels 4 g .. 4 g + 3 of v_j [1, y_j]: the last coordinate of
      // the packed point's float4 g - 1 (the 1 for g = 0) and the first
      // three of float4 g (zeros past the point: the packed coordinates
      // past D are zeros). The products are those of the unfused V.
      const int kq = WIDE ? kv : KS;
      const float4 cur = g < kq ? yv[j * kq + g] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float prev = g == 0 ? 1.f : yv[j * kq + g - 1].w;
      const float vj = kk < n ? vcol[j] : 0.f;
      sm.st.vs[kk] = make_float4(vj * prev, vj * cur.x, vj * cur.y, vj * cur.z);
    } else {
      if constexpr (P == 1) sm.st.ycb[kk] = cb[j];
      VT vj;
      chan_zero(vj);
      if (kk < n) vj = v[j];
      sm.st.vs[kk] = vj;
    }
  }
  __syncthreads();
  VT part[R];
#pragma unroll
  for (int r = 0; r < R; ++r) chan_zero(part[r]);
  float pval[VAL ? R : 1];
#pragma unroll
  for (int r = 0; r < (VAL ? R : 1); ++r) pval[r] = 0.f;
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
      const float bc = (P == 1 && !FUSED) ? sm.st.ycb[cb0 + c] : 0.f;
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
          if constexpr (D3) {
            sc = sqdiff3(xr[r][0], y[0], sc);
          } else {
#pragma unroll
            for (int q = 0; q < KS; ++q) sc = packed_acc<P>(xr[r][q], y[q], sc);
          }
        }
        if constexpr (FUSED) {
          // One MUFU for both weights: packed_weight's modes 4 and 3.
          const float m = fmaxf(sc, kSqdistFloor);
          const float rs = fast_rsqrt(m);
          chan_fma(sc > kGradCut ? rs : 0.f, vc, part[r]);
          if constexpr (VAL) pval[r] = fmaf(-m * rs, chan_first(vc), pval[r]);
        } else {
          chan_fma(packed_weight<P, MODE>(sc, br[r] + bc, c2), vc, part[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) chan_add(acc[r], part[r]);
  if constexpr (VAL) {
#pragma unroll
    for (int r = 0; r < R; ++r) accv[r] += pval[r];
  }
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

// -----------------------------------------------------------------------------
// The online log-sum-exp of kernels 1 and 7: out_i = log sum_j exp2(arg_ij)
// (in nats, times ln 2) for the lane's 8 rows against stages of n <= kTile
// columns, in passes of kStepPass (kStepCols columns per lane and pass):
//   p = 2: arg = cb_j + <c2 x_i, y_j>, cb_j = log2(e) h_j - c2 |y_j|^2 / 2;
//   p = 1: arg = cb_j - c2 sqrt(max(|x_i - y_j|^2, 1e-8)), cb_j = log2(e) h_j;
// the row term -c2 |x_i|^2 / 2 of p = 2 is added at the end (lse_out). A
// lane keeps a running max m and sum s of each of its rows, the sum
// relative to the max. A pass takes its rows in two halves of kLseHalf
// rows: the half's scores (kLseHalf x kStepCols) stay in registers,
// relative to the running max (arg - m), and each pair takes one
// ex2.approx of its score at once, beside the row's max over the pass (a
// tree of 7 FMNMX), so the max does not hold up the exponentials. The
// block's rows are staged in shared memory with the columns, and each half
// loads its 4 rows and 8 columns (lds4): registers, not loads, limit the
// stage. At p = 2 the relative score costs nothing: a row's last float4
// carries -m in its padding slot (set from the warp's own m as the half
// loads it: every warp keeps its own maxima) and a staged column a 1 (kv =
// cdiv(D + 1, 4) float4s a point); elsewhere m is subtracted. Where a pass
// raises a row's max (the warp votes once a half-pass, so the common pass
// takes no branch), the row is rebased: by up to 2^kLseLazy its pass's
// terms were at most that, so the new sum is rescaled by one exp2; a
// larger jump, or the row's first finite scores (while m = -inf the base
// is 0 and the sum 0), computes the row's scores again against the new
// max (lse_row_scores), so nothing overflows, no digits are lost to a
// base far below the max, and no inf - inf or 0 x inf arises. The
// stage packs the raw points as it loads them (load_point): coordinates
// with row stride ld, the first D read, zeros after; the column bias is
// staged apart. Points of up to kStepStaged float4s are staged (the rows
// scaled by c2 for p = 2); a wider point (KV = 0) is read as packed
// float4s from global memory per pass (the wrapper pads it to ld = 4 kv
// floats), its scores built up over the chunks. The 8 warps' (m, s) of
// each row merge in warp order through shared memory (block_lse_merge):
// no atomics, bitwise reproducible.
// -----------------------------------------------------------------------------
constexpr int kLseHalf = kPairRows / 2;  // rows of a lane per half-pass: 4
constexpr float kLseLazy = 64.f;  // largest rise of a max whose pass is rescaled, not recomputed
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.44269504088896341f;

// The first D coordinates of point j of p (row stride ld floats), times
// `scale`, as KS float4s, zero-padded.
template <int KS>
__device__ __forceinline__ void load_point(float4 (&v)[KS], const float* __restrict__ p, int64_t j, int ld, int D,
                                           float scale) {
  const float* q = p + j * ld;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    float a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = 4 * k + c < D ? scale * q[4 * k + c] : 0.f;
    v[k] = make_float4(a[0], a[1], a[2], a[3]);
  }
}

__device__ __forceinline__ float4 scale4(float4 a, float s) { return make_float4(s * a.x, s * a.y, s * a.z, s * a.w); }

// A float4 of shared memory, loaded where it stands: each half of a pass
// loads its rows and columns, rather than keeping them live across the
// pass (registers are what limits the stage).
__device__ __forceinline__ float4 lds4(const float4* p) {
  float4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}

// Shared memory of the stage: the block's rows (KS float4s each, the
// staged forms), and either kTile staged columns (KS float4s each, none
// for the wide form; their indices for the wide form) and their biases,
// or, after the last stage, the warps' (m, s) of each row.
template <int KS, bool WIDE>
struct LseSmem {
  float4 xs[KS][WIDE ? 1 : kThreads];
  union {
    struct {
      float4 ys[KS][WIDE ? 1 : kTile];
      float ycb[kTile];
      int yj[WIDE ? kTile : 1];
    } st;
    float2 red[kWarps * kThreads];
  } u;
};

// The block's rows, of which the first `rows` from i0 are valid, staged
// in shared memory (thread t's row t): raw points (ld, D) loaded as KS
// float4s, scaled by `scale`, the -m slot of p = 2 (the last) at 0; zeros
// past `rows`. The wide form reads its rows from global memory per pass.
// The first stage's barrier orders these stores before the passes.
template <int KS, bool WIDE>
__device__ __forceinline__ void load_lse_rows(LseSmem<KS, WIDE>& sm, const float* __restrict__ x, int ld, int D,
                                              int64_t i0, int rows, float scale) {
  if constexpr (!WIDE) {
    float4 v[KS];
    if ((int)threadIdx.x < rows) {
      load_point<KS>(v, x, i0 + threadIdx.x, ld, D, scale);
    } else {
#pragma unroll
      for (int k = 0; k < KS; ++k) v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) sm.xs[k][threadIdx.x] = v[k];
  }
}

// The scores arg - base of the lane's row r (of kPairRows) against its
// columns cb0 .. cb0 + kStepCols - 1 of the staged pass: the rebase's
// recomputation, against the new max.
template <int P, int KV>
__device__ __forceinline__ void lse_row_scores(LseSmem<KV == 0 ? 1 : KV, KV == 0>& sm, float (&t)[kStepCols],
                                               float base, int r, int cb0, const float* __restrict__ x,
                                               const float* __restrict__ y, int64_t i0, int rows, int kv, float c2) {
  constexpr int C = kStepCols;
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;
  constexpr bool FOLDED = P == 2 && !WIDE;
  const int il = (threadIdx.x & 31) + 32 * r;
#pragma unroll
  for (int c = 0; c < C; ++c) t[c] = P == 2 ? sm.u.st.ycb[cb0 + c] : 0.f;
  if constexpr (!WIDE) {
    float4 xq[KS];
#pragma unroll
    for (int q = 0; q < KS; ++q) xq[q] = lds4(&sm.xs[q][il]);
    if constexpr (FOLDED) xq[KS - 1].w = -base;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int q = 0; q < KS; ++q) t[c] = packed_acc<P>(xq[q], lds4(&sm.u.st.ys[q][cb0 + c]), t[c]);
    }
  } else {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    for (int q = 0; q < kv; ++q) {
      const float4 xk = il < rows ? scale4(x4[(i0 + il) * kv + q], P == 2 ? c2 : 1.f) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < C; ++c) t[c] = packed_acc<P>(xk, y4[(int64_t)sm.u.st.yj[cb0 + c] * kv + q], t[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if constexpr (P == 1) t[c] = fmaf(-sqrtf(fmaxf(t[c], kSqdistFloor)), c2, sm.u.st.ycb[cb0 + c]);
    if constexpr (!FOLDED) t[c] -= base;
  }
}

// One stage: the columns cols(k), k < n (1 <= n <= kTile; the stage is
// padded to whole passes with bias -inf), against the lane's rows (staged
// in sm.xs; WIDE: x's `rows` rows from i0, kv packed float4s each), folded into the
// running (m, s). Every thread of the block calls it: it synchronises.
template <int P, int KV, class Cols>
__device__ __forceinline__ void lse_stage(LseSmem<KV == 0 ? 1 : KV, KV == 0>& sm, float (&m)[kPairRows],
                                          float (&s)[kPairRows], const float* __restrict__ x, int64_t i0, int rows,
                                          const float* __restrict__ y, const float* __restrict__ h, int ld, int D,
                                          int kv, Cols cols, int n, float c2) {
  constexpr int H = kLseHalf, C = kStepCols;
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  constexpr bool FOLDED = P == 2 && !WIDE;  // the score carries -m (the rows' last slot)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_pad = (n + kStepPass - 1) / kStepPass * kStepPass;
  __syncthreads();  // the last stage's reads are done
  for (int k = threadIdx.x; k < n_pad; k += kThreads) {
    const bool ok = k < n;
    const int64_t j = ok ? cols(k) : 0;
    float sq = 0.f;
    if constexpr (!WIDE) {
      float4 v[KS];
      load_point<KS>(v, y, j, ld, D, 1.f);
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        if constexpr (P == 2) sq = dot4(v[q], v[q], sq);
        if (FOLDED && q == KS - 1) v[q].w = 1.f;  // the factor of the rows' -m slot
        sm.u.st.ys[q][k] = v[q];
      }
    } else {
      sm.u.st.yj[k] = (int)j;
      if constexpr (P == 2) {
        for (int d = 0; d < D; ++d) sq = fmaf(y[j * ld + d], y[j * ld + d], sq);
      }
    }
    const float b = P == 2 ? fmaf(-0.5f * c2, sq, kLog2e * h[j]) : kLog2e * h[j];
    sm.u.st.ycb[k] = ok ? b : -INFINITY;
  }
  __syncthreads();
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  for (int b0 = 0; b0 < n_pad; b0 += kStepPass) {
    const int cb0 = b0 + warp * C;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float bc[C], sc[H][C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        bc[c] = sm.u.st.ycb[cb0 + c];
#pragma unroll
        for (int r = 0; r < H; ++r) sc[r][c] = P == 2 ? bc[c] : 0.f;
      }
      if constexpr (!WIDE) {
        float4 xh[H][KS];
#pragma unroll
        for (int r = 0; r < H; ++r) {
#pragma unroll
          for (int q = 0; q < KS; ++q) xh[r][q] = lds4(&sm.xs[q][lane + 32 * (hf * H + r)]);
          // The warp's own base of the row (its warps keep their own maxima).
          if constexpr (FOLDED) xh[r][KS - 1].w = m[hf * H + r] == -INFINITY ? 0.f : -m[hf * H + r];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int q = 0; q < KS; ++q) {
            const float4 yy = lds4(&sm.u.st.ys[q][cb0 + c]);
#pragma unroll
            for (int r = 0; r < H; ++r) sc[r][c] = packed_acc<P>(xh[r][q], yy, sc[r][c]);
          }
        }
      } else {
        for (int q = 0; q < kv; ++q) {
          float4 xk[H];
#pragma unroll
          for (int r = 0; r < H; ++r) {
            const int il = lane + 32 * (hf * H + r);
            xk[r] = il < rows ? scale4(x4[(i0 + il) * kv + q], P == 2 ? c2 : 1.f) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float4 yy = y4[(int64_t)sm.u.st.yj[cb0 + c] * kv + q];
#pragma unroll
            for (int r = 0; r < H; ++r) sc[r][c] = packed_acc<P>(xk[r], yy, sc[r][c]);
          }
        }
      }
      // Each row's exponentials against its base, and their sum and max
      // (two trees, side by side: the max does not hold up the exp2s). A
      // row is rebased where the max is above 0, or finite while m = -inf.
      float pm[H], sum[H];
      bool up = false;
#pragma unroll
      for (int r = 0; r < H; ++r) {
        const float mr = m[hf * H + r];
        float e[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (P == 1) sc[r][c] = fmaf(-sqrtf(fmaxf(sc[r][c], kSqdistFloor)), c2, bc[c]);
          if constexpr (!FOLDED) sc[r][c] -= mr == -INFINITY ? 0.f : mr;
          e[c] = fast_exp2(sc[r][c]);
        }
        sum[r] = ((e[0] + e[1]) + (e[2] + e[3])) + ((e[4] + e[5]) + (e[6] + e[7]));
        pm[r] = fmaxf(fmaxf(fmaxf(sc[r][0], sc[r][1]), fmaxf(sc[r][2], sc[r][3])),
                      fmaxf(fmaxf(sc[r][4], sc[r][5]), fmaxf(sc[r][6], sc[r][7])));
        up |= pm[r] > (mr == -INFINITY ? -INFINITY : 0.f);
      }
      if (__any_sync(kFullMask, up)) {  // rare after a row's first passes: one vote a half-pass
#pragma unroll
        for (int r = 0; r < H; ++r) {
          float& mr = m[hf * H + r];
          float& sr = s[hf * H + r];
          if (!(pm[r] > (mr == -INFINITY ? -INFINITY : 0.f))) {
            sr += sum[r];
            continue;
          }
          // The new max as stored, and its rise over the base as the sum
          // sees it: rescaling by the stored difference, not by pm, keeps
          // the sum relative to the stored max (a max of a few hundred
          // rounds by ~1e-5 at each rebase, which would add up).
          const float base = mr == -INFINITY ? 0.f : mr;
          const float m_new = base + pm[r];
          const float rise = m_new - base;
          if (mr != -INFINITY && rise <= kLseLazy) {
            sr = (sr + sum[r]) * fast_exp2(-rise);  // the pass's terms were at most 2^kLseLazy
          } else {
            // The first finite scores, or a jump of the max: the row's
            // scores again, against the new max (scores taken against a
            // base far below it, such as that of a zero-weight column of
            // log weight -1e5, keep none of their digits near it).
            float t[C];
            lse_row_scores<P, KV>(sm, t, m_new, hf * H + r, cb0, x, y, i0, rows, kv, c2);
#pragma unroll
            for (int c = 0; c < C; ++c) t[c] = fast_exp2(t[c]);
            sr = (mr == -INFINITY ? 0.f : sr * fast_exp2(-rise)) +
                 (((t[0] + t[1]) + (t[2] + t[3])) + ((t[4] + t[5]) + (t[6] + t[7])));
          }
          mr = m_new;
        }
      } else {
#pragma unroll
        for (int r = 0; r < H; ++r) s[hf * H + r] += sum[r];
      }
    }
  }
}

// The max and the sum rescaled to it of n partials (m, s) at p[0],
// p[stride], ..., added in that order; (-inf, 0) where every m is -inf.
__device__ __forceinline__ float2 merge_lse(const float2* p, int64_t stride, int n) {
  float mm = -INFINITY;
  for (int k = 0; k < n; ++k) mm = fmaxf(mm, p[k * stride].x);
  float ss = 0.f;
  if (mm != -INFINITY) {
    for (int k = 0; k < n; ++k) {
      const float2 q = p[k * stride];
      ss += q.y * exp2f(q.x - mm);
    }
  }
  return make_float2(mm, ss);
}

// (m, s) of the block's rows: the 8 warps' partials of each row merged in
// warp order; thread t returns row t's. Every thread calls it.
template <int KS, bool WIDE>
__device__ __forceinline__ float2 block_lse_merge(LseSmem<KS, WIDE>& sm, const float (&m)[kPairRows],
                                                  const float (&s)[kPairRows]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the last stage's reads of st are done
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) sm.u.red[warp * kThreads + lane + 32 * r] = make_float2(m[r], s[r]);
  __syncthreads();
  return merge_lse(sm.u.red + threadIdx.x, kThreads, kWarps);
}

// Row i's LSE in nats from its (m, s): ln 2 (m + log2 s), minus
// |x_i|^2 / (2 eps) = ln 2 c2 |x_i|^2 / 2 for p = 2; -inf where s = 0.
__device__ __forceinline__ float lse_out(float2 ms, const float* __restrict__ x, int64_t i, int ld, int D, int p,
                                         float c2) {
  float v = kLn2 * (ms.x + log2f(ms.y));
  if (p == 2) {
    float sq = 0.f;
    for (int d = 0; d < D; ++d) sq = fmaf(x[i * ld + d], x[i * ld + d], sq);
    v = fmaf(-0.5f * kLn2 * c2, sq, v);
  }
  return v;
}

// Second pass of kernels 1 and 7 when their columns are split: out[i] =
// lse_out of the S partials part[s, i] (s < S), merged in slice order. One
// thread per row. Bound: reading the partials once.
__global__ void __launch_bounds__(kThreads)
lse_merge_kernel(const float2* __restrict__ part, const float* __restrict__ x, float* __restrict__ out, int N,
                 int S, int ld, int D, int p, float c2) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < N) out[i] = lse_out(merge_lse(part + i, N, S), x, i, ld, D, p, c2);
}

// Launches lse_merge_kernel where `S` > 1.
inline void launch_lse_merge(const float2* part, const float* x, float* out, int N, int S, int ld, int D, int p,
                             float c2, cudaStream_t st) {
  if (S > 1) lse_merge_kernel<<<cdiv(N, kThreads), kThreads, 0, st>>>(part, x, out, N, S, ld, D, p, c2);
}

}  // namespace

// Streaming pair-interaction kernels of the online Sinkhorn path, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// geomloss_tpu_torch/ops/cuda_kernels.py, which also holds each kernel's
// plain PyTorch twin and folds the biases (base-2 units) before launch
// (kernel 1 reads the raw points and folds its biases itself). The shared
// device code is in pair_common.cuh.
//
// What bounds these kernels on an H100: the exponential. At N = M = 1e5 a
// sweep is 1e10 pairs and reads a few bytes per point, so memory traffic
// is negligible; an SM issues 16 MUFU (ex2) results per clock against 128
// FP32 lanes, so the few FFMAs of a pair fit under the one exp2 it needs
// (p = 1 adds a sqrt, a second MUFU operation). The designs therefore
// spend FFMAs to save exponentials: the LSE keeps a pass's scores in
// registers for its max instead of rescaling per pair, the fused step
// reads both softmin directions off one exponential, and the symmetric
// step visits each off-diagonal pair once. All four run the register-tiled
// pair blocks of pair_common.cuh: kernel 1 its online log-sum-exp
// (lse_stage, shared with kernel 7), kernels 2 and 3 its absorbed-sum
// stage (step_stage, shared with kernel 5), kernel 4 its row contraction
// (apply_stage, shared with kernel 8; its fused energy form,
// energy_grad_kernel, too).
//
// Each entry point returns cudaGetLastError() after its launches.

#include "pair_common.cuh"

namespace {

// -----------------------------------------------------------------------------
// 1. Streaming LSE. Replaces geomloss_tpu/ops/pallas_kernels.py::lse_pallas
//    (_lse_kernel). out_i = log sum_j exp(h_j - C_p(x_i, y_j) / eps), in
//    base 2 inside (pair_common.cuh's lse_stage for the scores).
//    Bound: one exp2 per pair (MUFU: 16 per clock per SM); at p = 2, D = 3
//    a pair also takes 4 FFMAs, its share of the row's max, the subtraction
//    of the running max and the add, about 8 issue slots, which the MUFU
//    rate just balances.
//    Design: block (b, s) takes the 256 rows of row block b (raw points,
//    loaded and scaled into registers, 8 rows a lane) against column slice
//    s ([s width, min(M, (s + 1) width)), width a multiple of a 64-column
//    pass) in stages of 256 columns through lse_stage: one ex2.approx per
//    pair against a running max per row, rescaled only where a pass raises
//    it. The slices let a launch of few row blocks (the coarse sweeps of the
//    multiscale path: 4,096 points, 16 row blocks) fill the card. With one
//    slice the block writes out_i itself (lse_out: ln 2 and the p = 2 row
//    term); with more, each slice writes its rows' (m, s) to
//    part[s, i] and lse_merge_kernel merges them in slice order:
//    deterministic, no atomics, every entry written once. Points of up to
//    kStepStaged float4s are staged; wider ones (KV = 0) are read packed
//    from global memory per pass.
// -----------------------------------------------------------------------------
template <int P, int KV>
__global__ void __launch_bounds__(kThreads, KV == 1 ? 2 : 1)
lse_kernel(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ h,
           float* __restrict__ out, float2* __restrict__ part, int N, int M, int width, int ld, int D, int kv,
           float c2) {
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  __shared__ LseSmem<KS, WIDE> sm;
  const int64_t i0 = (int64_t)blockIdx.x * kThreads;
  const int64_t left = (int64_t)N - i0;
  const int rows = left < kThreads ? (int)left : kThreads;
  float m[kPairRows], s[kPairRows];
  load_lse_rows<KS, WIDE>(sm, x, ld, D, i0, rows, P == 2 ? c2 : 1.f);
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
  }
  const int j_end = min(M, (int)(blockIdx.y + 1) * width);
  for (int j0 = blockIdx.y * width; j0 < j_end; j0 += kTile)
    lse_stage<P, KV>(sm, m, s, x, i0, rows, y, h, ld, D, kv, [j0](int k) { return (int64_t)j0 + k; },
                     min(kTile, j_end - j0), c2);
  const float2 ms = block_lse_merge(sm, m, s);
  const int64_t i = i0 + threadIdx.x;
  if (threadIdx.x < rows) {
    if (gridDim.y == 1) out[i] = lse_out(ms, x, i, ld, D, P, c2);
    else part[(int64_t)blockIdx.y * N + i] = ms;
  }
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
//    Bound: exp2, as above, over half the pairs of a full sweep.
//    Design: block (b, s) takes the 256 rows of row tile I = tile0 + b, in
//    registers as packed points (load_pair_rows), against the column tiles
//    J >= I of slice s (wt tiles from tile0 + s * wt), one step_stage per
//    tile: with column sums for J > I, without for the diagonal tile, which
//    gives row sums over all of I x I. Its row sums stay in registers and
//    go to rowpart[s, b] ((gridDim.y, gridDim.x, 256)) through
//    block_row_sum; each tile's column sums go to colpart[b, J - tile0]
//    ((gridDim.x, nb - tile0, 256)), the tiles below the diagonal and the
//    diagonal's column sums as zeros. Every entry is written exactly once,
//    and the wrapper sums both over their short leading axis in a fixed
//    order: deterministic, no atomics, scratch bounded by the row tiles per
//    launch. The wrapper packs the points twice (rows, and columns that
//    carry the bias), the columns padded to whole tiles with bias -inf;
//    rows past N get bias -inf. Points wider than kStepStaged float4s
//    (D > 11 at p = 2) are read from global memory per pass (KV = 0).
// -----------------------------------------------------------------------------
template <int P, int KV>
__global__ void __launch_bounds__(kThreads)
sym_step_kernel(const float4* __restrict__ xv, const float4* __restrict__ yv,
                const float* __restrict__ rb, const float* __restrict__ cb,
                float* __restrict__ rowpart, float* __restrict__ colpart, int N, int tile0,
                int wt, int nb, int kv, float c2) {
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  __shared__ StepSmem<P, KS, WIDE> sm;
  const int lane = threadIdx.x & 31;
  const int I = tile0 + blockIdx.x;
  const int64_t i0 = (int64_t)I * kThreads;
  const int64_t left = (int64_t)N - i0;
  const int rows = left < kThreads ? (int)left : kThreads;
  float* cp = colpart + (int64_t)blockIdx.x * (nb - tile0) * kTile;
  float4 xr[kPairRows][KS];
  float br[kPairRows], racc[kPairRows];
  load_pair_rows<P, KS, WIDE>(xr, br, xv, rb, i0, rows, lane);
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) racc[r] = 0.f;
  const int J_end = min(nb, tile0 + (int)(blockIdx.y + 1) * wt);
  for (int J = tile0 + blockIdx.y * wt; J < J_end; ++J) {
    float* cj = cp + (int64_t)(J - tile0) * kTile;
    if (J < I) {
      cj[threadIdx.x] = 0.f;  // kThreads == kTile
      continue;
    }
    step_stage<P, KV>(sm, xr, br, racc, xv, i0, rows, kv, yv, cb, (int64_t)J * kTile, kTile, kTile, J > I,
                      cj, c2);
  }
  const float sum = block_row_sum(sm, racc);
  rowpart[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + threadIdx.x] = sum;
}

// -----------------------------------------------------------------------------
// 4. Gibbs apply. Replaces pallas_kernels.py::gibbs_apply_pallas
//    (_apply_kernel + _gibbs_weights). O_i = sum_j w_ij V_j with the weight
//    kinds of packed_weight's modes 0-4 (pair_common.cuh), CH = 1 or 4
//    channels a group: the wrapper sends one channel alone and wider V in
//    zero-padded groups of four, the groups being the grid's z axis, so
//    that one call is one launch.
//    Bound: one MUFU operation per pair (an exp2; p = 1 adds an IEEE sqrt
//    and, for gibbs_grad, a division; energy and inv_dist take one
//    rsqrt.approx, no exp2), then CH FFMAs: at p = 2, D = 3, 6 issue slots
//    a pair at CH = 1 (the MUFU rate binds) and 9 at CH = 4.
//    Design: kernel 8's register-tiled pass (apply_stage) over dense column
//    slices, no weight block ever stored. Block (b, s, g) takes the 256
//    rows of row block row_blk0 + b (packed points and CH accumulators in
//    registers, 8 rows a lane) against the columns of slice s ([s width,
//    (s + 1) width), width a multiple of 256) in 256-column stages, for
//    channel group g. A slice's row sums go to out[s, g, row] ((gridDim.y,
//    gridDim.z, out_rows) of CH floats each, rows counted from the launch's
//    first block), each entry written once; with more than one slice the
//    wrapper adds the slices in a fixed order: deterministic, no atomics.
//    The slices let a launch of few row blocks (N = 1e4: 40) still fill the
//    card. Points wider than kStepStaged float4s are read from global
//    memory per pass (KV = 0).
// -----------------------------------------------------------------------------
template <int MODE, int KV, int CH>
__global__ void __launch_bounds__(kThreads, KV == 1 ? 2 : 1)
apply_kernel(const float4* __restrict__ xv, const float4* __restrict__ yv,
             const float* __restrict__ rb, const float* __restrict__ cb,
             const typename Chan<CH>::T* __restrict__ v, typename Chan<CH>::T* __restrict__ out, int N,
             int M, int row_blk0, int width, int out_rows, int kv, float c2) {
  using VT = typename Chan<CH>::T;
  constexpr int P = MODE == 0 ? 2 : 1;
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  __shared__ ApplySmem<KS, CH, WIDE> sm;
  const int lane = threadIdx.x & 31;
  const int64_t i0 = (int64_t)(row_blk0 + blockIdx.x) * kThreads;
  const int64_t left = (int64_t)N - i0;
  const int rows = left < kThreads ? (int)left : kThreads;
  float4 xr[kPairRows][KS];
  float br[kPairRows];
  load_pair_rows<P, KS, WIDE>(xr, br, xv, rb, i0, rows, lane);
  VT acc[kPairRows];
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) chan_zero(acc[r]);
  const VT* vg = v + (int64_t)blockIdx.z * M;
  const int j_end = min(M, (int)(blockIdx.y + 1) * width);
  for (int j0 = blockIdx.y * width; j0 < j_end; j0 += kTile)
    apply_stage<MODE, KV, CH>(sm, xr, br, acc, xv, i0, rows, kv, yv, cb, vg, j0, min(kTile, j_end - j0), c2);
  const VT sum = block_apply_sum(sm, acc);
  if (threadIdx.x < rows)
    out[((int64_t)blockIdx.y * gridDim.z + blockIdx.z) * out_rows + (int64_t)blockIdx.x * kThreads + threadIdx.x] =
        sum;
}

// -----------------------------------------------------------------------------
// 4, fused energy form (apply_stage's MODE 5): the energy MMD matvec's
//    value O_i = -sum_j d_ij v_j and the rows of its x-gradient, R_i =
//    sum_j V_j / d_ij with V_j = v_j [1, y_j] (cut to 0 where d_ij^2 <=
//    1e-6), in one pass over the pairs where modes 3 and 4 take two.
//    Bound: the one rsqrt.approx a pair of modes 3 and 4, and about 16
//    issue slots a pair at D = 3: mode 4's 16 at CH = 4, with one FMUL and
//    one FFMA for the value, less the subtraction and the FFMA of the
//    packed point's zero fourth coordinate, which the D <= 3 instantiation
//    (D3) leaves out (and with it 8 registers: it runs two blocks an SM
//    with no spill, where the four-coordinate form at one float4 runs one).
//    Design: kernel 4's blocks at CH = 4 over the packed points of p = 1,
//    V's group g (the grid's z axis) built from v (M,) and the packed
//    columns as the stage loads them, so that no V is read from global
//    memory. Group 0 also carries the value: a fifth accumulator and stage
//    partial a row (v_j is its channel 0), whose rows go to val (gridDim.y,
//    out_rows) beside out as kernel 4 lays it out, each entry written once.
//    The gradient channels are summed as mode 4 sums them, to the bit.
// -----------------------------------------------------------------------------
template <int KV, bool D3>
__global__ void __launch_bounds__(kThreads, D3 ? 2 : 1)
energy_grad_kernel(const float4* __restrict__ xv, const float4* __restrict__ yv, const float* __restrict__ rb,
                   const float* __restrict__ v, float4* __restrict__ out, float* __restrict__ val, int N, int M,
                   int row_blk0, int width, int out_rows, int kv) {
  constexpr bool WIDE = KV == 0;
  constexpr int KS = WIDE ? 1 : KV;  // staged float4s per point
  __shared__ ApplySmem<KS, 4, WIDE> sm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i0 = (int64_t)(row_blk0 + blockIdx.x) * kThreads;
  const int64_t left = (int64_t)N - i0;
  const int rows = left < kThreads ? (int)left : kThreads;
  const int g = blockIdx.z;
  float4 xr[kPairRows][KS];
  float br[kPairRows];
  load_pair_rows<1, KS, WIDE>(xr, br, xv, rb, i0, rows, lane);
  float4 acc[kPairRows];
  float accv[kPairRows];
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) {
    chan_zero(acc[r]);
    accv[r] = 0.f;
  }
  const int j_end = min(M, (int)(blockIdx.y + 1) * width);
  if (g == 0) {
    for (int j0 = blockIdx.y * width; j0 < j_end; j0 += kTile)
      apply_stage<5, KV, 4, true, D3>(sm, xr, br, acc, xv, i0, rows, kv, yv, nullptr, nullptr, j0,
                                      min(kTile, j_end - j0), 0.f, v, g, accv);
  } else {
    for (int j0 = blockIdx.y * width; j0 < j_end; j0 += kTile)
      apply_stage<5, KV, 4, false, D3>(sm, xr, br, acc, xv, i0, rows, kv, yv, nullptr, nullptr, j0,
                                       min(kTile, j_end - j0), 0.f, v, g);
  }
  const float4 sum = block_apply_sum(sm, acc);
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (threadIdx.x < rows) out[((int64_t)blockIdx.y * gridDim.z + g) * out_rows + row] = sum;
  if (g == 0) {
    // The value's rows: the 8 warps' accumulators added in warp order.
    float* rv = reinterpret_cast<float*>(sm.red);
    __syncthreads();  // block_apply_sum's reads of red are done
#pragma unroll
    for (int r = 0; r < kPairRows; ++r) rv[warp * kThreads + lane + 32 * r] = accv[r];
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += rv[w * kThreads + threadIdx.x];
    if (threadIdx.x < rows) val[(int64_t)blockIdx.y * out_rows + row] = s;
  }
}

}  // namespace

extern "C" {

// x (N, D) and y (M, D) with row stride ld floats (ld = 4 kv for kv above
// kStepStaged: the wide form reads packed float4s), h (M,) in nats; the
// columns in n_slices slices of `width` columns (a multiple of 64); part
// (n_slices, N) (m, s) pairs where n_slices > 1.
int gl_lse(const float* x, const float* y, const float* h, float* out, float* part, int N, int M,
           int width, int n_slices, int ld, int D, int kv, int p, float c2, void* stream) {
  if ((p != 1 && p != 2) || kv < 1 || D < 1 || width % kStepPass || (kv > kStepStaged && ld != 4 * kv))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(N, kThreads), n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part2 = reinterpret_cast<float2*>(part);
#define GL_LSE(P, KV) lse_kernel<P, KV><<<grid, kThreads, 0, s>>>(x, y, h, out, part2, N, M, width, ld, D, kv, c2)
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
  launch_lse_merge(part2, x, out, N, n_slices, ld, D, p, c2, s);
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
// n_slices slices of cdiv(nb - tile0, n_slices) tiles; xv and yv the
// packed points as rows and as columns (kv float4 each, pair_common.cuh),
// yv's columns padded to nb * 256 with bias -inf; rb and cb the row and
// column biases (cb read for p = 1 only).
int gl_sinkhorn_step_sym(const float* xv, const float* yv, const float* rb,
                         const float* cb, float* rowpart, float* colpart, int N, int tile0,
                         int n_rows, int n_slices, int nb, int kv, int p, float c2,
                         void* stream) {
  if ((p != 1 && p != 2) || kv < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_rows, n_slices);
  const int wt = cdiv(nb - tile0, n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  const float4* y4 = reinterpret_cast<const float4*>(yv);
#define GL_SYM(P, KV) \
  sym_step_kernel<P, KV><<<grid, kThreads, 0, s>>>(x4, y4, rb, cb, rowpart, colpart, N, tile0, wt, nb, kv, c2)
#define GL_SYM_KV(P)                                  \
  switch (kv) {                                       \
    case 1: GL_SYM(P, 1); break;                      \
    case 2: GL_SYM(P, 2); break;                      \
    case kStepStaged: GL_SYM(P, kStepStaged); break;  \
    default: GL_SYM(P, 0); break;                     \
  }
  if (p == 2) GL_SYM_KV(2)
  else GL_SYM_KV(1)
#undef GL_SYM_KV
#undef GL_SYM
  return (int)cudaGetLastError();
}

// Row blocks row_blk0 .. row_blk0 + n_blk against all columns, in n_slices
// slices of `width` columns (a multiple of 256), for n_groups channel
// groups of ch (1 or 4) channels; xv and yv the packed points (kv float4
// each), rb and cb their biases (cb read for modes 1 and 2), v (n_groups,
// M, ch) and out (n_slices, n_groups, out_rows, ch), out's row 0 being row
// block row_blk0's first row.
int gl_gibbs_apply(const float* xv, const float* yv, const float* rb, const float* cb,
                   const float* v, float* out, int N, int M, int row_blk0, int n_blk,
                   int n_slices, int width, int n_groups, int out_rows, int kv, int ch,
                   int mode, float c2, void* stream) {
  if (mode < 0 || mode > 4 || kv < 1 || (ch != 1 && ch != 4) || width % kTile || n_blk < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blk, n_slices, n_groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  const float4* y4 = reinterpret_cast<const float4*>(yv);
#define GL_APPLY(MODE, KV, CH)                                                                    \
  apply_kernel<MODE, KV, CH><<<grid, kThreads, 0, s>>>(                                           \
      x4, y4, rb, cb, reinterpret_cast<const Chan<CH>::T*>(v), reinterpret_cast<Chan<CH>::T*>(out), \
      N, M, row_blk0, width, out_rows, kv, c2)
#define GL_APPLY_KV(MODE, CH)                             \
  switch (kv) {                                           \
    case 1: GL_APPLY(MODE, 1, CH); break;                 \
    case 2: GL_APPLY(MODE, 2, CH); break;                 \
    case kStepStaged: GL_APPLY(MODE, kStepStaged, CH); break; \
    default: GL_APPLY(MODE, 0, CH); break;                \
  }
#define GL_APPLY_CH(MODE) \
  if (ch == 1) {          \
    GL_APPLY_KV(MODE, 1)  \
  } else {                \
    GL_APPLY_KV(MODE, 4)  \
  }
  switch (mode) {
    case 0: GL_APPLY_CH(0) break;
    case 1: GL_APPLY_CH(1) break;
    case 2: GL_APPLY_CH(2) break;
    case 3: GL_APPLY_CH(3) break;
    default: GL_APPLY_CH(4) break;
  }
#undef GL_APPLY_CH
#undef GL_APPLY_KV
#undef GL_APPLY
  return (int)cudaGetLastError();
}

// Kernel 4's fused energy form: row blocks row_blk0 .. row_blk0 + n_blk
// against all columns, in n_slices slices of `width` columns (a multiple of
// 256), for the n_groups channel groups of v [1, y] (four channels each);
// xv and yv the packed points of p = 1 (kv float4 each, D coordinates),
// rb the row biases (read only where a row is valid), v (M,), out
// (n_slices, n_groups, out_rows, 4) and val (n_slices, out_rows), row 0
// being row block row_blk0's first row.
int gl_energy_grad_apply(const float* xv, const float* yv, const float* rb, const float* v, float* out,
                         float* val, int N, int M, int row_blk0, int n_blk, int n_slices, int width,
                         int n_groups, int out_rows, int kv, int D, void* stream) {
  if (kv < 1 || D < 1 || D > 4 * kv || width % kTile || n_blk < 1 || n_groups < 1 || n_groups > kv + 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blk, n_slices, n_groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(xv);
  const float4* y4 = reinterpret_cast<const float4*>(yv);
  float4* o4 = reinterpret_cast<float4*>(out);
#define GL_EGRAD(KV, D3) \
  energy_grad_kernel<KV, D3><<<grid, kThreads, 0, s>>>(x4, y4, rb, v, o4, val, N, M, row_blk0, width, out_rows, kv)
  switch (kv) {
    case 1:
      if (D <= 3) GL_EGRAD(1, true);
      else GL_EGRAD(1, false);
      break;
    case 2: GL_EGRAD(2, false); break;
    case kStepStaged: GL_EGRAD(kStepStaged, false); break;
    default: GL_EGRAD(0, false); break;
  }
#undef GL_EGRAD
  return (int)cudaGetLastError();
}

}  // extern "C"

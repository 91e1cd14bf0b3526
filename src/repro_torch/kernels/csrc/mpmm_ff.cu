// W4A16 / W8A16 dequant matmul in the FF order for Hopper: k outermost.
//
// Replaces repro/kernels/mpmm.py::mpmm_pallas in dequant mode with the FF
// order (body _mpmm_ff_kernel, grid (k, m, n)).  The Pallas kernel walks K in
// stages of bk (up to 512) rows as its outermost grid axis and adds each
// stage's f32 product into the f32 output block, which lives in device
// memory between stages: the partial sums spill, as SPEED's FF dataflow
// spills them to the VRF.  The output is the unscaled f32 accumulator; the
// wrapper applies the per-column scale in f32 and casts once.
//
// On Hopper blocks run in no order, so a sequential grid axis cannot carry a
// sum.  The stage axis becomes the grid's z dimension: block (n, m, s)
// computes the product of K rows [s * STAGE_K, (s + 1) * STAGE_K) for one 64 x 64
// output tile and spills it as f32 to its own slice of a [stages, M, N]
// buffer in device memory; a second kernel then adds the slices into out in
// stage order, out = ((p0 + p1) + p2) + ..., the sums the Pallas grid forms
// one stage after the other.  No atomics, so repeated runs give the same
// bits, and the stages of a tile run side by side instead of one launch
// after another (ResNet18's layer4 has 56 output tiles but 9 stages).  A
// single-stage product (K <= STAGE_K) writes out directly.  Within a block the
// tile stages 64 x 32 tiles of x and of the weights (unpacked to exact bf16)
// in shared memory and multiplies them with bf16 WMMA (mma.sync underneath)
// into f32 fragments that start from zero, so a stage's product is summed
// apart from the running total, as in the JAX kernel's
// `o_ref[...] += dot(...)`.
//
// What bounds it on an H100: at conv shapes (M = N*Ho*Wo in the thousands,
// K up to 4608) the tensor-core operations, and the spill costs one f32
// write and read of the output per stage.  Loads are one element per
// thread: K is odd for the first conv of a CNN (147, 27), so vector loads of
// x rows would be misaligned.  Single-buffered; TMA, wgmma and a deeper pipeline are
// later work.  Ragged M, N and K edges are masked here.
//
// The wrapper passes its stage size and stage count (it sizes the scratch
// from them); the entry point refuses a pair that does not split K and a
// size it was not compiled for.  The size is a template parameter: passed
// at run time instead, it made every FF case of chip_smoke.py's phase 2
// 8-20% slower on an H100 (700 W), with the same bits.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int FF_BUILT_STAGE_K = 512;  // the stage size compiled in (JAX: bk)
constexpr int FB_M = 64;
constexpr int FB_N = 64;
constexpr int FB_K = 32;
constexpr int FB_THREADS = 128;
constexpr int FXS_LD = FB_K + 8;  // bf16 row pitches: 16-byte multiples
constexpr int FWS_LD = FB_N + 8;
constexpr int FOS_LD = FB_N + 4;  // f32 row pitch of the epilogue tile

template <int STAGE_K>
__global__ void __launch_bounds__(FB_THREADS)
mpmm_ff_stage_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ w, float* __restrict__ part,
                     int M, int N, int K, int w_bits) {
  using namespace nvcuda;
  static_assert(STAGE_K % 2 == 0, "int4 stages start on a byte row");
  __shared__ __align__(32) __nv_bfloat16 xs[FB_M][FXS_LD];
  __shared__ __align__(32) __nv_bfloat16 ws[FB_K][FWS_LD];
  __shared__ __align__(32) float os[FB_M][FOS_LD];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // warp's 32 x 32 sub-tile
  const int m0 = blockIdx.y * FB_M, n0 = blockIdx.x * FB_N;
  const int k_begin = blockIdx.z * STAGE_K;
  const int k_end = min(K, k_begin + STAGE_K);
  float* out = part + (int64_t)blockIdx.z * M * N;  // this stage's spilled partial
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += FB_K) {
    for (int i = tid; i < FB_M * FB_K; i += FB_THREADS) {
      const int m = i / FB_K, kk = i % FB_K;
      const int gm = m0 + m, gk = k0 + kk;
      xs[m][kk] = (gm < M && gk < k_end) ? x[(int64_t)gm * K + gk] : zero;
    }
    if (w_bits == 8) {
      for (int i = tid; i < FB_K * FB_N; i += FB_THREADS) {
        const int kk = i / FB_N, n = i % FB_N;
        const int gk = k0 + kk, gn = n0 + n;
        ws[kk][n] = __float2bfloat16(
            (gk < k_end && gn < N) ? (float)w[(int64_t)gk * N + gn] : 0.f);
      }
    } else {  // int4: k_begin and FB_K are even, K is even (checked on entry)
      for (int i = tid; i < (FB_K / 2) * FB_N; i += FB_THREADS) {
        const int pp = i / FB_N, n = i % FB_N;
        const int gk = k0 + 2 * pp, gn = n0 + n;
        const int8_t byte =
            (gk < k_end && gn < N) ? w[(int64_t)(gk / 2) * N + gn] : (int8_t)0;
        ws[2 * pp][n] = __float2bfloat16((float)nibble_lo(byte));
        ws[2 * pp + 1][n] = __float2bfloat16((float)nibble_hi(byte));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &xs[wm + 16 * i][kk], FXS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &ws[kk][wn + 16 * j], FWS_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&os[wm + 16 * i][wn + 16 * j], acc[i][j], FOS_LD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < FB_M * FB_N; i += FB_THREADS) {
    const int m = i / FB_N, n = i % FB_N;
    const int gm = m0 + m, gn = n0 + n;
    if (gm < M && gn < N) out[(int64_t)gm * N + gn] = os[m][n];
  }
}

}  // namespace

// x [M, K] bf16, w [K or K/2, N] int8 (int4 packed along K), out [M, N] f32:
// the unscaled sum of the K stages of stage_k rows, in stage order.  part:
// [stages, M, N] f32 scratch for the spilled stage partials when stages > 1
// (else unused); stage_k must be the compiled-in stage size and stages
// ceil(K / stage_k), else cudaErrorInvalidValue and nothing is launched.
// Returns cudaGetLastError() after the launches.
extern "C" int mpmm_ff_dequant_f32(const void* x, const void* w, void* out, void* part,
                                   int M, int N, int K, int w_bits, int stage_k, int stages,
                                   void* stream) {
  if (stage_k != FF_BUILT_STAGE_K || !stages_fit(K, stage_k, stages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<float*>(out);
  float* pp = stages > 1 ? static_cast<float*>(part) : op;
  dim3 grid((N + FB_N - 1) / FB_N, (M + FB_M - 1) / FB_M, stages);
  mpmm_ff_stage_kernel<FF_BUILT_STAGE_K><<<grid, FB_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), pp, M, N, K, w_bits);
  if (stages > 1) launch_sum_stages(pp, op, (int64_t)M * N, stages, s);
  return (int)cudaGetLastError();
}

// W4A16 / W8A16 dequant matmul for Hopper: out[M, N] = x[M, K] @ dequant(w).
//
// Replaces repro/kernels/mpmm.py::mpmm_pallas in dequant mode with the CF
// order (body _mpmm_cf_kernel): k innermost, f32 accumulation, the
// per-column f32 scale applied to the f32 sum in the epilogue, one cast to
// bf16.  Weights are int8 [K, N], or int4 packed along K [K/2, N] (byte row r
// holds K index 2r in the low nibble and 2r + 1 in the high nibble), unpacked
// in registers; int -> float is exact for |w| <= 127, so the numerics are
// those of kernels/ref.py::mpmm_ref up to the order of the f32 sums.
//
// What bounds it on an H100: at decode M (a batch bucket of at most 8 rows)
// the weight bytes.  Each weight byte is read once, by 8-byte loads that a
// warp issues as whole 64-byte row segments; a split along K gives every SM work
// when N is small, and a second pass sums the split partials in a fixed
// order (no atomics, so results are the same run to run).  At prefill M the
// product is compute-bound; the tiled kernel below unpacks the weights to
// bf16 in shared memory and multiplies on the tensor cores with WMMA
// (bf16 in, f32 accumulate), single-buffered: wgmma, TMA and a multi-stage
// pipeline are later work.
//
// Ragged M, N and K edges are masked inside the kernels (the JAX wrapper
// pads to blocks instead).  The wrapper (kernels/mpmm.py) checks shapes,
// types, N % 8 == 0 and 16-byte alignment before it launches.
#include <mma.h>

#include "common.cuh"

namespace {

// ---- small M: weight-streaming kernel -------------------------------------
// 256 threads = 8 column groups x 32 K lanes; a thread owns 8 adjacent
// columns, read as one 8-byte load per weight row (two K rows for int4), so
// a warp's loads cover four whole 64-byte row segments.  MM (1, 2, 4 or 8)
// is the number of x rows handled, so accumulators stay in registers.
constexpr int SM_THREADS = 256;
constexpr int SM_CPT = 8;                       // columns per thread
constexpr int SM_CGROUPS = 8;                   // column groups per block
constexpr int SM_COLS = SM_CPT * SM_CGROUPS;    // 64 columns per block
constexpr int SM_KLANES = SM_THREADS / SM_CGROUPS;  // 32
constexpr int SM_WARPS = SM_THREADS / 32;
constexpr int SM_MMAX = 8;   // rows handled by this kernel
constexpr int SM_KC = 512;   // K rows of x staged in shared memory at once

template <int MM>
__global__ void __launch_bounds__(SM_THREADS)
mpmm_small_m_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ partial, int M, int N, int K,
                    int w_bits, int k_per_split) {
  __shared__ float xs[MM][SM_KC];
  __shared__ float red[SM_WARPS][MM][SM_COLS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid & 7;   // column group
  const int kl = tid >> 3;  // K lane
  const int col0 = blockIdx.x * SM_COLS + cg * SM_CPT;
  const int split = blockIdx.y;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool live = col0 < N;  // N % 8 == 0: a live group has all 8 columns

  float acc[MM][SM_CPT];
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int c = 0; c < SM_CPT; ++c) acc[m][c] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += SM_KC) {
    const int kn = min(SM_KC, k_end - kc);
    for (int i = tid; i < MM * SM_KC; i += SM_THREADS) {
      const int m = i / SM_KC, kk = i % SM_KC;
      xs[m][kk] = (m < M && kk < kn)
                      ? __bfloat162float(x[(int64_t)m * K + kc + kk])
                      : 0.f;
    }
    __syncthreads();
    if (live) {
      if (w_bits == 8) {
#pragma unroll 4
        for (int kk = kl; kk < kn; kk += SM_KLANES) {
          const uint2 word = *reinterpret_cast<const uint2*>(
              w + (int64_t)(kc + kk) * N + col0);
          float wv[SM_CPT];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            wv[c] = (float)(int8_t)(word.x >> (8 * c));
            wv[4 + c] = (float)(int8_t)(word.y >> (8 * c));
          }
#pragma unroll
          for (int m = 0; m < MM; ++m) {
            const float xv = xs[m][kk];
#pragma unroll
            for (int c = 0; c < SM_CPT; ++c) acc[m][c] += xv * wv[c];
          }
        }
      } else {  // w_bits == 4: kc and kn are even, one byte row = 2 K rows
#pragma unroll 4
        for (int pp = kl; pp < kn / 2; pp += SM_KLANES) {
          const uint2 word = *reinterpret_cast<const uint2*>(
              w + (int64_t)(kc / 2 + pp) * N + col0);
          float lo[SM_CPT], hi[SM_CPT];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int8_t b0 = (int8_t)(word.x >> (8 * c)), b1 = (int8_t)(word.y >> (8 * c));
            lo[c] = (float)nibble_lo(b0);
            hi[c] = (float)nibble_hi(b0);
            lo[4 + c] = (float)nibble_lo(b1);
            hi[4 + c] = (float)nibble_hi(b1);
          }
#pragma unroll
          for (int m = 0; m < MM; ++m) {
            const float x0 = xs[m][2 * pp], x1 = xs[m][2 * pp + 1];
#pragma unroll
            for (int c = 0; c < SM_CPT; ++c) acc[m][c] += x0 * lo[c] + x1 * hi[c];
          }
        }
      }
    }
    __syncthreads();
  }

  // reduce the 4 K lanes of a warp (lanes 8 apart) with shuffles, then the
  // 8 warps through shared memory, in a fixed order
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int c = 0; c < SM_CPT; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) red[warp][m][cg * SM_CPT + c] = v;
    }
  __syncthreads();
  for (int i = tid; i < MM * SM_COLS; i += SM_THREADS) {
    const int m = i / SM_COLS, col = i % SM_COLS;
    const int n = blockIdx.x * SM_COLS + col;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < SM_WARPS; ++wi) s += red[wi][m][col];
    if (gridDim.y == 1) {
      out[(int64_t)m * N + n] = __float2bfloat16(s * scale[n]);
    } else {
      partial[((int64_t)split * M + m) * N + n] = s;
    }
  }
}

// Sums the K-split partials in split order, applies the scale, casts.
__global__ void mpmm_splitk_reduce(const float* __restrict__ partial,
                                   const float* __restrict__ scale,
                                   __nv_bfloat16* __restrict__ out, int M,
                                   int N, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * total + i];
  out[i] = __float2bfloat16(s * scale[i % N]);
}

// ---- larger M: tensor-core tiled kernel -----------------------------------
// 64 x 64 output tiles, 4 warps of 32 x 32 each.  Every K step stages a
// 64 x 32 tile of x and a 32 x 64 tile of the weights in shared memory as
// bf16 (int -> bf16 is exact for |w| <= 127), and the warps multiply them
// with bf16 WMMA (mma.sync underneath) into f32 accumulators.  The
// epilogue goes through shared memory to apply the column scale in f32.
constexpr int TB_M = 64;
constexpr int TB_N = 64;
constexpr int TB_K = 32;
constexpr int TB_THREADS = 128;
constexpr int XS_LD = TB_K + 8;  // bf16 row pitches: 16-byte multiples
constexpr int WS_LD = TB_N + 8;
constexpr int OS_LD = TB_N + 4;  // f32 row pitch of the epilogue tile

__global__ void __launch_bounds__(TB_THREADS)
mpmm_tiled_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int M, int N, int K,
                  int w_bits) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 xs[TB_M][XS_LD];
  __shared__ __align__(32) __nv_bfloat16 ws[TB_K][WS_LD];
  __shared__ __align__(32) float os[TB_M][OS_LD];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // warp's 32 x 32 sub-tile
  const int m0 = blockIdx.y * TB_M, n0 = blockIdx.x * TB_N;
  const int k_packed = K / 2;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += TB_K) {
    for (int i = tid; i < TB_M * TB_K; i += TB_THREADS) {
      const int m = i / TB_K, kk = i % TB_K;
      const int gm = m0 + m, gk = k0 + kk;
      xs[m][kk] = (gm < M && gk < K) ? x[(int64_t)gm * K + gk] : zero;
    }
    if (w_bits == 8) {
      for (int i = tid; i < TB_K * TB_N; i += TB_THREADS) {
        const int kk = i / TB_N, n = i % TB_N;
        const int gk = k0 + kk, gn = n0 + n;
        ws[kk][n] = __float2bfloat16(
            (gk < K && gn < N) ? (float)w[(int64_t)gk * N + gn] : 0.f);
      }
    } else {
      for (int i = tid; i < (TB_K / 2) * TB_N; i += TB_THREADS) {
        const int pp = i / TB_N, n = i % TB_N;
        const int pr = k0 / 2 + pp, gn = n0 + n;
        const int8_t byte =
            (pr < k_packed && gn < N) ? w[(int64_t)pr * N + gn] : (int8_t)0;
        ws[2 * pp][n] = __float2bfloat16((float)nibble_lo(byte));
        ws[2 * pp + 1][n] = __float2bfloat16((float)nibble_hi(byte));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &xs[wm + 16 * i][kk], XS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &ws[kk][wn + 16 * j], WS_LD);
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
      wmma::store_matrix_sync(&os[wm + 16 * i][wn + 16 * j], acc[i][j], OS_LD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TB_M * TB_N; i += TB_THREADS) {
    const int m = i / TB_N, n = i % TB_N;
    const int gm = m0 + m, gn = n0 + n;
    if (gm < M && gn < N) out[(int64_t)gm * N + gn] = __float2bfloat16(os[m][n] * scale[gn]);
  }
}

}  // namespace

// x [M, K] bf16, w [K or K/2, N] int8, scale [N] f32, out [M, N] bf16.
// partial: [splits, M, N] f32 scratch when splits > 1 (else unused).
// Returns cudaGetLastError() after the launches.
extern "C" int mpmm_dequant_bf16(const void* x, const void* w, const void* scale,
                                 void* out, void* partial, int M, int N, int K,
                                 int w_bits, int splits, int k_per_split,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M <= SM_MMAX) {
    dim3 grid((N + SM_COLS - 1) / SM_COLS, splits);
    float* pp = static_cast<float*>(partial);
    if (M == 1) {
      mpmm_small_m_kernel<1><<<grid, SM_THREADS, 0, s>>>(xp, wp, sp, op, pp, M, N, K, w_bits,
                                                         k_per_split);
    } else if (M == 2) {
      mpmm_small_m_kernel<2><<<grid, SM_THREADS, 0, s>>>(xp, wp, sp, op, pp, M, N, K, w_bits,
                                                         k_per_split);
    } else if (M <= 4) {
      mpmm_small_m_kernel<4><<<grid, SM_THREADS, 0, s>>>(xp, wp, sp, op, pp, M, N, K, w_bits,
                                                         k_per_split);
    } else {
      mpmm_small_m_kernel<8><<<grid, SM_THREADS, 0, s>>>(xp, wp, sp, op, pp, M, N, K, w_bits,
                                                         k_per_split);
    }
    if (splits > 1) {
      const int64_t total = (int64_t)M * N;
      mpmm_splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
          static_cast<const float*>(partial), sp, op, M, N, splits);
    }
  } else {
    dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
    mpmm_tiled_kernel<<<grid, TB_THREADS, 0, s>>>(xp, wp, sp, op, M, N, K, w_bits);
  }
  return (int)cudaGetLastError();
}

// Exact integer multi-precision matmul for Hopper: out[M, N] = x @ w in int32,
// wrapping mod 2^32, in the CF or the FF order.
//
// Replaces repro/kernels/mpmm.py::mpmm_pallas in int mode (_digit_planes,
// _plane_dot, in _mpmm_cf_kernel and _mpmm_ff_kernel).  Operands: x int8 or
// int16 [M, K]; w int8 or int16 [K, N], or int4 packed along K [K/2, N].  This
// is the paper's multiplier-combining identity one level up: a 16-bit operand
// splits into radix-256 digit planes,
//     v = lo + 256 * hi,   lo = v & 0xFF in [0, 255],   hi = v >> 8 in [-128, 127],
// and x @ w = sum_{d,e} (x_d @ w_e) << 8 (d + e), so an int16 x int16 product
// is four 8-bit tensor-core passes, int16 x int8 two and int8 x int8 one.
// The TPU's MXU multiplies signed int8 only, so the Pallas kernel re-biases
// the low plane into int8 (lo - 128) and adds bias terms from row and column
// sums.  Hopper's integer MMA (mma.sync.m16n8k32) takes each operand as s8
// or u8, so here the low plane enters as an unsigned byte and the bias terms
// are not needed: the identity is the same, the correction vanishes.
//
// Exactness: each tensor-core pass of one 64-deep K tile sums at most 64
// products of |value| <= 255 * 255 into a fresh s32 accumulator (< 2^22, no
// overflow, so .satfinite does not matter and is not used); the shift and
// every add that may wrap happen in uint32_t, where C++ defines wraparound
// (signed overflow and left shifts of negative values are undefined).
//
// Orders: CF (k innermost): one stage of all K rows, so each block walks all
// of K for its output tile.  FF (k outermost): the grid's z dimension is the
// K stage of stage_k rows (512, passed in by the wrapper); each
// block spills its stage's partial to a [stages, M, N] int32 buffer in
// device memory and a second kernel adds them in stage order (in uint32_t),
// the partial sums of the Pallas FF grid (the FF dequant order in mpmm.cu has the same shape).
// Mod 2^32 both orders give the same bits.
//
// What bounds it on an H100: the 8-bit tensor-core operations (P plane pairs
// x 2MNK) at conv shapes; the staging, one element per thread (K may be odd),
// is single-buffered and is the first thing a faster version would change.
#include "common.cuh"

namespace {

constexpr int IB_M = 64;
constexpr int IB_N = 64;
constexpr int IB_K = 64;
constexpr int IB_THREADS = 128;
constexpr int IB_LD = IB_K + 16;  // bytes per shared row: 80 = 20 words, no bank conflicts

// D += A (16 x 32, row) * B (32 x 8, col) in s32; AU / BU pick u8 over s8.
template <bool AU, bool BU>
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
#define MMA_K32(AT, BT)                                                              \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT ".s32 "            \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"             \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
  if constexpr (AU && BU) {
    MMA_K32("u8", "u8");
  } else if constexpr (AU) {
    MMA_K32("u8", "s8");
  } else if constexpr (BU) {
    MMA_K32("s8", "u8");
  } else {
    MMA_K32("s8", "s8");
  }
#undef MMA_K32
}

// One plane pair over one staged K tile for a warp's 32 x 32 sub-tile:
// acc += (xs_plane @ ws_plane) << shift, the product exact in s32, the
// shift-add in uint32_t.  xs is [IB_M][IB_LD] (row = m, bytes along k), ws is
// [IB_N][IB_LD] (row = n, bytes along k): the m16n8k32 fragment layouts.
template <bool AU, bool BU>
__device__ __forceinline__ void plane_pass(uint8_t (*xs)[IB_LD], uint8_t (*ws)[IB_LD],
                                           int wm, int wn,
                                           int g, int t, uint32_t (&acc)[2][4][4],
                                           int shift) {
  int part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[i][j][r] = 0;
#pragma unroll
  for (int ks = 0; ks < IB_K; ks += 32) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wm + 16 * i + g;
      a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[row][ks + 4 * t]);
      a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[row + 8][ks + 4 * t]);
      a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[row][ks + 16 + 4 * t]);
      a[i][3] = *reinterpret_cast<const uint32_t*>(&xs[row + 8][ks + 16 + 4 * t]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn + 8 * j + g;
      b[j][0] = *reinterpret_cast<const uint32_t*>(&ws[col][ks + 4 * t]);
      b[j][1] = *reinterpret_cast<const uint32_t*>(&ws[col][ks + 16 + 4 * t]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_k32<AU, BU>(part[i][j], a[i], b[j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += (uint32_t)part[i][j][r] << shift;
}

// PX / PW: digit planes of x / w (1 for 8-bit storage, 2 for int16).  With
// two planes, plane 0 is the unsigned low byte and plane 1 the signed high
// byte; with one, plane 0 is the signed byte.  w_bits 4 reads packed nibbles.
template <int PX, int PW>
__global__ void __launch_bounds__(IB_THREADS)
mpmm_int_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                uint32_t* __restrict__ part, int M, int N, int K, int w_bits,
                int stage_k) {
  __shared__ __align__(16) uint8_t xs[PX][IB_M][IB_LD];
  __shared__ __align__(16) uint8_t ws[PW][IB_N][IB_LD];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * IB_M, n0 = blockIdx.x * IB_N;
  const int k_begin = blockIdx.z * stage_k;
  const int k_end = min(K, k_begin + stage_k);
  uint32_t* out = part + (int64_t)blockIdx.z * M * N;  // this stage's partial

  uint32_t acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0u;

  for (int k0 = k_begin; k0 < k_end; k0 += IB_K) {
    for (int i = tid; i < IB_M * IB_K; i += IB_THREADS) {
      const int m = i / IB_K, kk = i % IB_K;
      const int gm = m0 + m, gk = k0 + kk;
      const bool in = gm < M && gk < k_end;
      if constexpr (PX == 1) {
        xs[0][m][kk] = in ? (uint8_t)static_cast<const int8_t*>(xv)[(int64_t)gm * K + gk] : 0;
      } else {
        const uint16_t v =
            in ? (uint16_t)static_cast<const int16_t*>(xv)[(int64_t)gm * K + gk] : 0;
        xs[0][m][kk] = (uint8_t)(v & 0xFFu);
        xs[1][m][kk] = (uint8_t)(v >> 8);
      }
    }
    for (int i = tid; i < IB_K * IB_N; i += IB_THREADS) {
      const int kk = i / IB_N, n = i % IB_N;
      const int gk = k0 + kk, gn = n0 + n;
      const bool in = gk < k_end && gn < N;
      if constexpr (PW == 1) {
        int v = 0;
        if (in) {
          const int8_t* w = static_cast<const int8_t*>(wv);
          if (w_bits == 4) {
            const int8_t byte = w[(int64_t)(gk >> 1) * N + gn];
            v = (gk & 1) ? nibble_hi(byte) : nibble_lo(byte);
          } else {
            v = w[(int64_t)gk * N + gn];
          }
        }
        ws[0][n][kk] = (uint8_t)(int8_t)v;
      } else {
        const uint16_t v =
            in ? (uint16_t)static_cast<const int16_t*>(wv)[(int64_t)gk * N + gn] : 0;
        ws[0][n][kk] = (uint8_t)(v & 0xFFu);
        ws[1][n][kk] = (uint8_t)(v >> 8);
      }
    }
    __syncthreads();
    plane_pass<PX == 2, PW == 2>(xs[0], ws[0], wm, wn, g, t, acc, 0);
    if constexpr (PW == 2) plane_pass<PX == 2, false>(xs[0], ws[1], wm, wn, g, t, acc, 8);
    if constexpr (PX == 2) plane_pass<false, PW == 2>(xs[1], ws[0], wm, wn, g, t, acc, 8);
    if constexpr (PX == 2 && PW == 2) plane_pass<false, false>(xs[1], ws[1], wm, wn, g, t, acc, 16);
    __syncthreads();
  }

  // accumulator fragment: regs 0, 1 at row g, cols 2t, 2t + 1; regs 2, 3 at row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + wm + 16 * i + g + (r >= 2 ? 8 : 0);
        const int gn = n0 + wn + 8 * j + 2 * t + (r & 1);
        if (gm < M && gn < N) out[(int64_t)gm * N + gn] = acc[i][j][r];
      }
}

template <int PX, int PW>
int launch_int(const void* x, const void* w, uint32_t* out, uint32_t* part, int M, int N,
               int K, int w_bits, int stage_k, int stages, cudaStream_t s) {
  uint32_t* pp = stages > 1 ? part : out;
  dim3 grid((N + IB_N - 1) / IB_N, (M + IB_M - 1) / IB_M, stages);
  mpmm_int_kernel<PX, PW><<<grid, IB_THREADS, 0, s>>>(x, w, pp, M, N, K, w_bits, stage_k);
  if (stages > 1) launch_sum_stages(pp, out, (int64_t)M * N, stages, s);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] int8 (x_bits 8) or int16 (x_bits 16); w [K, N] int8 (w_bits 8),
// int16 (16) or [K/2, N] int8 with packed nibbles (4); out [M, N] int32, the
// exact product mod 2^32.  K runs in stages of stage_k rows, stages =
// ceil(K / stage_k): one stage of K rows is the CF order; the FF order
// spills the stage partials to part ([stages, M, N] int32 scratch, unused
// when stages == 1) and sums them in stage order.  Returns
// cudaGetLastError().
extern "C" int mpmm_int_i32(const void* x, const void* w, void* out, void* part, int M,
                            int N, int K, int x_bits, int w_bits, int stage_k, int stages,
                            void* stream) {
  if (!stages_fit(K, stage_k, stages)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<uint32_t*>(out);
  auto* pp = static_cast<uint32_t*>(part);
  const bool x16 = x_bits == 16, w16 = w_bits == 16;
  if (x16 && w16) return launch_int<2, 2>(x, w, op, pp, M, N, K, w_bits, stage_k, stages, s);
  if (x16) return launch_int<2, 1>(x, w, op, pp, M, N, K, w_bits, stage_k, stages, s);
  if (w16) return launch_int<1, 2>(x, w, op, pp, M, N, K, w_bits, stage_k, stages, s);
  return launch_int<1, 1>(x, w, op, pp, M, N, K, w_bits, stage_k, stages, s);
}

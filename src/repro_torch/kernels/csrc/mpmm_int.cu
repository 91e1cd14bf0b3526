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
// (signed overflow and left shifts of negative values are undefined).  An
// int4 weight enters the MMA as 16 v (its nibble in a byte's high half,
// exact in s8), and the tile's sum, a multiple of 16, is shifted back.
//
// Orders and splits: the grid's z dimension is a K range of stage_k rows;
// each block writes its range's partial to a [stages, M, N] int32 buffer and
// a second kernel adds them in stage order (in uint32_t), the partial sums
// of the Pallas FF grid.  FF: stage_k = 512.  CF: one range of all K where
// the output tiles alone fill the card, else a split into whole 64-row K
// tiles chosen on the host (kernels/mpmm.py::int_launch_plan) so that the
// grid does.  A sum mod 2^32 is associative and commutative, so every split
// gives the same bits as the CF order and the reference.
//
// What bounds it on an H100: at ResNet18's int shapes (M 392-12544, N 64-512)
// neither the bytes nor the 8-bit tensor-core operations but the latency of
// the staging and how many SMs the tiles keep busy.  So x and w stream as
// they are stored through a 4-stage cp.async ring (16-byte copies where rows
// start on 16 bytes; plain masked loads for odd K, as conv1's K = 147, or N
// off 16 bytes), each MMA operand fragment is built in registers from the
// staged bytes (the k-contiguous B fragment by a 4 x 4 byte transpose of
// w's [k][n] words; 16-bit planes split by byte permutes), and 64 x 64
// tiles of 4 warps, light enough for several blocks per SM, with the K
// split fill the card (128-row tiles were slower at every ResNet18 shape
// swept, tools/sweep_mpmm_plans.py).
#include "common.cuh"

namespace {

constexpr int IB_M = 64;  // block rows
constexpr int IB_N = 64;  // block columns
constexpr int IB_K = 64;  // K rows per tile (one ring stage)
constexpr int IB_STAGES = 4;

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

// Four 32-bit words r0..r3 (row i holds bytes [c0 c1 c2 c3]) -> out[j] =
// [r0.cj r1.cj r2.cj r3.cj]: a 4 x 4 byte transpose in 8 permutes.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// Digit plane P (0: low bytes, 1: high bytes) of four int16 values held in
// two words, as one word of four bytes.
template <int P>
__device__ __forceinline__ uint32_t plane_of(uint2 v) {
  return __byte_perm(v.x, v.y, P == 0 ? 0x6420 : 0x7531);
}

constexpr int IB_THREADS = 128;  // 4 warps of 32 x 32

template <int PX, int WB>
struct IntTile {
  static constexpr int PW = WB == 16 ? 2 : 1;             // weight digit planes
  static constexpr int XP = IB_K * PX + 16;               // x row pitch, bytes
  static constexpr int WROWS = WB == 4 ? IB_K / 2 : IB_K;  // w byte rows per tile
  static constexpr int WP = IB_N * PW + 16;               // w row pitch, bytes
  static constexpr int STAGE = IB_M * XP + WROWS * WP;
  static constexpr int SMEM = IB_STAGES * STAGE;
  // blocks an SM's 228 KB of shared memory holds (1 KB each reserved), at most 4
  static constexpr int PER_SM = 228 * 1024 / (SMEM + 1024) < 4 ? 228 * 1024 / (SMEM + 1024) : 4;
};

// One plane pair over one staged K tile for a warp's 32 x 32 sub-tile:
// acc += (x plane D @ w plane E) << 8 (D + E), the tile's product exact in
// s32, the shift-add in uint32_t.  xs: [IB_M][XP] bytes (row = m, k along the
// row, PX bytes a value); ws: [WROWS][WP] (row = k, or a k pair for int4; n
// along the row).  MMA tile j's column g is output column wn + 4 g + j, so a
// lane's B fragment is one 4-byte word per k row, transposed in registers.
template <int PX, int WB, int D, int E>
__device__ __forceinline__ void plane_pass(const uint8_t* xs, const uint8_t* ws, int wm,
                                           int wn, int g, int t, uint32_t (&acc)[2][4][4]) {
  using T = IntTile<PX, WB>;
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
#pragma unroll
      for (int h = 0; h < 4; ++h) {  // rows +0 / +8, k +0 / +16
        const int row = wm + 16 * i + g + (h & 1) * 8;
        const int k = ks + (h >> 1) * 16 + 4 * t;
        const uint8_t* p = xs + row * T::XP + k * PX;
        if constexpr (PX == 1) {
          a[i][h] = *reinterpret_cast<const uint32_t*>(p);
        } else {
          a[i][h] = plane_of<D>(*reinterpret_cast<const uint2*>(p));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = ks + 16 * h + 4 * t;  // this register's 4 k rows
      uint32_t r[4], col[4];
      if constexpr (WB == 4) {  // byte rows k / 2, k / 2 + 1: nibbles of k .. k + 3
        const uint8_t* p = ws + (k / 2) * T::WP + wn + 4 * g;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + T::WP);
        r[0] = (w0 << 4) & 0xF0F0F0F0u;  // 16 * low nibble (k), exact in s8
        r[1] = w0 & 0xF0F0F0F0u;         // 16 * high nibble (k + 1)
        r[2] = (w1 << 4) & 0xF0F0F0F0u;
        r[3] = w1 & 0xF0F0F0F0u;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint8_t* p = ws + (k + q) * T::WP + (wn + 4 * g) * T::PW;
          if constexpr (WB == 8) {
            r[q] = *reinterpret_cast<const uint32_t*>(p);
          } else {
            r[q] = plane_of<E>(*reinterpret_cast<const uint2*>(p));
          }
        }
      }
      transpose4(r[0], r[1], r[2], r[3], col);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j][h] = col[j];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_k32<PX == 2 && D == 0, T::PW == 2 && E == 0>(part[i][j], a[i], b[j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int v = WB == 4 ? part[i][j][r] >> 4 : part[i][j][r];  // exact: a multiple of 16
        acc[i][j][r] += (uint32_t)v << (8 * (D + E));
      }
}

// PX: digit planes of x (1: int8, 2: int16).  WB: w's storage (4: packed
// nibbles, 8: int8, 16: int16).  With two planes, plane 0 is the unsigned
// low byte and plane 1 the signed high byte; with one, the signed byte.
// x_vec: x rows start on 16 bytes (K * PX % 16 == 0 and an aligned base),
// so they are whole 16-byte copies; w_vec likewise for w rows (N * PW);
// otherwise plain masked loads.
template <int PX, int WB>
__global__ void __launch_bounds__(IB_THREADS, IntTile<PX, WB>::PER_SM)
mpmm_int_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                uint32_t* __restrict__ part, int M, int N, int K, int stage_k, bool x_vec,
                bool w_vec) {
  using T = IntTile<PX, WB>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * IB_M, n0 = blockIdx.x * IB_N;
  const int k_begin = blockIdx.z * stage_k;
  const int k_end = min(K, k_begin + stage_k);
  const int n_kt = (k_end - k_begin + IB_K - 1) / IB_K;
  const int w_row_end = WB == 4 ? k_end / 2 : k_end;  // k_end is even for int4
  uint32_t* out = part + (int64_t)blockIdx.z * M * N;  // this range's partial

  auto load_stage = [&](int kt) {
    uint8_t* xs = smem + (kt % IB_STAGES) * T::STAGE;
    uint8_t* ws = xs + IB_M * T::XP;
    const int k0 = k_begin + kt * IB_K;
    if (x_vec) {  // k_end is a multiple of 16 / PX: a chunk is all in or all out
      constexpr int CPR = IB_K * PX / 16;  // chunks per row
#pragma unroll
      for (int i = 0; i < IB_M * CPR / IB_THREADS; ++i) {
        const int c = tid + i * IB_THREADS;
        const int r = c / CPR, ch = c % CPR;
        const int gm = m0 + r, gk = k0 + ch * (16 / PX);
        const bool ok = gm < M && gk < k_end;
        cp_async<16>(xs + r * T::XP + ch * 16, ok ? x + ((int64_t)gm * K + gk) * PX : x, ok);
      }
    } else {
      for (int i = tid; i < IB_M * IB_K; i += IB_THREADS) {
        const int r = i / IB_K, kk = i % IB_K;
        const int gm = m0 + r, gk = k0 + kk;
        const bool ok = gm < M && gk < k_end;
        if constexpr (PX == 1) {
          xs[r * T::XP + kk] = ok ? x[(int64_t)gm * K + gk] : 0;
        } else {
          *reinterpret_cast<uint16_t*>(xs + r * T::XP + 2 * kk) =
              ok ? reinterpret_cast<const uint16_t*>(x)[(int64_t)gm * K + gk] : 0;
        }
      }
    }
    const int wr0 = WB == 4 ? k0 / 2 : k0;
    if (w_vec) {
      constexpr int CPR = IB_N * T::PW / 16;
#pragma unroll
      for (int i = 0; i < T::WROWS * CPR / IB_THREADS; ++i) {
        const int c = tid + i * IB_THREADS;
        const int r = c / CPR, ch = c % CPR;
        const int gr = wr0 + r, gn = n0 + ch * (16 / T::PW);
        const bool ok = gr < w_row_end && gn < N;  // N * PW % 16 == 0: whole or nothing
        cp_async<16>(ws + r * T::WP + ch * 16, ok ? w + ((int64_t)gr * N + gn) * T::PW : w,
                     ok);
      }
    } else {
      for (int i = tid; i < T::WROWS * IB_N; i += IB_THREADS) {
        const int r = i / IB_N, nn = i % IB_N;
        const int gr = wr0 + r, gn = n0 + nn;
        const bool ok = gr < w_row_end && gn < N;
        if constexpr (T::PW == 1) {
          ws[r * T::WP + nn] = ok ? w[(int64_t)gr * N + gn] : 0;
        } else {
          *reinterpret_cast<uint16_t*>(ws + r * T::WP + 2 * nn) =
              ok ? reinterpret_cast<const uint16_t*>(w)[(int64_t)gr * N + gn] : 0;
        }
      }
    }
  };

  uint32_t acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0u;

#pragma unroll
  for (int s = 0; s < IB_STAGES - 1; ++s) {
    if (s < n_kt) load_stage(s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<IB_STAGES - 2>();  // tile kt has landed
    __syncthreads();                 // ... for every thread; stage kt - 1 is free
    if (kt + IB_STAGES - 1 < n_kt) load_stage(kt + IB_STAGES - 1);
    cp_async_commit();
    const uint8_t* xs = smem + (kt % IB_STAGES) * T::STAGE;
    const uint8_t* ws = xs + IB_M * T::XP;
    plane_pass<PX, WB, 0, 0>(xs, ws, wm, wn, g, t, acc);
    if constexpr (T::PW == 2) plane_pass<PX, WB, 0, 1>(xs, ws, wm, wn, g, t, acc);
    if constexpr (PX == 2) plane_pass<PX, WB, 1, 0>(xs, ws, wm, wn, g, t, acc);
    if constexpr (PX == 2 && T::PW == 2) plane_pass<PX, WB, 1, 1>(xs, ws, wm, wn, g, t, acc);
  }
  cp_async_wait<0>();

  // acc[i][j][0 / 1]: row wm + 16 i + g, columns wn + 8 t + j / + 4 + j;
  // [2 / 3]: the same at row + 8.  So a lane holds 8 adjacent columns a row.
  const int gn = n0 + wn + 8 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + 16 * i + g + 8 * h;
      if (gm >= M || gn >= N) continue;
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][j][2 * h];
        v[4 + j] = acc[i][j][2 * h + 1];
      }
      uint32_t* p = out + (int64_t)gm * N + gn;
      if ((N & 3) == 0 && gn + 8 <= N) {
        reinterpret_cast<uint4*>(p)[0] = make_uint4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<uint4*>(p)[1] = make_uint4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (gn + c < N) p[c] = v[c];
      }
    }
}

template <int PX, int WB>
int launch_int(const void* x, const void* w, uint32_t* out, uint32_t* part, int M, int N,
               int K, int stage_k, int stages, cudaStream_t s) {
  using T = IntTile<PX, WB>;
  auto kernel = mpmm_int_kernel<PX, WB>;
  cudaError_t err = allow_smem(kernel, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  uint32_t* pp = stages > 1 ? part : out;
  // rows start on 16 bytes when the row length and the base do
  const bool x_vec = (int64_t)K * PX % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = (int64_t)N * T::PW % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid((N + IB_N - 1) / IB_N, (M + IB_M - 1) / IB_M, stages);
  kernel<<<grid, IB_THREADS, T::SMEM, s>>>(static_cast<const uint8_t*>(x),
                                          static_cast<const uint8_t*>(w), pp, M, N, K, stage_k,
                                          x_vec, w_vec);
  if (stages > 1) launch_sum_stages(pp, out, (int64_t)M * N, stages, s);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] int8 (x_bits 8) or int16 (x_bits 16); w [K, N] int8 (w_bits 8),
// int16 (16) or [K/2, N] int8 with packed nibbles (4); out [M, N] int32, the
// exact product mod 2^32.  K runs in ranges of stage_k rows, stages =
// ceil(K / stage_k), each range a whole number of 64-row K tiles when there
// is more than one: one range of K rows is the CF order unsplit, 512-row
// ranges the FF order, and the wrapper (kernels/mpmm.py::int_launch_plan)
// may split the CF order too.  More than one range spills the range
// partials to part ([stages, M, N] int32 scratch, unused when stages == 1)
// and sums them in range order.  Returns cudaErrorInvalidValue without
// launching on a split that does not fit, else cudaGetLastError() after
// the launches.
extern "C" int mpmm_int_i32(const void* x, const void* w, void* out, void* part, int M,
                            int N, int K, int x_bits, int w_bits, int stage_k, int stages,
                            void* stream) {
  if (!stages_fit(K, stage_k, stages) || (stages > 1 && stage_k % IB_K) ||
      (w_bits == 4 && K % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<uint32_t*>(out);
  auto* pp = static_cast<uint32_t*>(part);
#define MPMM_INT_CASE(PX, WB)                                                      \
  if (x_bits == 8 * PX && w_bits == WB)                                            \
    return launch_int<PX, WB>(x, w, op, pp, M, N, K, stage_k, stages, s);
  MPMM_INT_CASE(1, 4)
  MPMM_INT_CASE(1, 8)
  MPMM_INT_CASE(1, 16)
  MPMM_INT_CASE(2, 4)
  MPMM_INT_CASE(2, 8)
  MPMM_INT_CASE(2, 16)
#undef MPMM_INT_CASE
  return (int)cudaErrorInvalidValue;
}

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
// product is bound by the tensor cores' operations (M = 4096) or, at M =
// 128-400, by how many SMs its tiles keep busy.  The tensor-core kernel below
// streams x and the packed weights through a 4-stage cp.async ring, turns
// the weights into bf16 in registers and multiplies with wgmma (bf16 in, f32
// accumulate) as the transposed product, the weights being its register
// operand; the host picks 128- or 64-row tiles and a split along K so the
// grid fills the card, and the same fixed-order second pass sums the splits.
//
// Ragged M, N and K edges are masked inside the kernels (the JAX wrapper
// pads to blocks instead).  The wrapper (kernels/mpmm.py) checks shapes,
// types, N % 8 == 0 and 16-byte alignment before it launches.
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

// ---- larger M: warpgroup tensor-core kernel on an asynchronous-copy ring --
// The product runs transposed, out^T = w^T x^T, on Hopper's warpgroup MMA
// (wgmma): the dequantized weights are its register operand A (64 weight
// columns per warpgroup, 16 per warp) and x arrives untouched in shared
// memory as its operand B (BM x-rows by 64 k, K-major, in the 128-byte
// swizzled layout the descriptor names).  Block tile: 128 weight columns
// (2 warpgroups, 256 threads) by BM = 128 or 64 x-rows (chosen on the host
// from the shape); K advances in 64-row steps through a ring of TC_STAGES
// shared-memory stages filled by cp.async, the copies of the next
// TC_STAGES - 1 steps in flight while the current one is multiplied.  The
// weights land as they are stored, int8 or K-packed int4 (1 or 1/2 byte a
// weight), and are turned into bf16 in registers right before the product
// (exact for |w| <= 127).
//
// A fragments without a transpose: fragment row g of a warp's 16-row slice
// takes weight column 2g, row g + 8 column 2g + 1, so one 16-bit shared load
// per k row feeds both rows (4 loads per 16 k for int8, 2 for int4, whose
// byte already holds the k pair), and a lane's accumulators hold adjacent
// column pairs, stored as 4-byte writes.  Weight rows are 144 (int8) or 160
// (int4) bytes apart, so those loads are free of bank conflicts.
constexpr int TC_THREADS = 256;
constexpr int TC_BN = 128;
constexpr int TC_BK = 64;
constexpr int TC_STAGES = 4;

template <int W_BITS>
struct WTile {
  static constexpr int ROWS = W_BITS == 8 ? TC_BK : TC_BK / 2;        // byte rows
  static constexpr int PITCH = W_BITS == 8 ? TC_BN + 16 : TC_BN + 32;  // bytes
};

// x tile: BM rows of 64 bf16 (128 bytes), then the weight tile; every stage
// starts on a 1024-byte boundary (the swizzle repeats every 8 rows).
template <int BM, int W_BITS>
__host__ __device__ constexpr int tc_stage_bytes() {
  return BM * 128 + WTile<W_BITS>::ROWS * WTile<W_BITS>::PITCH;
}
template <int BM, int W_BITS>
constexpr int tc_smem_bytes() {
  return TC_STAGES * tc_stage_bytes<BM, W_BITS>() + 1024;  // + alignment slack
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: wgmma.m64n128k16, bf16 in, f32 accumulate;
// A from registers (mma.m16n8k16 A fragments, one 16-row slice per warp), B
// from shared memory through its descriptor.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: wgmma.m64n64k16, bf16 in, f32 accumulate;
// A from registers (mma.m16n8k16 A fragments, one 16-row slice per warp), B
// from shared memory through its descriptor.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (its issue and the wait for it).
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Orders this thread's generic-proxy writes to shared memory (cp.async, plain
// stores) before the async proxy's reads (wgmma's operand B).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Shared-memory matrix descriptor: K-major rows of 128 bytes, 128-byte
// swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// X_VEC: K % 8 == 0, so x rows are whole 16-byte copies; otherwise (rows off
// any 16-byte boundary) x goes through plain masked loads into the same ring.
// W_VEC: bytes per weight copy, 16 when N % 16 == 0, else 8 (N % 8 == 0).
template <int BM, int W_BITS, bool X_VEC, int W_VEC>
__global__ void __launch_bounds__(TC_THREADS, 2)
mpmm_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
               float* __restrict__ partial, int M, int N, int K, int k_per_split) {
  using WT = WTile<W_BITS>;
  constexpr int X_BYTES = BM * 128;
  constexpr int STAGE = tc_stage_bytes<BM, W_BITS>();
  constexpr int X_CHUNKS = BM * 8;
  constexpr int W_CHUNKS = WT::ROWS * TC_BN / W_VEC;
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert(X_CHUNKS % TC_THREADS == 0 && W_CHUNKS % TC_THREADS == 0, "copy split");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TC_BN;
  const int wcol = (warp >> 2) * 64 + (warp & 3) * 16 + 2 * g;  // this lane's column pair
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_kt = (k_end - k_begin + TC_BK - 1) / TC_BK;
  const int w_row_end = W_BITS == 8 ? k_end : k_end / 2;  // k_end is even for int4

  auto load_stage = [&](int kt) {
    uint8_t* st = smem + (kt % TC_STAGES) * STAGE;
    const int k0 = k_begin + kt * TC_BK;
    // x row r, 16-byte chunk c lands at chunk c ^ (r % 8) of row r (128B swizzle)
    if constexpr (X_VEC) {
#pragma unroll
      for (int i = 0; i < X_CHUNKS / TC_THREADS; ++i) {
        const int c = tid + i * TC_THREADS;
        const int r = c >> 3, ch = c & 7;
        const int gm = m0 + r, gk = k0 + ch * 8;
        const bool ok = gm < M && gk < k_end;
        cp_async<16>(st + r * 128 + ((ch ^ (r & 7)) << 4), ok ? x + (int64_t)gm * K + gk : x,
                     ok);
      }
    } else {
      for (int i = tid; i < BM * TC_BK; i += TC_THREADS) {
        const int r = i / TC_BK, kk = i % TC_BK;
        const int gm = m0 + r, gk = k0 + kk;
        *reinterpret_cast<__nv_bfloat16*>(st + r * 128 + (((kk >> 3) ^ (r & 7)) << 4) +
                                          (kk & 7) * 2) =
            (gm < M && gk < k_end) ? x[(int64_t)gm * K + gk] : __float2bfloat16(0.f);
      }
    }
    uint8_t* ws = st + X_BYTES;
    const int wr0 = W_BITS == 8 ? k0 : k0 / 2;
#pragma unroll
    for (int i = 0; i < W_CHUNKS / TC_THREADS; ++i) {
      const int c = tid + i * TC_THREADS;
      const int r = c / (TC_BN / W_VEC), nc = (c % (TC_BN / W_VEC)) * W_VEC;
      const int gr = wr0 + r, gn = n0 + nc;
      const bool ok = gr < w_row_end && gn < N;  // N % W_VEC == 0: whole or nothing
      cp_async<W_VEC>(ws + r * WT::PITCH + nc, ok ? w + (int64_t)gr * N + gn : w, ok);
    }
  };

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_kt) load_stage(s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<TC_STAGES - 2>();  // step kt has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; stage kt - 1 is free
    if (kt + TC_STAGES - 1 < n_kt) load_stage(kt + TC_STAGES - 1);
    cp_async_commit();
    const uint8_t* st = smem + (kt % TC_STAGES) * STAGE;
    const uint8_t* ws = st + X_BYTES + wcol;
    uint32_t a[TC_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      if constexpr (W_BITS == 8) {  // k rows 2q, 2q + 1, 2q + 8, 2q + 9 of this step
        const uint8_t* p = ws + (kk * 16 + 2 * q) * WT::PITCH;
        const uint32_t h0 = *reinterpret_cast<const uint16_t*>(p);
        const uint32_t h1 = *reinterpret_cast<const uint16_t*>(p + WT::PITCH);
        const uint32_t h8 = *reinterpret_cast<const uint16_t*>(p + 8 * WT::PITCH);
        const uint32_t h9 = *reinterpret_cast<const uint16_t*>(p + 9 * WT::PITCH);
        // bytes [col 2g k, col 2g + 1 k, col 2g k + 1, col 2g + 1 k + 1]
        const uint32_t lo = __byte_perm(h0, h1, 0x5410) ^ 0x80808080u;
        const uint32_t hi = __byte_perm(h8, h9, 0x5410) ^ 0x80808080u;
        a[kk][0] = pack_int_bf16x2(s8_biased_to_f32(lo, 0), s8_biased_to_f32(lo, 2));
        a[kk][1] = pack_int_bf16x2(s8_biased_to_f32(lo, 1), s8_biased_to_f32(lo, 3));
        a[kk][2] = pack_int_bf16x2(s8_biased_to_f32(hi, 0), s8_biased_to_f32(hi, 2));
        a[kk][3] = pack_int_bf16x2(s8_biased_to_f32(hi, 1), s8_biased_to_f32(hi, 3));
      } else {  // byte rows q and q + 4 hold k (2q, 2q + 1) and (2q + 8, 2q + 9)
        const uint8_t* p = ws + (kk * 8 + q) * WT::PITCH;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(p) ^ 0x8888u;
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + 4 * WT::PITCH) ^ 0x8888u;
        a[kk][0] = s4x2_biased_to_bf16x2(lo, 0);
        a[kk][1] = s4x2_biased_to_bf16x2(lo, 1);
        a[kk][2] = s4x2_biased_to_bf16x2(hi, 0);
        a[kk][3] = s4x2_biased_to_bf16x2(hi, 1);
      }
    }
    const uint64_t desc = desc_k128(st);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      if constexpr (BM == 128) {
        wgmma_m64n128k16(acc, a[kk], desc + 2 * kk);  // + 32 bytes of k per step
      } else {
        wgmma_m64n64k16(acc, a[kk], desc + 2 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait_all();  // the stage and a[] may be reused after this
    fence_operands(acc);
  }
  cp_async_wait<0>();

  // acc[4j + e]: fragment row g (e = 0, 1) or g + 8 (e = 2, 3) = weight column
  // wcol or wcol + 1; x row 8j + 2q (e = 0, 2) or 8j + 2q + 1 (e = 1, 3)
  const int gn = n0 + wcol;
  if (gn >= N) return;  // N is even: the column pair is all in or all out
  const bool direct = gridDim.z == 1;
  float2 sc = make_float2(0.f, 0.f);
  if (direct) sc = *reinterpret_cast<const float2*>(scale + gn);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gm = m0 + 8 * j + 2 * q + e;
      if (gm >= M) continue;
      const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      if (direct) {
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)gm * N + gn) =
            __floats2bfloat162_rn(v0 * sc.x, v1 * sc.y);
      } else {
        *reinterpret_cast<float2*>(partial + ((int64_t)split * M + gm) * N + gn) =
            make_float2(v0, v1);
      }
    }
  }
}

template <int BM, int W_BITS, bool X_VEC, int W_VEC>
cudaError_t launch_tc(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                      __nv_bfloat16* out, float* partial, int M, int N, int K, int splits,
                      int k_per_split, cudaStream_t s) {
  constexpr int smem = tc_smem_bytes<BM, W_BITS>();
  auto kernel = mpmm_tc_kernel<BM, W_BITS, X_VEC, W_VEC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, TC_THREADS, smem, s>>>(x, w, scale, out, partial, M, N, K, k_per_split);
  return cudaGetLastError();
}

template <int BM, int W_BITS>
cudaError_t dispatch_tc(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                        __nv_bfloat16* out, float* partial, int M, int N, int K, int splits,
                        int k_per_split, cudaStream_t s) {
  const bool x_vec = K % 8 == 0, w_vec16 = N % 16 == 0;
  if (x_vec) {
    return w_vec16 ? launch_tc<BM, W_BITS, true, 16>(x, w, scale, out, partial, M, N, K,
                                                     splits, k_per_split, s)
                   : launch_tc<BM, W_BITS, true, 8>(x, w, scale, out, partial, M, N, K,
                                                    splits, k_per_split, s);
  }
  return w_vec16 ? launch_tc<BM, W_BITS, false, 16>(x, w, scale, out, partial, M, N, K,
                                                    splits, k_per_split, s)
                 : launch_tc<BM, W_BITS, false, 8>(x, w, scale, out, partial, M, N, K,
                                                   splits, k_per_split, s);
}

}  // namespace

// x [M, K] bf16, w [K or K/2, N] int8, scale [N] f32, out [M, N] bf16.
// partial: [splits, M, N] f32 scratch when splits > 1 (else unused).
// block_m: the tensor-core kernel's block rows (64 or 128) when M > 8.
// k_per_split: K rows per split, a multiple of the kernel's K step (512 for
// M <= 8, 64 above), with (splits - 1) * k_per_split < K <= splits *
// k_per_split; the wrapper (kernels/mpmm.py::launch_plan) chooses both.
// Returns cudaErrorInvalidValue without launching on a plan that does not
// fit, else cudaGetLastError() after the launches.
extern "C" int mpmm_dequant_bf16(const void* x, const void* w, const void* scale,
                                 void* out, void* partial, int M, int N, int K,
                                 int w_bits, int splits, int k_per_split, int block_m,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  float* pp = static_cast<float*>(partial);
  const int step = M <= SM_MMAX ? SM_KC : TC_BK;
  if (splits < 1 || k_per_split < 1 || k_per_split % step ||
      (int64_t)splits * k_per_split < K || (int64_t)(splits - 1) * k_per_split >= K) {
    return (int)cudaErrorInvalidValue;
  }
  if (M <= SM_MMAX) {
    dim3 grid((N + SM_COLS - 1) / SM_COLS, splits);
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
  } else {
    cudaError_t err;
    if (block_m == 128) {
      err = w_bits == 8 ? dispatch_tc<128, 8>(xp, wp, sp, op, pp, M, N, K, splits, k_per_split, s)
                        : dispatch_tc<128, 4>(xp, wp, sp, op, pp, M, N, K, splits, k_per_split, s);
    } else if (block_m == 64) {
      err = w_bits == 8 ? dispatch_tc<64, 8>(xp, wp, sp, op, pp, M, N, K, splits, k_per_split, s)
                        : dispatch_tc<64, 4>(xp, wp, sp, op, pp, M, N, K, splits, k_per_split, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (splits > 1) {
    const int64_t total = (int64_t)M * N;
    mpmm_splitk_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(pp, sp, op, M, N,
                                                                       splits);
  }
  return (int)cudaGetLastError();
}

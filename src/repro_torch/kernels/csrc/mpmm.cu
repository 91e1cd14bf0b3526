// W4A16 / W8A16 dequant matmul for Hopper: x[M, K] @ dequant(w), in both
// dataflows of repro/kernels/mpmm.py::mpmm_pallas's dequant mode.
//
// CF order (entry mpmm_dequant_bf16; Pallas body _mpmm_cf_kernel): k
// innermost, f32 accumulation, the per-column f32 scale applied to the f32
// sum in the epilogue, one cast to bf16.  Its twin entry mpmm_dequant_f32
// returns the scaled f32 sum uncast (a row-split partial product, summed
// over the model ranks before its one cast).  FF order (entry
// mpmm_ff_dequant_f32; body _mpmm_ff_kernel, grid (k, m, n) with the 512-row
// K stages outermost): each stage's product is summed from zero and the
// stages are added into an unscaled f32 output in stage order,
// ((p0 + p1) + p2) + ...; the wrapper applies the scale.  Weights are int8
// [K, N], or int4 packed along K [K/2, N] (byte row r holds K index 2r in
// the low nibble and 2r + 1 in the high nibble), unpacked in registers;
// int -> float is exact for |w| <= 127, so the numerics are those of
// kernels/ref.py::mpmm_ref / mpmm_ff_ref up to the order of the f32 sums.
//
// What bounds it on an H100: at decode M (a batch bucket of at most 8 rows)
// the weight bytes; at prefill M and at a CNN's conv shapes the tensor cores'
// operations (M = 4096), x's bytes (K = 147 or 576 at M = 25088-100352) or,
// at M = 128-1568, how many SMs its tiles keep busy.  One tensor-core kernel
// serves every M and both orders: it streams x and the packed weights through
// a cp.async ring, turns the weights into bf16 in registers and multiplies
// with wgmma (bf16 in, f32 accumulate) as the transposed product, the weights
// being its register operand; the host picks 128-, 64- or (M <= 8) 8-row
// tiles and the K split so the grid fills the card.  At 8 rows a stage is
// almost all weights (2 KB of x beside 16 KB of int8 or 8 KB of int4
// weights, 128 K rows), and 4 of the ring's 5 stages are in flight per
// block: 64 KB (int8) or 32 KB (int4), about 100 KB per SM, enough to cover
// HBM's latency.  A K split's partials go through a second pass that sums
// them in a fixed order (no atomics, so results are the same run to run).
// The two orders differ only in the split and the epilogue: CF splits K
// freely and scales and casts when it does not split; FF splits K at the
// 512-row stage boundaries (Hopper blocks run in no order, so the Pallas
// grid's sequential stage axis becomes the grid's z), writes each stage's
// unscaled f32 partial to a [stages, M, N] spill buffer (out itself when
// K <= 512), and the same fixed-order second pass adds the stages, as the
// Pallas FF grid does.
//
// Float32 activations (the Pallas kernel's "x is bf16/f32"; the CNN path and
// the quickstart run f32) take a kernel of their own on the CUDA cores, in
// both orders (entries mpmm_dequant_x32, mpmm_ff_dequant_x32; described at
// mpmm_x32_kernel below).  The bf16 kernels and entries above are untouched
// by it.
//
// Ragged M, N and K edges are masked inside the kernels (the JAX wrapper
// pads to blocks instead).  The wrappers (kernels/mpmm.py) check shapes,
// types and 16-byte alignment before they launch; the CF wrapper also
// N % 8 == 0, while the FF order takes any N (weight rows of any length
// are staged by plain byte loads).
#include <type_traits>

#include "common.cuh"

namespace {

__device__ inline void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ inline void store_out(float* p, float v) { *p = v; }

// Sums the K-split partials in split order, applies the scale, stores as T.
// For T = float, out may be partial itself (one split): each thread reads
// its element before it writes it, so the pointers are not __restrict__.
template <typename T>
__global__ void mpmm_splitk_reduce(const float* partial, const float* scale, T* out, int M,
                                   int N, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[sp * total + i];
  store_out(out + i, s * scale[i % N]);
}

// ---- the warpgroup tensor-core kernel on an asynchronous-copy ring ---------
// The product runs transposed, out^T = w^T x^T, on Hopper's warpgroup MMA
// (wgmma): the dequantized weights are its register operand A (64 weight
// columns per warpgroup, 16 per warp) and x arrives untouched in shared
// memory as its operand B (BM x-rows by 64 k a slice, K-major, in the
// 128-byte swizzled layout the descriptor names).  Block tile: 128 weight
// columns (2 warpgroups, 256 threads) by BM = 128, 64 or 8 x-rows (chosen on
// the host from the shape; 8 for M <= 8, where wgmma.m64n8k16 takes a slice
// of x as one 8-row, 128-byte swizzle atom); K advances in tc_bk<BM>()-row
// steps (64, or 128 at 8 rows) through a ring of tc_stages<BM>()
// shared-memory stages filled by cp.async, the copies of the next stages - 1
// steps in flight while the current one is multiplied.  The weights land as
// they are stored, int8 or K-packed int4 (1 or 1/2 byte a weight), and are
// turned into bf16 in registers right before the product (exact for
// |w| <= 127).
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

// K rows per step: 64; 128 at 8 rows, so that a block syncs and waits for
// its products half as often per weight.  Ring depth: 4 stages; 5 at 8 rows,
// whose stages are nearly all weights, so that more weight bytes are in
// flight per SM.
template <int BM>
__host__ __device__ constexpr int tc_bk() {
  return BM == 8 ? 2 * TC_BK : TC_BK;
}
template <int BM>
__host__ __device__ constexpr int tc_stages() {
  return BM == 8 ? 5 : 4;
}

template <int W_BITS, int BK>
struct WTile {
  static constexpr int ROWS = W_BITS == 8 ? BK : BK / 2;               // byte rows
  static constexpr int PITCH = W_BITS == 8 ? TC_BN + 16 : TC_BN + 32;  // bytes
};

// x tile: BK / 64 slices of BM rows of 64 bf16 (128 bytes a row, BM * 128
// bytes a slice), then the weight tile; every slice and stage starts on a
// 1024-byte boundary (the swizzle repeats every 8 rows).
template <int BM, int W_BITS>
__host__ __device__ constexpr int tc_stage_bytes() {
  using WT = WTile<W_BITS, tc_bk<BM>()>;
  return BM * 2 * tc_bk<BM>() + WT::ROWS * WT::PITCH;
}
template <int BM, int W_BITS>
constexpr int tc_smem_bytes() {
  return tc_stages<BM>() * tc_stage_bytes<BM, W_BITS>() + 1024;  // + alignment slack
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

// D[64 x 8] += A[64 x 16] * B[16 x 8]: wgmma.m64n8k16, the decode-M tile.
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
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
// W_VEC: bytes per weight copy, 16 when N % 16 == 0, 8 when N % 8 == 0, else
// 1: plain masked byte loads (FF order only; weight rows of any length).
// FF: the FF order's epilogue, every split (K stage) written unscaled to its
// slice of `partial` (which is out itself for one stage); otherwise CF: one
// split writes scale * sum as bf16 to out, more (or a null out: the f32
// entry) write their partials.
template <int BM, int W_BITS, bool X_VEC, int W_VEC, bool FF>
__global__ void __launch_bounds__(TC_THREADS, 2)
mpmm_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
               float* __restrict__ partial, int M, int N, int K, int k_per_split) {
  constexpr int BK = tc_bk<BM>();
  using WT = WTile<W_BITS, BK>;
  constexpr int SLICE = BM * 128;  // x bytes of 64 k
  constexpr int X_BYTES = SLICE * (BK / 64);
  constexpr int STAGES = tc_stages<BM>();
  constexpr int STAGE = tc_stage_bytes<BM, W_BITS>();
  constexpr int X_CHUNKS = BM * BK / 8;
  constexpr int W_CHUNKS = WT::ROWS * TC_BN / W_VEC;
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert((X_CHUNKS % TC_THREADS == 0 || X_CHUNKS < TC_THREADS) &&
                W_CHUNKS % TC_THREADS == 0, "copy split");
  static_assert(FF || W_VEC >= 8, "the CF order takes N % 8 == 0");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * TC_BN;
  const int wcol = (warp >> 2) * 64 + (warp & 3) * 16 + 2 * g;  // this lane's column pair
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_kt = (k_end - k_begin + BK - 1) / BK;
  const int w_row_end = W_BITS == 8 ? k_end : k_end / 2;  // k_end is even for int4

  auto load_stage = [&](int kt) {
    uint8_t* st = smem + (kt % STAGES) * STAGE;
    const int k0 = k_begin + kt * BK;
    // x row r, 16-byte chunk c of a 64-k slice lands at chunk c ^ (r % 8) of
    // row r of that slice (128B swizzle)
    if constexpr (X_VEC) {
#pragma unroll
      for (int i = 0; i < (X_CHUNKS + TC_THREADS - 1) / TC_THREADS; ++i) {
        const int c = tid + i * TC_THREADS;
        if (X_CHUNKS < TC_THREADS && c >= X_CHUNKS) break;  // 8 rows: 128 chunks
        const int r = (unsigned)c / (BK / 8), ch = (unsigned)c % (BK / 8);
        const int gm = m0 + r, gk = k0 + ch * 8;
        const bool ok = gm < M && gk < k_end;
        cp_async<16>(st + (ch >> 3) * SLICE + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
                     ok ? x + (int64_t)gm * K + gk : x, ok);
      }
    } else {
      for (int i = tid; i < BM * BK; i += TC_THREADS) {
        const int r = i / BK, kk = i % BK;
        const int gm = m0 + r, gk = k0 + kk;
        const int slice = BK > 64 ? kk >> 6 : 0, k64 = BK > 64 ? kk & 63 : kk;
        *reinterpret_cast<__nv_bfloat16*>(st + slice * SLICE + r * 128 +
                                          (((k64 >> 3) ^ (r & 7)) << 4) + (kk & 7) * 2) =
            (gm < M && gk < k_end) ? x[(int64_t)gm * K + gk] : __float2bfloat16(0.f);
      }
    }
    uint8_t* ws = st + X_BYTES;
    const int wr0 = W_BITS == 8 ? k0 : k0 / 2;
    if constexpr (W_VEC == 1) {
#pragma unroll 4  // a full unroll holds 32 loads in registers and spills
      for (int c = tid; c < W_CHUNKS; c += TC_THREADS) {
        const int r = c / TC_BN, nc = c % TC_BN;
        const int gr = wr0 + r, gn = n0 + nc;
        ws[r * WT::PITCH + nc] =
            gr < w_row_end && gn < N ? (uint8_t)w[(int64_t)gr * N + gn] : (uint8_t)0;
      }
    } else {
#pragma unroll
      for (int i = 0; i < W_CHUNKS / TC_THREADS; ++i) {
        const int c = tid + i * TC_THREADS;
        const int r = c / (TC_BN / W_VEC), nc = (c % (TC_BN / W_VEC)) * W_VEC;
        const int gr = wr0 + r, gn = n0 + nc;
        const bool ok = gr < w_row_end && gn < N;  // N % W_VEC == 0: whole or nothing
        cp_async<W_VEC>(ws + r * WT::PITCH + nc, ok ? w + (int64_t)gr * N + gn : w, ok);
      }
    }
  };

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_kt) load_stage(s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; stage kt - 1 is free
    if (kt + STAGES - 1 < n_kt) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const uint8_t* st = smem + (kt % STAGES) * STAGE;
    const uint8_t* ws = st + X_BYTES + wcol;
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
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
        s4x4_biased_to_bf16x2(*reinterpret_cast<const uint16_t*>(p) ^ 0x8888u, a[kk][0],
                              a[kk][1]);
        s4x4_biased_to_bf16x2(*reinterpret_cast<const uint16_t*>(p + 4 * WT::PITCH) ^ 0x8888u,
                              a[kk][2], a[kk][3]);
      }
    }
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the slice's descriptor, + 32 bytes of k per 16-k step within it
      const uint64_t desc = desc_k128(st + (kk >> 2) * SLICE) + 2 * (kk & 3);
      if constexpr (BM == 128) {
        wgmma_m64n128k16(acc, a[kk], desc);
      } else if constexpr (BM == 64) {
        wgmma_m64n64k16(acc, a[kk], desc);
      } else {
        wgmma_m64n8k16(acc, a[kk], desc);
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
  if (gn >= N) return;  // with N even the column pair is all in or all out
  const bool direct = !FF && gridDim.z == 1 && out != nullptr;
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
        float* p = partial + ((int64_t)split * M + gm) * N + gn;
        if constexpr (W_VEC >= 8) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {  // any N: rows may start off 8 bytes, the pair may straddle N
          p[0] = v0;
          if (gn + 1 < N) p[1] = v1;
        }
      }
    }
  }
}

template <int BM, int W_BITS, bool X_VEC, int W_VEC, bool FF>
cudaError_t launch_tc(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                      __nv_bfloat16* out, float* partial, int M, int N, int K, int splits,
                      int k_per_split, cudaStream_t s) {
  constexpr int smem = tc_smem_bytes<BM, W_BITS>();
  auto kernel = mpmm_tc_kernel<BM, W_BITS, X_VEC, W_VEC, FF>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, TC_THREADS, smem, s>>>(x, w, scale, out, partial, M, N, K, k_per_split);
  return cudaGetLastError();
}

template <int BM, int W_BITS, bool FF, bool X_VEC>
cudaError_t dispatch_w(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                       __nv_bfloat16* out, float* partial, int M, int N, int K, int splits,
                       int k_per_split, cudaStream_t s) {
  if (N % 16 == 0)
    return launch_tc<BM, W_BITS, X_VEC, 16, FF>(x, w, scale, out, partial, M, N, K, splits,
                                               k_per_split, s);
  if (N % 8 == 0)
    return launch_tc<BM, W_BITS, X_VEC, 8, FF>(x, w, scale, out, partial, M, N, K, splits,
                                              k_per_split, s);
  if constexpr (FF)
    return launch_tc<BM, W_BITS, X_VEC, 1, FF>(x, w, scale, out, partial, M, N, K, splits,
                                              k_per_split, s);
  return cudaErrorInvalidValue;  // the CF order takes N % 8 == 0
}

template <bool FF>
cudaError_t dispatch_tc(const __nv_bfloat16* x, const int8_t* w, const float* scale,
                        __nv_bfloat16* out, float* partial, int M, int N, int K, int w_bits,
                        int splits, int k_per_split, int block_m, cudaStream_t s) {
  const bool x_vec = K % 8 == 0;
#define MPMM_TC_CASE(BM, WB)                                                                \
  if (block_m == BM && w_bits == WB)                                                        \
    return x_vec ? dispatch_w<BM, WB, FF, true>(x, w, scale, out, partial, M, N, K, splits,  \
                                                k_per_split, s)                             \
                 : dispatch_w<BM, WB, FF, false>(x, w, scale, out, partial, M, N, K, splits, \
                                                 k_per_split, s);
  MPMM_TC_CASE(128, 8)
  MPMM_TC_CASE(128, 4)
  MPMM_TC_CASE(64, 8)
  MPMM_TC_CASE(64, 4)
  if constexpr (!FF) {  // decode M: the CF order only
    MPMM_TC_CASE(8, 8)
    MPMM_TC_CASE(8, 4)
  }
#undef MPMM_TC_CASE
  return cudaErrorInvalidValue;
}

constexpr int FF_STAGE_K = 512;  // the FF order's K stage (JAX: bk)

// The share of block slots a grid of `blocks` fills over its waves: one
// block per SM up to 132 blocks, two per SM above (kernels/mpmm.py::wave_fill).
double wave_fill(int64_t blocks) {
  const int64_t slots = blocks <= 132 ? 132 : 264;
  return (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
}

// The FF order's block rows, by kernels/mpmm.py::launch_plan's rule with the
// split fixed at the stages: 128 unless 64-row tiles fill the card's block
// slots more than 1 / 0.9 times as well.
int ff_block_m(int M, int N, int K) {
  if (M <= 64) return 64;
  const int64_t cols = (N + TC_BN - 1) / TC_BN, stages = (K + FF_STAGE_K - 1) / FF_STAGE_K;
  const double f128 = wave_fill((M + 127) / 128 * cols * stages);
  const double f64 = wave_fill((M + 63) / 64 * cols * stages);
  return f128 >= 0.9 * fmax(f128, f64) ? 128 : 64;
}

// The CF entries' body.  T = bf16: one split scales and casts in the
// kernel's epilogue, more go through the reduce pass.  T = float: the kernel
// writes every split's partial (its out is null) and the reduce pass sums,
// scales and stores f32.
template <typename T>
int mpmm_dequant(const void* x, const void* w, const void* scale, T* out, void* partial,
                 int M, int N, int K, int w_bits, int splits, int k_per_split, int block_m,
                 void* stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const float*>(scale);
  float* pp = static_cast<float*>(partial);
  const int step = block_m == 8 ? tc_bk<8>() : TC_BK;
  if (splits < 1 || k_per_split < 1 || k_per_split % step || (block_m == 8 && M > 8) ||
      (int64_t)splits * k_per_split < K || (int64_t)(splits - 1) * k_per_split >= K) {
    return (int)cudaErrorInvalidValue;
  }
  __nv_bfloat16* direct_out = nullptr;
  if constexpr (!f32) direct_out = out;
  const cudaError_t err = dispatch_tc<false>(static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const int8_t*>(w), sp, direct_out, pp,
                                             M, N, K, w_bits, splits, k_per_split, block_m, s);
  if (err != cudaSuccess) return (int)err;
  if (f32 || splits > 1) {
    const int64_t total = (int64_t)M * N;
    mpmm_splitk_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(pp, sp, out, M, N,
                                                                          splits);
  }
  return (int)cudaGetLastError();
}

// ---- float32 activations (entries mpmm_dequant_x32, mpmm_ff_dequant_x32) --
// The Pallas body dots x against w.astype(x.dtype) with an f32 accumulator,
// so with f32 x every product is an f32 product of x and the exact integer
// weight.  wgmma has no f32 operand (its TF32 form rounds x to 10 mantissa
// bits), so this kernel multiplies on the CUDA cores in f32 FMA: what bounds
// it is the card's f32 rate (67 TFLOP/s outside the tensor cores), not the
// bytes.  Block tile 64 x-rows by 64 weight columns, 256 threads of 4 x 4
// outputs each (4 consecutive rows by 4 consecutive columns, read from
// shared memory as one float4 each per k); K advances 16 rows a step
// through two shared-memory buffers, the next step's x and weights loaded
// into registers while the current one is multiplied.  x lands transposed
// (k-major); the weights land dequantized to f32 and unscaled (int8, or
// int4 packed along K: byte row r holds K index 2r in the low nibble and
// 2r + 1 in the high one).  Ragged M, N and K edges load as zeros and are
// masked at the store.  A block sums its K range in k order from zero; the
// K split (CF) or the 512-row stages (FF) are the grid's z, and their
// partials go through the same fixed-order second passes as the bf16
// kernel's (mpmm_splitk_reduce, sum_stages).
constexpr int X32_BM = 64;
constexpr int X32_BN = 64;
constexpr int X32_BK = 16;
constexpr int X32_THREADS = 256;
constexpr int X32_XPITCH = X32_BM + 4;  // floats; keeps float4 rows aligned

// One split (or stage) per blockIdx.z.  out non-null (the CF order with one
// split): scale * sum written to out; otherwise the unscaled sum written to
// partial's slice of this split (partial may be out itself for one FF stage).
template <int W_BITS>
__global__ void __launch_bounds__(X32_THREADS)
mpmm_x32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* out, float* partial, int M, int N,
                int K, int k_per_split) {
  __shared__ __align__(16) float xs[2][X32_BK][X32_XPITCH];
  __shared__ __align__(16) float ws[2][X32_BK][X32_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // output columns tx*4.., rows ty*4..
  const int m0 = blockIdx.y * X32_BM, n0 = blockIdx.x * X32_BN;
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_kt = (k_end - k_begin + X32_BK - 1) / X32_BK;
  // this thread's loads: x row lr, k lk..lk+3; weight k row wk, columns wn..wn+3
  const int lr = tid / 4, lk = (tid % 4) * 4;
  const int wk = tid / 16, wn = (tid % 16) * 4;

  float xr[4], wr[4];
  auto load = [&](int kt) {
    const int k0 = k_begin + kt * X32_BK;
    const int gm = m0 + lr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + lk + j;
      xr[j] = gm < M && gk < k_end ? x[(int64_t)gm * K + gk] : 0.f;
    }
    const int gk = k0 + wk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + wn + j;
      float v = 0.f;
      if (gk < k_end && gn < N) {
        if constexpr (W_BITS == 8) {
          v = (float)w[(int64_t)gk * N + gn];
        } else {
          const int8_t b = w[(int64_t)(gk >> 1) * N + gn];
          v = (float)(gk & 1 ? (int8_t)(b >> 4) : (int8_t)((int8_t)(b << 4) >> 4));
        }
      }
      wr[j] = v;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[buf][lk + j][lr] = xr[j];
    *reinterpret_cast<float4*>(&ws[buf][wk][wn]) = make_float4(wr[0], wr[1], wr[2], wr[3]);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (n_kt > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_kt) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < X32_BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[cur][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[cur][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < n_kt) store(cur ^ 1);  // the buffer step kt - 1 read, before the sync
    __syncthreads();
  }

  const int gn0 = n0 + tx * 4;
  if (gn0 >= N) return;
  const bool direct = out != nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
    float* row = direct ? out + (int64_t)gm * N : partial + ((int64_t)split * M + gm) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = gn0 + j;
      if (gn < N) row[gn] = direct ? acc[i][j] * scale[gn] : acc[i][j];
    }
  }
}

cudaError_t launch_x32(const float* x, const int8_t* w, const float* scale, float* out,
                       float* partial, int M, int N, int K, int w_bits, int splits,
                       int k_per_split, cudaStream_t s) {
  dim3 grid((N + X32_BN - 1) / X32_BN, (M + X32_BM - 1) / X32_BM, splits);
  if (w_bits == 8) {
    mpmm_x32_kernel<8><<<grid, X32_THREADS, 0, s>>>(x, w, scale, out, partial, M, N, K,
                                                    k_per_split);
  } else if (w_bits == 4) {
    mpmm_x32_kernel<4><<<grid, X32_THREADS, 0, s>>>(x, w, scale, out, partial, M, N, K,
                                                    k_per_split);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w [K or K/2, N] int8, scale [N] f32, out [M, N] bf16.
// partial: [splits, M, N] f32 scratch when splits > 1 (else unused).
// block_m: the block rows (128, 64, or 8 for M <= 8).  k_per_split: K rows
// per split, a multiple of the kernel's K step (tc_bk: 128 at 8 rows, else
// 64), with (splits - 1) * k_per_split < K <= splits * k_per_split; the
// wrapper (kernels/mpmm.py::launch_plan) chooses all three.  Returns
// cudaErrorInvalidValue without launching on a plan that does not fit, else
// cudaGetLastError() after the launches.
extern "C" int mpmm_dequant_bf16(const void* x, const void* w, const void* scale,
                                 void* out, void* partial, int M, int N, int K,
                                 int w_bits, int splits, int k_per_split, int block_m,
                                 void* stream) {
  return mpmm_dequant(x, w, scale, static_cast<__nv_bfloat16*>(out), partial, M, N, K,
                      w_bits, splits, k_per_split, block_m, stream);
}

// As mpmm_dequant_bf16, with out [M, N] f32: the scaled f32 sum, uncast.
// partial: [splits, M, N] f32 scratch, which may be out itself for one split
// (every split writes its unscaled partial; a second pass sums and scales).
extern "C" int mpmm_dequant_f32(const void* x, const void* w, const void* scale,
                                void* out, void* partial, int M, int N, int K,
                                int w_bits, int splits, int k_per_split, int block_m,
                                void* stream) {
  return mpmm_dequant(x, w, scale, static_cast<float*>(out), partial, M, N, K, w_bits,
                      splits, k_per_split, block_m, stream);
}

// The FF order.  x [M, K] bf16, w [K or K/2, N] int8 (int4 packed along K),
// out [M, N] f32: the unscaled sum of the K stages of stage_k rows, in stage
// order.  part: [stages, M, N] f32 scratch for the spilled stage partials when
// stages > 1 (else unused); stage_k must be the compiled-in stage size (512)
// and stages ceil(K / stage_k), else cudaErrorInvalidValue and nothing is
// launched.  The block rows are mpmm_ff_block_m's.  Returns cudaGetLastError()
// after the launches.
extern "C" int mpmm_ff_dequant_f32(const void* x, const void* w, void* out, void* part,
                                   int M, int N, int K, int w_bits, int stage_k, int stages,
                                   void* stream) {
  if (stage_k != FF_STAGE_K || !stages_fit(K, stage_k, stages)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<float*>(out);
  float* pp = stages > 1 ? static_cast<float*>(part) : op;
  const cudaError_t err = dispatch_tc<true>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), nullptr, nullptr,
      pp, M, N, K, w_bits, stages, stage_k, ff_block_m(M, N, K), s);
  if (err != cudaSuccess) return (int)err;
  if (stages > 1) launch_sum_stages(pp, op, (int64_t)M * N, stages, s);
  return (int)cudaGetLastError();
}

// The block rows mpmm_ff_dequant_f32 launches an [M, K] x [K, N] product with.
extern "C" int mpmm_ff_block_m(int M, int N, int K) { return ff_block_m(M, N, K); }

// The CF order on float32 activations.  x [M, K] f32, w [K or K/2, N] int8
// (int4 packed along K; K even), scale [N] f32, out [M, N] f32 = scale * the
// f32 sum.  partial: [splits, M, N] f32 scratch when splits > 1 (else
// unused); k_per_split a multiple of 16 with (splits - 1) * k_per_split < K
// <= splits * k_per_split (kernels/mpmm.py::x32_launch_plan), else
// cudaErrorInvalidValue and nothing is launched.  Returns cudaGetLastError()
// after the launches.
extern "C" int mpmm_dequant_x32(const void* x, const void* w, const void* scale, void* out,
                                void* partial, int M, int N, int K, int w_bits, int splits,
                                int k_per_split, void* stream) {
  if (splits < 1 || k_per_split < 1 || k_per_split % X32_BK ||
      (int64_t)splits * k_per_split < K || (int64_t)(splits - 1) * k_per_split >= K ||
      (w_bits == 4 && K % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<float*>(out);
  auto* pp = static_cast<float*>(partial);
  const cudaError_t err =
      launch_x32(static_cast<const float*>(x), static_cast<const int8_t*>(w), sp,
                 splits == 1 ? op : nullptr, pp, M, N, K, w_bits, splits, k_per_split, s);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const int64_t total = (int64_t)M * N;
    mpmm_splitk_reduce<float><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(pp, sp, op, M,
                                                                             N, splits);
  }
  return (int)cudaGetLastError();
}

// The FF order on float32 activations.  x [M, K] f32, w as above, out [M, N]
// f32: the unscaled sum of the K stages of stage_k rows, in stage order.
// part: [stages, M, N] f32 scratch when stages > 1 (else unused); stage_k
// must be the FF stage (512) and stages ceil(K / stage_k), else
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launches.
extern "C" int mpmm_ff_dequant_x32(const void* x, const void* w, void* out, void* part,
                                   int M, int N, int K, int w_bits, int stage_k, int stages,
                                   void* stream) {
  if (stage_k != FF_STAGE_K || !stages_fit(K, stage_k, stages) || (w_bits == 4 && K % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<float*>(out);
  float* pp = stages > 1 ? static_cast<float*>(part) : op;
  const cudaError_t err =
      launch_x32(static_cast<const float*>(x), static_cast<const int8_t*>(w), nullptr, nullptr,
                 pp, M, N, K, w_bits, stages, stage_k, s);
  if (err != cudaSuccess) return (int)err;
  if (stages > 1) launch_sum_stages(pp, op, (int64_t)M * N, stages, s);
  return (int)cudaGetLastError();
}

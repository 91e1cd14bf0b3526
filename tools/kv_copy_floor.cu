// Copy-only streaming of a contiguous int8 KV cache [B, S, Hkv, Dk] in the
// layout and schedule of csrc/mqa_decode.cu (one warp per kv head, 4 adjacent
// heads a block, 8-token tiles through a 4-tile ring per warp, the same split
// of the positions), with no arithmetic: the floor the decode kernel's
// copies set.  Three copy engines: 16-byte cp.async (the kernel's), 16-byte
// loads staged through registers two tiles ahead, and one cp.async.bulk (TMA)
// copy per row completed on an mbarrier.  Then the same for the paged pool
// [L, P, ps, Hkv, Dk] in the layout and schedule of csrc/paged_decode.cu
// (warps over (kv head, query group, split), page ids looked up a tile ahead,
// int8 / packed int4 / bf16 rows and their scales by cp.async through a
// 4-tile ring per warp): paged_copy_floor.  Built and run by
// tools/kv_copy_floor.py.
#include "common.cuh"

namespace {

constexpr int TT = 8, RING = 4, WARPS = 4;

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile("{\n.reg .pred P1;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
               "@!P1 bra WAIT;\n}" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// ENGINE 0: cp.async, 1: registers, 2: cp.async.bulk.  Rows of dk bytes, dk %
// 16 == 0 and dk <= 128; `sink` keeps one byte a lane a tile live.
template <int ENGINE>
__global__ void __launch_bounds__(32 * WARPS)
kv_copy_kernel(const int8_t* k, const int8_t* v, float* sink, int s_len, int hkv, int dk,
               int per_split) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, h = blockIdx.y * WARPS + warp;
  if (h >= hkv) return;
  const int tb = 2 * TT * dk;
  uint8_t* ring = smem + warp * RING * tb;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + WARPS * RING * tb) + warp * RING;
  const int p0 = blockIdx.z * per_split, p1 = min(s_len, p0 + per_split);
  const int n_tiles = (p1 - p0 + TT - 1) / TT;
  const int64_t rs = (int64_t)hkv * dk;
  const int8_t* kb = k + ((int64_t)b * s_len * hkv + h) * dk;
  const int8_t* vb = v + ((int64_t)b * s_len * hkv + h) * dk;
  const int cpr = dk / 16;
  float acc = 0.f;
  if (ENGINE == 1) {
    uint4 r0[4], r1[4];
    auto load = [&](int i, uint4 (&r)[4]) {
      const int t0 = p0 + i * TT;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j, ch = c & 7, t = (c >> 3) & 7, kv = c >> 6;
        const bool ok = ch < cpr && t0 + t < p1 && i < n_tiles;
        r[j] = ok ? __ldg(reinterpret_cast<const uint4*>((kv ? vb : kb) + (t0 + t) * rs + ch * 16))
                  : make_uint4(0, 0, 0, 0);
      }
    };
    load(0, r0);
    load(1, r1);
    for (int i = 0; i < n_tiles; ++i) {
      uint8_t* st = ring + (i % 2) * tb;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j, ch = c & 7, t = (c >> 3) & 7, kv = c >> 6;
        if (ch < cpr) *reinterpret_cast<uint4*>(st + (kv * TT + t) * dk + ch * 16) = r0[j];
        r0[j] = r1[j];
      }
      load(i + 2, r1);
      __syncwarp();
      acc += (float)st[lane * 4];
      __syncwarp();
    }
  } else {
    if (ENGINE == 2) {
      if (lane < RING) mbar_init(bars + lane);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      __syncwarp();
    }
    auto issue = [&](int i) {
      uint8_t* st = ring + (i % RING) * tb;
      const int t0 = p0 + i * TT;
      if (ENGINE == 0) {
        for (int c = lane; c < 2 * TT * 8; c += 32) {
          const int ch = c & 7, t = (c >> 3) & 7, kv = c >> 6;
          const bool ok = t0 + t < p1;
          if (ch < cpr)
            cp_async<16>(st + (kv * TT + t) * dk + ch * 16,
                         (kv ? vb : kb) + (ok ? t0 + t : 0) * rs + ch * 16, ok);
        }
      } else {
        const int nt = min(TT, p1 - t0);
        if (lane == 0) mbar_expect(bars + i % RING, 2 * nt * dk);
        __syncwarp();
        const int t = lane % TT, kv = lane / TT;
        if (lane < 2 * TT && t < nt)
          bulk_copy(st + (kv * TT + t) * dk, (kv ? vb : kb) + (t0 + t) * rs, dk, bars + i % RING);
      }
    };
    for (int i = 0; i < RING - 1; ++i) {
      if (i < n_tiles) issue(i);
      if (ENGINE == 0) cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      if (ENGINE == 0) {
        cp_async_wait<RING - 2>();
      } else {
        mbar_wait(bars + i % RING, (i / RING) & 1);
      }
      __syncwarp();
      if (i + RING - 1 < n_tiles) issue(i + RING - 1);
      if (ENGINE == 0) cp_async_commit();
      acc += (float)(ring + (i % RING) * tb)[lane * 4];
    }
    if (ENGINE == 0) cp_async_wait<0>();
  }
  const int64_t blk = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  sink[blk * 32 * WARPS + threadIdx.x] = acc;
}

template <int ENGINE>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s, const int8_t* k, const int8_t* v,
                   float* sink, int s_len, int hkv, int dk, int per_split) {
  const cudaError_t err = allow_smem(kv_copy_kernel<ENGINE>, smem);
  if (err != cudaSuccess) return err;
  kv_copy_kernel<ENGINE><<<grid, 32 * WARPS, smem, s>>>(k, v, sink, s_len, hkv, dk, per_split);
  return cudaGetLastError();
}

// ---- the paged pool, as csrc/paged_decode.cu streams it
struct PagedCopyArgs {
  const uint8_t* k;      // [L, P, ps, Hkv, Dk]
  const uint8_t* v;
  const float* ks;       // [L, P, ps, Hkv, 1], null for bf16 pools
  const float* vs;
  const int32_t* tables;   // [B, W]
  const int32_t* lengths;  // [B]
  float* sink;
  int layer, n_pages, ps, hkv, n_groups, dk, w, window, n_split, per_split, pitch,
      copy_bytes, copy_shift;
};

__global__ void __launch_bounds__(32 * WARPS) paged_copy_kernel(const PagedCopyArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, unit = blockIdx.y * WARPS + warp;
  const int h = unit % a.hkv, split = unit / (a.hkv * a.n_groups);
  float acc = 0.f;
  if (split < a.n_split) {
    const int length = min(a.lengths[b], a.w * a.ps);
    const int win_lo = a.window > 0 ? max(length + 1 - a.window, 0) : 0;
    const int p0 = win_lo + split * a.per_split, p1 = min(length, p0 + a.per_split);
    const int n_tiles = p1 > p0 ? (p1 - p0 + TT - 1) / TT : 0;
    const bool scales = a.ks != nullptr;
    const int tb = 2 * TT * a.pitch + (scales ? 2 * TT * 4 : 0);
    uint8_t* ring = smem + warp * RING * tb;
    const int32_t* table = a.tables + (int64_t)b * a.w;
    const int64_t layer_page = (int64_t)a.layer * a.n_pages;
    const int slots = (2 * TT) << a.copy_shift, cpr = a.dk / a.copy_bytes;
    auto fetch = [&](int i, int& pg, int& ip) {
      const int pos = p0 + i * TT + lane;
      const bool ok = lane < TT && i < n_tiles && pos < p1;
      pg = ok ? __ldg(table + pos / a.ps) : 0;
      ip = ok ? pos % a.ps : 0;
    };
    auto issue = [&](int i, int pg, int ip) {
      uint8_t* st = ring + (i % RING) * tb;
      const int t0 = p0 + i * TT;
      const int64_t tok = ((layer_page + pg) * a.ps + ip) * a.hkv + h;
      for (int c0 = 0; c0 < slots; c0 += 32) {
        const int c = c0 + lane, ch = c & ((1 << a.copy_shift) - 1);
        const int t = (c >> a.copy_shift) & (TT - 1), kv = (c >> a.copy_shift) >= TT;
        const int64_t row = __shfl_sync(0xffffffffu, tok, t);
        if (c < slots && ch < cpr) {
          const uint8_t* src = (kv ? a.v : a.k) + row * a.dk + ch * a.copy_bytes;
          uint8_t* dst = st + (kv * TT + t) * a.pitch + ch * a.copy_bytes;
          const bool ok = t0 + t < p1;
          if (a.copy_bytes == 16) {
            cp_async<16>(dst, src, ok);
          } else if (a.copy_bytes == 8) {
            cp_async<8>(dst, src, ok);
          } else {
            cp_async<4>(dst, src, ok);
          }
        }
      }
      const int t = lane & (TT - 1);
      const int64_t row = __shfl_sync(0xffffffffu, tok, t);
      if (scales && lane < 2 * TT)
        cp_async<4>(st + 2 * TT * a.pitch + 4 * lane, (lane < TT ? a.ks : a.vs) + row,
                    t0 + t < p1);
    };
    {
      int pg[RING - 1], ip[RING - 1];
#pragma unroll
      for (int i = 0; i < RING - 1; ++i) fetch(i, pg[i], ip[i]);
#pragma unroll
      for (int i = 0; i < RING - 1; ++i) {
        if (i < n_tiles) issue(i, pg[i], ip[i]);
        cp_async_commit();
      }
    }
    int pg_next, ip_next;
    fetch(RING - 1, pg_next, ip_next);
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<RING - 2>();
      __syncwarp();
      if (i + RING - 1 < n_tiles) issue(i + RING - 1, pg_next, ip_next);
      cp_async_commit();
      fetch(i + RING, pg_next, ip_next);
      acc += (float)(ring + (i % RING) * tb)[lane * 4];
    }
    cp_async_wait<0>();
  }
  const int64_t blk = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  a.sink[blk * 32 * WARPS + threadIdx.x] = acc;
}

}  // namespace

// sink: B * ceil(Hkv / 4) * n_split * 128 floats.
extern "C" int kv_copy_floor(int engine, const void* k, const void* v, void* sink, int batch,
                             int s_len, int hkv, int dk, int n_split, int per_split,
                             void* stream) {
  if (dk % 16 || dk > 128 || engine < 0 || engine > 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * RING * (2 * TT * dk + 8);
  const dim3 grid(batch, (hkv + WARPS - 1) / WARPS, n_split);
  auto* kp = static_cast<const int8_t*>(k);
  auto* vp = static_cast<const int8_t*>(v);
  auto* sp = static_cast<float*>(sink);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      engine == 0 ? launch<0>(grid, smem, s, kp, vp, sp, s_len, hkv, dk, per_split)
      : engine == 1 ? launch<1>(grid, smem, s, kp, vp, sp, s_len, hkv, dk, per_split)
                    : launch<2>(grid, smem, s, kp, vp, sp, s_len, hkv, dk, per_split);
  return (int)err;
}

// The paged pool's copies alone, in paged_decode_bf16's grid (B, ceil(Hkv *
// n_groups * n_split / 4)) and split; scale pointers null for bf16 pools.
// sink: B * grid_y * 128 floats.
extern "C" int paged_copy_floor(const void* k_pool, const void* v_pool, const void* k_scale,
                                const void* v_scale, const void* tables, const void* lengths,
                                void* sink, int batch, int layer, int n_pages, int ps, int hkv,
                                int d, int w, int kv_bits, int window, int n_groups,
                                int n_split, int per_split, void* stream) {
  const int dk = d * kv_bits / 8;
  if (dk % 4 || n_split < 1 || per_split % TT) return (int)cudaErrorInvalidValue;
  const uintptr_t base = reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool);
  int copy_bytes = 16;
  while (dk % copy_bytes || base % copy_bytes) copy_bytes /= 2;
  int copy_shift = 0;
  while ((1 << copy_shift) < dk / copy_bytes) ++copy_shift;
  int pitch = (dk + 15) / 16 * 16;
  if ((pitch / 16) % 2 == 0) pitch += 16;
  const size_t smem = (size_t)WARPS * RING * (2 * TT * pitch + (kv_bits < 16 ? 2 * TT * 4 : 0));
  const cudaError_t err = allow_smem(paged_copy_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const PagedCopyArgs a{static_cast<const uint8_t*>(k_pool), static_cast<const uint8_t*>(v_pool),
                        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                        static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lengths),
                        static_cast<float*>(sink), layer, n_pages, ps, hkv, n_groups, dk, w,
                        window, n_split, per_split, pitch, copy_bytes, copy_shift};
  const int units = hkv * n_groups * n_split;
  paged_copy_kernel<<<dim3(batch, (units + WARPS - 1) / WARPS), 32 * WARPS, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

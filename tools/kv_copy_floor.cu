// Copy-only streaming of a contiguous int8 KV cache [B, S, Hkv, Dk] in the
// layout and schedule of csrc/mqa_decode.cu (one warp per kv head, 4 adjacent
// heads a block, 8-token tiles through a 4-tile ring per warp, the same split
// of the positions), with no arithmetic: the floor the decode kernel's
// copies set.  Three copy engines: 16-byte cp.async (the kernel's), 16-byte
// loads staged through registers two tiles ahead, and one cp.async.bulk (TMA)
// copy per row completed on an mbarrier.  Built and run by
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

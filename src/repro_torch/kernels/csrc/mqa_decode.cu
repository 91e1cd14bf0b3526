// Flash-decode GQA attention for Hopper over a contiguous int8 / int4 KV cache:
// one new query token per row against the row's first lengths[b] cached tokens.
//
// Replaces repro/kernels/mqa_decode.py::mqa_decode_pallas (body _decode_kernel).
// Same function: q [B, Hkv, G, D] (bf16 or f32) against K/V [B, S, Hkv, Dk]
// int8 (Dk = D) or int4 nibble-packed along D (Dk = D / 2, even index in the
// low nibble), each (token, head) row with its f32 scale [B, S, Hkv, 1];
// softmax in f32 over positions [0, lengths[b]); out in q's type.  A row of
// length 0 gives 0 (the Pallas kernel's max(l, 1e-20)).
//
// TPU -> Hopper: the Pallas grid (b, kv_head, seq_block) carries m / l / acc
// across *sequential* seq_block steps, which Hopper blocks cannot do.  The
// sequence axis becomes a split of each row's positions: a warp runs the
// online softmax of one (row, kv head) over one split and, when the row has
// more than one split, writes a partial (m, l, acc); a second kernel merges
// the splits in split order (no atomics: the same inputs give the same
// bits).  With one split the warp writes the output itself.  The split comes
// from S on the host (kernels/mqa_decode.py::decode_plan), so lengths is never
// read back; a split past lengths[b] ends at once, and no position at or past
// lengths[b] is read.  S needs no padding.
//
// What bounds it on an H100: the bytes of the live K/V payload and scales
// (about 4 flops per K/V byte at G = 1), streamed as rows of D or D / 2
// bytes, one per (token, head), with the latency of each warp's chain of
// tiles on top.  So no block-wide barrier sits in the token loop and copies
// stay in flight during the arithmetic:
// - block (row, 4 adjacent kv heads, split): warp w takes kv head 4 (block) +
//   w, so the block's copies of one token cover 4 adjacent rows of memory;
// - each warp walks its split in 8-token tiles through its own ring of 4
//   tiles in shared memory, filled by cp.async 3 tiles ahead of the
//   arithmetic (rows as stored, int8 or packed int4, in 16-, 8- or 4-byte
//   copies by the row length and alignment, each scale a 4-byte copy); only
//   __syncwarp orders the ring;
// - scores take a quad per token: each lane holds its quarter of q (words
//   p, p + 4, ... of the row) in registers, dots it with the int row
//   (converted exactly in registers, no f32 staging) and the quad sums with
//   two shuffles; the key scale and sm_scale multiply the sum afterwards;
// - the warp's online softmax keeps m per query and l and acc in registers,
//   acc split over the lanes by 4-element units of D (at D = 112 lanes 0-27
//   own one, the rest none: ragged, not padded); p * v_scale enters P V.
// Rows sit in shared memory at a pitch of 16 x (odd) bytes, so the eight
// quads' word reads fall in distinct banks.  Softmax runs in log2 units.
#include "common.cuh"

namespace {

constexpr int MQA_TT = 8;     // tokens per warp tile: one per quad
constexpr int MQA_RING = 4;   // tiles per warp ring: 3 in flight while one is used
constexpr int MQA_WARPS = 4;  // kv heads a block takes, one per warp
constexpr int MQA_THREADS = 32 * MQA_WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MQA_DMAX = 128;  // head dims taken (q quarters in registers)
constexpr int MQA_GMAX = 4;    // queries per block; larger groups split over blocks

__device__ __forceinline__ float load_q(const void* q, int64_t i, bool q_f32) {
  return q_f32 ? static_cast<const float*>(q)[i]
               : __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
}
__device__ __forceinline__ void store_out(void* out, int64_t i, float x, bool q_f32) {
  if (q_f32) {
    static_cast<float*>(out)[i] = x;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  }
}

// The EPW values of one stored 32-bit word, exactly, without I2F: int8 bytes
// through s8_biased_to_f32; int4 nibbles biased to 0..15 become the low
// mantissa bits of 2^23 (ulp 1), then 2^23 + 8 is subtracted.
template <int KV_BITS>
__device__ __forceinline__ void unpack_word(uint32_t word, float (&f)[KV_BITS == 8 ? 4 : 8]) {
  if constexpr (KV_BITS == 8) {
    const uint32_t b = word ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = s8_biased_to_f32(b, j);
  } else {
    const uint32_t b = word ^ 0x88888888u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = __uint_as_float(0x4B000000u | ((b >> (4 * j)) & 0xFu)) - 8388616.f;
  }
}

// Elements 4u .. 4u + 3 of a stored row (a byte word for int8, a 16-bit half
// word for int4), exactly.
template <int KV_BITS>
__device__ __forceinline__ void unpack_unit(const uint8_t* row, int u, float (&f)[4]) {
  if constexpr (KV_BITS == 8) {
    const uint32_t b = *reinterpret_cast<const uint32_t*>(row + 4 * u) ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = s8_biased_to_f32(b, j);
  } else {
    const uint32_t b = *reinterpret_cast<const uint16_t*>(row + 2 * u) ^ 0x8888u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(0x4B000000u | ((b >> (4 * j)) & 0xFu)) - 8388616.f;
  }
}

// Stage bytes of one warp tile: K rows, V rows, then the K and V scales.
__host__ __device__ __forceinline__ int tile_bytes(int pitch) {
  return 2 * MQA_TT * pitch + 2 * MQA_TT * 4;
}

// The split kernel's arguments (see the entry point mqa_decode).
struct MqaArgs {
  const void* q;           // [B, Hkv, G, D], f32 when q_f32, else bf16
  const int8_t* k;         // [B, S, Hkv, Dk]
  const int8_t* v;
  const float* k_scale;    // [B, S, Hkv, 1]
  const float* v_scale;
  const int32_t* lengths;  // [B]
  void* out;               // [B, Hkv, G, D] in q's type
  float* part;             // [B, Hkv, splits, G * (D + 2)]
  int s_len, hkv, g_size, n_groups, d, pitch, copy_bytes, copy_shift, per_split;
  bool q_f32;
  float sm_scale;
};

// Block (b, kv-head block * groups + group, split); warp w takes kv head
// 4 * (head block) + w over all of the split's positions.  GQ: queries of the
// group handled here (compile-time, so q and acc stay in registers).
template <int KV_BITS, int GQ>
__global__ void __launch_bounds__(MQA_THREADS) mqa_decode_split_kernel(const MqaArgs a) {
  const int s_len = a.s_len, hkv = a.hkv, g_size = a.g_size, d = a.d, pitch = a.pitch;
  const int copy_bytes = a.copy_bytes, copy_shift = a.copy_shift;
  constexpr int EPW = KV_BITS == 8 ? 4 : 8;  // values per stored 32-bit word
  constexpr int WPL = MQA_DMAX / EPW / 4;    // row words per quad lane, at most
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, grp = blockIdx.y % a.n_groups, split = blockIdx.z;
  const int h = (blockIdx.y / a.n_groups) * MQA_WARPS + warp;
  if (h >= hkv) return;  // no block-wide barrier follows
  const int dk = d * KV_BITS / 8, dw = dk / 4, du = d / 4;
  const int tb = tile_bytes(pitch);
  uint8_t* ring = smem + warp * MQA_RING * tb;  // this warp's ring

  const int length = min(a.lengths[b], s_len);
  const int p0 = split * a.per_split;
  const int p1 = min(length, p0 + a.per_split);
  const int n_tiles = p1 > p0 ? (p1 - p0 + MQA_TT - 1) / MQA_TT : 0;

  // Tile i covers positions p0 + i * MQA_TT onwards.  Copy slots
  // of a tile: (K or V, token t, chunk ch) with 2^copy_shift >= dk /
  // copy_bytes chunk slots a row, so lane l always takes chunk l % 2^shift.
  const int cpr = dk / copy_bytes;
  const int ch = lane & ((1 << copy_shift) - 1);
  const int64_t rs = (int64_t)hkv * dk;  // bytes from one token's row to the next
  const int8_t* kb = a.k + ((int64_t)b * s_len * hkv + h) * dk + ch * copy_bytes;
  const int8_t* vb = a.v + ((int64_t)b * s_len * hkv + h) * dk + ch * copy_bytes;
  const int slots = (2 * MQA_TT) << copy_shift;
  auto issue = [&](int i) {
    uint8_t* st = ring + (i % MQA_RING) * tb;
    const int t0 = p0 + i * MQA_TT;
    if (ch < cpr) {
      for (int c = lane; c < slots; c += 32) {
        const int t = (c >> copy_shift) & (MQA_TT - 1), kv = c >> copy_shift >= MQA_TT;
        const bool ok = t0 + t < p1;
        const int8_t* src = (kv ? vb : kb) + (ok ? t0 + t : 0) * rs;
        uint8_t* dst = st + (kv * MQA_TT + t) * pitch + ch * copy_bytes;
        if (copy_bytes == 16) {
          cp_async<16>(dst, src, ok);
        } else if (copy_bytes == 8) {
          cp_async<8>(dst, src, ok);
        } else {
          cp_async<4>(dst, src, ok);
        }
      }
    }
    for (int c = lane; c < 2 * MQA_TT; c += 32) {  // scales: K then V, 4 bytes a token
      const int kv = c / MQA_TT, t = c % MQA_TT;
      const bool ok = t0 + t < p1;
      const int64_t row = ((int64_t)b * s_len + (ok ? t0 + t : 0)) * hkv + h;
      cp_async<4>(st + 2 * MQA_TT * pitch + 4 * c, (kv ? a.v_scale : a.k_scale) + row, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < MQA_RING - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();  // empty groups keep the count uniform
  }

  // this lane's quarter of each query: words p, p + 4, ... of the row
  const int tq = lane >> 2, p = lane & 3;  // quad, and lane in the quad
  float qr[GQ][WPL * EPW];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const int gi = grp * GQ + g;
    const int64_t qb = ((int64_t)(b * hkv + h) * g_size + gi) * d;
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const int w = p + 4 * i;
#pragma unroll
      for (int e = 0; e < EPW; ++e)
        qr[g][i * EPW + e] =
            gi < g_size && w < dw ? load_q(a.q, qb + w * EPW + e, a.q_f32) : 0.f;
    }
  }
  float m[GQ], l[GQ], acc[GQ][4];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    m[g] = SOFTMAX_M0;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<MQA_RING - 2>();  // tile i has landed (this lane's copies)
    __syncwarp();                   // ... every lane's; tile i - 1's slot is free
    if (i + MQA_RING - 1 < n_tiles) issue(i + MQA_RING - 1);
    cp_async_commit();
    const uint8_t* st = ring + (i % MQA_RING) * tb;
    const float* sc = reinterpret_cast<const float*>(st + 2 * MQA_TT * pitch);
    const int t0 = p0 + i * MQA_TT;

    // scores: quad tq takes token tq of the tile
    float s[GQ];
#pragma unroll
    for (int g = 0; g < GQ; ++g) s[g] = 0.f;
    const uint8_t* krow = st + tq * pitch;
#pragma unroll
    for (int wi = 0; wi < WPL; ++wi) {
      const int w = p + 4 * wi;
      if (w < dw) {
        float kf[EPW];
        unpack_word<KV_BITS>(*reinterpret_cast<const uint32_t*>(krow + 4 * w), kf);
#pragma unroll
        for (int g = 0; g < GQ; ++g)
#pragma unroll
          for (int e = 0; e < EPW; ++e) s[g] = fmaf(qr[g][wi * EPW + e], kf[e], s[g]);
      }
    }
    const bool live = t0 + tq < p1;
    const float k_sc = sc[tq] * a.sm_scale * LOG2E, v_sc = sc[MQA_TT + tq];
    float pv[GQ];
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      // in log2 units: s * k_scale * sm_scale * log2(e)
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
      const float sg = live ? s[g] * k_sc : -INFINITY;
      float mx = fmaxf(sg, __shfl_xor_sync(0xffffffffu, sg, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[g], mx);  // finite: the tile has a live token
      const float alpha = exp2f(m[g] - m_new);
      const float pt = exp2f(sg - m_new);  // 0 for a masked token
      l[g] = l[g] * alpha + pt;  // this quad's token; the quads are summed at the end
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
      m[g] = m_new;
      pv[g] = pt * v_sc;
    }
    // P V: lane u owns elements 4u .. 4u + 3 (lanes past D / 4 own none)
    const uint8_t* vrows = st + MQA_TT * pitch;
#pragma unroll
    for (int t = 0; t < MQA_TT; ++t) {
      float vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (lane < du) unpack_unit<KV_BITS>(vrows + t * pitch, lane, vf);
#pragma unroll
      for (int g = 0; g < GQ; ++g) {
        const float pw = __shfl_sync(0xffffffffu, pv[g], 4 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pw, vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  const int64_t bh = (int64_t)b * hkv + h;
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    const int gi = grp * GQ + g;
    if (gi >= g_size) break;
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 4);  // sum the quads' tokens
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 8);
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 16);
    if (gridDim.z == 1) {
      const float inv = 1.f / fmaxf(l[g], 1e-20f);
      if (lane < du) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store_out(a.out, (bh * g_size + gi) * d + 4 * lane + e, acc[g][e] * inv, a.q_f32);
      }
    } else {
      float* pr = a.part + (bh * gridDim.z + split) * g_size * (d + 2);
      if (lane == 0) {
        pr[gi] = m[g];
        pr[g_size + gi] = l[g];
      }
      if (lane < du) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[2 * g_size + gi * d + 4 * lane + e] = acc[g][e];
      }
    }
  }
}

// Merges the splits of one (row, kv head) in split order.
__global__ void __launch_bounds__(MQA_THREADS)
mqa_decode_combine_kernel(const float* __restrict__ part,  // [B, Hkv, splits, G * (D + 2)]
                          void* __restrict__ out,           // [B, Hkv, G, D]
                          int hkv, int g_size, int d, int n_split, bool q_f32) {
  extern __shared__ float cmb[];
  const int64_t bh = (int64_t)blockIdx.x * hkv + blockIdx.y;
  const int tid = threadIdx.x;
  const int stride = g_size * (d + 2);
  float* c_s = cmb;                      // [splits][G] merge weights
  float* l_s = c_s + n_split * g_size;   // [G] merged denominator
  const float* pb = part + bh * n_split * stride;
  for (int gi = tid; gi < g_size; gi += blockDim.x) {
    float mx = SOFTMAX_M0;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pb[s * stride + gi]);
    float denom = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float c = exp2f(pb[s * stride + gi] - mx);  // m in log2 units
      c_s[s * g_size + gi] = c;
      denom += pb[s * stride + g_size + gi] * c;
    }
    l_s[gi] = fmaxf(denom, 1e-20f);
  }
  __syncthreads();
  for (int i = tid; i < g_size * d; i += blockDim.x) {
    const int gi = i / d;
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) acc += c_s[s * g_size + gi] * pb[s * stride + 2 * g_size + i];
    store_out(out, bh * g_size * d + i, acc / l_s[gi], q_f32);
  }
}

template <int KV_BITS, int GQ>
cudaError_t launch_split(const MqaArgs& a, dim3 grid, size_t smem, cudaStream_t s) {
  const cudaError_t err = allow_smem(mqa_decode_split_kernel<KV_BITS, GQ>, smem);
  if (err != cudaSuccess) return err;
  mqa_decode_split_kernel<KV_BITS, GQ><<<grid, MQA_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int KV_BITS>
cudaError_t dispatch_groups(int gq, const MqaArgs& a, dim3 grid, size_t smem, cudaStream_t s) {
  switch (gq) {
    case 1: return launch_split<KV_BITS, 1>(a, grid, smem, s);
    case 2: return launch_split<KV_BITS, 2>(a, grid, smem, s);
    case 3: return launch_split<KV_BITS, 3>(a, grid, smem, s);
    case 4: return launch_split<KV_BITS, 4>(a, grid, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Pointers are device pointers.  q and out are f32 when q_f32 != 0, else
// bf16.  kv_bits is 8 or 4; head dims up to 128 with rows of whole 32-bit
// words.  Split i covers positions [i * per_split, (i + 1) * per_split), a
// whole number of 8-token tiles, and the n_split splits cover S
// (kernels/mqa_decode.py::decode_plan); part is [B, Hkv, n_split, G * (D + 2)]
// f32 scratch when n_split > 1 (else unused).  Returns cudaErrorInvalidValue
// without launching on arguments it does not take, else cudaGetLastError()
// after the launches.
extern "C" int mqa_decode(const void* q, const void* k, const void* v, const void* k_scale,
                          const void* v_scale, const void* lengths, void* out, void* part,
                          int batch, int s_len, int hkv, int g_size, int d, int kv_bits,
                          int q_f32, int n_split, int per_split, float sm_scale,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dk = kv_bits == 8 ? d : d / 2;
  if ((kv_bits != 8 && kv_bits != 4) || d < 2 || d > MQA_DMAX || d % 2 || dk % 4 ||
      g_size < 1 || n_split < 1 || per_split < 1 || per_split % MQA_TT ||
      (int64_t)n_split * per_split < s_len || (int64_t)(n_split - 1) * per_split >= s_len) {
    return (int)cudaErrorInvalidValue;
  }
  // copy width: the widest of 16 / 8 / 4 bytes that splits the rows and the bases
  const uintptr_t base = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  int copy_bytes = 16;
  while (dk % copy_bytes || base % copy_bytes) copy_bytes /= 2;
  if (copy_bytes < 4) return (int)cudaErrorInvalidValue;
  int copy_shift = 0;
  while ((1 << copy_shift) < dk / copy_bytes) ++copy_shift;
  int pitch = (dk + 15) / 16 * 16;  // 16 x odd bytes: conflict-free quad reads
  if ((pitch / 16) % 2 == 0) pitch += 16;
  const int n_groups = (g_size + MQA_GMAX - 1) / MQA_GMAX;
  const int gq = (g_size + n_groups - 1) / n_groups;
  const size_t smem = (size_t)MQA_WARPS * MQA_RING * tile_bytes(pitch);
  const dim3 grid(batch, (hkv + MQA_WARPS - 1) / MQA_WARPS * n_groups, n_split);
  const MqaArgs a{q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                  static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                  static_cast<const int32_t*>(lengths), out, static_cast<float*>(part),
                  s_len, hkv, g_size, n_groups, d, pitch, copy_bytes, copy_shift, per_split,
                  q_f32 != 0, sm_scale};
  const cudaError_t err = kv_bits == 8 ? dispatch_groups<8>(gq, a, grid, smem, s)
                                       : dispatch_groups<4>(gq, a, grid, smem, s);
  if (err != cudaSuccess) return (int)err;
  if (n_split > 1) {
    const size_t smem2 = sizeof(float) * (n_split + 1) * g_size;
    const cudaError_t e2 = allow_smem(mqa_decode_combine_kernel, smem2);
    if (e2 != cudaSuccess) return (int)e2;
    mqa_decode_combine_kernel<<<dim3(batch, hkv), MQA_THREADS, smem2, s>>>(
        a.part, out, hkv, g_size, d, n_split, q_f32 != 0);
  }
  return (int)cudaGetLastError();
}

// Flash-decode GQA attention for Hopper over a contiguous int8 / int4 KV cache:
// one new query token per row against the row's first lengths[b] cached tokens.
//
// Replaces repro/kernels/mqa_decode.py::mqa_decode_pallas (body _decode_kernel).
// Same function: q [B, Hkv, G, D] (bf16 or f32) against K/V [B, S, Hkv, Dk]
// int8 (Dk = D) or int4 nibble-packed along D (Dk = D / 2, even index in the
// low nibble), each (token, head) row dequantized in registers with its f32
// scale [B, S, Hkv, 1]; softmax over positions [0, lengths[b]); out in q's
// type.  A row of length 0 gives 0 (the Pallas kernel's max(l, 1e-20)).
//
// TPU -> Hopper: the Pallas grid (b, kv_head, seq_block) carries m / l / acc
// across *sequential* seq_block steps, which Hopper blocks cannot do.  As in
// paged_decode.cu, the sequence axis becomes a split of each row's positions:
// block (b, kv_head, split) runs the online softmax over its positions and
// writes a partial (m, l, acc); a second kernel, one block per (b, kv_head),
// merges the splits in split order (no atomics: the same inputs give the
// same bits).  The split count comes from S on the host, so lengths is never
// read back; a split past lengths[b] ends at once and writes an empty partial
// (m = SOFTMAX_M0, l = 0), and no position at or past lengths[b] is read.
// S needs no padding: the last tile of a split is ragged.
//
// What bounds it on an H100: bytes (the live K/V payload and scales; about
// 4 flops per K/V byte at G = 1).  Each 32-token tile is dequantized into
// shared memory with 32-bit loads (common.cuh: load_kv_tile); the scores are
// one warp per (query, token) pair with the lanes splitting D (D = 112 at
// zamba2 is 3.5 words per lane: the loop is ragged, not padded), the online
// softmax one warp per query with a lane per token, the weighted sum one
// thread per (query, dim).  CUDA cores in f32: simple, not tuned (no
// cp.async pipelining or tensor cores).
#include "common.cuh"

namespace {

constexpr int MQA_THREADS = 128;
constexpr int MQA_WARPS = MQA_THREADS / 32;
constexpr int MQA_KT = 32;  // tokens per tile: one lane per token in the softmax

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(MQA_THREADS)
mqa_decode_split_kernel(const T* __restrict__ q,                // [B, Hkv, G, D]
                        const int8_t* __restrict__ k,           // [B, S, Hkv, Dk]
                        const int8_t* __restrict__ v,
                        const float* __restrict__ k_scale,      // [B, S, Hkv, 1]
                        const float* __restrict__ v_scale,
                        const int32_t* __restrict__ lengths,    // [B]
                        float* __restrict__ part,  // [B, Hkv, splits, G * (D + 2)]
                        int s_len, int hkv, int g_size, int d, int kv_bits, int per_split,
                        float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ldk = d + 1;  // padded K rows
  int64_t* rows_s = reinterpret_cast<int64_t*>(smem);  // [KT] payload rows
  float* q_s = smem + 2 * MQA_KT;      // [G][D]
  float* acc_s = q_s + g_size * d;     // [G][D]
  float* k_s = acc_s + g_size * d;     // [KT][D + 1]
  float* v_s = k_s + MQA_KT * ldk;     // [KT][D]
  float* p_s = v_s + MQA_KT * d;       // [G][KT] scores, then probabilities
  float* m_s = p_s + g_size * MQA_KT;  // [G] running max
  float* l_s = m_s + g_size;           // [G] running denominator
  float* a_s = l_s + g_size;           // [G] rescale of this tile

  const int length = min(lengths[b], s_len);
  const int p0 = split * per_split;
  const int p1 = min(length, p0 + per_split);

  const T* qb = q + (int64_t)(b * hkv + h) * g_size * d;
  for (int i = tid; i < g_size * d; i += blockDim.x) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < g_size; i += blockDim.x) {
    m_s[i] = SOFTMAX_M0;
    l_s[i] = 0.f;
  }
  __syncthreads();

  for (int t0 = p0; t0 < p1; t0 += MQA_KT) {
    const int nt = min(MQA_KT, p1 - t0);
    for (int t = tid; t < nt; t += blockDim.x)
      rows_s[t] = ((int64_t)b * s_len + t0 + t) * hkv + h;
    __syncthreads();
    load_kv_tile(k, v, k_scale, v_scale, rows_s, nt, d, kv_bits, k_s, ldk, v_s);
    __syncthreads();
    // scores: one warp per (query g, token t), the lanes split D
    for (int i = warp; i < g_size * MQA_KT; i += MQA_WARPS) {
      const int gi = i / MQA_KT, t = i % MQA_KT;
      if (t >= nt) {  // warp-uniform
        if (lane == 0) p_s[i] = -INFINITY;
        continue;
      }
      float dot = 0.f;
      for (int e = lane; e < d; e += 32) dot += q_s[gi * d + e] * k_s[t * ldk + e];
      dot = warp_sum(dot);
      if (lane == 0) p_s[i] = dot * sm_scale;
    }
    __syncthreads();
    // online softmax: one warp per query, lane = token (masked scores are
    // -inf and give p = 0; the tile holds at least one live token)
    for (int gi = warp; gi < g_size; gi += MQA_WARPS) {
      const float s = p_s[gi * MQA_KT + lane];
      const float m_prev = m_s[gi];
      const float mx = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - mx);
      const float sum = warp_sum(p);
      p_s[gi * MQA_KT + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = mx;
        a_s[gi] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < g_size * d; i += blockDim.x) {
      const int gi = i / d, e = i % d;
      float acc = acc_s[i] * a_s[gi];
      for (int t = 0; t < nt; ++t) acc += p_s[gi * MQA_KT + t] * v_s[t * d + e];
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  // partial of this split: m [G], l [G], acc [G][D]
  float* out = part + ((int64_t)(b * hkv + h) * gridDim.z + split) * g_size * (d + 2);
  for (int i = tid; i < g_size; i += blockDim.x) {
    out[i] = m_s[i];
    out[g_size + i] = l_s[i];
  }
  for (int i = tid; i < g_size * d; i += blockDim.x) out[2 * g_size + i] = acc_s[i];
}

// Merges the splits of one (row, kv head) in split order.
template <typename T>
__global__ void __launch_bounds__(MQA_THREADS)
mqa_decode_combine_kernel(const float* __restrict__ part,  // [B, Hkv, splits, G * (D + 2)]
                          T* __restrict__ out,              // [B, Hkv, G, D]
                          int hkv, int g_size, int d, int n_split) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x * hkv + blockIdx.y, tid = threadIdx.x;
  const int stride = g_size * (d + 2);
  float* c_s = smem;                     // [splits][G] merge weights
  float* l_s = c_s + n_split * g_size;   // [G] merged denominator
  const float* pb = part + (int64_t)bh * n_split * stride;
  for (int gi = tid; gi < g_size; gi += blockDim.x) {
    float mx = SOFTMAX_M0;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pb[s * stride + gi]);
    float denom = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float c = expf(pb[s * stride + gi] - mx);
      c_s[s * g_size + gi] = c;
      denom += pb[s * stride + g_size + gi] * c;
    }
    l_s[gi] = fmaxf(denom, 1e-20f);
  }
  __syncthreads();
  T* ob = out + (int64_t)bh * g_size * d;
  for (int i = tid; i < g_size * d; i += blockDim.x) {
    const int gi = i / d;
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) acc += c_s[s * g_size + gi] * pb[s * stride + 2 * g_size + i];
    store_f32(ob + i, acc / l_s[gi]);
  }
}

size_t split_smem_bytes(int g_size, int d) {
  return sizeof(float) * (2 * MQA_KT + 2 * g_size * d + MQA_KT * (d + 1) + MQA_KT * d +
                          g_size * MQA_KT + 3 * g_size);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* lengths, void* out, void* part, int batch,
           int s_len, int hkv, int g_size, int d, int kv_bits, int n_split, int per_split,
           float sm_scale, cudaStream_t s) {
  const size_t smem1 = split_smem_bytes(g_size, d);
  const size_t smem2 = sizeof(float) * (n_split + 1) * g_size;
  cudaError_t err = allow_smem(mqa_decode_split_kernel<T>, smem1);
  if (err == cudaSuccess) err = allow_smem(mqa_decode_combine_kernel<T>, smem2);
  if (err != cudaSuccess) return (int)err;
  mqa_decode_split_kernel<T><<<dim3(batch, hkv, n_split), MQA_THREADS, smem1, s>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(lengths), static_cast<float*>(part), s_len, hkv, g_size,
      d, kv_bits, per_split, sm_scale);
  mqa_decode_combine_kernel<T><<<dim3(batch, hkv), MQA_THREADS, smem2, s>>>(
      static_cast<const float*>(part), static_cast<T*>(out), hkv, g_size, d, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers are device pointers.  q and out are f32 when q_f32 != 0, else
// bf16.  part: [B, Hkv, n_split, G * (D + 2)] f32 scratch; split i covers
// positions [i * per_split, (i + 1) * per_split).  kv_bits is 8 or 4.
// Returns cudaGetLastError() after the two launches.
extern "C" int mqa_decode(const void* q, const void* k, const void* v, const void* k_scale,
                          const void* v_scale, const void* lengths, void* out, void* part,
                          int batch, int s_len, int hkv, int g_size, int d, int kv_bits,
                          int q_f32, int n_split, int per_split, float sm_scale,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_f32)
    return launch<float>(q, k, v, k_scale, v_scale, lengths, out, part, batch, s_len, hkv,
                         g_size, d, kv_bits, n_split, per_split, sm_scale, s);
  return launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, lengths, out, part, batch, s_len,
                               hkv, g_size, d, kv_bits, n_split, per_split, sm_scale, s);
}

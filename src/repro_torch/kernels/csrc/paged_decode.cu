// Paged flash-decode GQA attention for Hopper: one new token per row against
// the paged KV pool, read in place through the page tables.
//
// Replaces repro/kernels/paged_decode.py::paged_mqa_decode_pallas (body
// _paged_kernel).  Same function: q [B, Hkv, G, D] against pool pages
// [L, P, ps, Hkv, Dk] (int8, int4 nibble-packed along D, or bf16), int
// payloads dequantized in registers with their per-(token, head) f32 scales,
// an online softmax over the row's live tokens, an optional sliding window,
// and the step's own not-yet-stored token fused in as the last term.
//
// TPU -> Hopper: the Pallas grid (b, kv_head, page_slot) carries m / l / acc
// across *sequential* grid steps.  Blocks run in no order here, so the slot
// axis becomes a split of each row's positions (flash-decoding): block
// (b, kv_head, split) runs the online softmax over its share of the row's
// live positions in shared memory and writes its partial (m, l, acc); a
// second kernel, one block per (b, kv_head), merges the splits in a fixed
// order (no atomics: the same inputs give the same bits) and fuses in the new
// token.  The Pallas index map clamps dead slots; here that becomes the loop
// bounds: positions [win_lo, length) with win_lo = max(length + 1 - window,
// 0), i.e. table slots [win_lo / ps, ceil(length / ps)).  No position at or
// past `length` is read: tables are zero-padded, so a dead slot points at a
// real page 0 that belongs to another request.  length == 0 attends to the
// new token only.  The block computes its pool offsets from the layer, the
// page id, the in-page slot and the head itself.
//
// What bounds it on an H100: bytes (the live K/V pages and their scales,
// about 4 flops per K/V byte at G = 3).  Each 32-token tile first resolves
// its page ids into shared memory, then every thread issues 32-bit loads
// of payload words back to back (common.cuh: load_kv_tile); the split keeps
// enough blocks in flight to cover the load latency.  Scores and the
// weighted sum run on the CUDA cores in f32 from shared memory: simple, not
// tuned (no cp.async pipelining or tensor cores yet).
#include "common.cuh"

namespace {

constexpr int DEC_THREADS = 128;
constexpr int DEC_KT = 32;  // tokens per tile

__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hkv, G, D]
                          const void* __restrict__ k_pool,  // [L, P, ps, Hkv, Dk]
                          const void* __restrict__ v_pool,
                          const float* __restrict__ k_scale,  // [L, P, ps, Hkv, 1] or null
                          const float* __restrict__ v_scale,
                          const int32_t* __restrict__ tables,   // [B, W]
                          const int32_t* __restrict__ lengths,  // [B]
                          float* __restrict__ part,  // [B, Hkv, S, G * (D + 2)]
                          int layer, int n_pages, int ps, int hkv, int g_size, int d,
                          int w, int kv_bits, int window, int per_split,
                          float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z, tid = threadIdx.x;
  const int ldk = d + 1;  // padded K rows: conflict-free score reads
  int64_t* rows_s = reinterpret_cast<int64_t*>(smem);  // [KT] payload rows
  float* q_s = smem + 2 * DEC_KT;      // [G][D]
  float* acc_s = q_s + g_size * d;     // [G][D]
  float* k_s = acc_s + g_size * d;     // [KT][D + 1]
  float* v_s = k_s + DEC_KT * ldk;     // [KT][D]
  float* p_s = v_s + DEC_KT * d;       // [G][KT] scores, then probabilities
  float* m_s = p_s + g_size * DEC_KT;  // [G] running max
  float* l_s = m_s + g_size;           // [G] running denominator
  float* a_s = l_s + g_size;           // [G] rescale of this step

  const int length = lengths[b];
  const int win_lo = window > 0 ? max(length + 1 - window, 0) : 0;
  const int p0 = win_lo + split * per_split;
  const int p1 = min(length, p0 + per_split);

  const __nv_bfloat16* qb = q + (int64_t)(b * hkv + h) * g_size * d;
  for (int i = tid; i < g_size * d; i += blockDim.x) {
    q_s[i] = __bfloat162float(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < g_size; i += blockDim.x) {
    m_s[i] = SOFTMAX_M0;
    l_s[i] = 0.f;
  }
  __syncthreads();

  for (int t0 = p0; t0 < p1; t0 += DEC_KT) {
    const int nt = min(DEC_KT, p1 - t0);
    for (int t = tid; t < nt; t += blockDim.x) {
      const int pos = t0 + t;
      const int page = tables[(int64_t)b * w + pos / ps];
      const int64_t tok = ((int64_t)layer * n_pages + page) * ps + pos % ps;
      rows_s[t] = tok * hkv + h;
    }
    __syncthreads();
    load_kv_tile(k_pool, v_pool, k_scale, v_scale, rows_s, nt, d, kv_bits, k_s, ldk, v_s);
    __syncthreads();
    for (int i = tid; i < g_size * DEC_KT; i += blockDim.x) {
      const int gi = i / DEC_KT, t = i % DEC_KT;
      float s = -INFINITY;
      if (t < nt) {
        float dot = 0.f;
        for (int e = 0; e < d; ++e) dot += q_s[gi * d + e] * k_s[t * ldk + e];
        s = dot * sm_scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    for (int gi = tid; gi < g_size; gi += blockDim.x) {
      const float m_prev = m_s[gi];
      float mx = m_prev;
      for (int t = 0; t < nt; ++t) mx = fmaxf(mx, p_s[gi * DEC_KT + t]);
      const float alpha = expf(m_prev - mx);
      float sum = 0.f;
      for (int t = 0; t < DEC_KT; ++t) {
        const float p = t < nt ? expf(p_s[gi * DEC_KT + t] - mx) : 0.f;
        p_s[gi * DEC_KT + t] = p;
        sum += p;
      }
      l_s[gi] = l_s[gi] * alpha + sum;
      m_s[gi] = mx;
      a_s[gi] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < g_size * d; i += blockDim.x) {
      const int gi = i / d, e = i % d;
      float acc = acc_s[i] * a_s[gi];
      for (int t = 0; t < nt; ++t) acc += p_s[gi * DEC_KT + t] * v_s[t * d + e];
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  // partial of this split: m [G], l [G], acc [G][D] (m = SOFTMAX_M0 and
  // l = 0 when the split holds no live position)
  float* out = part + ((int64_t)(b * hkv + h) * gridDim.z + split) * g_size * (d + 2);
  for (int i = tid; i < g_size; i += blockDim.x) {
    out[i] = m_s[i];
    out[g_size + i] = l_s[i];
  }
  for (int i = tid; i < g_size * d; i += blockDim.x) out[2 * g_size + i] = acc_s[i];
}

// Merges the splits of one (row, kv head) in split order and fuses in the
// step's own token (always valid: distance 0 from itself).
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_combine_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hkv, G, D]
                            const void* __restrict__ new_k,       // [B, Hkv, Dk]
                            const void* __restrict__ new_v,
                            const float* __restrict__ new_k_scale,  // [B, Hkv, 1] or null
                            const float* __restrict__ new_v_scale,
                            const float* __restrict__ part,  // [B, Hkv, S, G * (D + 2)]
                            __nv_bfloat16* __restrict__ out,  // [B, Hkv, G, D]
                            int hkv, int g_size, int d, int kv_bits, int n_split,
                            float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int bh = b * hkv + h;
  float* q_s = smem;                     // [G][D]
  float* nk_s = q_s + g_size * d;        // [D]
  float* nv_s = nk_s + d;                // [D]
  float* c_s = nv_s + d;                 // [S + 1][G] merge weights
  float* l_s = c_s + (n_split + 1) * g_size;  // [G] merged denominator

  const __nv_bfloat16* qb = q + (int64_t)bh * g_size * d;
  for (int i = tid; i < g_size * d; i += blockDim.x) q_s[i] = __bfloat162float(qb[i]);
  const int64_t nrow = (int64_t)bh * (kv_bits == 4 ? d / 2 : d);
  for (int e = tid; e < d; e += blockDim.x) {
    float kv = load_kv(new_k, nrow, e, kv_bits);
    float vv = load_kv(new_v, nrow, e, kv_bits);
    if (kv_bits < 16) {
      kv *= new_k_scale[bh];
      vv *= new_v_scale[bh];
    }
    nk_s[e] = kv;
    nv_s[e] = vv;
  }
  __syncthreads();
  const float* pb = part + (int64_t)bh * n_split * g_size * (d + 2);
  for (int gi = tid; gi < g_size; gi += blockDim.x) {
    float dot = 0.f;
    for (int e = 0; e < d; ++e) dot += q_s[gi * d + e] * nk_s[e];
    const float s_new = dot * sm_scale;
    float mx = s_new;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pb[s * g_size * (d + 2) + gi]);
    float denom = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps_ = pb + s * g_size * (d + 2);
      const float c = expf(ps_[gi] - mx);
      c_s[s * g_size + gi] = c;
      denom += ps_[g_size + gi] * c;
    }
    const float c_new = expf(s_new - mx);
    c_s[n_split * g_size + gi] = c_new;
    l_s[gi] = fmaxf(denom + c_new, 1e-20f);
  }
  __syncthreads();
  __nv_bfloat16* ob = out + (int64_t)bh * g_size * d;
  for (int i = tid; i < g_size * d; i += blockDim.x) {
    const int gi = i / d, e = i % d;
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s)
      acc += c_s[s * g_size + gi] * pb[s * g_size * (d + 2) + 2 * g_size + i];
    acc += c_s[n_split * g_size + gi] * nv_s[e];
    ob[i] = __float2bfloat16(acc / l_s[gi]);
  }
}

size_t split_smem_bytes(int g_size, int d) {
  return sizeof(float) * (2 * DEC_KT + 2 * g_size * d + DEC_KT * (d + 1) + DEC_KT * d +
                          g_size * DEC_KT + 3 * g_size);
}

size_t combine_smem_bytes(int g_size, int d, int n_split) {
  return sizeof(float) * (g_size * d + 2 * d + (n_split + 1) * g_size + g_size);
}

}  // namespace

// Positions one split covers: a whole number of tiles.
extern "C" int paged_decode_tile_tokens() { return DEC_KT; }

// Pointers are device pointers; scale pointers are null when kv_bits == 16.
// part: [B, Hkv, n_split, G * (D + 2)] f32 scratch; each split covers
// per_split positions from the row's window start.  window <= 0 means no
// window.  Returns cudaGetLastError() after the two launches.
extern "C" int paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                 const void* k_scale, const void* v_scale,
                                 const void* tables, const void* lengths,
                                 const void* new_k, const void* new_v,
                                 const void* new_k_scale, const void* new_v_scale,
                                 void* out, void* part, int batch, int layer, int n_pages,
                                 int ps, int hkv, int g_size, int d, int w, int kv_bits,
                                 int window, int n_split, int per_split, float sm_scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = split_smem_bytes(g_size, d);
  const size_t smem2 = combine_smem_bytes(g_size, d, n_split);
  cudaError_t err = allow_smem(paged_decode_split_kernel, smem1);
  if (err == cudaSuccess) err = allow_smem(paged_decode_combine_kernel, smem2);
  if (err != cudaSuccess) return (int)err;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  paged_decode_split_kernel<<<dim3(batch, hkv, n_split), DEC_THREADS, smem1, s>>>(
      qp, k_pool, v_pool, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<float*>(part), layer, n_pages, ps,
      hkv, g_size, d, w, kv_bits, window, per_split, sm_scale);
  paged_decode_combine_kernel<<<dim3(batch, hkv), DEC_THREADS, smem2, s>>>(
      qp, new_k, new_v, static_cast<const float*>(new_k_scale),
      static_cast<const float*>(new_v_scale), static_cast<const float*>(part),
      static_cast<__nv_bfloat16*>(out), hkv, g_size, d, kv_bits, n_split, sm_scale);
  return (int)cudaGetLastError();
}

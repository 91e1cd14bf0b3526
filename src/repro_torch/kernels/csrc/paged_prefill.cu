// Paged chunk-prefill GQA attention for Hopper: a C-token query chunk against
// the paged KV pool plus the chunk's own K/V under a causal mask.
//
// Replaces repro/kernels/paged_prefill.py::paged_mqa_prefill_pallas (body
// _prefill_kernel).  Same function: q [B, Hkv, C, G, D] (query rows
// r = c * G + g) attends to (a) the ctx_lens[b] tokens already in the pool,
// read in place through the page table and dequantized in registers, and
// (b) the chunk's not-yet-stored K/V [B, Hkv, C, Dk], where key j is visible
// to query c iff j <= c and j < q_lens[b].  Pool keys all sit below ctx, so
// they are causal for free; a sliding window masks per query-key distance.
// Padding query rows (c >= q_len) come out finite: they see the pool and the
// valid chunk keys, and a row that sees nothing normalises 0 / 1e-20 = 0.
//
// TPU -> Hopper: the Pallas kernel holds a whole chunk's [C*G, D] f32
// accumulator in VMEM and walks page slots as a sequential grid axis.  At
// C = 128, G = 3, D = 128 that accumulator alone is 196 KB, so here the query
// rows are tiled across blocks: grid (b, kv_head, query tile of 16 rows),
// each block looping over the live pool positions [win_lo, ctx) (win_lo =
// max(ctx + 1 - window, 0), the first query's window start) and then over
// the chunk keys it can see, carrying m / l / acc in shared memory.
//
// What bounds it on an H100: at serving chunk sizes, the score and value
// products (operations); at small chunks, the K/V bytes.  Each 32-key tile
// resolves its payload rows into shared memory first, then every thread
// issues 32-bit payload loads back to back (common.cuh: load_kv_tile).
// Scores and the weighted sum run on the CUDA cores in f32 from shared
// memory, and each K/V tile is re-read once per query tile (from L2):
// simple, not tuned; tensor-core (wgmma) tiles are later work.
#include "common.cuh"

namespace {

constexpr int PF_THREADS = 128;
constexpr int PF_TQ = 16;  // query rows per block
constexpr int PF_KT = 32;  // keys per tile

struct Tile {
  int64_t* rows_s;  // [KT] payload rows of the staged keys
  float* q_s;    // [TQ][D]
  float* acc_s;  // [TQ][D]
  float* k_s;    // [KT][D + 1]
  float* v_s;    // [KT][D]
  float* p_s;    // [TQ][KT]
  float* m_s;    // [TQ]
  float* l_s;    // [TQ]
  float* a_s;    // [TQ]
};

// One online-softmax step over a staged K/V tile of nt keys.  valid(i, t)
// says whether query row i of the block sees key t of the tile.
template <typename Valid>
__device__ void online_update(const Tile& s, int d, int nt, float sm_scale,
                              Valid valid) {
  const int tid = threadIdx.x;
  const int ldk = d + 1;
  for (int i = tid; i < PF_TQ * PF_KT; i += blockDim.x) {
    const int r = i / PF_KT, t = i % PF_KT;
    float sc = -INFINITY;
    if (t < nt && valid(r, t)) {
      float dot = 0.f;
      for (int e = 0; e < d; ++e) dot += s.q_s[r * d + e] * s.k_s[t * ldk + e];
      sc = dot * sm_scale;
    }
    s.p_s[i] = sc;
  }
  __syncthreads();
  for (int r = tid; r < PF_TQ; r += blockDim.x) {
    const float m_prev = s.m_s[r];
    float mx = m_prev;
    for (int t = 0; t < nt; ++t) mx = fmaxf(mx, s.p_s[r * PF_KT + t]);
    const float alpha = expf(m_prev - mx);
    float sum = 0.f;
    for (int t = 0; t < PF_KT; ++t) {
      const float sc = s.p_s[r * PF_KT + t];
      const float p = (t < nt && sc != -INFINITY) ? expf(sc - mx) : 0.f;
      s.p_s[r * PF_KT + t] = p;
      sum += p;
    }
    s.l_s[r] = s.l_s[r] * alpha + sum;
    s.m_s[r] = mx;
    s.a_s[r] = alpha;
  }
  __syncthreads();
  for (int i = tid; i < PF_TQ * d; i += blockDim.x) {
    const int r = i / d, e = i % d;
    float acc = s.acc_s[i] * s.a_s[r];
    for (int t = 0; t < nt; ++t) acc += s.p_s[r * PF_KT + t] * s.v_s[t * d + e];
    s.acc_s[i] = acc;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(PF_THREADS)
paged_prefill_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hkv, C, G, D]
                     const void* __restrict__ k_pool,      // [L, P, ps, Hkv, Dk]
                     const void* __restrict__ v_pool,
                     const float* __restrict__ k_scale,    // [L, P, ps, Hkv, 1] or null
                     const float* __restrict__ v_scale,
                     const int32_t* __restrict__ tables,   // [B, W]
                     const int32_t* __restrict__ ctx_lens,  // [B]
                     const int32_t* __restrict__ q_lens,   // [B]
                     const void* __restrict__ chunk_k,     // [B, Hkv, C, Dk]
                     const void* __restrict__ chunk_v,
                     const float* __restrict__ chunk_k_scale,  // [B, Hkv, C, 1] or null
                     const float* __restrict__ chunk_v_scale,
                     __nv_bfloat16* __restrict__ out,      // [B, Hkv, C, G, D]
                     int layer, int n_pages, int ps, int hkv, int g_size, int d,
                     int w, int c_len, int kv_bits, int window, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int ldk = d + 1;
  const int n_rows = c_len * g_size;
  const int r0 = blockIdx.z * PF_TQ;
  const int nr = min(PF_TQ, n_rows - r0);
  Tile s;
  s.rows_s = reinterpret_cast<int64_t*>(smem);
  s.q_s = smem + 2 * PF_KT;
  s.acc_s = s.q_s + PF_TQ * d;
  s.k_s = s.acc_s + PF_TQ * d;
  s.v_s = s.k_s + PF_KT * ldk;
  s.p_s = s.v_s + PF_KT * d;
  s.m_s = s.p_s + PF_TQ * PF_KT;
  s.l_s = s.m_s + PF_TQ;
  s.a_s = s.l_s + PF_TQ;

  const int ctx = ctx_lens[b];
  const int qlen = q_lens[b];
  const int win_lo = window > 0 ? max(ctx + 1 - window, 0) : 0;
  const int64_t head_row0 = (int64_t)(b * hkv + h) * n_rows;  // row r of (b, h)

  for (int i = tid; i < PF_TQ * d; i += blockDim.x) {
    const int r = i / d, e = i % d;
    s.q_s[i] = r < nr ? __bfloat162float(q[(head_row0 + r0 + r) * d + e]) : 0.f;
    s.acc_s[i] = 0.f;
  }
  for (int r = tid; r < PF_TQ; r += blockDim.x) {
    s.m_s[r] = SOFTMAX_M0;
    s.l_s[r] = 0.f;
  }
  __syncthreads();

  // (a) pool keys at positions [win_lo, ctx)
  for (int t0 = win_lo; t0 < ctx; t0 += PF_KT) {
    const int nt = min(PF_KT, ctx - t0);
    for (int t = tid; t < nt; t += blockDim.x) {
      const int pos = t0 + t;
      const int page = tables[(int64_t)b * w + pos / ps];
      const int64_t tok = ((int64_t)layer * n_pages + page) * ps + pos % ps;
      s.rows_s[t] = tok * hkv + h;
    }
    __syncthreads();
    load_kv_tile(k_pool, v_pool, k_scale, v_scale, s.rows_s, nt, d, kv_bits, s.k_s, ldk,
                 s.v_s);
    __syncthreads();
    online_update(s, d, nt, sm_scale, [&](int r, int t) {
      if (r >= nr) return false;
      const int c = (r0 + r) / g_size;
      return window <= 0 || (ctx + c) - (t0 + t) < window;
    });
  }

  // (b) the chunk's own keys j < min(q_len, last query chunk index + 1)
  const int c_last = (r0 + nr - 1) / g_size;
  const int j_end = min(qlen, c_last + 1);
  const int64_t chunk_row0 = (int64_t)(b * hkv + h) * c_len;
  for (int j0 = 0; j0 < j_end; j0 += PF_KT) {
    const int nt = min(PF_KT, j_end - j0);
    for (int t = tid; t < nt; t += blockDim.x) s.rows_s[t] = chunk_row0 + j0 + t;
    __syncthreads();
    load_kv_tile(chunk_k, chunk_v, chunk_k_scale, chunk_v_scale, s.rows_s, nt, d, kv_bits,
                 s.k_s, ldk, s.v_s);
    __syncthreads();
    online_update(s, d, nt, sm_scale, [&](int r, int t) {
      if (r >= nr) return false;
      const int c = (r0 + r) / g_size;
      const int j = j0 + t;
      return j <= c && (window <= 0 || c - j < window);
    });
  }

  for (int i = tid; i < nr * d; i += blockDim.x) {
    const int r = i / d, e = i % d;
    out[(head_row0 + r0 + r) * d + e] =
        __float2bfloat16(s.acc_s[i] / fmaxf(s.l_s[r], 1e-20f));
  }
}

// Dynamic shared memory the kernel needs for one head dim, in bytes.
size_t smem_bytes(int d) {
  return sizeof(float) * (2 * PF_KT + 2 * PF_TQ * d + PF_KT * (d + 1) + PF_KT * d +
                          PF_TQ * PF_KT + 3 * PF_TQ);
}

}  // namespace

// Pointers are device pointers; scale pointers are null when kv_bits == 16.
// window <= 0 means no window.  Returns cudaGetLastError() after the launch.
extern "C" int paged_prefill_bf16(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* tables, const void* ctx_lens,
                                  const void* q_lens, const void* chunk_k,
                                  const void* chunk_v, const void* chunk_k_scale,
                                  const void* chunk_v_scale, void* out, int batch,
                                  int layer, int n_pages, int ps, int hkv, int g_size,
                                  int d, int w, int c_len, int kv_bits, int window,
                                  float sm_scale, void* stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = allow_smem(paged_prefill_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (c_len * g_size + PF_TQ - 1) / PF_TQ;
  dim3 grid(batch, hkv, n_tiles);
  paged_prefill_kernel<<<grid, PF_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ctx_lens),
      static_cast<const int32_t*>(q_lens), chunk_k, chunk_v,
      static_cast<const float*>(chunk_k_scale), static_cast<const float*>(chunk_v_scale),
      static_cast<__nv_bfloat16*>(out), layer, n_pages, ps, hkv, g_size, d, w, c_len,
      kv_bits, window, sm_scale);
  return (int)cudaGetLastError();
}

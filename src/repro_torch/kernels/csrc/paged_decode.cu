// Paged flash-decode GQA attention for Hopper: one new token per row against
// the paged KV pool, read in place through the page tables.
//
// Replaces repro/kernels/paged_decode.py::paged_mqa_decode_pallas (body
// _paged_kernel).  Same function: q [B, Hkv, G, D] against pool pages
// [L, P, ps, Hkv, Dk] (int8, int4 nibble-packed along D, or bf16), int
// payloads with their per-(token, head) f32 scales, an online softmax over
// the row's live positions [win_lo, length) with win_lo = max(length + 1 -
// window, 0), and the step's own not-yet-stored token fused in.  No position
// at or past `length` is read: tables are zero-padded, so a dead slot points
// at a real page 0 that belongs to another request.
//
// TPU -> Hopper: the Pallas grid (b, kv_head, page_slot) carries m / l / acc
// across *sequential* grid steps.  Blocks run in no order here, so the slot
// axis becomes a split of each row's positions (flash-decoding), planned on
// the host from shapes alone (kernels/paged_decode.py::decode_plan: the
// table capacity, or the window where that is smaller; lengths is never read
// back).  A warp is a whole decoder of one (row, kv head, group of up to 8
// queries, split); the block's warps take adjacent kv heads first, so one
// token's copies of a block cover adjacent rows of the page.  Split 0 starts
// from the step's own token (m = its score, l = 1, acc = its V row).  A row
// whose positions fit one split is finished by that warp; otherwise each live
// split writes a partial (acc, m, l) and a second launch, one block per
// (row, kv head, query), merges them in a fixed order (no atomics: the same
// inputs give the same bits).
//
// What bounds it on an H100: the bytes of the live K/V rows and their scales,
// streamed as rows of Dk bytes, one per (token, head), each page a different
// place in the pool, and the latency of each warp's chain of tiles.  So no
// block-wide barrier sits in the token loop and copies stay in flight during
// the arithmetic:
// - each warp walks its split in 8-token tiles through its own ring of 4
//   tiles in shared memory, filled by cp.async 3 tiles ahead of the
//   arithmetic (rows as stored, in 16-, 8- or 4-byte copies by the row length
//   and alignment, each scale a 4-byte copy); only __syncwarp orders the
//   ring;
// - page ids are resolved ahead of the copies: lanes 0-7 load the table
//   entries of the tile after the one being issued, so the lookup's latency
//   hides under a tile of arithmetic, and the copy lanes take each token's
//   pool row from them by shuffle (any page size);
// - both products run on the tensor cores with the query group as the M side
//   (mma.sync, bf16 in, f32 out; int8 and int4 are exact in bf16): scores
//   S = Q K^T by m16n8k16 over 16 dims a step (rows: up to 8 queries, n: the
//   tile's 8 tokens), P V by m16n8k8 with the dims as the M side (O^T = V^T
//   P^T), whose B operand is the score fragment itself, so P never leaves
//   registers.  Inside a product the k order is free: lane (g, q) takes dims
//   4q .. 4q + 3 of each 16, one stored word of an int8 row, half a word of
//   an int4 row, two of a bf16 row, converted exactly in registers (no f32
//   staging); the key scale and sm_scale multiply the score after the
//   product, p * v_scale enters P.  q lives in registers as bf16 fragments
//   (2 a 16 dims), acc as the P V fragments (8 f32 a 32 dims): 125-128
//   registers at D <= 128, four blocks an SM;
// - the online softmax runs in log2 units: a quad holds one query's scores
//   (two tokens a lane), so its max and sum take two shuffles;
// - the merge is wide: a single warp merging a row's partials waits an L2
//   round trip for every batch of its loads, so a block of 128 threads
//   merges each (row, kv head, query), every thread issuing all its loads
//   before their use.
// The f32 instantiation (paged_decode_f32: f32 q and out, f32 16-bit pools,
// the JAX kernel's function for a float32 model, whose products are f32)
// keeps the ring, the page walk, the split and the merge, and runs both
// products as f32 FMAs on the CUDA cores in the same register layouts: lane
// (g, q) holds query g's dims 16 ks + 4q .. + 3 as f32, scores its 8
// tokens over them, and a reduce-scatter over the quad (6 shuffles) leaves
// it tokens 2q, 2q + 1, as the mma fragment does; for P V it gathers the
// f32 weights of queries 2q, 2q + 1 (16 shuffles) and reads each token's V
// dims 4u .. 4u + 3.  Decode is bound by the bytes it reads, so FMA does not
// set its pace; a bf16 mma on a rounded q would lose 2^-9 relatively.  Its
// kv16 tiles are twice as wide: a block takes two warps where four rings
// would not fit in shared memory (D > 220).
// D up to 128 and up to 256 take 4 and 8 groups of 32 dims (the V^T tiles);
// larger query groups take several warps (each reads the K/V again, mostly
// from L2).  Rows sit in shared memory at a pitch of 16 x (odd) bytes, so the
// eight tokens' word reads fall in distinct banks.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int PD_TT = 8;           // tokens per warp tile: the products' n (k for P V)
constexpr int PD_RING = 4;         // tiles per warp ring: 3 in flight while one is used
constexpr int PD_MAX_WARPS = 4;    // warps a block takes at most
constexpr int PD_MAX_SPLITS = 64;  // the merge reads a split's (m, l) a thread
constexpr int PD_GQ = 8;           // queries a warp takes: rows 0-7 of the products
constexpr int PD_SMEM_MAX = 227 * 1024;  // shared memory a block may have on an H100
constexpr float LOG2E = 1.4426950408889634f;

// Stage bytes of one warp tile: K rows, V rows, then the K and V scales.
__host__ __device__ __forceinline__ int tile_bytes(int pitch, bool scales) {
  return 2 * PD_TT * pitch + (scales ? 2 * PD_TT * 4 : 0);
}

// d += a * b on the tensor cores: m16n8k8, bf16 in, f32 accumulate.  With
// g = lane / 4 and q = lane % 4: a0 / a1 hold A rows g / g + 8 x k (2q,
// 2q + 1), the lower k in the low half; b holds B column g x k (2q, 2q + 1);
// d holds rows (g, g + 8) x columns (2q, 2q + 1).
__device__ __forceinline__ void mma_bf16_1688(float (&d)[4], uint32_t a0, uint32_t a1,
                                              uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Dims e .. e + 3 of a stored row (shared or global memory; e % 4 == 0) as
// two bf16 pairs {e, e + 1} and {e + 2, e + 3}, exactly; zeros past d (a bf16
// row of D = 2 mod 4 ends in half a unit).
template <int KV_BITS>
__device__ __forceinline__ void load_dims4(const uint8_t* row, int e, int d, uint32_t& lo,
                                           uint32_t& hi) {
  lo = hi = 0u;
  if (e >= d) return;
  if constexpr (KV_BITS == 16) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + 2 * e);
    lo = p[0];
    if (e + 2 < d) hi = p[1];
  } else if constexpr (KV_BITS == 8) {
    const uint32_t b = *reinterpret_cast<const uint32_t*>(row + e) ^ 0x80808080u;
    lo = pack_int_bf16x2(s8_biased_to_f32(b, 0), s8_biased_to_f32(b, 1));
    hi = pack_int_bf16x2(s8_biased_to_f32(b, 2), s8_biased_to_f32(b, 3));
  } else {
    s4x4_biased_to_bf16x2(*reinterpret_cast<const uint16_t*>(row + e / 2) ^ 0x8888u, lo, hi);
  }
}

// Dims e .. e + 3 of two stored rows x, y as the bf16 pairs {x[e + j], y[e + j]},
// j = 0..3 (the A fragments of V^T for the tokens x and y); zeros past d.
template <int KV_BITS>
__device__ __forceinline__ void load_pairs4(const uint8_t* x, const uint8_t* y, int e, int d,
                                            uint32_t (&pr)[4]) {
  if constexpr (KV_BITS == 16) {
    uint32_t x0, x1, y0, y1;
    load_dims4<16>(x, e, d, x0, x1);
    load_dims4<16>(y, e, d, y0, y1);
    pr[0] = __byte_perm(x0, y0, 0x5410);
    pr[1] = __byte_perm(x0, y0, 0x7632);
    pr[2] = __byte_perm(x1, y1, 0x5410);
    pr[3] = __byte_perm(x1, y1, 0x7632);
  } else if constexpr (KV_BITS == 8) {
    if (e >= d) {
      pr[0] = pr[1] = pr[2] = pr[3] = 0u;
      return;
    }
    const uint32_t bx = *reinterpret_cast<const uint32_t*>(x + e) ^ 0x80808080u;
    const uint32_t by = *reinterpret_cast<const uint32_t*>(y + e) ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pr[j] = pack_int_bf16x2(s8_biased_to_f32(bx, j), s8_biased_to_f32(by, j));
  } else {
    if (e >= d) {
      pr[0] = pr[1] = pr[2] = pr[3] = 0u;
      return;
    }
    const uint32_t bx = *reinterpret_cast<const uint16_t*>(x + e / 2) ^ 0x8888u;
    const uint32_t by = *reinterpret_cast<const uint16_t*>(y + e / 2) ^ 0x8888u;
#pragma unroll
    for (int j = 0; j < 4; ++j)  // nibble j of each, as the mantissa of bf16 128
      pr[j] = bf16x2_minus_136(((bx >> (4 * j)) & 0xFu) | (((by >> (4 * j)) & 0xFu) << 16) |
                               0x43004300u);
  }
}

__device__ __forceinline__ float bf_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf_hi(uint32_t x) { return __uint_as_float(x & 0xFFFF0000u); }

// Dims e .. e + 3 of a stored row as f32, exactly; zeros past d.  A 16-bit
// pool holds the query's type T (bf16 or f32 rows, D even: 8-byte pairs).
template <int KV_BITS, typename T>
__device__ __forceinline__ void load_f4(const uint8_t* row, int e, int d, float (&x)[4]) {
  if constexpr (KV_BITS == 16 && std::is_same_v<T, float>) {
    x[0] = x[1] = x[2] = x[3] = 0.f;
    if (e >= d) return;
    const float2* p = reinterpret_cast<const float2*>(row + 4 * e);
    const float2 lo = p[0];
    x[0] = lo.x;
    x[1] = lo.y;
    if (e + 2 < d) {
      const float2 hi = p[1];
      x[2] = hi.x;
      x[3] = hi.y;
    }
  } else if constexpr (KV_BITS == 8) {
    x[0] = x[1] = x[2] = x[3] = 0.f;
    if (e >= d) return;
    const uint32_t b = *reinterpret_cast<const uint32_t*>(row + e) ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = s8_biased_to_f32(b, j);
  } else {
    uint32_t lo, hi;
    load_dims4<KV_BITS>(row, e, d, lo, hi);
    x[0] = bf_lo(lo);
    x[1] = bf_hi(lo);
    x[2] = bf_lo(hi);
    x[3] = bf_hi(hi);
  }
}

// Bytes of one stored K/V row: 16-bit pools hold T.
template <typename T>
__host__ __device__ __forceinline__ int pd_row_bytes(int d, int kv_bits) {
  return kv_bits == 16 ? d * (int)sizeof(T) : d * kv_bits / 8;
}

// The kernels' arguments (see the entry points paged_decode_bf16 / _f32);
// T is the query's and the output's type.
template <typename T>
struct PagedArgs {
  const T* q;                // [B, Hkv, G, D]
  const uint8_t* k_pool;     // [L, P, ps, Hkv, Dk] as stored
  const uint8_t* v_pool;
  const float* k_scale;      // [L, P, ps, Hkv, 1], null for bf16 pools
  const float* v_scale;
  const int32_t* tables;     // [B, W]
  const int32_t* lengths;    // [B]
  const uint8_t* new_k;      // [B, Hkv, Dk]
  const uint8_t* new_v;
  const float* new_k_scale;  // [B, Hkv, 1], null for bf16 pools
  const float* new_v_scale;
  T* out;                    // [B, Hkv, G, D]
  float* part;               // [B, Hkv, G, splits, 4 * ceil(D / 4) + 4]
  int layer, n_pages, ps, hkv, g_size, n_groups, d, w, window, n_split, per_split;
  int pitch, copy_bytes, copy_shift;
  float sm_scale;
};

// The row's live range and how many splits it fills (at least 1: split 0
// holds the step's own token even when no cached position is live).
struct RowRange {
  int win_lo, length, n_live;
};
template <typename T>
__device__ __forceinline__ RowRange row_range(const PagedArgs<T>& a, int b) {
  const int length = min(a.lengths[b], a.w * a.ps);
  const int win_lo = a.window > 0 ? max(length + 1 - a.window, 0) : 0;
  const int live = length > win_lo ? (length - win_lo + a.per_split - 1) / a.per_split : 1;
  return {win_lo, length, min(max(live, 1), a.n_split)};
}

// out[row][4u .. 4u + 3] = o * inv (pairs: D is even).
__device__ __forceinline__ void store_unit(const PagedArgs<__nv_bfloat16>& a, int64_t row, int u,
                                           const float (&o)[4], float inv) {
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(a.out + row * a.d) + 2 * u;
  dst[0] = __floats2bfloat162_rn(o[0] * inv, o[1] * inv);
  if (4 * u + 2 < a.d) dst[1] = __floats2bfloat162_rn(o[2] * inv, o[3] * inv);
}
__device__ __forceinline__ void store_unit(const PagedArgs<float>& a, int64_t row, int u,
                                           const float (&o)[4], float inv) {
  float2* dst = reinterpret_cast<float2*>(a.out + row * a.d) + 2 * u;
  dst[0] = make_float2(o[0] * inv, o[1] * inv);
  if (4 * u + 2 < a.d) dst[1] = make_float2(o[2] * inv, o[3] * inv);
}

// Warp (row b, unit = block y * warps + warp): kv head unit % Hkv, query
// group (unit / Hkv) % groups, split unit / (Hkv * groups).  NC: groups of
// 32 dims (D <= 32 NC); lane (g, q) = (lane / 4, lane % 4).  T: bf16 (both
// products on the tensor cores) or f32 (both as f32 FMAs).
template <typename T, int KV_BITS, int NC>
__global__ void __launch_bounds__(32 * PD_MAX_WARPS) paged_decode_kernel(const PagedArgs<T> a) {
  constexpr int KS = 2 * NC;  // 16-dim steps of the score product
  constexpr bool SCALES = KV_BITS < 16;
  constexpr bool F32 = std::is_same_v<T, float>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, unit = blockIdx.y * (blockDim.x >> 5) + warp;
  const int h = unit % a.hkv, grp = (unit / a.hkv) % a.n_groups;
  const int split = unit / (a.hkv * a.n_groups);
  if (split >= a.n_split) return;  // no block-wide barrier follows
  const RowRange rr = row_range(a, b);
  if (split >= rr.n_live) return;
  const int d = a.d, dk = pd_row_bytes<T>(d, KV_BITS), du = (d + 3) / 4;
  const int ks_live = (d + 15) / 16, nc_live = (du + 7) / 8;  // warp-uniform
  const int pitch = a.pitch, copy_bytes = a.copy_bytes, copy_shift = a.copy_shift;
  const int tb = tile_bytes(pitch, SCALES);
  uint8_t* ring = smem + warp * PD_RING * tb;  // this warp's ring
  const int64_t bh = (int64_t)b * a.hkv + h;
  const int gs = min(PD_GQ, a.g_size - grp * PD_GQ);  // the group's queries
  const float sms = a.sm_scale * LOG2E;

  const int p0 = rr.win_lo + split * a.per_split;
  const int p1 = min(rr.length, p0 + a.per_split);
  const int n_tiles = p1 > p0 ? (p1 - p0 + PD_TT - 1) / PD_TT : 0;

  // Page lookups: lane t < 8 holds the page id and in-page slot of token t
  // of a tile (0 for a dead token, whose copies read nothing).
  const int32_t* table = a.tables + (int64_t)b * a.w;
  auto fetch = [&](int i, int& pg, int& ip) {
    const int pos = p0 + i * PD_TT + lane;
    const bool ok = lane < PD_TT && i < n_tiles && pos < p1;
    pg = ok ? __ldg(table + pos / a.ps) : 0;
    ip = ok ? pos % a.ps : 0;
  };
  // Copy slots of a tile: (K or V, token t, chunk ch) with 2^copy_shift >=
  // dk / copy_bytes chunk slots a row.
  const int cpr = dk / copy_bytes;
  const int slots = (2 * PD_TT) << copy_shift;
  const int64_t layer_page = (int64_t)a.layer * a.n_pages;
  auto issue = [&](int i, int pg, int ip) {
    uint8_t* st = ring + (i % PD_RING) * tb;
    const int t0 = p0 + i * PD_TT;
    // the pool row of this lane's page id: lanes 0-7 hold tokens 0-7
    const int64_t tok = ((layer_page + pg) * a.ps + ip) * a.hkv + h;
    for (int c0 = 0; c0 < slots; c0 += 32) {
      const int c = c0 + lane, ch = c & ((1 << copy_shift) - 1);
      const int t = (c >> copy_shift) & (PD_TT - 1), kv = (c >> copy_shift) >= PD_TT;
      const int64_t row = __shfl_sync(0xffffffffu, tok, t);
      const bool ok = t0 + t < p1;
      if (c < slots && ch < cpr) {
        const uint8_t* src = (kv ? a.v_pool : a.k_pool) + row * dk + ch * copy_bytes;
        uint8_t* dst = st + (kv * PD_TT + t) * pitch + ch * copy_bytes;
        if (copy_bytes == 16) {
          cp_async<16>(dst, src, ok);
        } else if (copy_bytes == 8) {
          cp_async<8>(dst, src, ok);
        } else {
          cp_async<4>(dst, src, ok);
        }
      }
    }
    if constexpr (SCALES) {  // K then V scales, 4 bytes a token
      const int t = lane & (PD_TT - 1);
      const int64_t row = __shfl_sync(0xffffffffu, tok, t);
      if (lane < 2 * PD_TT)
        cp_async<4>(st + 2 * PD_TT * pitch + 4 * lane,
                    (lane < PD_TT ? a.k_scale : a.v_scale) + row, t0 + t < p1);
    }
  };

  {
    int pg[PD_RING - 1], ip[PD_RING - 1];
#pragma unroll
    for (int i = 0; i < PD_RING - 1; ++i) fetch(i, pg[i], ip[i]);  // lookups in flight together
#pragma unroll
    for (int i = 0; i < PD_RING - 1; ++i) {
      if (i < n_tiles) issue(i, pg[i], ip[i]);
      cp_async_commit();  // empty groups keep the count uniform
    }
  }
  int pg_next, ip_next;  // the next tile to issue
  fetch(PD_RING - 1, pg_next, ip_next);

  const int g = lane >> 2, q = lane & 3;
  // query g's dims 16 ks + 4q .. + 3: as bf16 pairs, the A fragments of
  // S = Q K^T, or as f32 (F32)
  uint32_t qa[F32 ? 1 : KS][2];
  float qv[F32 ? KS : 1][4];
  {
    const T* qrow = a.q + (bh * a.g_size + grp * PD_GQ + g) * d;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int e = 16 * ks + 4 * q;
      if constexpr (F32) {
        float2 lo = make_float2(0.f, 0.f), hi = lo;
        if (g < gs && e < d) lo = *reinterpret_cast<const float2*>(qrow + e);
        if (g < gs && e + 2 < d) hi = *reinterpret_cast<const float2*>(qrow + e + 2);
        qv[ks][0] = lo.x;
        qv[ks][1] = lo.y;
        qv[ks][2] = hi.x;
        qv[ks][3] = hi.y;
      } else {
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(qrow);
        qa[ks][0] = g < gs && e < d ? qw[e / 2] : 0u;
        qa[ks][1] = g < gs && e + 2 < d ? qw[e / 2 + 1] : 0u;
      }
    }
  }
  // dim 16 ks + 4q + j of query g, as f32
  auto q_at = [&](int ks, int j) -> float {
    if constexpr (F32) {
      return qv[ks][j];
    } else {
      return j % 2 ? bf_hi(qa[ks][j / 2]) : bf_lo(qa[ks][j / 2]);
    }
  };
  // acc[c][hh]: O^T rows 4u + 2hh (g) and 4u + 2hh + 1 (g + 8), u = g + 8c, x
  // queries 2q, 2q + 1 (the m16n8k8 fragment); m and l of query g
  float acc[NC][2][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][hh][e] = 0.f;
  float m = SOFTMAX_M0, l = 0.f;
  if (split == 0) {  // the step's own token: always live, counted by lane q == 0
    const uint8_t* nk = a.new_k + bh * dk;
    const uint8_t* nv = a.new_v + bh * dk;
    float s = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks < ks_live) {
        float kf[4];
        load_f4<KV_BITS, T>(nk, 16 * ks + 4 * q, d, kf);
#pragma unroll
        for (int j = 0; j < 4; ++j) s = fmaf(q_at(ks, j), kf[j], s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    m = s * (SCALES ? a.new_k_scale[bh] : 1.f) * sms;
    l = q == 0 ? 1.f : 0.f;
    const float v_sc = SCALES ? a.new_v_scale[bh] : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float v[4];
      load_f4<KV_BITS, T>(nv, 4 * (g + 8 * c), d, v);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        acc[c][hh][0] = acc[c][hh][1] = v[2 * hh] * v_sc;
        acc[c][hh][2] = acc[c][hh][3] = v[2 * hh + 1] * v_sc;
      }
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<PD_RING - 2>();  // tile i has landed (this lane's copies)
    __syncwarp();                  // ... every lane's; tile i - 1's slot is free
    if (i + PD_RING - 1 < n_tiles) issue(i + PD_RING - 1, pg_next, ip_next);
    cp_async_commit();
    fetch(i + PD_RING, pg_next, ip_next);  // lands under this tile's arithmetic
    const uint8_t* st = ring + (i % PD_RING) * tb;
    const float* sc = reinterpret_cast<const float*>(st + 2 * PD_TT * pitch);
    const int t0 = p0 + i * PD_TT;

    // S = Q K^T: query g x tokens 2q, 2q + 1 (sc0, sc1)
    float sc0, sc1;
    if constexpr (F32) {
      // query g's dims of this lane against all 8 tokens, then a
      // reduce-scatter over the quad: tokens 4 (q >> 1) + 0..3 after the
      // first exchange, 2q and 2q + 1 after the second
      float sp[PD_TT];
#pragma unroll
      for (int t = 0; t < PD_TT; ++t) sp[t] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks < ks_live) {
#pragma unroll
          for (int t = 0; t < PD_TT; ++t) {
            float kf[4];
            load_f4<KV_BITS, T>(st + t * pitch, 16 * ks + 4 * q, d, kf);
#pragma unroll
            for (int j = 0; j < 4; ++j) sp[t] = fmaf(q_at(ks, j), kf[j], sp[t]);
          }
        }
      }
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float keep = q & 2 ? sp[4 + j] : sp[j], send = q & 2 ? sp[j] : sp[4 + j];
        r[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
      }
      const float keep0 = q & 1 ? r[2] : r[0], send0 = q & 1 ? r[0] : r[2];
      const float keep1 = q & 1 ? r[3] : r[1], send1 = q & 1 ? r[1] : r[3];
      sc0 = keep0 + __shfl_xor_sync(0xffffffffu, send0, 1);
      sc1 = keep1 + __shfl_xor_sync(0xffffffffu, send1, 1);
    } else {
      // two chains of k steps on the tensor cores
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      const uint8_t* krow = st + g * pitch;  // token g: column g of K^T
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks < ks_live) {
          uint32_t b0, b1;
          load_dims4<KV_BITS>(krow, 16 * ks + 4 * q, d, b0, b1);
          const uint32_t qf[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
          mma_bf16_16816(ks % 2 ? s1 : s0, qf, b0, b1);
        }
      }
      sc0 = s0[0] + s1[0];
      sc1 = s0[1] + s1[1];
    }
    // log2 units: s * k_scale * sm_scale * log2(e); tokens past p1 masked
    const float2 ksc =
        SCALES ? *reinterpret_cast<const float2*>(sc + 2 * q) : make_float2(1.f, 1.f);
    const float2 vsc =
        SCALES ? *reinterpret_cast<const float2*>(sc + PD_TT + 2 * q) : make_float2(1.f, 1.f);
    const float x0 = t0 + 2 * q < p1 ? sc0 * ksc.x * sms : -INFINITY;
    const float x1 = t0 + 2 * q + 1 < p1 ? sc1 * ksc.y * sms : -INFINITY;
    float mx = fmaxf(x0, x1);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);  // finite: the tile has a live token
    const float alpha = exp2f(m - m_new);
    const float e0 = exp2f(x0 - m_new), e1 = exp2f(x1 - m_new);  // 0 when masked
    l = l * alpha + e0 + e1;  // this lane's two tokens; the quad is summed at the end
    m = m_new;
    // acc columns are queries 2q, 2q + 1: their rescale comes from quads 2q, 2q + 1
    const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * q);
    const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * q + 4);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        acc[c][hh][0] *= a0;
        acc[c][hh][1] *= a1;
        acc[c][hh][2] *= a0;
        acc[c][hh][3] *= a1;
      }
    }
    if constexpr (F32) {
      // P * v_scale of queries 2q + jj (jj = 0, 1) for the tile's 8 tokens,
      // from the lanes of quads 2q and 2q + 1, in f32
      const float pf0 = e0 * vsc.x, pf1 = e1 * vsc.y;
      float pw[2][PD_TT];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          pw[jj][2 * qq] = __shfl_sync(0xffffffffu, pf0, 8 * q + 4 * jj + qq);
          pw[jj][2 * qq + 1] = __shfl_sync(0xffffffffu, pf1, 8 * q + 4 * jj + qq);
        }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc_live) {
#pragma unroll
          for (int t = 0; t < PD_TT; ++t) {
            float v[4];  // token t's dims 4u .. 4u + 3
            load_f4<KV_BITS, T>(st + (PD_TT + t) * pitch, 4 * (g + 8 * c), d, v);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              acc[c][0][jj] = fmaf(pw[jj][t], v[0], acc[c][0][jj]);
              acc[c][0][2 + jj] = fmaf(pw[jj][t], v[1], acc[c][0][2 + jj]);
              acc[c][1][jj] = fmaf(pw[jj][t], v[2], acc[c][1][jj]);
              acc[c][1][2 + jj] = fmaf(pw[jj][t], v[3], acc[c][1][2 + jj]);
            }
          }
        }
      }
    } else {
      // P^T for tokens 2q, 2q + 1 of query g: the B fragment of O^T = V^T P^T
      const __nv_bfloat162 pb = __floats2bfloat162_rn(e0 * vsc.x, e1 * vsc.y);
      const uint32_t pf = *reinterpret_cast<const uint32_t*>(&pb);
      const uint8_t* vx = st + (PD_TT + 2 * q) * pitch;  // V rows of tokens 2q, 2q + 1
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nc_live) {
          uint32_t pr[4];
          load_pairs4<KV_BITS>(vx, vx + pitch, 4 * (g + 8 * c), d, pr);
          mma_bf16_1688(acc[c][0], pr[0], pr[1], pf);
          mma_bf16_1688(acc[c][1], pr[2], pr[3], pf);
        }
      }
    }
  }
  cp_async_wait<0>();

  l += __shfl_xor_sync(0xffffffffu, l, 1);  // query g's tokens over its quad
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  // this lane's acc columns: queries 2q and 2q + 1 (held by quads 2q, 2q + 1)
  const float l_c[2] = {__shfl_sync(0xffffffffu, l, 8 * q),
                        __shfl_sync(0xffffffffu, l, 8 * q + 4)};
  if (rr.n_live == 1) {  // the whole row in this warp: l >= 1 (its largest term)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gq = 2 * q + j;
      if (gq >= gs) break;
      const float inv = 1.f / l_c[j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int u = g + 8 * c;
        if (u < du) {
          const float o[4] = {acc[c][0][j], acc[c][0][2 + j], acc[c][1][j], acc[c][1][2 + j]};
          store_unit(a, bh * a.g_size + grp * PD_GQ + gq, u, o, inv);
        }
      }
    }
    return;
  }
  const int stride = 4 * du + 4;
  float* rec0 = a.part + (bh * a.g_size + grp * PD_GQ) * a.n_split * stride;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int gq = 2 * q + j;
    if (gq >= gs) break;
    float* rec = rec0 + ((int64_t)gq * a.n_split + split) * stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int u = g + 8 * c;
      if (u < du)
        reinterpret_cast<float4*>(rec)[u] =
            make_float4(acc[c][0][j], acc[c][0][2 + j], acc[c][1][j], acc[c][1][2 + j]);
    }
  }
  if (q == 0 && g < gs) {
    float* rec = rec0 + ((int64_t)g * a.n_split + split) * stride;
    rec[4 * du] = m;
    rec[4 * du + 1] = l;
  }
}

// The second launch: block (row, kv head x G + query) merges that query's
// splits (rows that fit one split were finished by the first launch).  Every
// load is issued before its use: thread t reads the (m, l) of split t, then
// units u = t % 32 (or % 64) of splits j, j + SL, ... (j = t / 32, SL split
// lanes), 16 at a time; the SL sums of a unit are added in lane order.  So
// the order is fixed and the same inputs give the same bits.
constexpr int PD_MERGE_THREADS = 128;
template <typename T>
__global__ void __launch_bounds__(PD_MERGE_THREADS)
    paged_decode_merge_kernel(const PagedArgs<T> a) {
  __shared__ float w_s[PD_MAX_SPLITS], lw_s[PD_MAX_SPLITS];  // c_s and c_s l_s
  __shared__ float4 acc_s[PD_MERGE_THREADS];
  const int b = blockIdx.x, t = threadIdx.x;
  const int n_live = row_range(a, b).n_live;
  if (n_live == 1) return;  // the split kernel wrote it
  const int du = (a.d + 3) / 4, stride = 4 * du + 4;
  const int64_t row = (int64_t)b * a.hkv * a.g_size + blockIdx.y;  // (b, h, query)
  const float* rec = a.part + row * a.n_split * stride;
  float2 ml = make_float2(SOFTMAX_M0, 0.f);
  if (t < n_live) ml = __ldcg(reinterpret_cast<const float2*>(rec + t * stride + 4 * du));
  if (t < PD_MAX_SPLITS) w_s[t] = ml.x;
  __syncthreads();
  float mx = SOFTMAX_M0;
  for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, w_s[s]);
  __syncthreads();
  if (t < n_live) {
    w_s[t] = exp2f(ml.x - mx);
    lw_s[t] = w_s[t] * ml.y;
  }
  const int dup = du <= 32 ? 32 : 64, sl = PD_MERGE_THREADS / dup;
  const int u = t % dup, j = t / dup, uc = min(u, du - 1);
  float4 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    v[k] = __ldcg(reinterpret_cast<const float4*>(rec + min(j + k * sl, n_live - 1) * stride) + uc);
  __syncthreads();
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = j; s0 < n_live; s0 += 16 * sl) {
    if (s0 != j) {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        v[k] = __ldcg(reinterpret_cast<const float4*>(rec + min(s0 + k * sl, n_live - 1) * stride) +
                      uc);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int s = s0 + k * sl;
      if (s >= n_live) break;
      const float c = w_s[s];
      acc.x = fmaf(c, v[k].x, acc.x);
      acc.y = fmaf(c, v[k].y, acc.y);
      acc.z = fmaf(c, v[k].z, acc.z);
      acc.w = fmaf(c, v[k].w, acc.w);
    }
  }
  acc_s[t] = acc;
  __syncthreads();
  if (t < du) {
    float den = 0.f;
    for (int s = 0; s < n_live; ++s) den += lw_s[s];
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int jj = 0; jj < sl; ++jj) {
      const float4 p = acc_s[jj * dup + t];
      o[0] += p.x;
      o[1] += p.y;
      o[2] += p.z;
      o[3] += p.w;
    }
    store_unit(a, row, t, o, 1.f / den);
  }
}

template <typename T, int KV_BITS, int NC>
cudaError_t launch(const PagedArgs<T>& a, int batch, int warps, size_t smem, cudaStream_t s) {
  cudaError_t err = allow_smem(paged_decode_kernel<T, KV_BITS, NC>, smem);
  if (err != cudaSuccess) return err;
  const int units = a.hkv * a.n_groups * a.n_split;
  paged_decode_kernel<T, KV_BITS, NC>
      <<<dim3(batch, (units + warps - 1) / warps), 32 * warps, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  paged_decode_merge_kernel<T><<<dim3(batch, a.hkv * a.g_size), PD_MERGE_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int KV_BITS>
cudaError_t dispatch(int nc, const PagedArgs<T>& a, int batch, int warps, size_t smem,
                     cudaStream_t s) {
  return nc == 4 ? launch<T, KV_BITS, 4>(a, batch, warps, smem, s)
                 : launch<T, KV_BITS, 8>(a, batch, warps, smem, s);
}

// Bytes of a stored row padded to 16 x (odd) bytes: conflict-free fragment reads.
int pd_pitch(int dk) {
  int pitch = (dk + 15) / 16 * 16;
  if ((pitch / 16) % 2 == 0) pitch += 16;
  return pitch;
}

// Warps a block takes: PD_MAX_WARPS, halved while their rings would not fit
// in shared memory (f32 pools at D > 128).
int pd_block_warps(int dk, bool scales) {
  int warps = PD_MAX_WARPS;
  while (warps > 1 && (size_t)warps * PD_RING * tile_bytes(pd_pitch(dk), scales) > PD_SMEM_MAX)
    warps /= 2;
  return warps;
}

template <typename T>
int paged_decode_entry(const void* q, const void* k_pool, const void* v_pool,
                       const void* k_scale, const void* v_scale, const void* tables,
                       const void* lengths, const void* new_k, const void* new_v,
                       const void* new_k_scale, const void* new_v_scale, void* out, void* part,
                       int batch, int layer, int n_pages, int ps, int hkv, int g_size, int d,
                       int w, int kv_bits, int window, int n_groups, int n_split, int per_split,
                       float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_bits != 4 && kv_bits != 8 && kv_bits != 16) return (int)cudaErrorInvalidValue;
  const int dk = pd_row_bytes<T>(d, kv_bits);
  const int64_t cap = (int64_t)w * ps;
  const int64_t span = window > 0 && window < cap ? window : cap;
  if (d < 2 || d > 256 || d % 2 || dk % 4 || g_size < 1 ||
      n_groups != (g_size + PD_GQ - 1) / PD_GQ || ps < 1 || w < 1 || n_split < 1 ||
      n_split > PD_MAX_SPLITS || per_split < PD_TT || per_split % PD_TT ||
      (int64_t)n_split * per_split < span || (n_split > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // copy width: the widest of 16 / 8 / 4 bytes that splits the rows and the bases
  const uintptr_t base = reinterpret_cast<uintptr_t>(k_pool) | reinterpret_cast<uintptr_t>(v_pool);
  int copy_bytes = 16;
  while (dk % copy_bytes || base % copy_bytes) copy_bytes /= 2;
  if (copy_bytes < 4) return (int)cudaErrorInvalidValue;
  int copy_shift = 0;
  while ((1 << copy_shift) < dk / copy_bytes) ++copy_shift;
  const int pitch = pd_pitch(dk);
  const int warps = pd_block_warps(dk, kv_bits < 16);
  const size_t smem = (size_t)warps * PD_RING * tile_bytes(pitch, kv_bits < 16);
  const PagedArgs<T> a{static_cast<const T*>(q),
                       static_cast<const uint8_t*>(k_pool), static_cast<const uint8_t*>(v_pool),
                       static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                       static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lengths),
                       static_cast<const uint8_t*>(new_k), static_cast<const uint8_t*>(new_v),
                       static_cast<const float*>(new_k_scale),
                       static_cast<const float*>(new_v_scale), static_cast<T*>(out),
                       static_cast<float*>(part), layer, n_pages, ps, hkv, g_size, n_groups, d,
                       w, window, n_split, per_split, pitch, copy_bytes, copy_shift, sm_scale};
  const int nc = d <= 128 ? 4 : 8;
  const cudaError_t err = kv_bits == 8   ? dispatch<T, 8>(nc, a, batch, warps, smem, s)
                          : kv_bits == 4 ? dispatch<T, 4>(nc, a, batch, warps, smem, s)
                                         : dispatch<T, 16>(nc, a, batch, warps, smem, s);
  return (int)err;
}

}  // namespace

// Pointers are device pointers; scale pointers are null when kv_bits == 16.
// Head dims up to 256 with rows of whole 32-bit words.  The plan
// (kernels/paged_decode.py::decode_plan): n_groups query groups of at most 8;
// split i covers positions [win_lo + i * per_split, win_lo + (i + 1) *
// per_split), a whole number of 8-token tiles, and the n_split <= 64 splits
// cover the table's capacity w * ps, or the window where that is smaller.
// part is [B, Hkv, G, n_split, 4 * ceil(D / 4) + 4] f32 scratch when
// n_split > 1, and a second launch then merges the splits.  window <= 0 means
// no window.  Returns cudaErrorInvalidValue without
// launching on arguments it does not take, else cudaGetLastError() after the
// launches.  paged_decode_bf16: bf16 q and out, bf16 16-bit pools;
// paged_decode_f32: f32 q and out, f32 16-bit pools (int8 / int4 pools and
// their f32 scales as for bf16).
#define PD_ENTRY_ARGS                                                                        \
  const void *q, const void *k_pool, const void *v_pool, const void *k_scale,                \
      const void *v_scale, const void *tables, const void *lengths, const void *new_k,       \
      const void *new_v, const void *new_k_scale, const void *new_v_scale, void *out,        \
      void *part, int batch, int layer, int n_pages, int ps, int hkv, int g_size, int d,     \
      int w, int kv_bits, int window, int n_groups, int n_split, int per_split,              \
      float sm_scale, void *stream
#define PD_ENTRY_CALL                                                                        \
  q, k_pool, v_pool, k_scale, v_scale, tables, lengths, new_k, new_v, new_k_scale,           \
      new_v_scale, out, part, batch, layer, n_pages, ps, hkv, g_size, d, w, kv_bits, window, \
      n_groups, n_split, per_split, sm_scale, stream
extern "C" int paged_decode_bf16(PD_ENTRY_ARGS) {
  return paged_decode_entry<__nv_bfloat16>(PD_ENTRY_CALL);
}
extern "C" int paged_decode_f32(PD_ENTRY_ARGS) { return paged_decode_entry<float>(PD_ENTRY_CALL); }
#undef PD_ENTRY_ARGS
#undef PD_ENTRY_CALL

// Warps a block of the kernel takes at head dim d, kv_bits and elem_bytes
// (2: bf16, 4: f32) the bytes of a 16-bit pool's value; its shared memory
// is that many rings of 4 tiles.
extern "C" int paged_decode_block_warps(int d, int kv_bits, int elem_bytes) {
  return pd_block_warps(kv_bits == 16 ? d * elem_bytes : d * kv_bits / 8, kv_bits < 16);
}

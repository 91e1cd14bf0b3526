// Paged chunk-prefill GQA attention for Hopper: a C-token query chunk against
// the paged KV pool plus the chunk's own K/V under a causal mask.
//
// Replaces repro/kernels/paged_prefill.py::paged_mqa_prefill_pallas (body
// _prefill_kernel).  Same function: q [B, Hkv, C, G, D] (query rows
// r = c * G + g) attends to (a) the ctx_lens[b] tokens already in the pool,
// read in place through the page table, and (b) the chunk's not-yet-stored
// K/V [B, Hkv, C, Dk], where key j is visible to query c iff j <= c and
// j < q_lens[b].  Pool keys all sit below ctx, so they are causal for free; a
// sliding window masks per query-key distance.  Padding query rows
// (c >= q_len) come out finite: they see the pool and the valid chunk keys,
// and a row that sees nothing normalises 0 / 1e-20 = 0.
//
// TPU -> Hopper: the Pallas kernel holds a whole chunk's [C*G, D] f32
// accumulator in VMEM and walks page slots as a sequential grid axis.  Here
// the query rows are tiled across blocks, FlashAttention-2 style: grid (b,
// kv head, 64-row query tile), 4 warps, each owning 16 query rows whose Q
// fragments, running max / sum and output accumulator stay in registers for
// the whole block.  The block walks 64-key tiles: first the live pool
// positions [win_lo, ctx) (win_lo from the window and the block's first
// query), then the chunk keys its queries can see.
//
// What bounds it on an H100: at serving chunk sizes the two products
// (operations), at small chunks the K/V bytes and latency.  The design:
// - key tiles are gathered through the page table with cp.async into a
//   ring (one page of one head is ps rows of Dk bytes at stride Hkv * Dk,
//   whole 16-byte copies at D = 128 and 256 for every kv_bits): the next two tiles'
//   payload and scales (int8 / int4; the next tile for bf16) are in flight
//   while the current one is converted and multiplied, and the page-table
//   entries of the tile after those are already being read;
// - the int8 / int4 payload is turned into bf16 in shared memory, exactly
//   (integers of at most 8 bits), each thread a whole row in unrolled
//   16-byte chunks, so S = Q K_int^T runs on the tensor cores
//   (mma.sync.m16n8k16, f32 accumulate) with exact products, and column t is
//   scaled by k_scale[t] * sm_scale afterwards, in f32;
// - the online softmax runs in registers on the accumulator layout, with the
//   row max and sum across the 4 lanes of a row by warp shuffles;
// - P V on the tensor cores: v_scale[t] is folded into P in f32, and
//   P * v_scale enters as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi)
//   (relative error 2^-17, where one bf16 rounding gives 2^-9 and flipped a
//   greedy pick against the CPU); V_int (exact in bf16) is read with
//   ldmatrix.trans.  The running sum l adds the f32 p, unscaled.
// A head dim is zero-padded in shared memory to the next of 32, 64, 128 and
// 256 (DP).  At DP <= 128 a warp keeps its Q fragments in registers for the
// whole block; at DP = 256 they would take 64 registers a thread beside the
// 128 f32 of the output accumulator and the 32 of the 16 x 64 S tile, past
// the 255 a thread may have.  So at DP = 256 each K step reads its Q
// fragment from the Q tile, which stays in shared memory for the whole
// block, with ldmatrix, and a 64-key tile goes through S, the online softmax
// and P V in two steps of 32 keys (16 registers of S).  Shared
// memory at DP = 256 (TP = 264): kv16 168,960 bytes, kv8 201,728, kv4
// 152,576, one block an SM; a deeper ring does not fit at kv8.  No atomics:
// the same inputs give the same bits.
//
// The f32 instantiation (paged_prefill_f32: f32 q and out, f32 16-bit pools,
// the JAX kernel's function for a float32 model, whose products are f32) has
// its own body, paged_prefill_f32_kernel, on the same tensor cores.  Its
// products are f32-accurate sums of bf16 products (bf16 terms, not TF32: a
// TF32 pass runs at half the bf16 rate on operands twice as wide, and the
// P V fragment of TF32 needs the scores moved between lanes):
// - q is split once, as the block starts, into bf16 terms q1 = bf16(q),
//   q2 = bf16(q - q1), q3 = bf16(q - q1 - q2), each a tile in shared memory
//   that every K step reads with ldmatrix (three terms' fragments beside
//   o[DP/8][4] would not fit in registers at DP 128);
// - int8 / int4 K and V are exact in bf16, converted as for bf16 q: S =
//   (q3 + q2 + q1) K_int and O += (p3 + p2 + p1) V_int with P * v_scale in
//   three terms too, three mma a step each (2^-24 of the f32 products);
// - an f32 kv16 pool's rows land in the ring as f32 and are split in place
//   into bf16 hi | lo halves of the same row (k = k_hi + k_lo to 2^-17; never
//   rounded once to bf16, which loses 2^-9): S = q2 k_hi + q1 k_lo + q1 k_hi
//   (q in two terms), O += p2 v_hi + p1 v_lo + p1 v_hi, three mma each;
// - small grids: a block takes 16 R query rows (R = 1, 2 or 4 row warps,
//   the fewest that hold C * G), and the 4 / R warps of a row group take
//   their own key range of every tile, merged (m, l, o) in shared memory
//   in a fixed order at the end; where B * Hkv * ceil(C * G / 16 R) blocks
//   are under a wave, each (b, kv head, row block) also splits its key tiles
//   over n_split blocks (kernels/paged_prefill.py::prefill_plan, from shapes
//   alone), which write (o, m, l) partials that a second launch merges in
//   split order.  Which tiles a split takes is computed on the card from
//   ctx_lens and q_lens, so a captured step replays the same plan;
// - tiles: 64 keys, or 32 where 64 would not fit in 227 KB of shared memory
//   (pf32_keys_per_tile), each warp's key range stepped KC keys at a time;
//   at DP 256 K and V fragments are read one 16-key / 16-dim block at a
//   time (registers).
// No atomics: the same inputs give the same bits.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int PF_THREADS = 128;  // 4 warps x 16 query rows
constexpr int PF_TQ = 64;        // query rows per block (bf16; the f32 kernel's most)
constexpr int PF_SMEM_MAX = 227 * 1024;  // shared memory a block may have on an H100
constexpr int PF_MAX_SPLITS = 64;        // key splits of the f32 kernel

// Shared-memory layout of the bf16 kernel for head dim padded to DP: tiles of
// TP-element bf16 rows that the products read (TP * 2 bytes is an odd
// multiple of 16, so the 8 rows an ldmatrix reads hit distinct banks).
// kv_bits 16: Q, then a 2-stage ring of K / V tiles that the products read
// directly.  kv_bits 8 / 4: Q, a 3-stage ring of raw payload rows and raw
// scales (1 or 1/2 byte a value, so a deeper ring fits), and the K / V
// tiles plus per-key factors converted from the stage of the current tile.
template <int DP, int KV_BITS>
struct PfSmem {
  static constexpr int KT = 64;  // keys a tile
  static constexpr int TP = DP + 8;
  static constexpr int TILE = KT * TP * 2;  // one K or V tile, bytes
  static constexpr int RAW_PITCH = KV_BITS == 8 ? DP : DP / 2;
  static constexpr int RAW = KT * RAW_PITCH;  // one raw K or V tile (8 / 4 bits)
  static constexpr int Q = 0;
  static constexpr int RING = Q + PF_TQ * TP * 2;
  // one ring stage: [K tile, V tile] (16 bits) or [raw K, raw V, k scales, v scales]
  static constexpr int STAGE = KV_BITS == 16 ? 2 * TILE : 2 * RAW + 2 * KT * 4;
  static constexpr int STAGES = KV_BITS == 16 ? 2 : 3;  // tiles in flight: STAGES - 1
  static constexpr int CONV = RING + STAGES * STAGE;  // K, V, k factors, v factors
  static constexpr int KF = CONV + 2 * TILE;
  static constexpr int VF = KF + KT * 4;
  static constexpr int BYTES = KV_BITS == 16 ? CONV : VF + KT * 4;
};

// 16 raw int8 (32 int4) values of a K or V row -> bf16, exactly: the chunk
// `raw` of a raw row goes to dst (32 or 64 bytes).
template <int KV_BITS>
__device__ __forceinline__ void int_chunk_to_bf16(uint4 raw, uint8_t* dst) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (KV_BITS == 8) {  // 16 values -> 32 bytes
    uint32_t o[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t bw = words[u] ^ 0x80808080u;
      o[2 * u] = pack_int_bf16x2(s8_biased_to_f32(bw, 0), s8_biased_to_f32(bw, 1));
      o[2 * u + 1] = pack_int_bf16x2(s8_biased_to_f32(bw, 2), s8_biased_to_f32(bw, 3));
    }
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  } else {  // 32 values -> 64 bytes
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t bw = words[u] ^ 0x88888888u;
      d[u] = make_uint4(s4x2_biased_to_bf16x2(bw, 0), s4x2_biased_to_bf16x2(bw, 1),
                        s4x2_biased_to_bf16x2(bw, 2), s4x2_biased_to_bf16x2(bw, 3));
    }
  }
}

template <int DP, int KV_BITS>
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
                     int w, int c_len, int window, float sm_scale) {
  using T = __nv_bfloat16;
  using L = PfSmem<DP, KV_BITS>;
  constexpr int TP = L::TP, KT = L::KT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, qd = lane & 3;
  const int n_rows = c_len * g_size;
  const int r0 = blockIdx.z * PF_TQ;
  const int nr = min(PF_TQ, n_rows - r0);
  const int row_bytes = kv_row_bytes(d, KV_BITS);
  const int ctx = ctx_lens[b];
  const int qlen = q_lens[b];
  const int c_first = r0 / g_size, c_last = (r0 + nr - 1) / g_size;
  const int64_t head_row0 = (int64_t)(b * hkv + h) * n_rows;  // query row r of (b, h)
  const int64_t chunk_row0 = (int64_t)(b * hkv + h) * c_len;  // chunk key j of (b, h)

  // key tiles: pool positions [win_lo, ctx), then chunk keys [j_lo, j_end)
  const int win_lo = window > 0 ? max(ctx + c_first + 1 - window, 0) : 0;
  const int n_pool = ctx > win_lo ? (ctx - win_lo + KT - 1) / KT : 0;
  const int j_lo = window > 0 ? max(c_first + 1 - window, 0) : 0;
  const int j_end = min(qlen, c_last + 1);
  const int n_chunk = j_end > j_lo ? (j_end - j_lo + KT - 1) / KT : 0;
  const int n_tiles = n_pool + n_chunk;

  // A head dim below DP leaves columns no copy writes: zero everything once,
  // so they stay 0.  At d == DP every byte that is read is written first.
  if (d < DP) {
    for (int i = tid; i < L::BYTES / 16; i += PF_THREADS) {
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
  }

  // The copies of a tile: thread (t = tid % KT, side = tid / KT) copies the
  // K (side 0) or V (side 1) payload row of key t and, for int payloads, its
  // scale; rows past the tile's keys are zero-filled.  tile_row resolves the
  // row through the page table, two tiles before the copies it feeds, so the
  // table load's latency hides behind the products.
  const int my_t = tid % KT, side = tid / KT;
  auto tile_row = [&](int i) -> int64_t {
    const bool pool = i < n_pool;
    const int pos = (pool ? win_lo + i * KT : j_lo + (i - n_pool) * KT) + my_t;
    if (pos >= (pool ? ctx : j_end)) return -1;
    if (!pool) return chunk_row0 + pos;
    const int page = tables[(int64_t)b * w + pos / ps];
    return (((int64_t)layer * n_pages + page) * ps + pos % ps) * hkv + h;
  };
  auto issue = [&](int i, int64_t row) {
    const bool pool = i < n_pool;
    const bool ok = row >= 0;
    uint8_t* st = smem + L::RING + (i % L::STAGES) * L::STAGE;
    uint8_t* dst = st + (KV_BITS == 16 ? side * L::TILE + my_t * TP * 2
                                       : side * L::RAW + my_t * L::RAW_PITCH);
    const uint8_t* base = static_cast<const uint8_t*>(
        side == 0 ? (pool ? k_pool : chunk_k) : (pool ? v_pool : chunk_v));
    const uint8_t* src = ok ? base + row * row_bytes : base;
    auto copy_row = [&](auto vec) {
      constexpr int V = decltype(vec)::value;
      for (int off = 0; off < row_bytes; off += V) {
        cp_async<V>(dst + off, ok ? src + off : base, ok);
      }
    };
    if (row_bytes % 16 == 0) {
      copy_row(std::integral_constant<int, 16>());
    } else if (row_bytes % 8 == 0) {
      copy_row(std::integral_constant<int, 8>());
    } else {
      copy_row(std::integral_constant<int, 4>());
    }
    if constexpr (KV_BITS < 16) {
      const float* sb = side == 0 ? (pool ? k_scale : chunk_k_scale)
                                  : (pool ? v_scale : chunk_v_scale);
      float* sd = reinterpret_cast<float*>(st + 2 * L::RAW) + side * KT + my_t;
      cp_async<4>(sd, ok ? sb + row : sb, ok);
    }
  };

  // the block's Q rows (bf16, zero-filled past nr rows) in one commit group
  T* qs = reinterpret_cast<T*>(smem + L::Q);
  auto copy_q = [&](auto vec) {
    constexpr int V = decltype(vec)::value;
    const int cpr = 2 * d / V;
    for (int c = tid; c < PF_TQ * cpr; c += PF_THREADS) {
      const int r = c / cpr, off = (c - r * cpr) * V;
      const bool ok = r < nr;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(q + (head_row0 + r0 + r) * d);
      cp_async<V>(reinterpret_cast<uint8_t*>(qs + r * TP) + off,
                  ok ? src + off : reinterpret_cast<const uint8_t*>(q), ok);
    }
  };
  if (2 * d % 16 == 0) {
    copy_q(std::integral_constant<int, 16>());
  } else if (2 * d % 8 == 0) {
    copy_q(std::integral_constant<int, 8>());
  } else {
    copy_q(std::integral_constant<int, 4>());
  }
  cp_async_commit();
  // then one commit group per tile (empty past the last), so waiting for all
  // but the newest AHEAD - 1 groups means the oldest tile has landed
  constexpr int AHEAD = L::STAGES - 1;
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) {
    if (a < n_tiles) issue(a, tile_row(a));
    cp_async_commit();
  }
  // page-table lookups run two tiles ahead of the copies they feed
  int64_t row_next = AHEAD < n_tiles ? tile_row(AHEAD) : -1;
  int64_t row_after = AHEAD + 1 < n_tiles ? tile_row(AHEAD + 1) : -1;
  cp_async_wait<AHEAD>();  // Q has landed
  __syncthreads();

  const bool warp_live = warp * 16 < nr;
  // this lane's ldmatrix row of the warp's 16 Q rows; the fragments stay in
  // registers up to DP = 128 and are read per K step at DP = 256 (see above)
  constexpr bool Q_IN_REGS = DP <= 128;
  constexpr int KC = DP <= 128 ? KT : 32;  // keys per softmax step
  const T* q_lane = qs + (warp * 16 + (lane & 15)) * TP + (lane >> 4) * 8;
  uint32_t qf[Q_IN_REGS ? DP / 16 : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) ldmatrix_x4(qf[kd], q_lane + kd * 16);
  }
  // this lane's two query rows (g, g + 8): their chunk index, -1 if dead
  int c_row[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    c_row[hh] = r < nr ? (r0 + r) / g_size : -1;
  }
  // scores in the log2 domain: exp2(s * log2 e) = exp(s)
  const float sm_log2 = sm_scale * 1.4426950408889634f;
  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {SOFTMAX_M0, SOFTMAX_M0}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (i + AHEAD < n_tiles) {  // into the stage tile i - 1 used
      issue(i + AHEAD, row_next);
      row_next = row_after;
      if (i + AHEAD + 2 < n_tiles) row_after = tile_row(i + AHEAD + 2);
    }
    cp_async_commit();
    const bool pool = i < n_pool;
    const int t0 = pool ? win_lo + i * KT : j_lo + (i - n_pool) * KT;
    const int nt = min(KT, (pool ? ctx : j_end) - t0);
    const uint8_t* st = smem + L::RING + (i % L::STAGES) * L::STAGE;
    const T* ks;
    const T* vs;
    const float* kf = nullptr;
    const float* vf = nullptr;
    if constexpr (KV_BITS == 16) {
      ks = reinterpret_cast<const T*>(st);
      vs = reinterpret_cast<const T*>(st + L::TILE);
    } else {
      // raw payload -> bf16 tiles (exact), scales -> per-key factors.  Thread
      // (t, side) converts row t of K or V in 16-byte chunks, fully unrolled;
      // the chunk order is skewed by t so that the 8 lanes of a shared-memory
      // phase read 8 different bank groups.
      constexpr int CPR = L::RAW_PITCH / 16;  // chunks per raw row (zero past d)
      uint8_t* kc = smem + L::CONV;
      const uint8_t* src_row = st + side * L::RAW + my_t * L::RAW_PITCH;
      uint8_t* dst_row = kc + side * L::TILE + my_t * TP * 2;
#pragma unroll
      for (int j = 0; j < CPR; ++j) {
        const int ck = (j + my_t) & (CPR - 1);
        int_chunk_to_bf16<KV_BITS>(*reinterpret_cast<const uint4*>(src_row + 16 * ck),
                                   dst_row + (KV_BITS == 8 ? 32 : 64) * ck);
      }
      {  // the K factors, then the V factors
        const float raw = reinterpret_cast<const float*>(st + 2 * L::RAW)[tid];
        reinterpret_cast<float*>(smem + L::KF)[tid] = tid < KT ? raw * sm_log2 : raw;
      }
      __syncthreads();  // converted
      ks = reinterpret_cast<const T*>(kc);
      vs = reinterpret_cast<const T*>(kc + L::TILE);
      kf = reinterpret_cast<const float*>(smem + L::KF);
      vf = reinterpret_cast<const float*>(smem + L::VF);
    }
    if (!warp_live) continue;

    // the tile's keys in steps of KC, each its own online-softmax update: at
    // DP = 256 the warp's 16 x 64 S tile would not fit in registers beside
    // the output accumulator, so there KC = 32 (and a step past the tile's
    // nt keys, all masked, is skipped: it would change nothing)
#pragma unroll 1
    for (int kc0 = 0; kc0 < (KC == KT ? 1 : nt); kc0 += KC) {
      // S = Q K^T: 16 rows x KC keys per warp, f32
      float s[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        uint32_t qa[4];
        if constexpr (Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kd][e];
        } else {
          ldmatrix_x4(qa, q_lane + kd * 16);
        }
#pragma unroll
        for (int np = 0; np < KC / 16; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + (kc0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * TP + kd * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16_16816(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      // scale, mask, online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // the row sees tile keys t_lo..t_hi: pool keys all lie below the
        // chunk (causal for free), chunk keys up to its own index c; a window
        // cuts both from below; a dead row sees none
        const int c = c_row[hh];
        int t_lo = 0, t_hi = nt - 1;
        if (c < 0) {
          t_hi = -1;
        } else if (pool) {
          if (window > 0) t_lo = ctx + c - window + 1 - t0;
        } else {
          t_hi = min(t_hi, c - t0);
          if (window > 0) t_lo = c - window + 1 - t0;
        }
        float mx = SOFTMAX_M0;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int t = kc0 + j * 8 + 2 * qd + e2;
            const bool ok = t >= t_lo && t <= t_hi;
            const float f = KV_BITS == 16 ? sm_log2 : kf[t];
            const float v = ok ? s[j][2 * hh + e2] * f : -INFINITY;
            s[j][2 * hh + e2] = v;
            mx = fmaxf(mx, v);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hh], mx);
        alpha[hh] = exp2f(m_run[hh] - m_new);
        m_run[hh] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {  // masked: exp2(-inf) = 0
            const float p = exp2f(s[j][2 * hh + e2] - m_new);
            s[j][2 * hh + e2] = p;
            sum += p;
          }
        }
        l_run[hh] = l_run[hh] * alpha[hh] + sum;  // this lane's share of the row sum
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // O += (P * v_scale) V.  P's accumulator layout is the A fragment
      // layout; P * v_scale (f32) goes in as two bf16 terms, hi + lo, so the
      // weights keep about 16 bits (one bf16 rounding would keep 8)
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int half_k = 0; half_k < 2; ++half_k) {  // keys 16kk + (0..7) and + (8..15)
          const int j = 2 * kk + half_k;
          const int t = kc0 + j * 8 + 2 * qd;
          const float v0 = KV_BITS == 16 ? 1.f : vf[t];
          const float v1 = KV_BITS == 16 ? 1.f : vf[t + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float x0 = s[j][2 * hh] * v0, x1 = s[j][2 * hh + 1] * v1;
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            const __nv_bfloat162 lo =
                __floats2bfloat162_rn(x0 - __low2float(hi), x1 - __high2float(hi));
            ph[2 * half_k + hh] = *reinterpret_cast<const uint32_t*>(&hi);
            pl[2 * half_k + hh] = *reinterpret_cast<const uint32_t*>(&lo);
          }
        }
#pragma unroll
        for (int dp = 0; dp < DP / 16; dp += 2) {  // 4 accumulators between dependent mma
          uint32_t vb[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            ldmatrix_x4_trans(
                vb[u], vs + (kc0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TP +
                           (dp + u) * 16 + (lane >> 4) * 8);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            mma_bf16_16816(o[2 * (dp + u)], ph, vb[u][0], vb[u][1]);
            mma_bf16_16816(o[2 * (dp + u) + 1], ph, vb[u][2], vb[u][3]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            mma_bf16_16816(o[2 * (dp + u)], pl, vb[u][0], vb[u][1]);
            mma_bf16_16816(o[2 * (dp + u) + 1], pl, vb[u][2], vb[u][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) return;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-20f);
    const int r = warp * 16 + g + 8 * hh;
    if (r >= nr) continue;
    T* orow = out + (head_row0 + r0 + r) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int e = j * 8 + 2 * qd;
      if (e < d) {
        __nv_bfloat162 v = __floats2bfloat162_rn(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(orow + e) = v;
      }
    }
  }
}

// ---------------------------------------------------------------- f32 kernel

// Shared memory of the f32 kernel at padded head dim dp, kv_bits and r row
// warps, with kt keys a tile: the bf16 terms of q (nq tiles of 16 r rows of
// dp + 8 elements), then a ring of K / V stages: kv16 two stages of f32 rows
// of 4 dp + 16 bytes, each split in place into bf16 hi | lo halves; int8 /
// int4 three stages of raw payload rows and scales, plus the bf16 K / V tiles
// and per-key factors converted from the current stage, as in the bf16
// kernel.
__host__ __device__ constexpr int pf32_bytes(int dp, int kv_bits, int r, int kt) {
  return (kv_bits == 16 ? 2 : 3) * 16 * r * (dp + 8) * 2 +
         (kv_bits == 16 ? 2 * 2 * kt * (4 * dp + 16)
                        : 3 * (2 * kt * (kv_bits == 8 ? dp : dp / 2) + 2 * kt * 4) +
                              2 * kt * (dp + 8) * 2 + 2 * kt * 4);
}
// Keys a tile: 64, or 32 where 64 would not fit in a block's shared memory.
__host__ __device__ constexpr int pf32_keys_per_tile(int dp, int kv_bits, int r) {
  return pf32_bytes(dp, kv_bits, r, 64) <= PF_SMEM_MAX ? 64 : 32;
}
// Row warps a block takes for C * G query rows: the fewest of 1, 2, 4 whose
// 16-row groups hold them.
__host__ __device__ constexpr int pf32_row_warps(int rows) {
  return rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
}

template <int DP, int KV_BITS, int R>
struct PfF32 {
  static constexpr int RB = 16 * R;                // query rows a block
  static constexpr int NQ = KV_BITS == 16 ? 2 : 3;  // bf16 terms of q
  static constexpr int TQ = DP + 8;     // bf16 elements a Q term row / converted K, V row
  static constexpr int P32 = 4 * DP + 16;  // bytes of an f32 kv16 row (an odd multiple of 16)
  static constexpr int RAW_PITCH = KV_BITS == 8 ? DP : DP / 2;
  static constexpr int STAGES = KV_BITS == 16 ? 2 : 3;  // tiles in flight: STAGES - 1
  static constexpr int KT = pf32_keys_per_tile(DP, KV_BITS, R);
  static constexpr int S = 4 / R < KT / 16 ? 4 / R : KT / 16;  // key warps of a row group
  static constexpr int KW = KT / S;  // keys of a tile a warp takes
  static constexpr int KC = KW < (DP <= 128 ? 64 : 32) ? KW : (DP <= 128 ? 64 : 32);
  static constexpr int RING = NQ * RB * TQ * 2;
  static constexpr int STAGE = KV_BITS == 16 ? 2 * KT * P32 : 2 * KT * RAW_PITCH + 2 * KT * 4;
  static constexpr int CONV = RING + STAGES * STAGE;  // int: bf16 K, V tiles
  static constexpr int TILE = KT * TQ * 2;
  static constexpr int KF = CONV + 2 * TILE;
  static constexpr int VF = KF + KT * 4;
  static constexpr int BYTES = pf32_bytes(DP, KV_BITS, R, KT);
  static constexpr int REC = DP / 2 + 4;  // in-block merge: o, m, l of a lane, floats
  static_assert(BYTES <= PF_SMEM_MAX, "f32 prefill: shared memory");
  static_assert(KV_BITS == 16 || VF + KT * 4 == BYTES, "f32 prefill: layout");
  static_assert((S - 1) * R * 32 * REC * 4 <= BYTES, "f32 prefill: merge space");
  static_assert(KW >= 16 && KW % KC == 0 && KC % 16 == 0, "f32 prefill: key steps");
};

// The f32 kernels' arguments (see the entry points paged_prefill_f32 /
// paged_prefill_f32_split).
struct PfF32Args {
  const float* q;            // [B, Hkv, C, G, D]
  const uint8_t* k_pool;     // [L, P, ps, Hkv, Dk] as stored
  const uint8_t* v_pool;
  const float* k_scale;      // [L, P, ps, Hkv, 1], null for f32 pools
  const float* v_scale;
  const int32_t* tables;     // [B, W]
  const int32_t* ctx_lens;   // [B]
  const int32_t* q_lens;     // [B]
  const uint8_t* chunk_k;    // [B, Hkv, C, Dk]
  const uint8_t* chunk_v;
  const float* chunk_k_scale;  // [B, Hkv, C, 1], null for f32 pools
  const float* chunk_v_scale;
  float* out;                // [B, Hkv, C, G, D]
  float* part;               // [B, Hkv, C * G, n_split, 4 * ceil(D / 4) + 4], or null
  int layer, n_pages, ps, hkv, g_size, d, w, c_len, window, n_split;
  float sm_scale;
};

// The key tiles of row b's query rows [r0, r0 + nr), kt keys a tile: pool
// positions [win_lo, pool_end), then chunk keys [j_lo, j_end); and how they
// split: `per` tiles a split, n_live splits hold any (at least 1).  Both
// launches compute it from the same inputs on the card.
struct PfTiles {
  int ctx, win_lo, pool_end, n_pool, j_lo, j_end, n_tiles, per, n_live;
};
__device__ __forceinline__ PfTiles pf_tiles(const PfF32Args& a, int b, int r0, int nr, int kt) {
  PfTiles t;
  t.ctx = a.ctx_lens[b];
  const int c_first = r0 / a.g_size, c_last = (r0 + nr - 1) / a.g_size;
  t.pool_end = min(t.ctx, a.w * a.ps);
  t.win_lo = a.window > 0 ? max(t.ctx + c_first + 1 - a.window, 0) : 0;
  t.n_pool = t.pool_end > t.win_lo ? (t.pool_end - t.win_lo + kt - 1) / kt : 0;
  t.j_lo = a.window > 0 ? max(c_first + 1 - a.window, 0) : 0;
  t.j_end = min(a.q_lens[b], c_last + 1);
  t.n_tiles = t.n_pool + (t.j_end > t.j_lo ? (t.j_end - t.j_lo + kt - 1) / kt : 0);
  t.per = max(1, (t.n_tiles + a.n_split - 1) / a.n_split);
  t.n_live = max(1, (t.n_tiles + t.per - 1) / t.per);
  return t;
}

// Rows [0, n) of DP f32 values at a pitch of 4 DP + 16 bytes -> in place,
// each row's bf16 hi (elements [0, DP)) and lo ([DP, 2 DP)) halves; dims past
// d are 0 (the copies wrote d of them).  A warp takes whole rows: its lanes
// read a row, then write it.
template <int DP>
__device__ __forceinline__ void split_rows_in_place(uint8_t* base, int n, int d, int warp,
                                                    int lane) {
  constexpr int P32 = 4 * DP + 16, CH = DP / 4;  // float4 chunks a row
  constexpr int LPR = CH < 32 ? CH : 32, RPW = 32 / LPR, CPL = CH / LPR;
  const int sub = lane / LPR, l = lane - sub * LPR;
  for (int row = warp * RPW + sub; row < n; row += (PF_THREADS / 32) * RPW) {
    uint8_t* rp = base + row * P32;
    float4 x[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) x[c] = reinterpret_cast<const float4*>(rp)[l + c * LPR];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int e = 4 * (l + c * LPR);
      const float v[4] = {e < d ? x[c].x : 0.f, e + 1 < d ? x[c].y : 0.f,
                          e + 2 < d ? x[c].z : 0.f, e + 3 < d ? x[c].w : 0.f};
      uint32_t t0[2], t1[2];
      split_bf16x2<2>(v[0], v[1], t0);
      split_bf16x2<2>(v[2], v[3], t1);
      *reinterpret_cast<uint2*>(rp + 2 * e) = make_uint2(t0[0], t1[0]);
      *reinterpret_cast<uint2*>(rp + 2 * DP + 2 * e) = make_uint2(t0[1], t1[1]);
    }
  }
}

// Block (b, kv head, row block z x n_split + split), 4 warps: warp = row
// group rg (16 query rows) x key part kp of S; see the note at the top.
template <int DP, int KV_BITS, int R>
__global__ void __launch_bounds__(PF_THREADS) paged_prefill_f32_kernel(const PfF32Args a) {
  using L = PfF32<DP, KV_BITS, R>;
  using T = __nv_bfloat16;
  constexpr int KT = L::KT, S = L::S, KW = L::KW, KC = L::KC, TQ = L::TQ, RB = L::RB;
  constexpr int NQ = L::NQ, NP = NQ;  // bf16 terms of q, of P
  constexpr int PK = KV_BITS == 16 ? L::P32 / 2 : TQ;  // bf16 elements between K / V rows
  constexpr int PARTS = PF_THREADS / (2 * KT);          // threads a K or V row: 1 or 2
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int zb = blockIdx.z / a.n_split, split = blockIdx.z - zb * a.n_split;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, qd = lane & 3;
  const int rg = warp / S, kp = warp - rg * S;
  const int d = a.d, hkv = a.hkv, ps = a.ps;
  const int n_rows = a.c_len * a.g_size;
  const int r0 = zb * RB;
  const int nr = min(RB, n_rows - r0);
  const PfTiles tl = pf_tiles(a, b, r0, nr, KT);
  if (split >= tl.n_live) return;  // the whole block: no partial of it is read
  const int i_begin = split * tl.per, i_end = min(tl.n_tiles, i_begin + tl.per);
  const int n_my = max(i_end - i_begin, 0);
  const int row_bytes = KV_BITS == 16 ? 4 * d : kv_row_bytes(d, KV_BITS);
  const int64_t head_row0 = (int64_t)(b * hkv + h) * n_rows;  // query row r of (b, h)
  const int64_t chunk_row0 = (int64_t)(b * hkv + h) * a.c_len;  // chunk key j of (b, h)
  const float sm_log2 = a.sm_scale * 1.4426950408889634f;

  // int payloads: a head dim below DP leaves raw bytes no copy writes; zero
  // the ring and tiles once, so they stay 0 (kv16 masks them as it splits)
  if constexpr (KV_BITS < 16) {
    if (d < DP) {
      for (int i = L::RING / 16 + tid; i < L::BYTES / 16; i += PF_THREADS)
        reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
      __syncthreads();
    }
  }

  // The copies of a tile, as in the bf16 kernel: thread (t, side, part)
  // copies its share of the K (side 0) or V (side 1) row of key t.
  const int my_t = tid % KT, side = PARTS == 1 ? tid / KT : (tid / KT) & 1;
  const int part = PARTS == 1 ? 0 : tid / (2 * KT);
  auto tile_row = [&](int i) -> int64_t {
    const bool pool = i < tl.n_pool;
    const int pos = (pool ? tl.win_lo + i * KT : tl.j_lo + (i - tl.n_pool) * KT) + my_t;
    if (pos >= (pool ? tl.pool_end : tl.j_end)) return -1;
    if (!pool) return chunk_row0 + pos;
    const int page = a.tables[(int64_t)b * a.w + pos / ps];
    return (((int64_t)a.layer * a.n_pages + page) * ps + pos % ps) * hkv + h;
  };
  auto issue = [&](int i, int64_t row) {
    const bool pool = i < tl.n_pool;
    const bool ok = row >= 0;
    uint8_t* st = smem + L::RING + ((i - i_begin) % L::STAGES) * L::STAGE;
    uint8_t* dst = st + (KV_BITS == 16 ? (side * KT + my_t) * L::P32
                                       : (side * KT + my_t) * L::RAW_PITCH);
    const uint8_t* base = side == 0 ? (pool ? a.k_pool : a.chunk_k) : (pool ? a.v_pool : a.chunk_v);
    const uint8_t* src = ok ? base + row * row_bytes : base;
    auto copy_row = [&](auto vec) {
      constexpr int V = decltype(vec)::value;
      for (int off = part * V; off < row_bytes; off += PARTS * V) {
        cp_async<V>(dst + off, ok ? src + off : base, ok);
      }
    };
    if (row_bytes % 16 == 0) {
      copy_row(std::integral_constant<int, 16>());
    } else if (row_bytes % 8 == 0) {
      copy_row(std::integral_constant<int, 8>());
    } else {
      copy_row(std::integral_constant<int, 4>());
    }
    if constexpr (KV_BITS < 16) {
      if (part == 0) {
        const float* sb = side == 0 ? (pool ? a.k_scale : a.chunk_k_scale)
                                    : (pool ? a.v_scale : a.chunk_v_scale);
        float* sd = reinterpret_cast<float*>(st + 2 * KT * L::RAW_PITCH) + side * KT + my_t;
        cp_async<4>(sd, ok ? sb + row : sb, ok);
      }
    }
  };
  // one commit group per tile (empty past the split's last), so waiting for
  // all but the newest AHEAD - 1 groups means the oldest tile has landed
  constexpr int AHEAD = L::STAGES - 1;
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) {
    if (u < n_my) issue(i_begin + u, tile_row(i_begin + u));
    cp_async_commit();
  }
  // page-table lookups run two tiles ahead of the copies they feed
  int64_t row_next = AHEAD < n_my ? tile_row(i_begin + AHEAD) : -1;
  int64_t row_after = AHEAD + 1 < n_my ? tile_row(i_begin + AHEAD + 1) : -1;

  // q -> NQ bf16 term tiles (zero past nr rows and d dims), while the first
  // tiles are in flight; the loop's first barrier publishes them
  T* qt = reinterpret_cast<T*>(smem);
  {
    constexpr int PAIRS = RB * DP / 2, BATCH = 8;
    for (int p0 = tid; p0 < PAIRS; p0 += BATCH * PF_THREADS) {
      float2 x[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int p = p0 + u * PF_THREADS, r = p / (DP / 2), e = 2 * (p - r * (DP / 2));
        x[u] = p < PAIRS && r < nr && e < d
                   ? __ldg(reinterpret_cast<const float2*>(a.q + (head_row0 + r0 + r) * d + e))
                   : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int p = p0 + u * PF_THREADS, r = p / (DP / 2), e = 2 * (p - r * (DP / 2));
        if (p < PAIRS) {
          uint32_t t[NQ];
          split_bf16x2<NQ>(x[u].x, x[u].y, t);
#pragma unroll
          for (int k = 0; k < NQ; ++k)
            *reinterpret_cast<uint32_t*>(qt + (k * RB + r) * TQ + e) = t[k];
        }
      }
    }
  }

  const bool warp_live = rg < R && rg * 16 < nr;
  const T* q_lane = qt + (rg * 16 + (lane & 15)) * TQ + (lane >> 4) * 8;  // term k: + k RB TQ
  // this lane's two query rows (g, g + 8): their chunk index, -1 if dead
  int c_row[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rg * 16 + g + 8 * hh;
    c_row[hh] = r < nr ? (r0 + r) / a.g_size : -1;
  }
  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {SOFTMAX_M0, SOFTMAX_M0}, l_run[2] = {0.f, 0.f};

  for (int i = i_begin; i < i_end; ++i) {
    const int li = i - i_begin;
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (li + AHEAD < n_my) {  // into the stage tile i - 1 used
      issue(i + AHEAD, row_next);
      row_next = row_after;
      if (li + AHEAD + 2 < n_my) row_after = tile_row(i + AHEAD + 2);
    }
    cp_async_commit();
    const bool pool = i < tl.n_pool;
    const int t0 = pool ? tl.win_lo + i * KT : tl.j_lo + (i - tl.n_pool) * KT;
    const int nt = min(KT, (pool ? tl.pool_end : tl.j_end) - t0);
    uint8_t* st = smem + L::RING + (li % L::STAGES) * L::STAGE;
    const T* ks;  // K rows (kv16: hi halves; lo at + DP)
    const T* vs;
    const float* kf = nullptr;
    const float* vf = nullptr;
    if constexpr (KV_BITS == 16) {
      split_rows_in_place<DP>(st, 2 * KT, d, warp, lane);
      __syncthreads();  // split
      ks = reinterpret_cast<const T*>(st);
      vs = reinterpret_cast<const T*>(st + KT * L::P32);
    } else {
      // raw payload -> bf16 tiles (exact), scales -> per-key factors, as in
      // the bf16 kernel (thread (t, side, part): its share of row t)
      constexpr int CPR = L::RAW_PITCH / 16;
      uint8_t* kc = smem + L::CONV;
      const uint8_t* src_row = st + (side * KT + my_t) * L::RAW_PITCH;
      uint8_t* dst_row = kc + side * L::TILE + my_t * TQ * 2;
#pragma unroll
      for (int jp = 0; jp < CPR / PARTS; ++jp) {
        const int ck = (jp * PARTS + part + my_t) & (CPR - 1);
        int_chunk_to_bf16<KV_BITS>(*reinterpret_cast<const uint4*>(src_row + 16 * ck),
                                   dst_row + (KV_BITS == 8 ? 32 : 64) * ck);
      }
      if (tid < 2 * KT) {  // the K factors, then the V factors
        const float raw = reinterpret_cast<const float*>(st + 2 * KT * L::RAW_PITCH)[tid];
        reinterpret_cast<float*>(smem + L::KF)[tid] = tid < KT ? raw * sm_log2 : raw;
      }
      __syncthreads();  // converted
      ks = reinterpret_cast<const T*>(kc);
      vs = reinterpret_cast<const T*>(kc + L::TILE);
      kf = reinterpret_cast<const float*>(smem + L::KF);
      vf = reinterpret_cast<const float*>(smem + L::VF);
    }
    if (!warp_live) continue;

    // this warp's keys of the tile, [kp KW, kp KW + KW), KC a step (a step
    // past the tile's nt keys, all masked, is skipped: it would change nothing)
#pragma unroll 1
    for (int kc0 = kp * KW; kc0 < kp * KW + KW; kc0 += KC) {
      if (kc0 >= nt) break;
      // S = Q K^T from the terms, smallest first: int K q3, q2, q1 against
      // K; f32 K q2 k_hi, q1 k_lo, q1 k_hi
      float s[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        uint32_t qa[NQ][4];
#pragma unroll
        for (int k = 0; k < NQ; ++k) ldmatrix_x4(qa[k], q_lane + k * RB * TQ + kd * 16);
        // the terms' mma for keys np * 16 .. + 15: kb = K (kv16: k_hi), kl = k_lo
        auto s_mma = [&](int np, const uint32_t(&kb)[4], const uint32_t(&kl)[4]) {
          if constexpr (KV_BITS == 16) {
            mma_bf16_16816(s[2 * np], qa[1], kb[0], kb[1]);
            mma_bf16_16816(s[2 * np + 1], qa[1], kb[2], kb[3]);
            mma_bf16_16816(s[2 * np], qa[0], kl[0], kl[1]);
            mma_bf16_16816(s[2 * np + 1], qa[0], kl[2], kl[3]);
            mma_bf16_16816(s[2 * np], qa[0], kb[0], kb[1]);
            mma_bf16_16816(s[2 * np + 1], qa[0], kb[2], kb[3]);
          } else {
#pragma unroll
            for (int k = NQ - 1; k >= 0; --k) {
              mma_bf16_16816(s[2 * np], qa[k], kb[0], kb[1]);
              mma_bf16_16816(s[2 * np + 1], qa[k], kb[2], kb[3]);
            }
          }
        };
        // K fragments: all of the step's at once, or at DP = 256 (registers)
        // one 16-key block at a time
        constexpr int NB = DP == 256 ? 1 : KC / 16;
#pragma unroll
        for (int np0 = 0; np0 < KC / 16; np0 += NB) {
          uint32_t kb[NB][4], kl[NB][4];
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const T* kr = ks + (kc0 + (np0 + u) * 16 + (lane & 7) + (lane >> 4) * 8) * PK +
                          kd * 16 + ((lane >> 3) & 1) * 8;
            ldmatrix_x4(kb[u], kr);
            if constexpr (KV_BITS == 16) ldmatrix_x4(kl[u], kr + DP);
          }
#pragma unroll
          for (int u = 0; u < NB; ++u) s_mma(np0 + u, kb[u], kl[u]);
        }
      }
      // scale, mask, online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = c_row[hh];
        int t_lo = 0, t_hi = nt - 1;
        if (c < 0) {
          t_hi = -1;
        } else if (pool) {
          if (a.window > 0) t_lo = tl.ctx + c - a.window + 1 - t0;
        } else {
          t_hi = min(t_hi, c - t0);
          if (a.window > 0) t_lo = c - a.window + 1 - t0;
        }
        float mx = SOFTMAX_M0;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int t = kc0 + j * 8 + 2 * qd + e2;
            const bool ok = t >= t_lo && t <= t_hi;
            const float f = KV_BITS == 16 ? sm_log2 : kf[t];
            const float v = ok ? s[j][2 * hh + e2] * f : -INFINITY;
            s[j][2 * hh + e2] = v;
            mx = fmaxf(mx, v);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hh], mx);
        alpha[hh] = exp2f(m_run[hh] - m_new);
        m_run[hh] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {  // masked: exp2(-inf) = 0
            const float p = exp2f(s[j][2 * hh + e2] - m_new);
            s[j][2 * hh + e2] = p;
            sum += p;
          }
        }
        l_run[hh] = l_run[hh] * alpha[hh] + sum;  // this lane's share of the row sum
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // O += (P * v_scale) V from bf16 terms of P * v_scale: int V (exact)
      // against three (p1 + p2 + p3, 2^-24), f32 V as p1 v_hi + p1 v_lo +
      // p2 v_hi; smallest first
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t pt[NP][4];
#pragma unroll
        for (int half_k = 0; half_k < 2; ++half_k) {  // keys 16kk + (0..7) and + (8..15)
          const int j = 2 * kk + half_k;
          const int t = kc0 + j * 8 + 2 * qd;
          const float v0 = KV_BITS == 16 ? 1.f : vf[t];
          const float v1 = KV_BITS == 16 ? 1.f : vf[t + 1];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            uint32_t x[NP];
            split_bf16x2<NP>(s[j][2 * hh] * v0, s[j][2 * hh + 1] * v1, x);
#pragma unroll
            for (int k = 0; k < NP; ++k) pt[k][2 * half_k + hh] = x[k];
          }
        }
        const T* vr = vs + (kc0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PK +
                      (lane >> 4) * 8;
        // V fragments of UB 16-dim blocks a step (2: 4 accumulators between
        // dependent mma; 1 for f32 V at DP = 256, for registers)
        constexpr int UB = DP == 256 && KV_BITS == 16 ? 1 : 2;
#pragma unroll
        for (int dp = 0; dp < DP / 16; dp += UB) {
          uint32_t vb[UB][4], vl[UB][4];
#pragma unroll
          for (int u = 0; u < UB; ++u) {
            ldmatrix_x4_trans(vb[u], vr + (dp + u) * 16);
            if constexpr (KV_BITS == 16) ldmatrix_x4_trans(vl[u], vr + DP + (dp + u) * 16);
          }
          auto mma_pv = [&](const uint32_t(&pa)[4], const uint32_t(&vv)[UB][4]) {
#pragma unroll
            for (int u = 0; u < UB; ++u) {
              mma_bf16_16816(o[2 * (dp + u)], pa, vv[u][0], vv[u][1]);
              mma_bf16_16816(o[2 * (dp + u) + 1], pa, vv[u][2], vv[u][3]);
            }
          };
          if constexpr (KV_BITS == 16) {
            mma_pv(pt[1], vb);
            mma_pv(pt[0], vl);
            mma_pv(pt[0], vb);
          } else {
#pragma unroll
            for (int k = NP - 1; k >= 0; --k) mma_pv(pt[k], vb);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float l_row[2];  // the rows' sums over their quads
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_row[hh] = l_run[hh] + __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_row[hh] += __shfl_xor_sync(0xffffffffu, l_row[hh], 2);
  }
  if constexpr (S > 1) {
    // key parts 1 .. S - 1 hand (o, m, l) to part 0 through shared memory
    // (every warp is past its last tile: the ring and Q are free), which
    // merges them in part order
    constexpr int REC = L::REC;
    float* mb = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (warp_live && kp > 0) {
      float* rec = mb + ((kp - 1) * R + rg) * REC * 32 + lane;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rec[(4 * j + e) * 32] = o[j][e];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rec[(DP / 2 + hh) * 32] = m_run[hh];
        rec[(DP / 2 + 2 + hh) * 32] = l_row[hh];
      }
    }
    __syncthreads();
    if (!warp_live || kp > 0) return;
#pragma unroll 1
    for (int k = 1; k < S; ++k) {
      const float* rec = mb + ((k - 1) * R + rg) * REC * 32 + lane;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_k = rec[(DP / 2 + hh) * 32];
        const float m_new = fmaxf(m_run[hh], m_k);
        const float a_own = exp2f(m_run[hh] - m_new), a_k = exp2f(m_k - m_new);
        m_run[hh] = m_new;
        l_row[hh] = l_row[hh] * a_own + rec[(DP / 2 + 2 + hh) * 32] * a_k;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          o[j][2 * hh] = o[j][2 * hh] * a_own + rec[(4 * j + 2 * hh) * 32] * a_k;
          o[j][2 * hh + 1] = o[j][2 * hh + 1] * a_own + rec[(4 * j + 2 * hh + 1) * 32] * a_k;
        }
      }
    }
  } else {
    if (!warp_live) return;
  }

  // the rows: whole (one live split) or this split's partial (o, m, l)
  const bool whole = tl.n_live == 1;
  const int du4 = 4 * ((d + 3) / 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rg * 16 + g + 8 * hh;
    if (r >= nr) continue;
    const int64_t grow = head_row0 + r0 + r;
    const float inv = whole ? 1.f / fmaxf(l_row[hh], 1e-20f) : 1.f;
    float* dst = whole ? a.out + grow * d : a.part + (grow * a.n_split + split) * (du4 + 4);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int e = j * 8 + 2 * qd;
      if (e < d)
        *reinterpret_cast<float2*>(dst + e) =
            make_float2(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
    }
    if (!whole && qd == 0) {
      dst[du4] = m_run[hh];
      dst[du4 + 1] = l_row[hh];
    }
  }
}

// The second launch: warp (b, kv head, query row) merges that row's live
// partials in split order (rows whose tiles one split held were written by
// the first launch).  Each lane takes D / 64 float2 of the row; the partials
// of 8 splits are loaded before they are added, so the L2 round trips
// overlap.  The same inputs give the same bits.
constexpr int PF_MERGE_WARPS = 4;
__global__ void __launch_bounds__(32 * PF_MERGE_WARPS)
    paged_prefill_f32_merge_kernel(const PfF32Args a, int kt, int rb) {
  constexpr int UN = 4, SB = 8;  // float2 units a lane (D <= 256), splits a batch
  const int b = blockIdx.x, h = blockIdx.y, lane = threadIdx.x & 31;
  const int n_rows = a.c_len * a.g_size;
  const int r = blockIdx.z * PF_MERGE_WARPS + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int r0 = r / rb * rb;
  const PfTiles tl = pf_tiles(a, b, r0, min(rb, n_rows - r0), kt);
  if (tl.n_live == 1) return;
  const int d = a.d, du4 = 4 * ((d + 3) / 4), stride = du4 + 4;
  const int64_t grow = (int64_t)(b * a.hkv + h) * n_rows + r;
  const float* rec = a.part + grow * a.n_split * stride;
  float mx = SOFTMAX_M0;
  for (int s = 0; s < tl.n_live; ++s) mx = fmaxf(mx, __ldcg(rec + s * stride + du4));
  float2 acc[UN];
#pragma unroll
  for (int u = 0; u < UN; ++u) acc[u] = make_float2(0.f, 0.f);
  float den = 0.f;
  for (int s0 = 0; s0 < tl.n_live; s0 += SB) {
    float2 ml[SB], v[SB][UN];
#pragma unroll
    for (int k = 0; k < SB; ++k) {
      const bool live = s0 + k < tl.n_live;
      const float* rs = rec + (int64_t)(live ? s0 + k : 0) * stride;
      ml[k] = live ? __ldcg(reinterpret_cast<const float2*>(rs + du4)) : make_float2(mx, 0.f);
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        const int e = 2 * (lane + 32 * u);
        v[k][u] = live && e < d ? __ldcg(reinterpret_cast<const float2*>(rs + e))
                                : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < SB; ++k) {
      const float wk = s0 + k < tl.n_live ? exp2f(ml[k].x - mx) : 0.f;
      den = fmaf(wk, ml[k].y, den);
#pragma unroll
      for (int u = 0; u < UN; ++u) {
        acc[u].x = fmaf(wk, v[k][u].x, acc[u].x);
        acc[u].y = fmaf(wk, v[k][u].y, acc[u].y);
      }
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-20f);
#pragma unroll
  for (int u = 0; u < UN; ++u) {
    const int e = 2 * (lane + 32 * u);
    if (e < d)
      *reinterpret_cast<float2*>(a.out + grow * d + e) = make_float2(acc[u].x * inv, acc[u].y * inv);
  }
}

template <int DP, int KV_BITS>
cudaError_t launch_prefill(dim3 grid, cudaStream_t s, const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale, const void* v_scale,
                           const void* tables, const void* ctx_lens, const void* q_lens,
                           const void* chunk_k, const void* chunk_v,
                           const void* chunk_k_scale, const void* chunk_v_scale, void* out,
                           int layer, int n_pages, int ps, int hkv, int g_size, int d, int w,
                           int c_len, int window, float sm_scale) {
  constexpr int smem = PfSmem<DP, KV_BITS>::BYTES;
  auto kernel = paged_prefill_kernel<DP, KV_BITS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, PF_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), k_pool, v_pool,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ctx_lens),
      static_cast<const int32_t*>(q_lens), chunk_k, chunk_v,
      static_cast<const float*>(chunk_k_scale), static_cast<const float*>(chunk_v_scale),
      static_cast<__nv_bfloat16*>(out), layer, n_pages, ps, hkv, g_size, d, w, c_len, window,
      sm_scale);
  return cudaGetLastError();
}

#define PF_ARGS                                                                       \
  grid, s, q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, q_lens, chunk_k,   \
      chunk_v, chunk_k_scale, chunk_v_scale, out, layer, n_pages, ps, hkv, g_size, d, \
      w, c_len, window, sm_scale

template <int DP>
cudaError_t dispatch_kv(int kv_bits, dim3 grid, cudaStream_t s, const void* q,
                        const void* k_pool, const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* tables, const void* ctx_lens,
                        const void* q_lens, const void* chunk_k, const void* chunk_v,
                        const void* chunk_k_scale, const void* chunk_v_scale, void* out,
                        int layer, int n_pages, int ps, int hkv, int g_size, int d, int w,
                        int c_len, int window, float sm_scale) {
  if (kv_bits == 16) return launch_prefill<DP, 16>(PF_ARGS);
  if (kv_bits == 8) return launch_prefill<DP, 8>(PF_ARGS);
  if (kv_bits == 4) return launch_prefill<DP, 4>(PF_ARGS);
  return cudaErrorInvalidValue;
}

int prefill_bf16_entry(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                       const void* v_scale, const void* tables, const void* ctx_lens,
                       const void* q_lens, const void* chunk_k, const void* chunk_v,
                       const void* chunk_k_scale, const void* chunk_v_scale, void* out,
                       int batch, int layer, int n_pages, int ps, int hkv, int g_size, int d,
                       int w, int c_len, int kv_bits, int window, float sm_scale,
                       void* stream) {
  if (d < 2 || d > 256 || d % 2 || kv_row_bytes(d, kv_bits) % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (c_len * g_size + PF_TQ - 1) / PF_TQ;
  if (batch == 0 || n_tiles == 0) return (int)cudaSuccess;
  dim3 grid(batch, hkv, n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32) {
    err = dispatch_kv<32>(kv_bits, PF_ARGS);
  } else if (d <= 64) {
    err = dispatch_kv<64>(kv_bits, PF_ARGS);
  } else if (d <= 128) {
    err = dispatch_kv<128>(kv_bits, PF_ARGS);
  } else {
    err = dispatch_kv<256>(kv_bits, PF_ARGS);
  }
  return (int)err;
}
#undef PF_ARGS

template <int DP, int KV_BITS, int R>
cudaError_t launch_prefill_f32(const PfF32Args& a, int batch, cudaStream_t s) {
  using L = PfF32<DP, KV_BITS, R>;
  auto kernel = paged_prefill_f32_kernel<DP, KV_BITS, R>;
  cudaError_t err = allow_smem(kernel, L::BYTES);
  if (err != cudaSuccess) return err;
  const int n_rows = a.c_len * a.g_size;
  kernel<<<dim3(batch, a.hkv, (n_rows + L::RB - 1) / L::RB * a.n_split), PF_THREADS, L::BYTES,
           s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  paged_prefill_f32_merge_kernel<<<dim3(batch, a.hkv, (n_rows + PF_MERGE_WARPS - 1) / PF_MERGE_WARPS),
                                   32 * PF_MERGE_WARPS, 0, s>>>(a, L::KT, L::RB);
  return cudaGetLastError();
}

template <int DP, int KV_BITS>
cudaError_t dispatch_f32_rows(const PfF32Args& a, int batch, cudaStream_t s) {
  switch (pf32_row_warps(a.c_len * a.g_size)) {
    case 1: return launch_prefill_f32<DP, KV_BITS, 1>(a, batch, s);
    case 2: return launch_prefill_f32<DP, KV_BITS, 2>(a, batch, s);
    default: return launch_prefill_f32<DP, KV_BITS, 4>(a, batch, s);
  }
}

template <int DP>
cudaError_t dispatch_f32_kv(int kv_bits, const PfF32Args& a, int batch, cudaStream_t s) {
  if (kv_bits == 16) return dispatch_f32_rows<DP, 16>(a, batch, s);
  if (kv_bits == 8) return dispatch_f32_rows<DP, 8>(a, batch, s);
  if (kv_bits == 4) return dispatch_f32_rows<DP, 4>(a, batch, s);
  return cudaErrorInvalidValue;
}

int prefill_f32_entry(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                      const void* v_scale, const void* tables, const void* ctx_lens,
                      const void* q_lens, const void* chunk_k, const void* chunk_v,
                      const void* chunk_k_scale, const void* chunk_v_scale, void* out,
                      void* part, int batch, int layer, int n_pages, int ps, int hkv,
                      int g_size, int d, int w, int c_len, int kv_bits, int window,
                      int n_split, float sm_scale, void* stream) {
  if (d < 2 || d > 256 || d % 2 || (kv_bits == 16 ? 4 * d : kv_row_bytes(d, kv_bits)) % 4 ||
      n_split < 1 || n_split > PF_MAX_SPLITS || (n_split > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || c_len * g_size == 0) return (int)cudaSuccess;
  const PfF32Args a{static_cast<const float*>(q),
                    static_cast<const uint8_t*>(k_pool), static_cast<const uint8_t*>(v_pool),
                    static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                    static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ctx_lens),
                    static_cast<const int32_t*>(q_lens),
                    static_cast<const uint8_t*>(chunk_k), static_cast<const uint8_t*>(chunk_v),
                    static_cast<const float*>(chunk_k_scale),
                    static_cast<const float*>(chunk_v_scale), static_cast<float*>(out),
                    static_cast<float*>(part), layer, n_pages, ps, hkv, g_size, d, w, c_len,
                    window, n_split, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32) {
    err = dispatch_f32_kv<32>(kv_bits, a, batch, s);
  } else if (d <= 64) {
    err = dispatch_f32_kv<64>(kv_bits, a, batch, s);
  } else if (d <= 128) {
    err = dispatch_f32_kv<128>(kv_bits, a, batch, s);
  } else {
    err = dispatch_f32_kv<256>(kv_bits, a, batch, s);
  }
  return (int)err;
}

template <int DP>
int bf16_smem(int kv_bits) {
  return kv_bits == 16 ? PfSmem<DP, 16>::BYTES
         : kv_bits == 8 ? PfSmem<DP, 8>::BYTES
                        : PfSmem<DP, 4>::BYTES;
}

}  // namespace

// Query rows per block of the bf16 kernel (grid z = ceil(C * G / this)); the
// f32 kernel's blocks take 16, 32 or 64 (paged_prefill_f32_row_warps x 16).
extern "C" int paged_prefill_rows_per_block() { return PF_TQ; }

// Row warps of an f32 block for C * G query rows.
extern "C" int paged_prefill_f32_row_warps(int rows) { return pf32_row_warps(rows); }

// Keys a tile of the f32 kernel at padded head dim dp, kv_bits and row warps.
extern "C" int paged_prefill_f32_keys_per_tile(int dp, int kv_bits, int row_warps) {
  return pf32_keys_per_tile(dp, kv_bits, row_warps);
}

// Dynamic shared memory of the instantiation at padded head dim dp, kv_bits,
// elem_bytes (2: bf16, 4: f32) the bytes of q's type and row_warps (4 for
// bf16; 1, 2 or 4 for f32); -1 for none.
extern "C" int paged_prefill_smem_bytes(int dp, int kv_bits, int elem_bytes, int row_warps) {
  if ((kv_bits != 4 && kv_bits != 8 && kv_bits != 16) || (dp != 32 && dp != 64 && dp != 128 &&
                                                           dp != 256))
    return -1;
  if (elem_bytes == 2) {
    if (row_warps != 4) return -1;
    switch (dp) {
      case 32: return bf16_smem<32>(kv_bits);
      case 64: return bf16_smem<64>(kv_bits);
      case 128: return bf16_smem<128>(kv_bits);
      default: return bf16_smem<256>(kv_bits);
    }
  }
  if (elem_bytes != 4 || (row_warps != 1 && row_warps != 2 && row_warps != 4)) return -1;
  return pf32_bytes(dp, kv_bits, row_warps, pf32_keys_per_tile(dp, kv_bits, row_warps));
}

// Pointers are device pointers; scale pointers are null when kv_bits == 16.
// window <= 0 means no window.  The head dim is padded to 32, 64, 128 or 256
// in shared memory; d > 256, an odd d or rows that are not whole 32-bit words
// return cudaErrorInvalidValue without a launch.  Returns cudaGetLastError()
// after the launches.  paged_prefill_bf16: bf16 q and out, bf16 16-bit pools;
// paged_prefill_f32: f32 q and out, f32 16-bit pools (int8 / int4 pools and
// their f32 scales as for bf16), one split; paged_prefill_f32_split: the same
// with each row block's key tiles split over n_split <= 64 blocks
// (kernels/paged_prefill.py::prefill_plan), part [B, Hkv, C * G, n_split,
// 4 * ceil(D / 4) + 4] f32 scratch, and a second launch that merges them.
#define PF_ENTRY_ARGS                                                                     \
  const void *q, const void *k_pool, const void *v_pool, const void *k_scale,             \
      const void *v_scale, const void *tables, const void *ctx_lens, const void *q_lens,  \
      const void *chunk_k, const void *chunk_v, const void *chunk_k_scale,                \
      const void *chunk_v_scale, void *out
#define PF_ENTRY_INTS                                                                     \
  int batch, int layer, int n_pages, int ps, int hkv, int g_size, int d, int w, int c_len, \
      int kv_bits, int window
#define PF_ENTRY_CALL                                                                     \
  q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, q_lens, chunk_k, chunk_v,        \
      chunk_k_scale, chunk_v_scale, out
#define PF_ENTRY_INTS_CALL batch, layer, n_pages, ps, hkv, g_size, d, w, c_len, kv_bits, window
extern "C" int paged_prefill_bf16(PF_ENTRY_ARGS, PF_ENTRY_INTS, float sm_scale, void* stream) {
  return prefill_bf16_entry(PF_ENTRY_CALL, PF_ENTRY_INTS_CALL, sm_scale, stream);
}
extern "C" int paged_prefill_f32(PF_ENTRY_ARGS, PF_ENTRY_INTS, float sm_scale, void* stream) {
  return prefill_f32_entry(PF_ENTRY_CALL, nullptr, PF_ENTRY_INTS_CALL, 1, sm_scale, stream);
}
extern "C" int paged_prefill_f32_split(PF_ENTRY_ARGS, void* part, PF_ENTRY_INTS, int n_split,
                                       float sm_scale, void* stream) {
  return prefill_f32_entry(PF_ENTRY_CALL, part, PF_ENTRY_INTS_CALL, n_split, sm_scale, stream);
}
#undef PF_ENTRY_ARGS
#undef PF_ENTRY_INTS
#undef PF_ENTRY_CALL
#undef PF_ENTRY_INTS_CALL

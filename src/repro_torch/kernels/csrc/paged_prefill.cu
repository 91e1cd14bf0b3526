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
// the JAX kernel's function for a float32 model, whose products are f32) keeps
// the grid, the gather ring, the masks and the online softmax on the same
// accumulator layouts, and runs both products as f32 FMAs on the CUDA cores:
// the Q tile and the K / V tiles it reads are f32 (int payloads are converted
// to f32, exactly), lane (g, qd) scores rows g, g + 8 against keys 8j + 2qd,
// + 1 four dims at a time, and for P V takes each key's two row weights from
// the lane that holds them (a shuffle each) against that key's V dims
// 8j + 2qd, + 1.  Bound by operations at serving chunks (67 TFLOP/s of f32
// FMA, not the tensor cores); a bf16 mma on a rounded q would lose 2^-9
// relatively.  f32 tiles are twice as wide: at DP = 256 a tile holds 32 keys,
// not 64 (shared memory: kv16 199,680 bytes, kv8 183,296, kv4 158,720);
// a thread then copies and converts half a row.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int PF_THREADS = 128;  // 4 warps x 16 query rows
constexpr int PF_TQ = 64;        // query rows per block

// Shared-memory layout for head dim padded to DP, T the query's type: tiles
// of TP-element rows of T that the products read (TP * sizeof(T) is an odd
// multiple of 16, so the 8 rows an ldmatrix or a warp's 16-byte loads read
// hit distinct banks).
// kv_bits 16: Q, then a 2-stage ring of K / V tiles that the products read
// directly.  kv_bits 8 / 4: Q, a 3-stage ring of raw payload rows and raw
// scales (1 or 1/2 byte a value, so a deeper ring fits), and the K / V
// tiles plus per-key factors converted from the stage of the current tile.
// KT keys a tile: 64, or 32 for f32 at DP = 256 (64 would not fit).
template <typename T, int DP, int KV_BITS>
struct PfSmem {
  static constexpr int ELEM = sizeof(T);
  static constexpr int KT = ELEM == 4 && DP == 256 ? 32 : 64;
  static constexpr int TP = DP + 16 / ELEM;
  static constexpr int TILE = KT * TP * ELEM;  // one K or V tile, bytes
  static constexpr int RAW_PITCH = KV_BITS == 8 ? DP : DP / 2;
  static constexpr int RAW = KT * RAW_PITCH;  // one raw K or V tile (8 / 4 bits)
  static constexpr int Q = 0;
  static constexpr int RING = Q + PF_TQ * TP * ELEM;
  // one ring stage: [K tile, V tile] (16 bits) or [raw K, raw V, k scales, v scales]
  static constexpr int STAGE = KV_BITS == 16 ? 2 * TILE : 2 * RAW + 2 * KT * 4;
  static constexpr int STAGES = KV_BITS == 16 ? 2 : 3;  // tiles in flight: STAGES - 1
  static constexpr int CONV = RING + STAGES * STAGE;  // K, V, k factors, v factors
  static constexpr int KF = CONV + 2 * TILE;
  static constexpr int VF = KF + KT * 4;
  static constexpr int BYTES = KV_BITS == 16 ? CONV : VF + KT * 4;
};

// acc + a . b in f32, w first.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

template <typename T, int DP, int KV_BITS>
__global__ void __launch_bounds__(PF_THREADS)
paged_prefill_kernel(const T* __restrict__ q,              // [B, Hkv, C, G, D]
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
                     T* __restrict__ out,                  // [B, Hkv, C, G, D]
                     int layer, int n_pages, int ps, int hkv, int g_size, int d,
                     int w, int c_len, int window, float sm_scale) {
  using L = PfSmem<T, DP, KV_BITS>;
  constexpr int TP = L::TP, KT = L::KT, ELEM = L::ELEM;
  constexpr bool F32 = std::is_same_v<T, float>;
  constexpr int PARTS = PF_THREADS / (2 * KT);  // threads a K or V row: 1 or 2
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, qd = lane & 3;
  const int n_rows = c_len * g_size;
  const int r0 = blockIdx.z * PF_TQ;
  const int nr = min(PF_TQ, n_rows - r0);
  const int row_bytes = KV_BITS == 16 ? d * ELEM : kv_row_bytes(d, KV_BITS);
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

  // The copies of a tile: thread (t = tid % KT, side = tid / KT % 2, part =
  // tid / 2KT) copies the K (side 0) or V (side 1) payload row of key t (its
  // part-th of PARTS interleaved shares) and, for int payloads, its scale;
  // rows past the tile's keys are zero-filled.  tile_row resolves the row
  // through the page table, two tiles before the copies it feeds, so the
  // table load's latency hides behind the products.
  // (with one thread a row, tid < 2 KT: side and part need no masking)
  const int my_t = tid % KT, side = PARTS == 1 ? tid / KT : (tid / KT) & 1;
  const int part = PARTS == 1 ? 0 : tid / (2 * KT);
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
    uint8_t* dst = st + (KV_BITS == 16 ? side * L::TILE + my_t * TP * ELEM
                                       : side * L::RAW + my_t * L::RAW_PITCH);
    const uint8_t* base = static_cast<const uint8_t*>(
        side == 0 ? (pool ? k_pool : chunk_k) : (pool ? v_pool : chunk_v));
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
        const float* sb = side == 0 ? (pool ? k_scale : chunk_k_scale)
                                    : (pool ? v_scale : chunk_v_scale);
        float* sd = reinterpret_cast<float*>(st + 2 * L::RAW) + side * KT + my_t;
        cp_async<4>(sd, ok ? sb + row : sb, ok);
      }
    }
  };

  // the block's Q rows (T, zero-filled past nr rows) in one commit group
  T* qs = reinterpret_cast<T*>(smem + L::Q);
  auto copy_q = [&](auto vec) {
    constexpr int V = decltype(vec)::value;
    const int cpr = ELEM * d / V;
    for (int c = tid; c < PF_TQ * cpr; c += PF_THREADS) {
      const int r = c / cpr, off = (c - r * cpr) * V;
      const bool ok = r < nr;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(q + (head_row0 + r0 + r) * d);
      cp_async<V>(reinterpret_cast<uint8_t*>(qs + r * TP) + off,
                  ok ? src + off : reinterpret_cast<const uint8_t*>(q), ok);
    }
  };
  if (ELEM * d % 16 == 0) {
    copy_q(std::integral_constant<int, 16>());
  } else if (ELEM * d % 8 == 0) {
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
  // (bf16; the f32 products read the Q tile four dims at a time)
  constexpr bool Q_IN_REGS = DP <= 128 && !F32;
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
      // raw payload -> T tiles (exact), scales -> per-key factors.  Thread
      // (t, side, part) converts its share of row t of K or V in 16-byte
      // chunks, fully unrolled; the chunk order is skewed by t so that the 8
      // lanes of a shared-memory phase read 8 different bank groups.
      constexpr int CPR = L::RAW_PITCH / 16;  // chunks per raw row (zero past d)
      uint8_t* kc = smem + L::CONV;
      const uint8_t* src_row = st + side * L::RAW + my_t * L::RAW_PITCH;
      uint8_t* dst_row = kc + side * L::TILE + my_t * TP * ELEM;
#pragma unroll
      for (int jp = 0; jp < CPR / PARTS; ++jp) {
        const int j = jp * PARTS + part;
        const int ck = (j + my_t) & (CPR - 1);
        const uint4 raw = *reinterpret_cast<const uint4*>(src_row + 16 * ck);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        if constexpr (F32 && KV_BITS == 8) {  // 16 values -> 64 bytes
          float4* dst = reinterpret_cast<float4*>(dst_row + 64 * ck);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t bw = words[u] ^ 0x80808080u;
            dst[u] = make_float4(s8_biased_to_f32(bw, 0), s8_biased_to_f32(bw, 1),
                                 s8_biased_to_f32(bw, 2), s8_biased_to_f32(bw, 3));
          }
        } else if constexpr (F32) {  // 32 values -> 128 bytes: byte j = dims 2j, 2j + 1
          float4* dst = reinterpret_cast<float4*>(dst_row + 128 * ck);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t bw = words[u] ^ 0x88888888u;
            float f[8];
#pragma unroll
            for (int n = 0; n < 8; ++n)  // nibble n + 8 as the mantissa of f32 2^23
              f[n] = __uint_as_float(0x4B000000u | ((bw >> (4 * n)) & 0xFu)) - 8388616.f;
            dst[2 * u] = make_float4(f[0], f[1], f[2], f[3]);
            dst[2 * u + 1] = make_float4(f[4], f[5], f[6], f[7]);
          }
        } else if constexpr (KV_BITS == 8) {  // 16 values -> 32 bytes
          uint32_t o[8];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t bw = words[u] ^ 0x80808080u;
            o[2 * u] = pack_int_bf16x2(s8_biased_to_f32(bw, 0), s8_biased_to_f32(bw, 1));
            o[2 * u + 1] = pack_int_bf16x2(s8_biased_to_f32(bw, 2), s8_biased_to_f32(bw, 3));
          }
          uint4* dst = reinterpret_cast<uint4*>(dst_row + 32 * ck);
          dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
          dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
        } else {  // 32 values -> 64 bytes
          uint4* dst = reinterpret_cast<uint4*>(dst_row + 64 * ck);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t bw = words[u] ^ 0x88888888u;
            dst[u] = make_uint4(s4x2_biased_to_bf16x2(bw, 0), s4x2_biased_to_bf16x2(bw, 1),
                                s4x2_biased_to_bf16x2(bw, 2), s4x2_biased_to_bf16x2(bw, 3));
          }
        }
      }
      if (PARTS == 1 || tid < 2 * KT) {  // the K factors, then the V factors
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
      if constexpr (F32) {
        // rows g, g + 8 x keys 8j + 2qd, + 1, four dims a step
        const float* q0 = qs + (warp * 16 + g) * TP;
        const float* k0 = ks + (kc0 + 2 * qd) * TP;
#pragma unroll 2
        for (int e = 0; e < DP; e += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(q0 + e);
          const float4 qb = *reinterpret_cast<const float4*>(q0 + 8 * TP + e);
#pragma unroll
          for (int j = 0; j < KC / 8; ++j) {
            const float4 ka = *reinterpret_cast<const float4*>(k0 + 8 * j * TP + e);
            const float4 kb = *reinterpret_cast<const float4*>(k0 + (8 * j + 1) * TP + e);
            s[j][0] = dot4(qa, ka, s[j][0]);
            s[j][1] = dot4(qa, kb, s[j][1]);
            s[j][2] = dot4(qb, ka, s[j][2]);
            s[j][3] = dot4(qb, kb, s[j][3]);
          }
        }
      } else {
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
      if constexpr (F32) {
        // O += (P * v_scale) V in f32: key t's weights of rows g, g + 8 come
        // from lane (g, (t % 8) / 2), its V dims 8j + 2qd, + 1 from the tile
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float vo = KV_BITS == 16 ? 1.f : vf[kc0 + j * 8 + 2 * qd + e2];
            const float x0 = s[j][e2] * vo, x1 = s[j][2 + e2] * vo;
#pragma unroll
            for (int src = 0; src < 4; ++src) {
              const float p0 = __shfl_sync(0xffffffffu, x0, (lane & ~3) | src);
              const float p1 = __shfl_sync(0xffffffffu, x1, (lane & ~3) | src);
              const float* vr = vs + (kc0 + j * 8 + 2 * src + e2) * TP + 2 * qd;
#pragma unroll
              for (int jd = 0; jd < DP / 8; ++jd) {
                const float2 v = *reinterpret_cast<const float2*>(vr + 8 * jd);
                o[jd][0] = fmaf(p0, v.x, o[jd][0]);
                o[jd][1] = fmaf(p0, v.y, o[jd][1]);
                o[jd][2] = fmaf(p1, v.x, o[jd][2]);
                o[jd][3] = fmaf(p1, v.y, o[jd][3]);
              }
            }
          }
        }
      } else {
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
        if constexpr (F32) {
          *reinterpret_cast<float2*>(orow + e) =
              make_float2(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
        } else {
          __nv_bfloat162 v =
              __floats2bfloat162_rn(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
          *reinterpret_cast<__nv_bfloat162*>(orow + e) = v;
        }
      }
    }
  }
}

template <typename T, int DP, int KV_BITS>
cudaError_t launch_prefill(dim3 grid, cudaStream_t s, const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale, const void* v_scale,
                           const void* tables, const void* ctx_lens, const void* q_lens,
                           const void* chunk_k, const void* chunk_v,
                           const void* chunk_k_scale, const void* chunk_v_scale, void* out,
                           int layer, int n_pages, int ps, int hkv, int g_size, int d, int w,
                           int c_len, int window, float sm_scale) {
  constexpr int smem = PfSmem<T, DP, KV_BITS>::BYTES;
  auto kernel = paged_prefill_kernel<T, DP, KV_BITS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, PF_THREADS, smem, s>>>(
      static_cast<const T*>(q), k_pool, v_pool,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ctx_lens),
      static_cast<const int32_t*>(q_lens), chunk_k, chunk_v,
      static_cast<const float*>(chunk_k_scale), static_cast<const float*>(chunk_v_scale),
      static_cast<T*>(out), layer, n_pages, ps, hkv, g_size, d, w, c_len, window, sm_scale);
  return cudaGetLastError();
}

#define PF_ARGS                                                                       \
  grid, s, q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, q_lens, chunk_k,   \
      chunk_v, chunk_k_scale, chunk_v_scale, out, layer, n_pages, ps, hkv, g_size, d, \
      w, c_len, window, sm_scale

template <typename T, int DP>
cudaError_t dispatch_kv(int kv_bits, dim3 grid, cudaStream_t s, const void* q,
                        const void* k_pool, const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* tables, const void* ctx_lens,
                        const void* q_lens, const void* chunk_k, const void* chunk_v,
                        const void* chunk_k_scale, const void* chunk_v_scale, void* out,
                        int layer, int n_pages, int ps, int hkv, int g_size, int d, int w,
                        int c_len, int window, float sm_scale) {
  if (kv_bits == 16) return launch_prefill<T, DP, 16>(PF_ARGS);
  if (kv_bits == 8) return launch_prefill<T, DP, 8>(PF_ARGS);
  if (kv_bits == 4) return launch_prefill<T, DP, 4>(PF_ARGS);
  return cudaErrorInvalidValue;
}

template <typename T>
int prefill_entry(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                  const void* v_scale, const void* tables, const void* ctx_lens,
                  const void* q_lens, const void* chunk_k, const void* chunk_v,
                  const void* chunk_k_scale, const void* chunk_v_scale, void* out, int batch,
                  int layer, int n_pages, int ps, int hkv, int g_size, int d, int w, int c_len,
                  int kv_bits, int window, float sm_scale, void* stream) {
  if (d < 2 || d > 256 || d % 2 ||
      (kv_bits == 16 ? d * (int)sizeof(T) : kv_row_bytes(d, kv_bits)) % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (c_len * g_size + PF_TQ - 1) / PF_TQ;
  if (batch == 0 || n_tiles == 0) return (int)cudaSuccess;
  dim3 grid(batch, hkv, n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= 32) {
    err = dispatch_kv<T, 32>(kv_bits, PF_ARGS);
  } else if (d <= 64) {
    err = dispatch_kv<T, 64>(kv_bits, PF_ARGS);
  } else if (d <= 128) {
    err = dispatch_kv<T, 128>(kv_bits, PF_ARGS);
  } else {
    err = dispatch_kv<T, 256>(kv_bits, PF_ARGS);
  }
  return (int)err;
}
#undef PF_ARGS

template <typename T, int DP>
int smem_of(int kv_bits) {
  return kv_bits == 16 ? PfSmem<T, DP, 16>::BYTES
         : kv_bits == 8 ? PfSmem<T, DP, 8>::BYTES
                        : PfSmem<T, DP, 4>::BYTES;
}

}  // namespace

// Query rows per block (grid z = ceil(C * G / this)), for every instantiation.
extern "C" int paged_prefill_rows_per_block() { return PF_TQ; }

// Dynamic shared memory of the instantiation at padded head dim dp, kv_bits
// and elem_bytes (2: bf16, 4: f32) the bytes of q's type; -1 for none.
extern "C" int paged_prefill_smem_bytes(int dp, int kv_bits, int elem_bytes) {
  if ((kv_bits != 4 && kv_bits != 8 && kv_bits != 16) || (elem_bytes != 2 && elem_bytes != 4))
    return -1;
  const bool f32 = elem_bytes == 4;
  switch (dp) {
    case 32: return f32 ? smem_of<float, 32>(kv_bits) : smem_of<__nv_bfloat16, 32>(kv_bits);
    case 64: return f32 ? smem_of<float, 64>(kv_bits) : smem_of<__nv_bfloat16, 64>(kv_bits);
    case 128: return f32 ? smem_of<float, 128>(kv_bits) : smem_of<__nv_bfloat16, 128>(kv_bits);
    case 256: return f32 ? smem_of<float, 256>(kv_bits) : smem_of<__nv_bfloat16, 256>(kv_bits);
    default: return -1;
  }
}

// Pointers are device pointers; scale pointers are null when kv_bits == 16.
// window <= 0 means no window.  The head dim is padded to 32, 64, 128 or 256
// in shared memory; d > 256, an odd d or rows that are not whole 32-bit words
// return cudaErrorInvalidValue without a launch.  Returns cudaGetLastError()
// after the launch.  paged_prefill_bf16: bf16 q and out, bf16 16-bit pools;
// paged_prefill_f32: f32 q and out, f32 16-bit pools (int8 / int4 pools and
// their f32 scales as for bf16).
#define PF_ENTRY_ARGS                                                                     \
  const void *q, const void *k_pool, const void *v_pool, const void *k_scale,             \
      const void *v_scale, const void *tables, const void *ctx_lens, const void *q_lens,  \
      const void *chunk_k, const void *chunk_v, const void *chunk_k_scale,                \
      const void *chunk_v_scale, void *out, int batch, int layer, int n_pages, int ps,    \
      int hkv, int g_size, int d, int w, int c_len, int kv_bits, int window,              \
      float sm_scale, void *stream
#define PF_ENTRY_CALL                                                                     \
  q, k_pool, v_pool, k_scale, v_scale, tables, ctx_lens, q_lens, chunk_k, chunk_v,        \
      chunk_k_scale, chunk_v_scale, out, batch, layer, n_pages, ps, hkv, g_size, d, w,    \
      c_len, kv_bits, window, sm_scale, stream
extern "C" int paged_prefill_bf16(PF_ENTRY_ARGS) {
  return prefill_entry<__nv_bfloat16>(PF_ENTRY_CALL);
}
extern "C" int paged_prefill_f32(PF_ENTRY_ARGS) { return prefill_entry<float>(PF_ENTRY_CALL); }
#undef PF_ENTRY_ARGS
#undef PF_ENTRY_CALL

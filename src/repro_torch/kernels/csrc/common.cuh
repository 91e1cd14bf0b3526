// Helpers shared by the kernels: the paged attention kernels (paged_decode.cu,
// paged_prefill.cu), the FF-order matmuls (mpmm_ff.cu, mpmm_int.cu) and the
// tensor-core pieces of the CF matmul (mpmm.cu) and paged prefill.
// Plain C interface, no PyTorch headers: the library is
// built with nvcc alone and bound with ctypes (kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Initial running max of the online softmax.  Finite, so exp(m_prev - m_new)
// never sees inf - inf; masked scores are -INFINITY and contribute p = 0.
#define SOFTMAX_M0 (-1e30f)

// Signed nibbles of one packed byte: even index in the low nibble, odd index
// in the high nibble, sign-extended by arithmetic shifts (quant/pack.py).
__device__ __forceinline__ int nibble_lo(int8_t b) {
  return ((int)(int8_t)((uint8_t)b << 4)) >> 4;
}
__device__ __forceinline__ int nibble_hi(int8_t b) { return ((int)b) >> 4; }

// Element e of a K/V payload row that starts at storage offset `row`:
// kv_bits 16 = bf16, 8 = int8, 4 = two nibbles per byte along the head dim.
__device__ __forceinline__ float load_kv(const void* base, int64_t row, int e,
                                         int kv_bits) {
  if (kv_bits == 16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[row + e]);
  }
  const int8_t* p = static_cast<const int8_t*>(base);
  if (kv_bits == 8) return (float)p[row + e];
  const int8_t byte = p[row + (e >> 1)];
  return (float)((e & 1) ? nibble_hi(byte) : nibble_lo(byte));
}

// Bytes of one K/V payload row (one token of one kv head).
__host__ __device__ __forceinline__ int kv_row_bytes(int d, int kv_bits) {
  return kv_bits == 16 ? 2 * d : (kv_bits == 8 ? d : d / 2);
}

// Stages nt K/V rows in shared memory as f32: row t of the tile is row
// rows_s[t] of the [rows, Dk] payload matrices k_base / v_base (a row is
// one token of one kv head), dequantized with its f32 scale when
// kv_bits < 16.  Each thread loads whole 32-bit words (4 int8, 8 int4 or 2
// bf16 values) from precomputed row offsets, so its loads are independent
// and issue back to back.  Needs kv_row_bytes(d, kv_bits) % 4 == 0 and
// 4-byte aligned payloads (the wrappers check both).
__device__ __forceinline__ void load_kv_tile(const void* k_base, const void* v_base,
                                             const float* k_scale,
                                             const float* v_scale,
                                             const int64_t* rows_s, int nt, int d,
                                             int kv_bits, float* k_s, int ldk,
                                             float* v_s) {
  const int row_bytes = kv_row_bytes(d, kv_bits);
  const int wpr = row_bytes / 4;                                      // words per row
  const int epw = kv_bits == 16 ? 2 : (kv_bits == 8 ? 4 : 8);         // values per word
  const char* kb = static_cast<const char*>(k_base);
  const char* vb = static_cast<const char*>(v_base);
  for (int i = threadIdx.x; i < nt * wpr; i += blockDim.x) {
    const int t = i / wpr, wi = i % wpr;
    const int64_t row = rows_s[t];
    const uint32_t kw = reinterpret_cast<const uint32_t*>(kb + row * row_bytes)[wi];
    const uint32_t vw = reinterpret_cast<const uint32_t*>(vb + row * row_bytes)[wi];
    float* kd = k_s + t * ldk + wi * epw;
    float* vd = v_s + t * d + wi * epw;
    if (kv_bits == 16) {  // bf16 -> f32 is the high half of the f32 bits
      kd[0] = __uint_as_float(kw << 16);
      kd[1] = __uint_as_float(kw & 0xFFFF0000u);
      vd[0] = __uint_as_float(vw << 16);
      vd[1] = __uint_as_float(vw & 0xFFFF0000u);
      continue;
    }
    const float ks = k_scale[row], vs = v_scale[row];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int8_t kbyte = (int8_t)(kw >> (8 * c)), vbyte = (int8_t)(vw >> (8 * c));
      if (kv_bits == 8) {
        kd[c] = (float)kbyte * ks;
        vd[c] = (float)vbyte * vs;
      } else {
        kd[2 * c] = (float)nibble_lo(kbyte) * ks;
        kd[2 * c + 1] = (float)nibble_hi(kbyte) * ks;
        vd[2 * c] = (float)nibble_lo(vbyte) * vs;
        vd[2 * c + 1] = (float)nibble_hi(vbyte) * vs;
      }
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... + part[stages - 1][i], added in stage
// order: the K-stage partials an FF-order matmul spilled to its [stages, M, N]
// scratch (total = M * N), summed one stage after the other as the Pallas FF
// grid sums them.  T = float, or uint32_t for sums that wrap mod 2^32.
template <typename T>
__global__ void sum_stages(const T* __restrict__ part, T* __restrict__ out, int64_t total,
                           int stages) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  T s = part[i];
  for (int st = 1; st < stages; ++st) s += part[st * total + i];
  out[i] = s;
}

template <typename T>
__host__ void launch_sum_stages(const T* part, T* out, int64_t total, int stages,
                                cudaStream_t s) {
  sum_stages<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(part, out, total, stages);
}

// Whether (stage_k, stages) split K into whole stages of stage_k rows, the
// last one ragged: the caller sized a [stages, M, N] scratch from them.
__host__ inline bool stages_fit(int K, int stage_k, int stages) {
  return stage_k > 0 && stages == (K + stage_k - 1) / stage_k;
}

// ---- tensor-core tiles fed by asynchronous copies (mpmm.cu, paged_prefill.cu)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory; when `valid`
// is false nothing is read and the destination is zero-filled, so ragged
// edges and padding rows land as zeros (never stale bits: 0 * NaN = NaN).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the row address of
// matrix l / 8.  _trans delivers each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a * b on the tensor cores: m16n8k16, bf16 in, f32 accumulate.  With
// g = lane / 4 and q = lane % 4: a holds A rows (g, g + 8) x k (2q, 2q + 1)
// and (2q + 8, 2q + 9); b0 / b1 hold B column g x k (2q, 2q + 1) / (2q + 8,
// 2q + 9), the lower k in the low half; d holds rows (g, g + 8) x columns
// (2q, 2q + 1).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Exact integer -> bf16 conversions without the (quarter-rate) I2F unit.
// int8: byte j of `biased` (= word ^ 0x80808080, so it holds v + 128)
// becomes the low byte of the f32 2^23, whose ulp is 1; subtracting
// 2^23 + 128 leaves v exactly.
__device__ __forceinline__ float s8_biased_to_f32(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | j)) - 8388736.f;
}
// Two f32 holding small integers -> bf16x2 {lo, hi}: the high halves, exact.
__device__ __forceinline__ uint32_t pack_int_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// int4: the two nibbles of byte j of `biased` (= word ^ 0x88888888, so each
// holds v + 8) -> bf16x2 {low nibble, high nibble}: each nibble becomes the
// mantissa of bf16 128 (ulp 1), then 136 is subtracted, exactly.
__device__ __forceinline__ uint32_t s4x2_biased_to_bf16x2(uint32_t biased, int j) {
  const uint32_t t = __byte_perm(biased, 0u, 0x4040u | j | (j << 8));  // [b, 0, b, 0]
  uint32_t u = (t & 0x0000000Fu) | ((t >> 4) & 0x000F0000u) | 0x43004300u;
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Helpers shared by the kernels: the attention kernels (paged_decode.cu,
// paged_prefill.cu, mqa_decode.cu), the FF-order matmuls (mpmm.cu, mpmm_int.cu)
// and the tensor-core pieces of the dequant matmul (mpmm.cu) and paged prefill.
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

// Bytes of one K/V payload row (one token of one kv head).
__host__ __device__ __forceinline__ int kv_row_bytes(int d, int kv_bits) {
  return kv_bits == 16 ? 2 * d : (kv_bits == 8 ? d : d / 2);
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

// ---- tiles fed by asynchronous copies (mpmm.cu, mpmm_int.cu, paged_prefill.cu,
// and the decode kernels mqa_decode.cu and paged_decode.cu)

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

// x0, x1 -> N bf16x2 terms (the f32 paged kernels' operands): t[0] = bf16(x), t[k] = bf16(x - t[0] - .. - t[k - 1])
// (each residual exact in f32).
template <int N>
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t (&t)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    t[k] = *reinterpret_cast<const uint32_t*>(&v);
    x0 -= __low2float(v);
    x1 -= __high2float(v);
  }
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

// int4, four at a time: the 16-bit word `biased` (= word ^ 0x8888) holds
// byte 0 = nibbles (v0, v1) and byte 1 = (v2, v3), each v + 8 ->
// lo = bf16x2 {v0, v1}, hi = bf16x2 {v2, v3}.  t = biased | biased << 12
// puts v0, v1 at bits 0 and 16 and v2, v3 at bits 8 and 24, so one mask per
// pair sets them as the mantissas of bf16 128 (ulp 1); 136 is subtracted,
// exactly.  Half the instructions of two s4x2_biased_to_bf16x2 calls.
__device__ __forceinline__ uint32_t bf16x2_minus_136(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  v = __hsub2(v, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void s4x4_biased_to_bf16x2(uint32_t biased, uint32_t& lo,
                                                      uint32_t& hi) {
  const uint32_t t = biased | (biased << 12);
  lo = bf16x2_minus_136((t & 0x000F000Fu) | 0x43004300u);
  hi = bf16x2_minus_136(((t >> 8) & 0x000F000Fu) | 0x43004300u);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

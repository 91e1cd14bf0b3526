// Helpers shared by the paged attention kernels (paged_decode.cu,
// paged_prefill.cu).  Plain C interface, no PyTorch headers: the library is
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

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

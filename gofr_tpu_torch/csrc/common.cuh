// Shared helpers for the port's CUDA kernels (plain C interface, no
// PyTorch headers; built by gofr_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gofr {

// Same sentinel as the JAX package (gofr_tpu/ops/attention.py NEG_INF):
// close to the bf16 minimum, finite, so (NEG_INF) - (NEG_INF) is 0, not nan.
constexpr float kNegInf = -2.3819763e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Padding (elements) that makes a shared-memory row of T an odd number of
// 32-bit words long when the row length is even: threads reading the same
// column of 32 different rows then hit 32 different banks.
template <typename T>
__host__ __device__ constexpr int row_pad() { return 4 / static_cast<int>(sizeof(T)); }

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Elements of T in one 16-byte vector load.
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / static_cast<int>(sizeof(T)); }

// One 16-byte vector into a padded shared-memory row, as four 32-bit
// stores (a padded row is 4-byte aligned, not 16-byte aligned).
__device__ __forceinline__ void store_words(void* dst, const uint4& v) {
  uint32_t* d = static_cast<uint32_t*>(dst);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

// Stage `rows` rows of D elements into shared memory: row r is read from
// src_k/src_v + row_offset(r) (elements) and written to Ks + r * KS (padded)
// and Vs + r * D. Each thread keeps U 16-byte loads of each tensor in
// flight before storing any of them; rows >= valid_rows are zero-filled.
// D * sizeof(T) must be a multiple of 16 and the sources 16-byte aligned.
template <typename T, int D, int KS, int THREADS, int U = 4, typename RowOffset>
__device__ __forceinline__ void stage_kv(const T* __restrict__ src_k, const T* __restrict__ src_v,
                                         T* Ks, T* Vs, int rows, int valid_rows,
                                         RowOffset row_offset) {
  constexpr int VEC = vec_elems<T>();
  const int nvec = rows * (D / VEC);
  for (int i0 = threadIdx.x; i0 < nvec; i0 += THREADS * U) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      if (i < nvec && r < valid_rows) {
        const size_t g = row_offset(r) + c;
        kr[u] = *reinterpret_cast<const uint4*>(src_k + g);
        vr[u] = *reinterpret_cast<const uint4*>(src_v + g);
      } else {
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nvec) {
        const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
        store_words(Ks + r * KS + c, kr[u]);
        *reinterpret_cast<uint4*>(Vs + r * D + c) = vr[u];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float soft_cap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gofr

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

// --- Tensor-core and asynchronous-copy primitives (PTX, sm_80 and up) ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that bypasses L1 (cp.async.cg). With
// valid == false nothing is read and the 16 shared bytes are zero-filled.
// Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
// 4-byte copy global -> shared (cp.async.ca; .cg takes only 16 bytes).
// Both addresses must be 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lanes 8j..8j+7 give the row
// addresses of matrix j (16-byte aligned), register j receives it: lane l
// holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 (with .trans, the
// transpose: rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// d += a . b on the tensor cores: a 16x16 bf16 (row-major fragment), b
// 16x8 bf16 (column-major fragment), d 16x8 f32. With g = lane / 4 and
// c = 2 (lane % 4): a = {(g, c..c+1), (g+8, c..), (g, c+8..), (g+8, c+8..)},
// b = {(k c..c+1, n g), (k c+8..c+9, n g)}, d = {(g, c), (g, c+1), (g+8, c),
// (g+8, c+1)}; each 32-bit register holds two bf16, the lower index in the
// low half.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gofr

// Paged-attention decode partials for Hopper (sm_90a).
//
// Replaces: gofr_tpu/ops/attention.py:_paged_decode_kernel (via
// _paged_decode_partials), both variants: gofr_paged_decode_partials reads
// pools of q's type (bf16 or f32); gofr_paged_decode_partials_int8 reads
// int8 pools with one f32 scale per (block, row, KV head)
// (quantized=True), for bf16 or f32 queries.
//
// What it computes: for each sequence b and KV head h, the GQA group of
// queries q[b, h*G .. h*G+G-1] (scaled by `scale` in f32) attends the
// K/V rows at logical positions [lo[b], hi[b]), reading logical row p
// from pool block tables[b, p / B], row p % B — no gathered copy. Optional
// soft-cap. Outputs the online-softmax partials the caller merges with
// the decode chunk's buffer region: o (normalized, f32), m (running max)
// and l (denominator); an empty band gives o = 0, m = NEG_INF, l = 0.
// int8 rows are dequantized in f32 after the read: the V row is staged as
// int8 and each element is multiplied by its row's scale before P.V (the
// Pallas kernel's multiply-then-dot); the K scale is folded into the score,
// s = (q . k_int8) * k_scale, which differs from scaling each K element
// first only in the rounding of the f32 score.
//
// What bounds it on this card: decode attention moves each K/V row once
// for G = 8 queries (Gemma-2B), about 2 flops per byte, so the roofline
// bound is the memory rate (int8 rows move half the bytes of bf16 ones,
// plus a 4-byte scale per row). With one CTA per (sequence, KV head) the
// serving shape (32 slots, 1 KV head) fills only 32 CTAs of the H100's
// 132 SMs, and each CTA walks its blocks one after another, waiting for
// each block's loads, so the kernel is latency-bound well above the
// memory bound.
//
// What the simple design does about it: each 16 x head_dim K and V block
// is loaded once into shared memory (16-byte loads, several in flight per
// thread) and used by the whole query group; the CTA reads its own block
// table row (the TPU kernel's scalar prefetch) and visits only the table
// slots that meet [lo, hi). Splitting
// the slot axis across CTAs (flash-decoding, which the (o, m, l) contract
// already allows) and asynchronous copies are later work.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using gofr::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;

// shared memory carve: Ks [B][D + pad] S | Vs [B][D] S | Qs [G][D] f32 |
// Ss [kMaxGroup][B] f32 | As [kMaxGroup] f32 | Ms, Ls [G] f32 (| Ksc, Vsc
// [B] f32 row scales for int8 S), each S region 16-byte aligned. Ss and As
// rows past G stay 0, so the P.V loop runs over kMaxGroup rows with no
// runtime predicate. T is the query's type, S the pool's storage type.
template <typename S>
__host__ __device__ constexpr bool quantized() { return std::is_same<S, int8_t>::value; }
template <typename S, int D>
__host__ __device__ size_t off_v(int B) {
  return gofr::align16(sizeof(S) * (size_t)B * (D + gofr::row_pad<S>()));
}
template <typename S, int D>
__host__ __device__ size_t off_q(int B) {
  return gofr::align16(off_v<S, D>(B) + sizeof(S) * (size_t)B * D);
}
template <typename S, int D>
size_t smem_bytes(int G, int B) {
  return off_q<S, D>(B) + sizeof(float) * ((size_t)G * D + (size_t)kMaxGroup * (B + 1) + 2 * G +
                                           (quantized<S>() ? 2 * (size_t)B : 0));
}

template <typename T, typename S, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const S* __restrict__ k_pool,
                    const S* __restrict__ v_pool, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ tables,
                    const int* __restrict__ lo_v, const int* __restrict__ hi_v,
                    float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                    int hq, int hkv, int n_blocks, int B, int MB, float scale, float logit_cap) {
  constexpr int KS = D + gofr::row_pad<S>();
  constexpr int CPT = (D + kThreads - 1) / kThreads;  // output columns per thread
  const int G = hq / hkv;
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* Ks = reinterpret_cast<S*>(smem_raw);                             // [B][KS]
  S* Vs = reinterpret_cast<S*>(smem_raw + off_v<S, D>(B));            // [B][D]
  float* Qs = reinterpret_cast<float*>(smem_raw + off_q<S, D>(B));    // [G][D], pre-scaled
  float* Ss = Qs + G * D;          // [kMaxGroup][B] scores, then probabilities
  float* As = Ss + kMaxGroup * B;  // [kMaxGroup] this block's rescale
  float* Ms = As + kMaxGroup;      // [G] running max
  float* Ls = Ms + G;              // [G] running denominator
  float* Ksc = Ls + G;             // [B] K row scales (int8 S only)
  float* Vsc = Ksc + B;            // [B] V row scales (int8 S only)

  constexpr int VEC = gofr::vec_elems<T>();
  const T* qb = q + ((size_t)b * hq + (size_t)h * G) * D;
#pragma unroll 4
  for (int i = tid; i < G * (D / VEC); i += kThreads) {
    const uint4 raw = *reinterpret_cast<const uint4*>(qb + i * VEC);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) Qs[i * VEC + j] = gofr::to_f32(e[j]) * scale;
  }
  if (tid < G) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  for (int i = G * B + tid; i < kMaxGroup * B; i += kThreads) Ss[i] = 0.f;
  if (tid >= G && tid < kMaxGroup) As[tid] = 0.f;
  float acc[kMaxGroup][CPT];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[g][c] = 0.f;

  const int lo = max(lo_v[b], 0);
  const int hi = min(hi_v[b], MB * B);
  const int j_end = hi > lo ? (hi - 1) / B + 1 : 0;
  for (int j = lo / B; j < j_end; ++j) {
    const int base = j * B;
    const int blk = min(max(tables[(size_t)b * MB + j], 0), n_blocks - 1);
    __syncthreads();  // previous block fully consumed
    gofr::stage_kv<S, D, KS, kThreads>(k_pool, v_pool, Ks, Vs, B, B, [&](int r) {
      return (((size_t)blk * B + r) * hkv + h) * D;
    });
    if constexpr (quantized<S>()) {
      for (int r = tid; r < B; r += kThreads) {
        const size_t si = ((size_t)blk * B + r) * hkv + h;
        Ksc[r] = k_scales[si];
        Vsc[r] = v_scales[si];
      }
    }
    __syncthreads();

    // scores for every (query, row) pair of the block
    for (int i = tid; i < G * B; i += kThreads) {
      const int g = i / B, r = i % B;
      const float* qr = Qs + g * D;
      const S* kr = Ks + r * KS;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;  // four chains, not one
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        s0 = fmaf(qr[d], gofr::to_f32(kr[d]), s0);
        s1 = fmaf(qr[d + 1], gofr::to_f32(kr[d + 1]), s1);
        s2 = fmaf(qr[d + 2], gofr::to_f32(kr[d + 2]), s2);
        s3 = fmaf(qr[d + 3], gofr::to_f32(kr[d + 3]), s3);
      }
      float sc = (s0 + s1) + (s2 + s3);
      if constexpr (quantized<S>()) sc *= Ksc[r];
      Ss[i] = gofr::soft_cap(sc, logit_cap);
    }
    __syncthreads();

    // online softmax, one warp per query row; masked rows of the band
    // contribute exactly 0
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < B; r += 32) {
        const int pos = base + r;
        if (pos >= lo && pos < hi) mx = fmaxf(mx, Ss[g * B + r]);
      }
      mx = gofr::warp_max(mx);
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < B; r += 32) {
        const int pos = base + r;
        const float p = (pos >= lo && pos < hi) ? expf(Ss[g * B + r] - m_new) : 0.f;
        Ss[g * B + r] = p;
        sum += p;
      }
      sum = gofr::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        As[g] = alpha;
        Ls[g] = alpha * Ls[g] + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V; thread owns columns tid + kThreads * c.
    // No runtime predicate inside: rows g >= G multiply zeros, and the
    // column guard folds away when kThreads divides D.
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tid + kThreads * c;
      if (D % kThreads != 0 && col >= D) continue;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) acc[g][c] *= As[g];
      for (int r = 0; r < B; ++r) {
        float vv = gofr::to_f32(Vs[r * D + col]);
        if constexpr (quantized<S>()) vv *= Vsc[r];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) acc[g][c] = fmaf(Ss[g * B + r], vv, acc[g][c]);
      }
    }
  }
  __syncthreads();

  float* ob = o + ((size_t)b * hq + (size_t)h * G) * D;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = tid + kThreads * c;
    if (D % kThreads != 0 && col >= D) continue;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float l = Ls[g];
        ob[(size_t)g * D + col] = acc[g][c] / (l == 0.f ? 1.f : l);
      }
    }
  }
  if (tid < G) {
    m_out[(size_t)b * hq + h * G + tid] = Ms[tid];
    l_out[(size_t)b * hq + h * G + tid] = Ls[tid];
  }
}

template <typename T, typename S, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const float* k_scales,
                   const float* v_scales, const int* tables, const int* lo, const int* hi,
                   float* o, float* m, float* l, int b, int hq, int hkv, int n_blocks, int B,
                   int MB, float scale, float logit_cap, cudaStream_t stream) {
  const int G = hq / hkv;
  const size_t smem = smem_bytes<S, D>(G, B);
  cudaError_t err = gofr::allow_smem(paged_decode_kernel<T, S, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(b, hkv);
  paged_decode_kernel<T, S, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(k_pool), static_cast<const S*>(v_pool),
      k_scales, v_scales, tables, lo, hi, o, m, l, hq, hkv, n_blocks, B, MB, scale, logit_cap);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t dispatch_d(int d, const void* q, const void* k_pool, const void* v_pool,
                       const float* k_scales, const float* v_scales, const int* tables,
                       const int* lo, const int* hi, float* o, float* m, float* l, int b, int hq,
                       int hkv, int n_blocks, int B, int MB, float scale, float logit_cap,
                       cudaStream_t stream) {
  switch (d) {
#define GOFR_CASE(DIM)                                                                       \
  case DIM:                                                                                  \
    return launch<T, S, DIM>(q, k_pool, v_pool, k_scales, v_scales, tables, lo, hi, o, m, l, \
                             b, hq, hkv, n_blocks, B, MB, scale, logit_cap, stream);
    GOFR_CASE(16)
    GOFR_CASE(32)
    GOFR_CASE(64)
    GOFR_CASE(128)
    GOFR_CASE(256)
#undef GOFR_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

int check_args(int hq, int hkv, int block, int n_blocks) {
  return hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxGroup || block <= 0 || n_blocks <= 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [b, hq, d]; k_pool/v_pool
// [n_blocks, block, hkv, d] of q's type; tables [b, table_width] int32;
// lo/hi [b] int32; o [b, hq, d] f32; m/l [b, hq] f32 — all contiguous.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int gofr_paged_decode_partials(const void* q, const void* k_pool, const void* v_pool,
                                          const void* tables, const void* lo, const void* hi,
                                          void* o, void* m, void* l, int dtype, int b, int hq,
                                          int hkv, int d, int n_blocks, int block,
                                          int table_width, float scale, float logit_cap,
                                          void* stream) {
  if (check_args(hq, hkv, block, n_blocks)) return cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* lo_p = static_cast<const int*>(lo);
  const int* hi_p = static_cast<const int*>(hi);
  float* o_p = static_cast<float*>(o);
  float* m_p = static_cast<float*>(m);
  float* l_p = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, float>(d, q, k_pool, v_pool, nullptr, nullptr, t, lo_p, hi_p, o_p,
                                    m_p, l_p, b, hq, hkv, n_blocks, block, table_width, scale,
                                    logit_cap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, q, k_pool, v_pool, nullptr, nullptr, t,
                                                    lo_p, hi_p, o_p, m_p, l_p, b, hq, hkv,
                                                    n_blocks, block, table_width, scale,
                                                    logit_cap, s);
  return cudaErrorInvalidValue;
}

// As gofr_paged_decode_partials, with int8 k_pool/v_pool [n_blocks, block,
// hkv, d] and f32 k_scales/v_scales [n_blocks, block, hkv]; dtype is q's
// type (0 = float32, 1 = bfloat16).
extern "C" int gofr_paged_decode_partials_int8(const void* q, const void* k_pool,
                                               const void* v_pool, const void* k_scales,
                                               const void* v_scales, const void* tables,
                                               const void* lo, const void* hi, void* o, void* m,
                                               void* l, int dtype, int b, int hq, int hkv, int d,
                                               int n_blocks, int block, int table_width,
                                               float scale, float logit_cap, void* stream) {
  if (check_args(hq, hkv, block, n_blocks)) return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* t = static_cast<const int*>(tables);
  const int* lo_p = static_cast<const int*>(lo);
  const int* hi_p = static_cast<const int*>(hi);
  float* o_p = static_cast<float*>(o);
  float* m_p = static_cast<float*>(m);
  float* l_p = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float, int8_t>(d, q, k_pool, v_pool, ks, vs, t, lo_p, hi_p, o_p, m_p, l_p,
                                     b, hq, hkv, n_blocks, block, table_width, scale, logit_cap,
                                     s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, int8_t>(d, q, k_pool, v_pool, ks, vs, t, lo_p, hi_p, o_p,
                                             m_p, l_p, b, hq, hkv, n_blocks, block, table_width,
                                             scale, logit_cap, s);
  return cudaErrorInvalidValue;
}

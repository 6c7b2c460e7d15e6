// Flash attention forward for Hopper (sm_90a).
//
// Replaces: gofr_tpu/ops/attention.py:_flash_kernel (via flash_attention),
// in both of its modes — q_offsets (chunked prefill: query row i of batch b
// sits at absolute position q_offsets[b] + i) and full-prompt (q_offsets ==
// nullptr: row i is position i; causal or not, with or without a window).
//
// What it computes: BSHD in and out. For query head h (KV head h / group),
// s = (q * scale) . k in f32, optional soft-cap cap * tanh(s / cap), masks
// kpos <= qpos (causal) and kpos > qpos - window (window > 0) plus the key
// bound kpos < sk, online softmax over key tiles with f32 running max /
// denominator / accumulator, out = acc / l (l == 0 -> 1, so a fully-masked
// row gives 0). Output in the input dtype (float32 or bfloat16).
//
// What bounds it on this card: at the slice's shapes (c <= 64 query rows
// against a 512-row slot view, head_dim 256) the work is small and the
// kernel is bound by issue rate: it runs the two products as f32 FMA loops
// over shared memory, not on the tensor cores, so it is far from both the
// bf16 tensor-core peak and the memory roofline.
//
// What the simple design does about it: one CTA per (batch, query head,
// 16-row query block); the TPU's sequential k grid becomes a loop over
// 64-row key tiles inside the CTA, with K/V tiles staged in dynamic
// shared memory (above 48 KB at head_dim 256, requested with
// cudaFuncSetAttribute) by 16-byte loads, several in flight per thread.
// Each of the 4 warps owns 4 query rows, so the running max / denominator
// live in registers and the softmax reductions are warp shuffles. Tiles that no query of the block can see (behind
// the causal diagonal or the window) are skipped, as the Pallas kernel
// skips them with pl.when. Tensor cores (mma / wgmma), TMA and reading
// K/V through the block table are later work.

#include <cstdint>

#include "common.cuh"

namespace {

using gofr::kNegInf;

constexpr int kBQ = 16;                     // query rows per CTA
constexpr int kBK = 64;                     // key rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;  // 4

// shared memory carve: Ks [kBK][D + pad] T | Vs [kBK][D] T | Qs [kBQ][D] f32
// | Ps [kBQ][kBK] f32, each region 16-byte aligned
template <typename T, int D>
__host__ __device__ constexpr size_t off_v() {
  return gofr::align16(sizeof(T) * kBK * (D + gofr::row_pad<T>()));
}
template <typename T, int D>
__host__ __device__ constexpr size_t off_q() {
  return gofr::align16(off_v<T, D>() + sizeof(T) * kBK * D);
}
template <typename T, int D>
constexpr size_t smem_bytes() {
  return off_q<T, D>() + sizeof(float) * (kBQ * D + kBQ * kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ q_offsets, T* __restrict__ out, int sq, int sk,
             int hq, int hkv, int causal, int window, float scale, float logit_cap) {
  constexpr int KS = D + gofr::row_pad<T>();  // padded K row stride
  constexpr int DPL = (D + 31) / 32;          // output columns per lane
  constexpr int VEC = gofr::vec_elems<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);                          // [kBK][KS]
  T* Vs = reinterpret_cast<T*>(smem_raw + off_v<T, D>());          // [kBK][D]
  float* Qs = reinterpret_cast<float*>(smem_raw + off_q<T, D>());  // [kBQ][D], pre-scaled
  float* Ps = Qs + kBQ * D;                                        // [kBQ][kBK] probabilities

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int off = q_offsets ? q_offsets[b] : 0;
  const int q0 = qb * kBQ;
  const int q_last = min(q0 + kBQ, sq) - 1;  // last real query row of the block

  // Q block -> shared memory as f32 * scale (the Pallas kernel's
  // q.astype(f32) * scale); rows past sq are zero and never stored.
#pragma unroll
  for (int i = threadIdx.x; i < kBQ * (D / VEC); i += kThreads) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    const int row = q0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < sq)
      raw = *reinterpret_cast<const uint4*>(q + ((size_t)(b * sq + row) * hq + h) * D + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) Qs[r * D + c + j] = gofr::to_f32(e[j]) * scale;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const int k_last = min(k0 + kBK, sk) - 1;
    // tile liveness, uniform across the CTA (so the __syncthreads below
    // are reached by every thread): some query of the block must see some
    // key of the tile
    bool live = true;
    if (causal) live = live && (off + q_last >= k0);
    if (window > 0) live = live && (k_last > off + q0 - window);
    if (!live) continue;

    __syncthreads();  // every warp is done with the previous tile
    gofr::stage_kv<T, D, KS, kThreads>(k, v, Ks, Vs, kBK, sk - k0, [&](int r) {
      return ((size_t)(b * sk + k0 + r) * hkv + hk) * D;
    });
    __syncthreads();

    // scores: lane owns key columns lane and lane + 32 of each of its rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const T* k0p = Ks + lane * KS;
    const T* k1p = Ks + (lane + 32) * KS;
    const float* qrow = Qs + warp * kRowsPerWarp * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float ka = gofr::to_f32(k0p[d]), kb = gofr::to_f32(k1p[d]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = qrow[r * D + d];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kb, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qpos = off + q0 + row;
      bool valid[2];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        bool ok = kpos < sk && q0 + row < sq;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        valid[c] = ok;
        s[r][c] = gofr::soft_cap(s[r][c], logit_cap);
        if (ok) mx = fmaxf(mx, s[r][c]);
      }
      mx = gofr::warp_max(mx);
      const float m_new = fmaxf(m_i[r], mx);
      const float p0 = valid[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = valid[1] ? expf(s[r][1] - m_new) : 0.f;
      const float alpha = expf(m_i[r] - m_new);
      l_i[r] = alpha * l_i[r] + gofr::warp_sum(p0 + p1);
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      Ps[row * kBK + lane] = p0;
      Ps[row * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P . V: lane owns output columns lane + 32 * c (rows past sk
    // hold zero probabilities and zero values, so the loop is full-width)
    const float* prow = Ps + warp * kRowsPerWarp * kBK;
#pragma unroll 8
    for (int j = 0; j < kBK; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = prow[r * kBK + j];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int col = lane + 32 * c;
        if (D % 32 == 0 || col < D) {  // guard folds away when 32 divides D
          const float vv = gofr::to_f32(Vs[j * D + col]);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= sq) continue;
    const float inv = 1.f / (l_i[r] == 0.f ? 1.f : l_i[r]);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int col = lane + 32 * c;
      if (D % 32 == 0 || col < D)  // guard folds away when 32 divides D
        out[((size_t)(b * sq + row) * hq + h) * D + col] = gofr::from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_offsets, void* out,
                   int b, int sq, int sk, int hq, int hkv, int causal, int window, float scale,
                   float logit_cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = gofr::allow_smem(flash_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_offsets,
      static_cast<T*>(out), sq, sk, hq, hkv, causal, window, scale, logit_cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const int* q_offsets,
                       void* out, int b, int sq, int sk, int hq, int hkv, int causal, int window,
                       float scale, float logit_cap, cudaStream_t stream) {
  switch (d) {
#define GOFR_CASE(DIM)                                                                        \
  case DIM:                                                                                   \
    return launch<T, DIM>(q, k, v, q_offsets, out, b, sq, sk, hq, hkv, causal, window, scale, \
                          logit_cap, stream);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [b, sq, hq, d], k/v [b, sk, hkv, d],
// out [b, sq, hq, d], all contiguous; q_offsets [b] int32 or nullptr.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* q_offsets, void* out, int dtype, int b, int sq,
                                    int sk, int hq, int hkv, int d, int causal, int window,
                                    float scale, float logit_cap, void* stream) {
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(q_offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, offs, out, b, sq, sk, hq, hkv, causal, window, scale,
                             logit_cap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, offs, out, b, sq, sk, hq, hkv, causal, window,
                                     scale, logit_cap, s);
  return cudaErrorInvalidValue;
}

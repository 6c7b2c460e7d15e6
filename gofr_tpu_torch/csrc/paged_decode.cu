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
// plus a 4-byte scale per row). At the serving shape (32 sequences, one KV
// head, bands up to 32 blocks of 16 rows) the bytes are ~3 MB, a couple of
// microseconds at 3.35 TB/s; what holds the kernel back is latency — how
// many blocks one CTA walks in series and how long each waits for its
// loads — and how few CTAs a one-CTA-per-sequence grid puts on 132 SMs.
//
// What the design does about it:
// - Split the table-slot axis (flash-decoding): a cluster of `splits` CTAs
//   per (sequence, KV head); CTA `rank` takes a contiguous share of the
//   band's table slots (only slots that meet [lo, hi) are shared out).
//   `splits` is a fixed rule of b * hkv, the SM count and the table width
//   (choose_splits): about two CTAs per SM, at most a portable cluster of
//   8 — at 32 sequences, 8 splits, 256 CTAs, and at most 4 blocks on the
//   longest band's critical path instead of 32.
// - Merge over distributed shared memory, in the same launch: each CTA
//   keeps its partial (o unnormalized, m, l) in shared memory; after a
//   cluster barrier CTA `rank` writes a slice of the G x D outputs, each
//   partial weighted by exp(m_p - max m), normalized by the sum of the
//   weights times l_p. A CTA that saw no row has m = NEG_INF and l = 0, so
//   it weighs exactly 0, and an all-empty band gives (0, NEG_INF, 0) bit
//   for bit. Every CTA reaches both cluster barriers (no early return).
// - A three-stage cp.async ring of whole table slots (K, V and, for int8,
//   the two scale vectors): two slots' loads are in flight while one is
//   scored. The CTA's table entries are read into shared memory once, up
//   front, so no copy waits on a table load. K rows are padded by 16
//   bytes: 16-byte aligned for cp.async, and an odd count of 16-byte
//   chunks keeps the score loop (8 threads of a quarter-warp on 8 rows of
//   one column) free of bank conflicts.
// - Exactly G query rows: the group is a template parameter (the next power
//   of two, so G = 1, 2, 4, 8, 16 run no padding row), and the P.V loop
//   over it has no runtime predicate (one once serialized this kernel 8x).
// - Per slot: scores with one (query, row) pair per thread; the online
//   softmax with a warp's query rows reduced side by side; P.V with each
//   thread owning output columns for the whole group. Three barriers.
// - __launch_bounds__(128, 2): without a minimum of CTAs per SM, ptxas held
//   these kernels near 64-80 registers and spilled in about half of the
//   instantiations (chip_smoke.py fails on a spill).
// Products stay f32 FMA: the kernel moves ~2 flops per byte, and the
// tensor cores would run f32 pools as TF32.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using gofr::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;
constexpr int kStages = 3;     // cp.async ring depth, in table slots
constexpr int kMaxSplits = 8;  // CTAs per cluster (the portable limit)
constexpr int kCtasPerSm = 2;  // CTAs per SM that the split aims at

template <typename S>
__host__ __device__ constexpr bool quantized() { return std::is_same<S, int8_t>::value; }

__host__ __device__ constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }

// Dynamic shared memory carve, in bytes. Region 0 is the ring of kStages
// table slots, each K [B][D + 16 bytes] | V [B][D] | (int8) K scales [B] |
// V scales [B]; after the slot loop it holds this CTA's partial O [GP][D]
// f32. Then Q [GP][D] f32 (pre-scaled), S [GP][B] scores, P [B][GP]
// probabilities, M, L, A [GP], W [GP][kMaxSplits + 1] merge weights, and
// the CTA's table entries [n_tbl] int32. Every region is 16-byte aligned.
struct Smem {
  size_t k, v, sc, stage, q, s, p, m, w, t, bytes;
  __host__ __device__ Smem(int elem, bool quant, int D, int GP, int B, int n_tbl) {
    k = (size_t)B * (D * elem + 16);
    v = (size_t)B * D * elem;
    sc = quant ? gofr::align16(4 * (size_t)B) : 0;
    stage = k + v + 2 * sc;
    const size_t ring = kStages * stage, part = 4 * (size_t)GP * D;
    q = gofr::align16(ring > part ? ring : part);
    s = q + 4 * (size_t)GP * D;
    p = gofr::align16(s + 4 * (size_t)GP * B);
    m = gofr::align16(p + 4 * (size_t)GP * B);
    w = gofr::align16(m + 4 * 3 * (size_t)GP);
    t = gofr::align16(w + 4 * (size_t)GP * (kMaxSplits + 1));
    bytes = t + 4 * (size_t)n_tbl;
  }
};

// CTAs sharing one (sequence, KV head): about kCtasPerSm CTAs per SM in
// all, at most a portable cluster and at most one per table slot
__host__ int choose_splits(int b, int hkv, int table_width, int sms) {
  const int cells = std::max(1, b * hkv);
  const int want = (kCtasPerSm * sms + cells - 1) / cells;
  return std::max(1, std::min({want, kMaxSplits, table_width}));
}

// 16 bytes of S as f32 values (bit operations, no conversion instructions:
// bf16 is the top half of an f32; an int8 byte, offset by 128, is the low
// byte of the f32 2^23 + u)
__device__ __forceinline__ void unpack16(float (&f)[4], const uint4& r) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(float (&f)[8], const uint4& r) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(float (&f)[16], const uint4& r) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - 8388736.f;
  }
}

// q . k over D: q f32 in shared memory (16-byte aligned), k a staged row of S
template <typename S, int D>
__device__ __forceinline__ float dot_row(const float* __restrict__ qr, const S* __restrict__ kr) {
  constexpr int VK = gofr::vec_elems<S>();
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;  // four chains, not one
#pragma unroll 4
  for (int d = 0; d < D; d += VK) {
    float kf[VK];
    unpack16(kf, *reinterpret_cast<const uint4*>(kr + d));
#pragma unroll
    for (int j = 0; j < VK; j += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + d + j);
      s0 = fmaf(qv.x, kf[j], s0);
      s1 = fmaf(qv.y, kf[j + 1], s1);
      s2 = fmaf(qv.z, kf[j + 2], s2);
      s3 = fmaf(qv.w, kf[j + 3], s3);
    }
  }
  return (s0 + s1) + (s2 + s3);
}

// GP consecutive floats from shared memory (16-byte aligned when GP % 4 == 0)
template <int GP>
__device__ __forceinline__ void load_row(float (&x)[GP], const float* src) {
  if constexpr (GP % 4 == 0) {
#pragma unroll
    for (int g = 0; g < GP; g += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + g);
      x[g] = v.x;
      x[g + 1] = v.y;
      x[g + 2] = v.z;
      x[g + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int g = 0; g < GP; ++g) x[g] = src[g];
  }
}

// One cluster of `splits` CTAs per (sequence b, KV head h); CTA `rank`
// walks its share of b's table slots, then the cluster merges. S is the
// pool's storage type, GP the GQA group rounded up to a power of two
// (query rows past G are zero and never stored). q is bf16 when q_bf16,
// else f32: it is read once, so its type is a runtime argument rather
// than a template parameter (fewer instantiations to build).
template <typename S, int D, int GP>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
paged_decode_kernel(const void* __restrict__ q, int q_bf16, const S* __restrict__ k_pool,
                    const S* __restrict__ v_pool, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ tables,
                    const int* __restrict__ lo_v, const int* __restrict__ hi_v,
                    float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                    int hq, int hkv, int n_blocks, int B, int MB, int n_tbl, float scale,
                    float logit_cap) {
  constexpr int VK = gofr::vec_elems<S>();  // elements per 16-byte chunk
  constexpr int KS = D + VK;                // padded K row stride
  constexpr int CH = D / VK;                // 16-byte chunks per row
  constexpr int CPT = (D + kThreads - 1) / kThreads;  // output columns per thread
  constexpr int WS = kMaxSplits + 1;
  static_assert(D % VK == 0, "rows are whole 16-byte chunks");
  const Smem L(sizeof(S), quantized<S>(), D, GP, B, n_tbl);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw + L.q);  // [GP][D], pre-scaled
  float* Ss = reinterpret_cast<float*>(smem_raw + L.s);  // [GP][B] scores
  float* Ps = reinterpret_cast<float*>(smem_raw + L.p);  // [B][GP] probabilities
  float* Ms = reinterpret_cast<float*>(smem_raw + L.m);  // [GP] running max
  float* Ls = Ms + GP;                                   // [GP] running denominator
  float* As = Ls + GP;                                   // [GP] this slot's rescale
  float* Ws = reinterpret_cast<float*>(smem_raw + L.w);  // [GP][WS] merge weights
  int* Ts = reinterpret_cast<int*>(smem_raw + L.t);      // [n_tbl] pool blocks

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = hq / hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the band's table slots [j_first, j_first + n), and this CTA's share
  const int lo = max(lo_v[b], 0);
  const int hi = min(hi_v[b], MB * B);
  const int j_first = lo / B;
  const int n = hi > lo ? (hi - 1) / B + 1 - j_first : 0;
  const int per = (n + splits - 1) / splits;  // <= n_tbl
  const int j_begin = j_first + min(n, rank * per);
  const int cnt = j_first + min(n, (rank + 1) * per) - j_begin;

  for (int i = tid; i < cnt; i += kThreads)
    Ts[i] = min(max(tables[(size_t)b * MB + j_begin + i], 0), n_blocks - 1);
  const size_t q0 = ((size_t)b * hq + (size_t)h * G) * D;  // first element of the group
  for (int i = tid; i < GP * (D / 8); i += kThreads) {  // 8 elements (16 or 32 bytes)
    float* dst = Qs + i * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (i / (D / 8) < G) {
      if (q_bf16) {
        unpack16(x, *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(q) + q0 + i * 8));
      } else {
        const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(q) + q0 + i * 8);
        const float4 a = src[0], c = src[1];
        x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = c.x, x[5] = c.y, x[6] = c.z, x[7] = c.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = x[j] * scale;
  }
  if (tid < GP) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  __syncthreads();  // table entries visible before any copy is issued

  // table slot j_begin + i -> ring stage `stage`
  auto load_slot = [&](int i, int stage) {
    unsigned char* base = smem_raw + stage * L.stage;
    S* Ks = reinterpret_cast<S*>(base);
    S* Vs = reinterpret_cast<S*>(base + L.k);
    const size_t row0 = (size_t)Ts[i] * B;
    for (int c = tid; c < B * CH; c += kThreads) {
      const int r = c / CH, col = (c % CH) * VK;
      const size_t g = ((row0 + r) * hkv + h) * D + col;
      gofr::cp_async16(Ks + r * KS + col, k_pool + g, true);
      gofr::cp_async16(Vs + r * D + col, v_pool + g, true);
    }
    if constexpr (quantized<S>()) {
      float* Ksc = reinterpret_cast<float*>(base + L.k + L.v);
      float* Vsc = reinterpret_cast<float*>(base + L.k + L.v + L.sc);
      for (int r = tid; r < B; r += kThreads) {
        const size_t si = (row0 + r) * hkv + h;
        gofr::cp_async4(Ksc + r, k_scales + si);
        gofr::cp_async4(Vsc + r, v_scales + si);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < cnt) load_slot(s, s);
    gofr::cp_async_commit();  // one group per stage, empty or not
  }

  float acc[GP][CPT];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[g][c] = 0.f;

  for (int i = 0; i < cnt; ++i) {
    gofr::cp_async_wait<kStages - 2>();  // this thread's copies of slot i landed
    __syncthreads();  // everyone's did; the stage of slot i - 1 is free
    if (i + kStages - 1 < cnt) load_slot(i + kStages - 1, (i + kStages - 1) % kStages);
    gofr::cp_async_commit();
    const unsigned char* base = smem_raw + (i % kStages) * L.stage;
    const S* Ks = reinterpret_cast<const S*>(base);
    const S* Vs = reinterpret_cast<const S*>(base + L.k);
    const float* Ksc = reinterpret_cast<const float*>(base + L.k + L.v);
    const float* Vsc = reinterpret_cast<const float*>(base + L.k + L.v + L.sc);
    const int p0 = (j_begin + i) * B;  // logical position of the slot's row 0

    // scores for every (query, row) pair of the slot
    for (int e = tid; e < GP * B; e += kThreads) {
      const int g = e / B, r = e - g * B;
      float sc = dot_row<S, D>(Qs + g * D, Ks + r * KS);
      if constexpr (quantized<S>()) sc *= Ksc[r];
      Ss[e] = gofr::soft_cap(sc, logit_cap);
    }
    __syncthreads();

    // online softmax, query row g on warp g % kWarps; a warp's rows are
    // reduced side by side (independent shuffle chains), and rows outside
    // the band contribute exactly 0
    {
      constexpr int RPW = (GP + kWarps - 1) / kWarps;  // rows per warp
      float mx[RPW], sum[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        mx[j] = kNegInf;
        sum[j] = 0.f;
      }
      for (int r = lane; r < B; r += 32) {
        const int pos = p0 + r;
        if (pos >= lo && pos < hi) {
#pragma unroll
          for (int j = 0; j < RPW; ++j) {
            const int g = warp + j * kWarps;
            if (GP % kWarps == 0 || g < GP) mx[j] = fmaxf(mx[j], Ss[g * B + r]);
          }
        }
      }
      float m_new[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int g = warp + j * kWarps;
        m_new[j] = fmaxf(gofr::warp_max(mx[j]), (GP % kWarps == 0 || g < GP) ? Ms[g] : kNegInf);
      }
      for (int r = lane; r < B; r += 32) {
        const int pos = p0 + r;
        const bool in = pos >= lo && pos < hi;
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const int g = warp + j * kWarps;
          if (GP % kWarps == 0 || g < GP) {
            const float p = in ? expf(Ss[g * B + r] - m_new[j]) : 0.f;
            Ps[r * GP + g] = p;
            sum[j] += p;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int g = warp + j * kWarps;
        sum[j] = gofr::warp_sum(sum[j]);
        if (lane == 0 && (GP % kWarps == 0 || g < GP)) {
          const float alpha = expf(Ms[g] - m_new[j]);
          As[g] = alpha;
          Ls[g] = alpha * Ls[g] + sum[j];
          Ms[g] = m_new[j];
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V; thread owns columns tid + kThreads * c.
    // No runtime predicate on g; the column guard folds away when
    // kThreads divides D.
    float a[GP];
    load_row<GP>(a, As);
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[g][c] *= a[g];
#pragma unroll 4
    for (int r = 0; r < B; ++r) {
      float p[GP];
      load_row<GP>(p, Ps + r * GP);
      float vs = 1.f;
      if constexpr (quantized<S>()) vs = Vsc[r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tid + kThreads * c;
        if (D % kThreads != 0 && col >= D) continue;
        float vv = gofr::to_f32(Vs[r * D + col]);
        if constexpr (quantized<S>()) vv *= vs;
#pragma unroll
        for (int g = 0; g < GP; ++g) acc[g][c] = fmaf(p[g], vv, acc[g][c]);
      }
    }
  }
  gofr::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes this CTA's partial O

  float* Os = reinterpret_cast<float*>(smem_raw);  // [GP][D], unnormalized
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int col = tid + kThreads * c;
    if (D % kThreads != 0 && col >= D) continue;
#pragma unroll
    for (int g = 0; g < GP; ++g) Os[g * D + col] = acc[g][c];
  }
  cluster.sync();  // every CTA's (O, m, l) is visible to the cluster

  // merge weights of the cluster's partials for each query row:
  // w_p = exp(m_p - max m) (taken against 0 when no CTA saw a row, so an
  // empty partial weighs exactly 0), and 1 / sum_p w_p l_p
  // (all kMaxSplits remote reads issued at once; ranks past `splits` read
  // as empty partials)
  if (tid < G) {
    const int g = tid;
    float mp[kMaxSplits], lp[kMaxSplits], mm = kNegInf;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      mp[p] = p < splits ? *cluster.map_shared_rank(Ms + g, p) : kNegInf;
      lp[p] = p < splits ? *cluster.map_shared_rank(Ls + g, p) : 0.f;
      mm = fmaxf(mm, mp[p]);
    }
    const float mu = mm == kNegInf ? 0.f : mm;
    float lt = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      const float w = expf(mp[p] - mu);
      Ws[g * WS + p] = w;
      lt += w * lp[p];
    }
    Ws[g * WS + kMaxSplits] = __fdividef(1.f, lt == 0.f ? 1.f : lt);
    if (rank == 0) {
      m_out[(size_t)b * hq + h * G + g] = mm;
      l_out[(size_t)b * hq + h * G + g] = lt;
    }
  }
  __syncthreads();

  // CTA `rank` writes its slice of the G x D outputs
  const int total = G * D, chunk = (total + splits - 1) / splits;
  const int e_end = min(total, (rank + 1) * chunk);
  float* ob = o + ((size_t)b * hq + (size_t)h * G) * D;
  for (int e = rank * chunk + tid; e < e_end; e += kThreads) {
    const float* w = Ws + (e / D) * WS;
    float v[kMaxSplits];
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) v[p] = p < splits ? cluster.map_shared_rank(Os, p)[e] : 0.f;
    float x = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) x += w[p] * v[p];
    ob[e] = x * w[kMaxSplits];
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

struct Plan {
  int splits, n_tbl;
  size_t smem;
};

cudaError_t plan(int elem, bool quant, int b, int hq, int hkv, int d, int B, int MB, Plan* out) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  out->splits = choose_splits(b, hkv, MB, sms);
  out->n_tbl = (MB + out->splits - 1) / out->splits;
  out->smem = Smem(elem, quant, d, pow2_ceil(hq / hkv), B, out->n_tbl).bytes;
  return cudaSuccess;
}

template <typename S, int D, int GP>
cudaError_t launch(const void* q, int q_bf16, const void* k_pool, const void* v_pool, const float* k_scales,
                   const float* v_scales, const int* tables, const int* lo, const int* hi,
                   float* o, float* m, float* l, int b, int hq, int hkv, int n_blocks, int B,
                   int MB, float scale, float logit_cap, cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan(sizeof(S), quantized<S>(), b, hq, hkv, D, B, MB, &p);
  if (err != cudaSuccess) return err;
  if ((err = gofr::allow_smem(paged_decode_kernel<S, D, GP>, p.smem)) != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, hkv, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_kernel<S, D, GP>, q, q_bf16,
                           static_cast<const S*>(k_pool), static_cast<const S*>(v_pool), k_scales,
                           v_scales, tables, lo, hi, o, m, l, hq, hkv, n_blocks, B, MB, p.n_tbl,
                           scale, logit_cap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename S, int GP>
cudaError_t dispatch_d(int d, const void* q, int q_bf16, const void* k_pool, const void* v_pool,
                       const float* k_scales, const float* v_scales, const int* tables,
                       const int* lo, const int* hi, float* o, float* m, float* l, int b, int hq,
                       int hkv, int n_blocks, int B, int MB, float scale, float logit_cap,
                       cudaStream_t stream) {
  switch (d) {
#define GOFR_CASE(DIM)                                                                         \
  case DIM:                                                                                    \
    return launch<S, DIM, GP>(q, q_bf16, k_pool, v_pool, k_scales, v_scales, tables, lo, hi, o, \
                              m, l, b, hq, hkv, n_blocks, B, MB, scale, logit_cap, stream);
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

// the GQA group, rounded up to a power of two, as a template parameter
template <typename S>
cudaError_t dispatch(int d, const void* q, int q_bf16, const void* k_pool, const void* v_pool,
                     const float* k_scales, const float* v_scales, const void* tables,
                     const void* lo, const void* hi, void* o, void* m, void* l, int b, int hq,
                     int hkv, int n_blocks, int B, int MB, float scale, float logit_cap,
                     void* stream) {
  const int* t = static_cast<const int*>(tables);
  const int* lo_p = static_cast<const int*>(lo);
  const int* hi_p = static_cast<const int*>(hi);
  float* o_p = static_cast<float*>(o);
  float* m_p = static_cast<float*>(m);
  float* l_p = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pow2_ceil(hq / hkv)) {
#define GOFR_CASE(GP)                                                                        \
  case GP:                                                                                   \
    return dispatch_d<S, GP>(d, q, q_bf16, k_pool, v_pool, k_scales, v_scales, t, lo_p, hi_p, \
                             o_p, m_p, l_p, b, hq, hkv, n_blocks, B, MB, scale, logit_cap, s);
    GOFR_CASE(1)
    GOFR_CASE(2)
    GOFR_CASE(4)
    GOFR_CASE(8)
    GOFR_CASE(16)
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
  if (dtype == 0)
    return dispatch<float>(d, q, 0, k_pool, v_pool, nullptr, nullptr, tables, lo, hi, o, m, l, b,
                           hq, hkv, n_blocks, block, table_width, scale, logit_cap, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, 1, k_pool, v_pool, nullptr, nullptr, tables, lo, hi, o,
                                   m, l, b, hq, hkv, n_blocks, block, table_width, scale,
                                   logit_cap, stream);
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
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  return dispatch<int8_t>(d, q, dtype, k_pool, v_pool, ks, vs, tables, lo, hi, o, m, l, b, hq, hkv,
                          n_blocks, block, table_width, scale, logit_cap, stream);
}

// The launch plan both entry points use, for reports and tests: pool_bytes
// is the pool's element size (4 = float32, 2 = bfloat16, 1 = int8 with
// scales). Writes the CTAs per (sequence, KV head) of the cluster split and
// the dynamic shared memory per CTA; returns a cudaError_t.
extern "C" int gofr_paged_decode_plan(int pool_bytes, int b, int hq, int hkv, int d, int block,
                                      int table_width, int* splits, int* smem_bytes) {
  if (check_args(hq, hkv, block, 1) || (pool_bytes != 1 && pool_bytes != 2 && pool_bytes != 4))
    return cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan(pool_bytes, pool_bytes == 1, b, hq, hkv, d, block, table_width, &p);
  if (err != cudaSuccess) return err;
  *splits = p.splits;
  *smem_bytes = static_cast<int>(p.smem);
  return cudaSuccess;
}

// Flash attention forward for Hopper (sm_90a).
//
// Replaces: gofr_tpu/ops/attention.py:_flash_kernel (via flash_attention),
// in both of its modes — q_offsets (chunked prefill: query row i of batch b
// sits at absolute position q_offsets[b] + i) and full-prompt (q_offsets ==
// nullptr: row i is position i; causal or not, with or without a window).
//
// What it computes: BSHD in and out. For query head h (KV head h / group),
// s = (q . k) * scale in f32, optional soft-cap cap * tanh(s / cap), masks
// kpos <= qpos (causal) and kpos > qpos - window (window > 0) plus the key
// bound kpos < sk, online softmax over key tiles with f32 running max /
// denominator / accumulator, out = acc / l (l == 0 -> 1, so a fully-masked
// row gives 0). Output in the input dtype.
//
// Two kernels, one per dtype:
//
// bfloat16 (the serving path): flash_mma_kernel, on the tensor cores.
// - Bound: at the serving shapes (c = 16 or 64 query rows of 8 heads on one
//   KV head, head_dim 256, 512 key rows) the work is a few MFLOP and the
//   bytes a few MB, so the kernel is bound by latency: how fast one CTA
//   streams its key range through two products, not by either roofline.
// - GQA packing: one CTA per (batch, KV head, 64 packed rows), packed row
//   r = i * group + g for query row i and head g of the KV head's group, so
//   K/V are staged once per KV head (not once per query head) and the
//   64-row tile is a tensor-core tile even for a 16-token chunk. With one
//   KV head a tile's Q rows are contiguous in BSHD. Each row computes its
//   own i for the masks; rows past sq * group are masked.
// - Products: mma.sync m16n8k16 bf16 -> f32. 4 warps, 16 packed rows each.
//   S = Q . K^T with Q and K fragments from ldmatrix; the softmax runs on
//   the f32 accumulator fragments (row max / sum over the 4 lanes of a
//   quad by shuffles, exp2 with log2(e) folded into the scale); P is
//   rounded to bf16 in registers and is the A operand of O += P . V (V
//   fragments by ldmatrix.trans). q is fed unscaled and S is scaled in f32
//   (1 / sqrt(d) is not a power of two for every d, so q * scale would
//   round differently in bf16).
// - Staging: Q tile and a two-stage K/V ring in dynamic shared memory,
//   filled by 16-byte cp.async (zero-fill past sk); tile t + 1 is in flight
//   while tile t is computed. Rows are padded by 16 bytes (an odd number of
//   16-byte chunks), so the 8 row addresses of an ldmatrix land in 8
//   distinct bank groups and every row stays 16-byte aligned for cp.async.
// - Registers: the O accumulator is 16 x D f32 per warp, D / 2 registers a
//   thread (128 at D = 256), beside 4 per 8-key column of the S tile; Q is
//   re-read from shared memory each k-step instead of held in registers.
//   At D = 256 the key tile is 32 rows, which keeps the kernel under 255
//   registers with 0 spill bytes (the build's -Xptxas=-v line shows both).
// - Split keys: a 16-token chunk has only 16 (batch, KV head, row tile)
//   triples, too few CTAs for 132 SMs. So each row tile's key tiles are
//   shared by a cluster of up to 8 CTAs (about one CTA per SM in all);
//   each keeps its partial (O unnormalized, m, l) in shared memory, and
//   the cluster merges them over distributed shared memory (the merge of
//   paged_chunk_decode_attention), each CTA writing a slice of the columns.
// - Tiles that no row of the CTA can see are never visited (the key range
//   is cut to the causal / window band of the tile's rows, as the Pallas
//   kernel skips them with pl.when); tiles that every row sees in full
//   skip the per-element mask.
// - The key tile at D = 256 (32), the largest cluster (8) and the CTAs per
//   SM that the split aims at (1) are the settings the H100 measured
//   fastest without spills (PERF.md, Findings).
//
// float32: flash_kernel, f32 FMA loops over shared memory (the tensor
// cores would run f32 as TF32, which breaks the f32 contract). Bound by
// FMA issue; not on the serving path. One CTA per (16-row query block,
// query head, batch), 64-row K/V tiles staged by 16-byte loads with the
// K rows padded to an odd word count, each warp owning 4 query rows.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using gofr::kNegInf;

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* q_offsets,
                       void* out, int b, int sq, int sk, int hq, int hkv, int causal, int window,
                       float scale, float logit_cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<float, D>();
  cudaError_t err = gofr::allow_smem(flash_kernel<float, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      q_offsets, static_cast<float*>(out), sq, sk, hq, hkv, causal, window, scale, logit_cap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kMmaRows = 64;      // packed (query row, head) rows per CTA
constexpr int kMmaThreads = 128;  // 4 warps x 16 packed rows
constexpr int kMaxSplits = 8;     // most CTAs sharing one row tile's keys (a portable cluster)
constexpr int kCtasPerSm = 1;     // CTAs per SM that the split aims at
constexpr float kLog2e = 1.4426950408889634f;

// key rows per K/V tile: 32 at D = 256 keeps the kernel under 255
// registers without spills (the O accumulator alone is 128)
template <int D>
__host__ __device__ constexpr int mma_key_tile() { return D >= 256 ? 32 : 64; }

// shared memory row stride in elements: D plus a 16-byte pad
template <int D>
__host__ __device__ constexpr int mma_stride() { return D + 8; }

// Q [kMmaRows] rows | K [2][BK] rows | V [2][BK] rows, all of stride D + 8;
// after the key loop the same bytes hold this CTA's f32 partial (O, m, l)
template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (kMmaRows + 4 * mma_key_tile<D>()) * mma_stride<D>();
}

// rows x D elements global -> shared (stride D + 8) by 16-byte cp.async,
// one chunk per thread per step; row_src(row) is the row's global address,
// or nullptr for a row to zero-fill (then `valid`, any readable global
// address, stands in for it and nothing is read)
template <int D, int ROWS, typename RowSrc>
__device__ __forceinline__ void cp_async_rows(bf16* dst, int tid, const bf16* valid,
                                              RowSrc row_src) {
  constexpr int CH = D / 8, S = mma_stride<D>();
  constexpr int N = ROWS * CH, STEPS = (N + kMmaThreads - 1) / kMmaThreads;
#pragma unroll
  for (int it = 0; it < STEPS; ++it) {
    const int c = tid + it * kMmaThreads;
    if (N % kMmaThreads == 0 || c < N) {
      const int row = c / CH, col = (c % CH) * 8;
      const bf16* src = row_src(row);
      gofr::cp_async16(dst + row * S + col, (src ? src : valid) + col, src != nullptr);
    }
  }
}

// One cluster of `splits` CTAs per (row tile of 64 packed rows, KV head,
// batch); CTA `rank` of the cluster runs its share of the tile's key tiles.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ q_offsets,
                 bf16* __restrict__ out, int sq, int sk, int hq, int hkv, int causal, int window,
                 float scale, float logit_cap) {
  constexpr int BK = mma_key_tile<D>();
  constexpr int S = mma_stride<D>();
  constexpr int NT = BK / 8;  // 8-key column tiles of S
  constexpr int DT = D / 8;   // 8-wide column tiles of O
  static_assert(D % 16 == 0 && BK % 16 == 0, "mma tiles are 16 deep");
  static_assert(sizeof(float) * 4 * 32 * (4 * DT + 4) <= mma_smem_bytes<D>(),
                "the partial (O, m, l) must fit the tile buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kMmaRows][S]
  bf16* sK = sQ + kMmaRows * S;                  // [2][BK][S]
  bf16* sV = sK + 2 * BK * S;                    // [2][BK][S]

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int R = sq * group;  // packed rows of this (batch, KV head)
  const int r_first = (blockIdx.x / splits) * kMmaRows;
  const int r_last = min(r_first + kMmaRows, R) - 1;
  const int off = q_offsets ? q_offsets[b] : 0;
  const int i_min = r_first / group, i_max = r_last / group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // key tiles some row of the tile can see, [k_begin, k_end) rounded out
  // to tiles, and this CTA's share of them
  int k_begin = 0, k_end = sk;
  if (causal) k_end = min(k_end, off + i_max + 1);
  if (window > 0) k_begin = max(0, off + i_min - window + 1);
  const int t_first = k_begin / BK;
  const int n_tiles = k_end > k_begin ? (k_end + BK - 1) / BK - t_first : 0;
  const int per_cta = (n_tiles + splits - 1) / splits;
  const int t_begin = t_first + min(n_tiles, rank * per_cta);
  const int t_end = t_first + min(n_tiles, (rank + 1) * per_cta);

  // Q tile: packed row r is query row r / group, head hk * group + r % group
  const size_t kv_base = ((size_t)b * sk * hkv + hk) * D;  // key row 0 of this (batch, KV head)
  auto load_kv = [&](int t, int stage) {
    cp_async_rows<D, BK>(sK + stage * BK * S, tid, k, [&](int row) -> const bf16* {
      const int kr = t * BK + row;
      return kr < sk ? k + kv_base + (size_t)kr * hkv * D : nullptr;
    });
    cp_async_rows<D, BK>(sV + stage * BK * S, tid, v, [&](int row) -> const bf16* {
      const int kr = t * BK + row;
      return kr < sk ? v + kv_base + (size_t)kr * hkv * D : nullptr;
    });
  };
  if (t_begin < t_end) {
    cp_async_rows<D, kMmaRows>(sQ, tid, q, [&](int row) -> const bf16* {
      const int r = r_first + row;
      if (r >= R) return nullptr;
      return q + ((size_t)(b * sq + r / group) * hq + hk * group + r % group) * D;
    });
    load_kv(t_begin, 0);
  }
  gofr::cp_async_commit();

  // this thread's two rows: warp * 16 + gq and + 8; keys [lo, hi) visible
  const int gq = lane >> 2, tq = lane & 3;
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_first + warp * 16 + gq + 8 * h;
    const int pos = off + r / group;
    lo[h] = window > 0 ? pos - window + 1 : 0;
    hi[h] = r >= R ? -1 : causal ? min(sk, pos + 1) : sk;
  }
  const bool capped = logit_cap > 0.f;
  const float s_mul = capped ? scale / logit_cap : scale * kLog2e;  // S in log2 units
  const float cap_mul = logit_cap * kLog2e;
  const bool rows_full = r_first + kMmaRows <= R;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's partial sums
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, stage ^ 1);  // overwrites the stage computed last iteration
      gofr::cp_async_commit();
      gofr::cp_async_wait<1>();
    } else {
      gofr::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const bf16* cK = sK + stage * BK * S;
    const bf16* cV = sV + stage * BK * S;

    // S = Q . K^T, 16 packed rows x BK keys per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      gofr::ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];
        gofr::ldmatrix_x4(
            bk, cK + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 + ((lane >> 3) & 1) * 8);
        gofr::mma_bf16_16816(s[j], a, bk[0], bk[1]);
        gofr::mma_bf16_16816(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // scale, cap, mask; online softmax on the fragments (row gq: s[.][0..1],
    // row gq + 8: s[.][2..3]; a row's 4 lanes are one quad)
    const int k0 = t * BK;
    const bool full = rows_full && k0 + BK <= sk && (!causal || k0 + BK - 1 <= off + i_min) &&
                      (window <= 0 || k0 > off + i_max - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * s_mul;
        if (capped) x = cap_mul * tanhf(x);
        if (!full) {
          const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
          if (kpos < lo[e >> 1] || kpos >= hi[e >> 1]) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with nothing visible yet keeps m = kNegInf; exponents are
      // taken against 0 then, so its masked pairs still give exactly 0
      m_use[h] = m_new == kNegInf ? 0.f : m_new;
      const float alpha = exp2f(m[h] - m_use[h]);
      m[h] = m_new;
      l[h] *= alpha;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][2 * h] *= alpha;
        o[j][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }

    // O += P . V: P (bf16) is the A operand straight from the S fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          gofr::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          gofr::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          gofr::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          gofr::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bv[4];
        gofr::ldmatrix_x4_trans(
            bv, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + j * 8 + (lane >> 4) * 8);
        gofr::mma_bf16_16816(o[j], a, bv[0], bv[1]);
        gofr::mma_bf16_16816(o[j + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  gofr::cp_async_wait<0>();
  __syncthreads();

  // partial (O unnormalized, m, l) -> this CTA's shared memory in fragment
  // order: xO[warp][j][lane], xML[warp][lane] = (m0, m1, l0, l1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float4* xO = reinterpret_cast<float4*>(smem_raw);
  float4* xML = xO + 4 * DT * 32;
#pragma unroll
  for (int j = 0; j < DT; ++j)
    xO[(warp * DT + j) * 32 + lane] = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
  xML[warp * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
  cluster.sync();  // every CTA's partial is visible to the cluster

  // merge over the cluster (distributed shared memory): CTA `rank` takes
  // the column tiles [j_lo, j_hi) of all 64 rows
  // weight of CTA p's partial: exp2(m_p - max m) / sum over p of the same
  // times l_p (a CTA past `splits`, or one that saw no key, weighs 0)
  float w[kMaxSplits][2], lp[kMaxSplits][2], mm[2] = {kNegInf, kNegInf}, inv[2];
#pragma unroll
  for (int p = 0; p < kMaxSplits; ++p) {
    const float4 ml = p < splits ? cluster.map_shared_rank(xML, p)[warp * 32 + lane]
                                 : make_float4(kNegInf, kNegInf, 0.f, 0.f);
    w[p][0] = ml.x;
    w[p][1] = ml.y;
    lp[p][0] = ml.z;
    lp[p][1] = ml.w;
    mm[0] = fmaxf(mm[0], ml.x);
    mm[1] = fmaxf(mm[1], ml.y);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mu = mm[h] == kNegInf ? 0.f : mm[h];
    float lt = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      w[p][h] = exp2f(w[p][h] - mu);
      lt += w[p][h] * lp[p][h];
    }
    inv[h] = 1.f / (lt == 0.f ? 1.f : lt);
  }
  bf16* dst[2] = {nullptr, nullptr};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_first + warp * 16 + gq + 8 * h;
    if (r < R) dst[h] = out + ((size_t)(b * sq + r / group) * hq + hk * group + r % group) * D + 2 * tq;
  }
  const int j_lo = rank * DT / splits, j_hi = (rank + 1) * DT / splits;
  for (int j = j_lo; j < j_hi; ++j) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      if (p < splits) {
        const float4 x = cluster.map_shared_rank(xO, p)[(warp * DT + j) * 32 + lane];
        acc.x += w[p][0] * x.x;
        acc.y += w[p][0] * x.y;
        acc.z += w[p][1] * x.z;
        acc.w += w[p][1] * x.w;
      }
    }
    if (dst[0])
      *reinterpret_cast<uint32_t*>(dst[0] + j * 8) = gofr::pack_bf16x2(acc.x * inv[0], acc.y * inv[0]);
    if (dst[1])
      *reinterpret_cast<uint32_t*>(dst[1] + j * 8) = gofr::pack_bf16x2(acc.z * inv[1], acc.w * inv[1]);
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* q_offsets,
                        void* out, int b, int sq, int sk, int hq, int hkv, int causal, int window,
                        float scale, float logit_cap, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = gofr::allow_smem(flash_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  // split each row tile's keys over as many CTAs as give about one CTA per
  // SM (two fit an SM, but filling both measured slower: the merge and the
  // cluster launch grow with the split), at most kMaxSplits and at most
  // one per key tile
  const int row_tiles = (sq * (hq / hkv) + kMmaRows - 1) / kMmaRows;
  const int key_tiles = (sk + mma_key_tile<D>() - 1) / mma_key_tile<D>();
  const int splits = std::max(
      1, std::min({kMaxSplits, key_tiles,
                   kCtasPerSm * sms / std::max(1, row_tiles * hkv * b)}));

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * splits, hkv, b);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_mma_kernel<D>, static_cast<const bf16*>(q),
                           static_cast<const bf16*>(k), static_cast<const bf16*>(v), q_offsets,
                           static_cast<bf16*>(out), sq, sk, hq, hkv, causal, window, scale,
                           logit_cap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [b, sq, hq, d], k/v [b, sk, hkv, d],
// out [b, sq, hq, d], all contiguous; q_offsets [b] int32 or nullptr.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int gofr_flash_attention(const void* q, const void* k, const void* v,
                                    const void* q_offsets, void* out, int dtype, int b, int sq,
                                    int sk, int hq, int hkv, int d, int causal, int window,
                                    float scale, float logit_cap, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const int* offs = static_cast<const int*>(q_offsets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define GOFR_CASE(DIM)                                                                          \
  case DIM:                                                                                     \
    return dtype == 0 ? launch_f32<DIM>(q, k, v, offs, out, b, sq, sk, hq, hkv, causal, window, \
                                        scale, logit_cap, s)                                    \
                      : launch_bf16<DIM>(q, k, v, offs, out, b, sq, sk, hq, hkv, causal,        \
                                         window, scale, logit_cap, s);
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

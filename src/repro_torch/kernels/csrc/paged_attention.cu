// K1 paged_attention: one-token decode attention over the fenced global
// paged KV pool.
//
// Replaces: src/repro/kernels/fenced_paged_attention.py
// `fenced_paged_attention` (body `_kernel`); on the TPU the fence and the
// page-map translation live in the BlockSpec index map, before the page DMA.
//
// What it computes, for each sequence b and query head h (GQA: KV head
// h / G, G = H / KH):
//   page p of row b:  phys = resolve_page((page_table[b,p] & mask[b]) | base[b])
//   scores  s_t = (q[b,h] . round_q(K[phys, t, kh])) / sqrt(D)
//   out[b,h] = softmax over positions t < seq_lens[b] of s, applied to
//              round_q(V[phys, t, kh]), accumulated in float32.
// round_q rounds a pool value to the query's type first — the serve path
// keeps a float32 pool under bfloat16 weights and the reference rounds the
// gathered K/V to the query type before its float32-accumulated product.
// Masked positions score -1e30, so a row with seq_len <= 0 is the uniform
// mean over all max_pages * page positions, as in the reference; a row
// with seq_len > 0 reads only its held tokens (a masked position's weight
// exp(-1e30 - m) is exactly 0 in float32).  The fence (base, mask) is one
// scalar pair passed by value, or one pair per row (`base_rows` /
// `mask_rows`, each non-null pointer overriding its scalar).
//
// What bounds it on the H100: at the serve shapes, latency, then bytes.
// The bytes (2 * sum_b len_b * KH * D * 4 of the float32 pool: 7.9 MB at
// stablelm-3b's KH = 32, 1.5 MB at qwen3-moe's KH = 4, for 17-80 held
// tokens a row) take 2.4 / 0.5 us at 3.35 TB/s, at ~1 FLOP per byte;
// before them sits a chain of dependent loads (length and page table ->
// page map -> K/V), and after them the math, whose loops are latency-bound
// when one CTA walks many tokens.  One block per (sequence, KV head) is
// only 32 blocks for 132 SMs at qwen3-moe's B = 8, KH = 4.
//
// Design: one thread-block cluster per (sequence, KV head), of C <= 8 CTAs
// of 256 threads (the wrapper picks C: the largest power of two with
// B * KH * C <= the SM count, so 4 at qwen3-moe, 1 at stablelm-3b).  CTA r
// of the cluster takes the r-th contiguous share of the row's positions.
//  - Fence before address: the row's length, its fence and the first page-
//    table entries load together; then each thread fences, translates and
//    clamps one page id of the CTA's share into shared memory.  No K/V
//    address forms from anything else.
//  - Loads: 16-byte cp.async of the float32 pool rows (D = 80 is 20 a
//    token, D = 128 32) into shared memory, a tile at a time: 128 tokens
//    for a lone CTA (a row of up to 128 held tokens in one round), 64 in a
//    cluster (smaller shared memory, so the clusters pack onto the GPCs'
//    SMs in one wave).  K and V are rounded to the query's type as they
//    are read, as the plain version rounds the gathered pages.
//  - Q.K^T on the CUDA cores over the tile's (head, token) pairs, a lane
//    per token, four accumulators a thread; when the pairs are fewer than
//    the threads (G = 1), D is split over thread groups.  q is a broadcast
//    read and K rows sit at stride D + 4 floats, free of bank conflicts at
//    D = 80 and 128.  The tensor cores would not pay: the products are ~4
//    KFLOP a token, under the latency above, and the CUDA-core path serves
//    the bf16 and the float32 query with one code.
//  - Softmax and P.V in float32, P not rounded (the plain version does not
//    round it); an online softmax across tiles, a warp per head.  P.V
//    gives each thread one output quad (G x D/4 of them), with two
//    accumulators over alternate tokens; spare threads split the tokens
//    and their sums add in a fixed order.
//  - Combine: each CTA leaves its partial (m, l, acc) in its shared memory;
//    after cluster.sync() rank 0 reads every rank's partial through
//    distributed shared memory (all ranks' loads issued at once), merges
//    them in rank order (deterministic) and writes the output; a second
//    cluster.sync() keeps the partials alive until it has.  No global
//    workspace, no second kernel.
//  A CTA whose share holds no token leaves (m = -1e30, l = 0, acc = 0),
//  which the merge weighs to nothing.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDQ = 32;       // D / 4 <= 32 (D <= 128, D % 4 == 0)
constexpr int kMaxGDQ = 512;     // G * D / 4 <= 512 (G * D <= 2048)
constexpr int kMaxQuads = (kMaxGDQ + kThreads - 1) / kThreads;
constexpr int kMaxCluster = 8;   // the portable cluster size

// Shared memory, in floats: q (G*D, later the CTA's partial acc), the K
// tile (tile rows at stride D + 4), the V tile, the partial scores
// (max(kThreads, G*tile)), the probabilities (G x tile), the P.V
// reduction scratch (kThreads float4), m, l, alpha (G each) and the CTA's
// physical page ids (at most max_pages).
static size_t smem_bytes(int tile, int G, int D, int max_pages) {
  const size_t gt = (size_t)G * tile;
  return sizeof(float) * ((size_t)G * D + (size_t)tile * (D + 4) +
                          (size_t)tile * D + (gt > kThreads ? gt : kThreads) +
                          gt + 4 * (size_t)kThreads + 3 * (size_t)G) +
         sizeof(int) * (size_t)max_pages;
}

__device__ __forceinline__ float4 round4(float4 x, bool bf16) {
  if (bf16) {
    x.x = round_to<__nv_bfloat16>(x.x);
    x.y = round_to<__nv_bfloat16>(x.y);
    x.z = round_to<__nv_bfloat16>(x.z);
    x.w = round_to<__nv_bfloat16>(x.w);
  }
  return x;
}

__device__ __forceinline__ float4 fma4(float p, float4 v, float4 a) {
  return make_float4(fmaf(p, v.x, a.x), fmaf(p, v.y, a.y),
                     fmaf(p, v.z, a.z), fmaf(p, v.w, a.w));
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// One output quad's P.V over tokens t, t + step, ... < n_t of a tile,
// after the running sum is rescaled by alpha: two accumulators take
// alternate tokens so consecutive FMAs do not wait on each other.
__device__ __forceinline__ float4 pv_quad(float4 acc, float alpha,
                                          const float* p, const float* v,
                                          int D, int t, int n_t, int step,
                                          bool bf16) {
  float4 a0 = scale4(acc, alpha), a1 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (; t + step < n_t; t += 2 * step) {
    a0 = fma4(p[t], round4(*reinterpret_cast<const float4*>(v + t * D), bf16),
              a0);
    a1 = fma4(p[t + step],
              round4(*reinterpret_cast<const float4*>(v + (t + step) * D),
                     bf16),
              a1);
  }
  if (t < n_t)
    a0 = fma4(p[t], round4(*reinterpret_cast<const float4*>(v + t * D), bf16),
              a0);
  return make_float4(a0.x + a1.x, a0.y + a1.y, a0.z + a1.z, a0.w + a1.w);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <typename Q_T, int kTile>
__global__ void __launch_bounds__(kThreads, kTile == 64 ? 3 : 2)
    paged_attention_kernel(
        const Q_T* __restrict__ q, const float* __restrict__ k_pool,
        const float* __restrict__ v_pool, const int* __restrict__ page_table,
        const int* __restrict__ seq_lens, const int* __restrict__ base_rows,
        const int* __restrict__ mask_rows, int base, int mask,
        const int* __restrict__ page_map, int n_map, Q_T* __restrict__ out,
        int H, int KH, int D, int page, int max_pages, int phys_mask,
        int cluster, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kBf16 = sizeof(Q_T) == 2;
  const int G = H / KH, GD = G * D, DQ = D / 4, GDQ = G * DQ;
  const int GT = G * kTile;
  const int rank = blockIdx.x % cluster, kh = blockIdx.x / cluster;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ks = D + 4;
  float* q_s = smem;
  float* k_s = q_s + GD;
  float* v_s = k_s + kTile * ks;
  float* sc_s = v_s + kTile * D;
  float* p_s = sc_s + (GT > kThreads ? GT : kThreads);
  float4* red_s = reinterpret_cast<float4*>(p_s + GT);
  float* m_s = reinterpret_cast<float*>(red_s + kThreads);
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  int* phys_s = reinterpret_cast<int*>(a_s + G);

  // Loads that depend on nothing, issued together: the row's length and
  // fence, one page-table entry a thread, and q.
  const int len = seq_lens[b];
  const int rbase = base_rows != nullptr ? base_rows[b] : base;
  const int rmask = mask_rows != nullptr ? mask_rows[b] : mask;
  const int* row_table = page_table + (size_t)b * max_pages;
  const int first_id = tid < max_pages ? row_table[tid] : 0;
  const Q_T* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int e = tid; e < GD; e += kThreads) q_s[e] = to_f32<Q_T>(qb[e]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = NEG_INF_F;
    l_s[g] = 0.f;
  }

  // This CTA's share of the row: tokens [t0, t1) of its n_tok positions.
  const int cap = max_pages * page;
  const int n_tok = len > 0 ? min(len, cap) : cap;
  const int chunk = (n_tok + cluster - 1) / cluster;
  const int t0 = min(rank * chunk, n_tok), t1 = min(t0 + chunk, n_tok);
  const int p_lo = t0 / page, p_hi = t1 > t0 ? (t1 - 1) / page + 1 : p_lo;
  for (int p = tid; p < p_hi; p += kThreads) {
    if (p < p_lo) continue;
    // Guardian fence, then virtual -> physical, then the pool clamp: the
    // page id is pinned before it forms any K/V address below.
    const int id = p == tid ? first_id : row_table[p];
    phys_s[p - p_lo] = resolve_page(fence_id(id, rbase, rmask), page_map,
                                    n_map, phys_mask);
  }
  __syncthreads();

  // P.V: one output quad (g, 4 columns) a thread, the tokens split over
  // n_sub thread groups when the quads are fewer than the threads; else
  // up to kMaxQuads quads a thread over every token.
  const int n_sub = GDQ <= kThreads ? kThreads / GDQ : 1;
  const int sub = GDQ <= kThreads ? tid / GDQ : 0;
  float4 acc[kMaxQuads];
#pragma unroll
  for (int r = 0; r < kMaxQuads; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t tok_stride = (size_t)KH * D, head_off = (size_t)kh * D;
  for (int tb = t0; tb < t1; tb += kTile) {
    const int n_t = min(kTile, t1 - tb);
    // stage the tile: 16-byte cp.async of the float32 pool rows
    for (int e = tid; e < n_t * DQ; e += kThreads) {
      const int t = e / DQ, c = e - t * DQ;
      const int pos = tb + t, pg = pos / page;
      const size_t off =
          ((size_t)phys_s[pg - p_lo] * page + (pos - pg * page)) *
              tok_stride + head_off + 4 * c;
      cp_async16(k_s + t * ks + 4 * c, k_pool + off);
      cp_async16(v_s + t * D + 4 * c, v_pool + off);
    }
    cp_async_wait_all();
    __syncthreads();
    // Q.K^T over the tile's (head, token) pairs, a lane per token; when
    // the pairs are fewer than the threads, D's quads are split over
    // n_split thread groups whose partial sums add in group order.  K is
    // rounded to the query's type as it is read.
    const int n_pairs = G * n_t;
    const int n_split = n_pairs < kThreads ? kThreads / n_pairs : 1;
    for (int e = tid; e < n_pairs * n_split; e += kThreads) {
      const int pair = e % n_pairs, part = e / n_pairs;
      const int g = pair / n_t, t = pair - g * n_t;
      const float4* qg = reinterpret_cast<const float4*>(q_s + g * D);
      const float4* kt = reinterpret_cast<const float4*>(k_s + t * ks);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
      for (int c = part; c < DQ; c += n_split) {
        const float4 a = qg[c], k = round4(kt[c], kBf16);
        s0 = fmaf(a.x, k.x, s0);
        s1 = fmaf(a.y, k.y, s1);
        s2 = fmaf(a.z, k.z, s2);
        s3 = fmaf(a.w, k.w, s3);
      }
      sc_s[part * n_pairs + pair] = (s0 + s1) + (s2 + s3);
    }
    __syncthreads();
    // online softmax over the tile: a warp per head, kTile / 32 tokens a
    // lane; masked positions score -1e30, positions past the share weigh 0
    for (int g = warp; g < G; g += kWarps) {
      float sv[kTile / 32];
      float mx = NEG_INF_F;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const int t = lane + 32 * i;
        float s = NEG_INF_F;
        if (t < n_t) {
          s = 0.f;
          for (int part = 0; part < n_split; ++part)
            s += sc_s[part * n_pairs + g * n_t + t];
          s = tb + t < len ? s * scale : NEG_INF_F;
        }
        sv[i] = s;
        mx = fmaxf(mx, s);
      }
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const int t = lane + 32 * i;
        const float w = t < n_t ? expf(sv[i] - m_new) : 0.f;
        p_s[g * kTile + t] = w;
        sum += w;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // P.V in float32, V rounded to the query's type as it is read
    if (n_sub > 1) {
      if (sub < n_sub) {
        const int qd = tid - sub * GDQ, g = qd / DQ, c = qd - g * DQ;
        acc[0] = pv_quad(acc[0], a_s[g], p_s + g * kTile, v_s + 4 * c, D,
                         sub, n_t, n_sub, kBf16);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kMaxQuads; ++r) {
        const int qd = tid + r * kThreads;
        if (qd < GDQ) {
          const int g = qd / DQ, c = qd - g * DQ;
          acc[r] = pv_quad(acc[r], a_s[g], p_s + g * kTile, v_s + 4 * c, D,
                           0, n_t, 1, kBf16);
        }
      }
    }
    __syncthreads();
  }
  if (n_sub > 1) {
    // the token groups' sums, added in group order
    if (sub > 0 && sub < n_sub) red_s[tid] = acc[0];
    __syncthreads();
    if (sub == 0)
      for (int j = 1; j < n_sub; ++j) {
        const float4 x = red_s[tid + j * GDQ];
        acc[0].x += x.x;
        acc[0].y += x.y;
        acc[0].z += x.z;
        acc[0].w += x.w;
      }
  }
  // output quads this thread owns: (n_sub > 1) the group-0 thread of each
  // quad, else up to kMaxQuads quads
  const int n_own = n_sub > 1 ? (sub == 0 ? 1 : 0) : kMaxQuads;
  Q_T* ob = out + ((size_t)b * H + (size_t)kh * G) * D;

  if (cluster == 1) {
#pragma unroll
    for (int r = 0; r < kMaxQuads; ++r) {
      const int qd = tid + r * kThreads;
      if (r < n_own && qd < GDQ) {
        const float inv = 1.f / fmaxf(l_s[qd / DQ], 1e-30f);
        ob[4 * qd + 0] = from_f32<Q_T>(acc[r].x * inv);
        ob[4 * qd + 1] = from_f32<Q_T>(acc[r].y * inv);
        ob[4 * qd + 2] = from_f32<Q_T>(acc[r].z * inv);
        ob[4 * qd + 3] = from_f32<Q_T>(acc[r].w * inv);
      }
    }
    return;
  }

  // The CTA's partial acc replaces q in shared memory (q is read no more).
  float4* part = reinterpret_cast<float4*>(q_s);
#pragma unroll
  for (int r = 0; r < kMaxQuads; ++r) {
    const int qd = tid + r * kThreads;
    if (r < n_own && qd < GDQ) part[qd] = acc[r];
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every rank's (m, l, acc) is visible cluster-wide
  if (rank == 0) {
#pragma unroll
    for (int r = 0; r < kMaxQuads; ++r) {
      const int qd = tid + r * kThreads;
      if (r < n_own && qd < GDQ) {
        const int g = qd / DQ;
        // every rank's partial is read at once, then merged in rank order
        float mj[kMaxCluster], lj[kMaxCluster];
        float4 pj[kMaxCluster];
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j)
          if (j < cluster) {
            mj[j] = cl.map_shared_rank(m_s, j)[g];
            lj[j] = cl.map_shared_rank(l_s, j)[g];
            pj[j] = cl.map_shared_rank(part, j)[qd];
          }
        float M = NEG_INF_F;
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j)
          if (j < cluster) M = fmaxf(M, mj[j]);
        float L = 0.f;
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < kMaxCluster; ++j)
          if (j < cluster) {
            const float w = expf(mj[j] - M);
            L = fmaf(lj[j], w, L);
            A = fma4(w, pj[j], A);
          }
        const float inv = 1.f / fmaxf(L, 1e-30f);
        ob[4 * qd + 0] = from_f32<Q_T>(A.x * inv);
        ob[4 * qd + 1] = from_f32<Q_T>(A.y * inv);
        ob[4 * qd + 2] = from_f32<Q_T>(A.z * inv);
        ob[4 * qd + 3] = from_f32<Q_T>(A.w * inv);
      }
    }
  }
  cl.sync();  // the partials stay alive until rank 0 has read them
}

template <typename Q_T, int kTile>
static int launch_tile(const void* q, const void* k_pool, const void* v_pool,
                       const void* page_table, const void* seq_lens,
                       const void* base_rows, const void* mask_rows, int base,
                       int mask, const void* page_map, int n_map, void* out,
                       int B, int H, int KH, int D, int page, int max_pages,
                       int phys_mask, int cluster, cudaStream_t stream) {
  const size_t smem = smem_bytes(kTile, H / KH, D, max_pages);
  auto kernel = paged_attention_kernel<Q_T, kTile>;
  int rc = allow_smem(kernel, smem);
  if (rc) return rc;
  const float scale = (float)(1.0 / sqrt((double)D));
  const Q_T* qp = (const Q_T*)q;
  const float *kp = (const float*)k_pool, *vp = (const float*)v_pool;
  const int *tp = (const int*)page_table, *lp = (const int*)seq_lens;
  const int *bp = (const int*)base_rows, *mp = (const int*)mask_rows;
  const int* pm = (const int*)page_map;
  Q_T* op = (Q_T*)out;
  const dim3 grid(KH * cluster, B);
  if (cluster == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(
        qp, kp, vp, tp, lp, bp, mp, base, mask, pm, n_map, op, H, KH, D,
        page, max_pages, phys_mask, cluster, scale);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, qp, kp, vp, tp, lp, bp, mp,
                               base, mask, pm, n_map, op, H, KH, D, page,
                               max_pages, phys_mask, cluster, scale);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// A lone CTA per (sequence, KV head) stages 128-token tiles, so a row of up
// to 128 held tokens loads in one round; a cluster's CTAs hold shorter
// shares and stage 64-token tiles, whose smaller shared memory lets the
// clusters pack onto the GPCs' SMs in one wave (measured with chip_smoke's
// K1 inputs: see PERF.md).
template <typename Q_T>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* page_table, const void* seq_lens,
                  const void* base_rows, const void* mask_rows, int base,
                  int mask, const void* page_map, int n_map, void* out, int B,
                  int H, int KH, int D, int page, int max_pages,
                  int phys_mask, int cluster, cudaStream_t stream) {
  if (KH <= 0 || H % KH || D <= 0 || D % 4 || D / 4 > kMaxDQ ||
      (H / KH) * (D / 4) > kMaxGDQ || cluster < 1 ||
      cluster > kMaxCluster || page <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
#define ARGS q, k_pool, v_pool, page_table, seq_lens, base_rows, mask_rows, \
             base, mask, page_map, n_map, out, B, H, KH, D, page, max_pages, \
             phys_mask, cluster, stream
  if (cluster == 1) return launch_tile<Q_T, 128>(ARGS);
  return launch_tile<Q_T, 64>(ARGS);
#undef ARGS
}

extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* seq_lens, const void* base_rows,
    const void* mask_rows, int base, int mask, const void* page_map,
    int n_map, void* out, int B, int H, int KH, int D, int page,
    int max_pages, int n_pool_pages, int cluster, int q_dtype,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int pm = n_pool_pages - 1;
#define ARGS q, k_pool, v_pool, page_table, seq_lens, base_rows, mask_rows, \
             base, mask, page_map, n_map, out, B, H, KH, D, page, max_pages, \
             pm, cluster, s
  if (q_dtype == DT_F32) return launch<float>(ARGS);
  if (q_dtype == DT_BF16) return launch<__nv_bfloat16>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

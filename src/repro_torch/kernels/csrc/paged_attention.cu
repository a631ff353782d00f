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
// Masked positions score -1e30 (so a row with seq_len 0 is the uniform mean
// over all max_pages pages, like the reference); a row only reads the pages
// that hold its seq_len tokens, each page whole.
//
// What bounds it on the H100: bytes.  The function needs each held K and V
// token row once (2 * sum_b len_b * KH * D * 4 bytes of the float32 pool)
// at ~4 FLOPs per byte, far below the ~295 FLOP/byte ridge.  The kernel
// stages the held pages whole: staging only the held tokens of the last
// page (behind a branch, or with a second zero-fill loop) measured about
// 27 % slower on an H100 SXM at 700 W (chip_smoke.py, K1 row).
//
// Design: one block per (KV head, sequence), reading the layer view of the
// (P, page, KH, D) pool in place — no (B, S, KH, D) gather is materialised.
// The block walks its row's pages in order: thread 0's fence and map lookup
// run before any K/V address of the page forms; the page's K and V rows
// are staged in shared memory, the G x page scores and an online softmax
// in float32 follow, and the (G, D) accumulator stays in registers.
// D = 80 (stablelm-3b) is not a power of two: the staging and the
// accumulator walk flat (token, d) index spaces, so no tile is rounded up
// to a power of two; K rows sit at the odd stride D + 1 in shared memory,
// which keeps the score loop free of bank conflicts.

#include "common.cuh"

constexpr int kThreads = 128;
constexpr int kMaxAccPerThread = 16;  // G * D <= 2048

template <typename Q_T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const Q_T* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ seq_lens, const int* __restrict__ base,
    const int* __restrict__ mask, const int* __restrict__ page_map,
    int n_map, Q_T* __restrict__ out, int H, int KH, int D, int page,
    int max_pages, int phys_mask, float scale) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KH;
  const int GD = G * D;
  // K rows are padded to an odd stride: the score loop reads one column
  // of 32 consecutive tokens per warp, which a stride of D = 80 would put
  // in two banks (a 16-way conflict).
  const int ks = D + 1;
  float* q_s = smem;                  // G * D
  float* k_s = q_s + GD;              // page * ks
  float* v_s = k_s + page * ks;       // page * D
  float* p_s = v_s + page * D;        // G * page
  float* m_s = p_s + G * page;        // G
  float* l_s = m_s + G;               // G
  float* a_s = l_s + G;               // G (rescale factor of this page)
  __shared__ int s_phys;

  const int tid = threadIdx.x;
  for (int e = tid; e < GD; e += kThreads)
    q_s[e] = to_f32<Q_T>(q[((size_t)b * H + kh * G) * D + e]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = NEG_INF_F;
    l_s[g] = 0.f;
  }
  float acc[kMaxAccPerThread];
#pragma unroll
  for (int r = 0; r < kMaxAccPerThread; ++r) acc[r] = 0.f;

  const int len = seq_lens[b];
  const int n_pages =
      len > 0 ? min((len + page - 1) / page, max_pages) : max_pages;
  const int warp = tid / 32, lane = tid % 32, n_warps = kThreads / 32;
  const size_t tok_stride = (size_t)KH * D;

  for (int p = 0; p < n_pages; ++p) {
    if (tid == 0) {
      // Guardian fence, then virtual -> physical, then the pool clamp: the
      // page id is pinned before it forms the K/V addresses below.
      s_phys = resolve_page(
          fence_id(page_table[(size_t)b * max_pages + p], base[b], mask[b]),
          page_map, n_map, phys_mask);
    }
    __syncthreads();
    const size_t page_off = ((size_t)s_phys * page) * tok_stride + kh * D;
    for (int e = tid; e < page * D; e += kThreads) {
      const int t = e / D, d = e % D;
      const size_t off = page_off + t * tok_stride + d;
      k_s[t * ks + d] = round_to<Q_T>(k_pool[off]);
      v_s[e] = round_to<Q_T>(v_pool[off]);
    }
    __syncthreads();
    for (int e = tid; e < G * page; e += kThreads) {
      const int g = e / page, t = e % page;
      const float* qg = q_s + g * D;
      const float* kt = k_s + t * ks;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kt[d], s);
      s *= scale;
      p_s[e] = (p * page + t < len) ? s : NEG_INF_F;
    }
    __syncthreads();
    for (int g = warp; g < G; g += n_warps) {
      float mx = NEG_INF_F;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, p_s[g * page + t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_s[g], mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float e = expf(p_s[g * page + t] - m_new);
        p_s[g * page + t] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_s[g] - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxAccPerThread; ++r) {
      const int e = tid + r * kThreads;
      if (e < GD) {
        const int g = e / D, d = e % D;
        float a = acc[r] * a_s[g];
        const float* pg = p_s + g * page;
        for (int t = 0; t < page; ++t) a = fmaf(pg[t], v_s[t * D + d], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kMaxAccPerThread; ++r) {
    const int e = tid + r * kThreads;
    if (e < GD) {
      const int g = e / D;
      out[((size_t)b * H + kh * G) * D + e] =
          from_f32<Q_T>(acc[r] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename Q_T>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* page_table, const void* seq_lens,
                  const void* base, const void* mask, const void* page_map,
                  int n_map, void* out, int B, int H, int KH, int D,
                  int page, int max_pages, int phys_mask,
                  cudaStream_t stream) {
  const int G = H / KH;
  if (G * D > kThreads * kMaxAccPerThread) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + (size_t)page * (2 * D + 1) +
                       (size_t)G * page + 3 * (size_t)G);
  auto kernel = paged_attention_kernel<Q_T>;
  int rc = allow_smem(kernel, smem);
  if (rc) return rc;
  dim3 grid(KH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const Q_T*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)page_table, (const int*)seq_lens, (const int*)base,
      (const int*)mask, (const int*)page_map, n_map, (Q_T*)out, H, KH, D,
      page, max_pages, phys_mask, rsqrtf((float)D));
  return (int)cudaGetLastError();
}

extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* seq_lens, const void* base,
    const void* mask, const void* page_map, int n_map, void* out, int B,
    int H, int KH, int D, int page, int max_pages, int n_pool_pages,
    int q_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int pm = n_pool_pages - 1;
#define ARGS q, k_pool, v_pool, page_table, seq_lens, base, mask, page_map, \
             n_map, out, B, H, KH, D, page, max_pages, pm, s
  if (q_dtype == DT_F32) return launch<float>(ARGS);
  if (q_dtype == DT_BF16) return launch<__nv_bfloat16>(ARGS);
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

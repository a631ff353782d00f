// K4 flash_attention: blocked causal attention forward for prefill.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (body
// `_kernel`; the TPU kernel carries its online-softmax state across a
// sequential KV grid axis and asserts S % blk == 0).
//
// What it computes: out[b, i, h] = softmax_{j <= i} (q[b,i,h] . k[b,j,kh]
// / sqrt(D)) applied to v[b,j,kh], kh = h / (H / KH) (GQA), accumulated in
// float32 and stored in the inputs' type.
//
// What bounds it on the H100: at serve prefill shapes (S <= a few hundred
// tokens, D = 80) the attention FLOPs (~2 * B * H * S^2 * D) are small and
// the kernel reads q, k, v and writes out once, so it is bound by bytes and
// launch latency; this first version computes with CUDA-core FMAs, not
// tensor cores (wgmma is later work).
//
// Design: one block per (64-query tile, head, batch).  Blocks run in no
// order, so the sequential KV grid of the TPU kernel becomes a loop inside
// the block over 64-key tiles up to the diagonal (tiles above it are never
// loaded).  The query tile, the K/V tile, the 64 x 64 score tile and the
// float32 accumulator live in shared memory (K rows at the odd stride
// D + 1, free of bank conflicts in the score loop); per-row max and sum
// carry the online softmax.  Prompts are right-padded to the longest joiner, so S is
// arbitrary: rows and keys at or past S are masked inside the kernel and
// there is no S % tile requirement.

#include "common.cuh"

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int H, int KH,
    int D, float scale) {
  extern __shared__ float smem[];
  // K rows are padded to an odd stride: the score loop reads one column
  // of 32 consecutive keys per warp, which a stride of D = 80 would put in
  // two banks (a 16-way conflict).
  const int ks = D + 1;
  float* q_s = smem;                // kBQ * D
  float* k_s = q_s + kBQ * D;       // kBK * ks
  float* v_s = k_s + kBK * ks;      // kBK * D
  float* acc_s = v_s + kBK * D;     // kBQ * D
  float* s_s = acc_s + kBQ * D;     // kBQ * kBK
  float* m_s = s_s + kBQ * kBK;     // kBQ
  float* l_s = m_s + kBQ;           // kBQ
  float* a_s = l_s + kBQ;           // kBQ

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D, s = q0 + i;
    q_s[e] =
        s < S ? to_f32<T>(q[(((size_t)b * S + s) * H + h) * D + d]) : 0.f;
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    m_s[i] = NEG_INF_F;
    l_s[i] = 0.f;
  }
  const int last = min(q0 + kBQ, S) - 1;  // last query row of the tile
  const int n_tiles = last / kBK + 1;     // key tiles up to the diagonal

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D, s = k0 + j;
      const size_t off = (((size_t)b * S + s) * KH + kvh) * D + d;
      k_s[j * ks + d] = s < S ? to_f32<T>(k[off]) : 0.f;
      v_s[e] = s < S ? to_f32<T>(v[off]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int i = e / kBK, j = e % kBK;
      const float* qi = q_s + i * D;
      const float* kj = k_s + j * ks;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
      const int key = k0 + j;
      s_s[e] = (key <= q0 + i && key < S) ? s * scale : NEG_INF_F;
    }
    __syncthreads();
    for (int i = tid; i < kBQ; i += kThreads) {
      float* row = s_s + i * kBK;
      float mx = m_s[i];
      for (int j = 0; j < kBK; ++j) mx = fmaxf(mx, row[j]);
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = expf(row[j] - mx);
        row[j] = p;
        sum += p;
      }
      const float alpha = expf(m_s[i] - mx);
      a_s[i] = alpha;
      l_s[i] = l_s[i] * alpha + sum;
      m_s[i] = mx;
    }
    __syncthreads();
    for (int e = tid; e < kBQ * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const float* p = s_s + i * kBK;
      float a = acc_s[e] * a_s[i];
      for (int j = 0; j < kBK; ++j) a = fmaf(p[j], v_s[j * D + d], a);
      acc_s[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D, s = q0 + i;
    if (s < S)
      out[(((size_t)b * S + s) * H + h) * D + d] =
          from_f32<T>(acc_s[e] / fmaxf(l_s[i], 1e-30f));
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int KH, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kBQ * D +
                                       (size_t)kBK * (2 * D + 1) +
                                       (size_t)kBQ * kBK + 3 * (size_t)kBQ);
  auto kernel = flash_attention_kernel<T>;
  int rc = allow_smem(kernel, smem);
  if (rc) return rc;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k,
                                           (const T*)v, (T*)out, S, H, KH, D,
                                           rsqrtf((float)D));
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KH, int D, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch<float>(q, k, v, out, B, S, H, KH, D, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, KH, D, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// K4 flash_attention: blocked softmax attention forward for prefill,
// causal or not, optionally under a sliding window.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (body
// `_kernel`; the TPU kernel carries its online-softmax state across a
// sequential KV grid axis, asserts S % blk == 0 and takes `causal`).
//
// What it computes: out[b, i, h] = softmax_{j in band(i)} (q[b,i,h] .
// k[b,j,kh] / sqrt(D)) applied to v[b,j,kh], kh = h / (H / KH) (GQA),
// accumulated in float32 and stored in the inputs' type.  The band is the
// reference's mask (src/repro/models/layers.py `chunked_attention`): j <= i
// when causal, and j > i - window when window > 0 (window and causal are
// launch-time operands).  q has Sq rows and k / v Skv keys of their own
// (the TPU kernel asserts Skv = Sq): a non-causal call may attend Sq
// queries over Skv keys (cross-attention: the decoder's tokens over the
// encoder's frames); a causal one has Skv = Sq (the wrapper refuses
// another).  Prompts are right-padded to the longest joiner, so Sq and Skv
// are arbitrary: keys at or past Skv are masked (-1e30) and rows at or
// past Sq are never stored; there is no S % tile requirement.  A query tile
// walks only the key tiles its rows' bands reach: from the tile holding
// q0 - window + 1 (window > 0) to the diagonal (causal) or to Skv.  A row
// whose band misses the first tile it walks carries weights of 1 for that
// tile's masked keys until its first real key, whose rescale
// exp(-1e30 - m) = 0 clears them; every causal row < Sq holds its own key
// j = i, and every non-causal row without a window holds key 0.
//
// What bounds it on the H100: at serve prefill shapes (S <= a few hundred
// tokens) the attention FLOPs (~2 * B * H * S^2 * D) are small and the
// kernel reads q, k, v and writes out once, so it is bound by bytes and,
// at these sizes, by latency: how many blocks run at once and how long
// each waits on its loads.
//
// Two kernels, chosen by dtype (never a fallback):
//
// bfloat16 (the serve path) runs on the tensor cores.  One warpgroup (128
// threads) per (64-query tile, head, batch): the query tile is exactly
// wgmma's M = 64.  Q, K and V tiles stay bf16 in shared memory in the
// 128-byte-swizzled layout wgmma's descriptors read, D padded to 128 as two
// 64-column chunks (16 KB a tile); K/V tiles are double-buffered, so tile
// j + 1 loads while tile j computes.  Tiles are staged with cp.async (16
// bytes a thread, the swizzle XOR computed here; rows at or past S use the
// zero-fill form and read nothing), which keeps the library a plain .so:
// no tensor map to encode per prefill S and no libcuda link.
//   S = Q K^T: wgmma m64n64k16, D / 16 k-steps (a template parameter, so
//   the loop unrolls), both operands K-major in shared memory; the scores
//   stay in registers, where the causal/ragged mask, the 1/sqrt(D) scale
//   (applied to the f32 scores, folded with log2 e for exp2) and the
//   online softmax run (a row lives in the four threads of a quad: max by
//   __shfl_xor_sync over offsets 1 and 2).
//   O += P V: P is rounded to bf16 in registers and is wgmma's register A
//   operand (the S accumulator fragment of a k16 key slice is exactly the
//   A fragment); V, stored (key, d), is the shared-memory B operand read
//   MN-major (the descriptor's transpose bit); m64n128k16, so D = 80 runs
//   N = 128 against V columns 80-127 zeroed once per block, and output
//   columns >= D are dropped.  The row sum adds the rounded P, so the
//   weights applied to V are normalised exactly; the epilogue divides by
//   max(l, 1e-30) and stores through shared memory in 16-byte rows.
//   81 KB of shared memory a block: two blocks per SM.
//
// float32 (chip_smoke's card-against-CPU check of the whole model) keeps
// the CUDA-core kernel: tensor cores would round its operands to TF32 or
// bf16, and that check holds logits within 2e-3.  It stages tiles widened
// to float in shared memory (K rows at the odd stride D + 1, free of bank
// conflicts in the score loop) and carries the online softmax per row.

#include "common.cuh"

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile

// Whether key `key` lies in query row `row`'s band (and inside Skv).
__device__ __forceinline__ bool in_band(int key, int row, int Skv,
                                        int causal, int window) {
  return key < Skv && (!causal || key <= row) &&
         (window <= 0 || key > row - window);
}

// The key tiles [lo, hi) the query tile starting at q0 reaches: from the
// first key of its first row's band to its last row's diagonal (causal,
// where Skv = Sq) or to Skv.
__device__ __forceinline__ void key_tiles(int q0, int Sq, int Skv,
                                          int causal, int window, int* lo,
                                          int* hi) {
  const int last = min(q0 + kBQ, Sq) - 1;  // last query row of the tile
  *hi = causal ? last / kBK + 1 : (Skv + kBK - 1) / kBK;
  *lo = window > 0 ? max(q0 - window + 1, 0) / kBK : 0;
}

// ------------------------------------------------------------------------
// float32: CUDA-core kernel
// ------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Sq, int Skv,
    int H, int KH, int D, int causal, int window, float scale) {
  extern __shared__ float smem[];
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
    q_s[e] = s < Sq ? q[(((size_t)b * Sq + s) * H + h) * D + d] : 0.f;
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    m_s[i] = NEG_INF_F;
    l_s[i] = 0.f;
  }
  int kt_lo, kt_hi;
  key_tiles(q0, Sq, Skv, causal, window, &kt_lo, &kt_hi);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D, s = k0 + j;
      const size_t off = (((size_t)b * Skv + s) * KH + kvh) * D + d;
      k_s[j * ks + d] = s < Skv ? k[off] : 0.f;
      v_s[e] = s < Skv ? v[off] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int i = e / kBK, j = e % kBK;
      const float* qi = q_s + i * D;
      const float* kj = k_s + j * ks;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
      s_s[e] = in_band(k0 + j, q0 + i, Skv, causal, window) ? s * scale
                                                            : NEG_INF_F;
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
    if (s < Sq)
      out[(((size_t)b * Sq + s) * H + h) * D + d] =
          acc_s[e] / fmaxf(l_s[i], 1e-30f);
  }
}

static int launch_f32(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Skv, int H, int KH, int D,
                      int causal, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)kBQ * D +
                                       (size_t)kBK * (2 * D + 1) +
                                       (size_t)kBQ * kBK + 3 * (size_t)kBQ);
  int rc = allow_smem(flash_attention_f32_kernel, smem);
  if (rc) return rc;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_f32_kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq,
      Skv, H, KH, D, causal, window, rsqrtf((float)D));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// bfloat16: tensor-core kernel (wgmma)
// ------------------------------------------------------------------------

// A tile is 64 rows x 128 bf16 columns, stored as two 64-column chunks;
// each chunk is 8 swizzle atoms of 8 rows x 128 bytes (1024 bytes, 1024-
// byte aligned), with 16-byte column chunk c of row r at c ^ (r % 8).
constexpr int kChunkBytes = 64 * 128;
constexpr int kTileBytes = 2 * kChunkBytes;
constexpr int kMaxD = 128;  // D padded to this in shared memory
// Q, two K buffers, two V buffers, and slack to align the base to 1024.
constexpr int kTcSmem = 5 * kTileBytes + 1024;
// Output staging row stride (bytes): 128 columns + 16, conflict-free for
// the fragment's 4-byte stores and 16-byte aligned for the row copy.
constexpr int kOStride = 2 * kMaxD + 16;

// Byte offset of 16-byte column chunk c (0..15) of tile row r.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * kChunkBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes by threads (generic proxy) made visible to wgmma's
// operand reads (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major
// operands (Q, K): leading offset unused (16), stride 1024 = one 8-row
// atom.  MN-major V: leading offset = the step between 64-column chunks,
// stride 1024 = one 8-key atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32 fragment) (+)= A (smem, K-major) * B (smem, K-major)^T.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128 f32 fragment) += A (registers, bf16) * B (smem, MN-major).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3,
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Stage rows [row0, row0 + 64) of one head of a (B, S, NH, D) tensor
// (`src` points at that head's row 0; rows are `stride` elements apart)
// into the swizzled tile at `dst`: NC = D / 8 16-byte chunks a row, rows
// at or past S zero-filled.
template <int NC>
__device__ __forceinline__ void stage_tile(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           int row0, int S, int stride,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < kBK * NC / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / NC, c = e % NC, s = row0 + r;
    const bool ok = s < S;
    cp_async16(dst + swizzled(r, c), src + (size_t)(ok ? s : 0) * stride +
                                         c * 8, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int KSTEPS>  // D / 16
__global__ void __launch_bounds__(kThreads, 2) flash_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int Sq, int Skv, int H, int KH, int causal, int window,
    float scale_log2) {
  constexpr int D = KSTEPS * 16;
  constexpr int nc = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK = sQ + kTileBytes;      // two buffers
  const uint32_t sV = sK + 2 * kTileBytes;  // two buffers

  // the longest (last) query tiles start first (causal, no window)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qh = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kh = k + ((size_t)b * Skv * KH + kvh) * D;
  const __nv_bfloat16* vh = v + ((size_t)b * Skv * KH + kvh) * D;

  // V columns D..127 of both buffers: zero once (P V runs N = 128; the
  // loads below never write these chunks).
  constexpr int pad_c = 16 - nc;
  if constexpr (pad_c > 0) {
    for (int e = tid; e < 2 * kBK * pad_c; e += kThreads) {
      const int buf = e / (kBK * pad_c), rc = e - buf * kBK * pad_c;
      const int r = rc / pad_c, c = nc + rc % pad_c;
      *reinterpret_cast<uint4*>(smem + 3 * kTileBytes + buf * kTileBytes +
                                swizzled(r, c)) = make_uint4(0, 0, 0, 0);
    }
  }

  int kt_lo, kt_hi;
  key_tiles(q0, Sq, Skv, causal, window, &kt_lo, &kt_hi);
  const int n_tiles = kt_hi - kt_lo;

  // cp.async group t holds the t-th key tile walked, kt_lo + t (group 0
  // also Q).
  stage_tile<nc>(sQ, qh, q0, Sq, H * D, tid);
  stage_tile<nc>(sK, kh, kt_lo * kBK, Skv, KH * D, tid);
  stage_tile<nc>(sV, vh, kt_lo * kBK, Skv, KH * D, tid);
  cp_async_commit();
  if (n_tiles > 1) {
    stage_tile<nc>(sK + kTileBytes, kh, (kt_lo + 1) * kBK, Skv, KH * D,
                   tid);
    stage_tile<nc>(sV + kTileBytes, vh, (kt_lo + 1) * kBK, Skv, KH * D,
                   tid);
  }
  cp_async_commit();

  // Fragment rows of this thread: row0 and row0 + 8 of the query tile;
  // columns 8 i + cq + {0, 1} of each n8 block i.
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = NEG_INF_F, m1 = NEG_INF_F;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sum

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t kbuf = sK + (j & 1) * kTileBytes;
    const uint32_t vbuf = sV + (j & 1) * kTileBytes;
    cp_async_wait<1>();  // tile j has landed (tile j + 1 may be in flight)
    fence_proxy_async();
    __syncthreads();

    // ---- S = Q K^T ---------------------------------------------------
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk >> 2) * kChunkBytes + (kk & 3) * 32;
      wgmma_m64n64k16_ss(s, sw128_desc(sQ + off, 16, 1024),
                         sw128_desc(kbuf + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    // ---- mask, scale, online softmax ---------------------------------
    const int k0 = (kt_lo + j) * kBK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int key = k0 + 8 * i + cq + (e & 1);
        const float x = s[4 * i + e] * scale_log2;
        s[4 * i + e] = in_band(key, row, Skv, causal, window) ? x : NEG_INF_F;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // P rounded to bf16: p[4 kk .. 4 kk + 3] is the A fragment of key
    // slice kk (rows row0 / row0 + 8, keys 16 kk + cq and 16 kk + 8 + cq)
    uint32_t p[16];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          exp2f(s[4 * i] - mx0), exp2f(s[4 * i + 1] - mx0));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          exp2f(s[4 * i + 2] - mx1), exp2f(s[4 * i + 3] - mx1));
      const float2 flo = __bfloat1622float2(lo);
      const float2 fhi = __bfloat1622float2(hi);
      sum0 += flo.x + flo.y;
      sum1 += fhi.x + fhi.y;
      p[2 * i] = bf16x2_bits(lo);
      p[2 * i + 1] = bf16x2_bits(hi);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }

    // ---- O += P V ----------------------------------------------------
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                          p[4 * kk + 3],
                          sw128_desc(vbuf + kk * 2048, kChunkBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();

    __syncthreads();  // every warp is done with this K/V buffer
    if (j + 2 < n_tiles) {
      stage_tile<nc>(kbuf, kh, (kt_lo + j + 2) * kBK, Skv, KH * D, tid);
      stage_tile<nc>(vbuf, vh, (kt_lo + j + 2) * kBK, Skv, KH * D, tid);
    }
    cp_async_commit();
  }

  // ---- epilogue: O / l, staged through the (free) K buffers ----------
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  uint8_t* so = smem + kTileBytes;
  const int lr = warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {  // n8 blocks of the D real columns
    const int col = 8 * i + cq;
    *reinterpret_cast<__nv_bfloat162*>(so + lr * kOStride + col * 2) =
        __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(so + (lr + 8) * kOStride + col * 2) =
        __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
  __syncthreads();
  __nv_bfloat16* oh = out + ((size_t)b * Sq * H + h) * D;
  for (int e = tid; e < kBQ * nc; e += kThreads) {
    const int r = e / nc, c = e - r * nc, srow = q0 + r;
    if (srow < Sq)
      *reinterpret_cast<uint4*>(oh + (size_t)srow * H * D + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * kOStride + c * 16);
  }
}

template <int KSTEPS>
static int launch_bf16(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Skv, int H, int KH,
                       int causal, int window, cudaStream_t stream) {
  auto kernel = flash_attention_bf16_kernel<KSTEPS>;
  int rc = allow_smem(kernel, kTcSmem);
  if (rc) return rc;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, kTcSmem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Sq, Skv, H, KH, causal,
      window,
      rsqrtf((float)(KSTEPS * 16)) * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

static int launch_bf16(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Skv, int H, int KH,
                       int D, int causal, int window, cudaStream_t s) {
  if (KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
#define ARGS q, k, v, out, B, Sq, Skv, H, KH, causal, window, s
  switch (D) {
    case 16: return launch_bf16<1>(ARGS);
    case 32: return launch_bf16<2>(ARGS);
    case 48: return launch_bf16<3>(ARGS);
    case 64: return launch_bf16<4>(ARGS);
    case 80: return launch_bf16<5>(ARGS);
    case 96: return launch_bf16<6>(ARGS);
    case 112: return launch_bf16<7>(ARGS);
    case 128: return launch_bf16<8>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Skv, int H, int KH, int D,
                                      int causal, int window, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Sq <= 0 || Skv <= 0 || (causal && Skv != Sq))
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return launch_f32(q, k, v, out, B, Sq, Skv, H, KH, D, causal, window, s);
  if (dtype == DT_BF16)
    return launch_bf16(q, k, v, out, B, Sq, Skv, H, KH, D, causal, window,
                       s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

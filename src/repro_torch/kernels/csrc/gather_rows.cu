// K3 gather_rows: fenced embedding-row gather.
//
// Replaces: src/repro/kernels/fenced_gather.py `fenced_gather` (the TPU
// kernel fences the row id in its BlockSpec index map, before the row DMA).
//
// What it computes: out[n] = table[(idx[n] & mask) | base], where the fence
// is either one scalar pair for every id (passed by value: the serve path's
// vocab fence) or one pair per id (`base_ids` / `mask_ids`, each non-null
// pointer overriding its scalar: row-mixed guards).  Negative fenced ids
// in [-V, 0) wrap once and fenced ids outside [-V, V) give a NaN row,
// exactly as jnp.take does.  The point of the kernel is the fence on the
// load address: the serve path fences token ids with a pow2 vocab extent
// wider than the table (65,536 against 50,304 rows for stablelm-3b), and
// an id that lands past the table never forms an address at all — the row
// is filled with NaN instead.
//
// What bounds it on the H100: bytes.  It moves N rows in and N rows out
// (2 * N * D * elem bytes); at the serve shapes (N <= 512 ids, D = 2560
// bf16) that is a few MB, so it is bound by launch latency before HBM.
// A scalar fence therefore costs nothing but this one launch: no per-call
// fill of per-id fence tensors.
//
// Design: one warp per id, four ids per 128-thread block.  Lane 0 reads
// and fences the id and broadcasts the row with __shfl_sync; the warp
// copies the row with 16-byte vector loads and stores when the row is a
// multiple of 16 bytes (every configuration the repo serves), else element
// by element, each lane holding up to 16 loads in flight before it stores.

#include "common.cuh"

constexpr int kWarps = 4;   // ids per block
constexpr int kBatch = 16;  // words a lane loads before it stores

template <typename W>
__global__ void __launch_bounds__(32 * kWarps) gather_rows_kernel(
    const W* __restrict__ table, const int* __restrict__ idx,
    const int* __restrict__ base_ids, const int* __restrict__ mask_ids,
    int base, int mask, W* __restrict__ out, int N, int V, int row_words,
    W nan_word) {
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;  // uniform over the warp
  int row = 0;
  if (lane == 0) {
    // Guardian fence on the load address.
    row = fence_id(idx[n], base_ids ? base_ids[n] : base,
                   mask_ids ? mask_ids[n] : mask);
    if (row < 0 && row >= -V) row += V;
  }
  row = __shfl_sync(0xffffffffu, row, 0);
  W* dst = out + (size_t)n * row_words;
  if (row < 0 || row >= V) {
    // Outside the table: no address is formed; the row reads as NaN.
    for (int w = lane; w < row_words; w += 32) dst[w] = nan_word;
    return;
  }
  // Up to kBatch words a lane in flight before any is stored: a 5 KB row
  // (stablelm-3b's 2,560 bf16) is one round trip to memory.
  const W* src = table + (size_t)row * row_words;
  for (int w0 = lane; w0 < row_words; w0 += 32 * kBatch) {
    W buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (w0 + 32 * u < row_words) buf[u] = src[w0 + 32 * u];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (w0 + 32 * u < row_words) dst[w0 + 32 * u] = buf[u];
  }
}

template <typename W>
static int launch(const void* table, const void* idx, const void* base_ids,
                  const void* mask_ids, int base, int mask, void* out, int N,
                  int V, int row_words, W nan_word, cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  gather_rows_kernel<W><<<blocks, 32 * kWarps, 0, stream>>>(
      (const W*)table, (const int*)idx, (const int*)base_ids,
      (const int*)mask_ids, base, mask, (W*)out, N, V, row_words, nan_word);
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_launch(const void* table, const void* idx,
                                  const void* base_ids, const void* mask_ids,
                                  int base, int mask, void* out, int N, int V,
                                  int D, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != DT_F32 && dtype != DT_BF16) return (int)cudaErrorInvalidValue;
  const int elem = dtype == DT_F32 ? 4 : 2;
  const long row_bytes = (long)D * elem;
  if (dtype == DT_F32) {
    const uint32_t nan32 = 0x7FC00000u;
    if (row_bytes % 16 == 0)
      return launch<uint4>(table, idx, base_ids, mask_ids, base, mask, out,
                           N, V, (int)(row_bytes / 16),
                           make_uint4(nan32, nan32, nan32, nan32), s);
    return launch<uint32_t>(table, idx, base_ids, mask_ids, base, mask, out,
                            N, V, D, nan32, s);
  }
  const uint16_t nan16 = 0x7FC0u;  // bfloat16 quiet NaN
  if (row_bytes % 16 == 0) {
    const uint32_t w = ((uint32_t)nan16 << 16) | nan16;
    return launch<uint4>(table, idx, base_ids, mask_ids, base, mask, out, N,
                         V, (int)(row_bytes / 16), make_uint4(w, w, w, w),
                         s);
  }
  return launch<uint16_t>(table, idx, base_ids, mask_ids, base, mask, out, N,
                          V, D, nan16, s);
}

extern "C" const char* gather_rows_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

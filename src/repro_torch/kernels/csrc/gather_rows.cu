// K3 gather_rows: fenced embedding-row gather.
//
// Replaces: src/repro/kernels/fenced_gather.py `fenced_gather` (the TPU
// kernel fences the row id in its BlockSpec index map, before the row DMA).
//
// What it computes: out[n] = table[(idx[n] & mask[n]) | base[n]], one
// (base, mask) pair per id (a scalar pair is broadcast by the wrapper).
// Negative fenced ids in [-V, 0) wrap once and fenced ids outside [-V, V)
// give a NaN row, exactly as jnp.take does.  The point of the kernel is
// the fence on the load address: the serve path fences token ids with a
// pow2 vocab extent wider than the table (65,536 against 50,304 rows for
// stablelm-3b), and an id that lands past the table never forms an
// address at all — the row is filled with NaN instead.
//
// What bounds it on the H100: bytes.  It moves N rows in and N rows out
// (2 * N * D * elem bytes); at the serve shapes (N <= 512 ids, D = 2560
// bf16) that is a few MB, so it is bound by launch latency before HBM.
//
// Design: one block per id; the block's threads copy the row with 16-byte
// vector loads and stores when the row is a multiple of 16 bytes (every
// configuration the repo serves), else element by element.

#include "common.cuh"

template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ table,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ base,
                                   const int* __restrict__ mask,
                                   W* __restrict__ out, int V,
                                   int row_words, W nan_word) {
  const int n = blockIdx.x;
  // Guardian fence on the load address.
  int row = fence_id(idx[n], base[n], mask[n]);
  if (row < 0 && row >= -V) row += V;
  W* dst = out + (size_t)n * row_words;
  if (row < 0 || row >= V) {
    // Outside the table: no address is formed; the row reads as NaN.
    for (int w = threadIdx.x; w < row_words; w += blockDim.x) dst[w] = nan_word;
    return;
  }
  const W* src = table + (size_t)row * row_words;
  for (int w = threadIdx.x; w < row_words; w += blockDim.x) dst[w] = src[w];
}

template <typename W>
static int launch(const void* table, const void* idx, const void* base,
                  const void* mask, void* out, int N, int V, int row_words,
                  W nan_word, cudaStream_t stream) {
  gather_rows_kernel<W><<<N, 128, 0, stream>>>(
      (const W*)table, (const int*)idx, (const int*)base, (const int*)mask,
      (W*)out, V, row_words, nan_word);
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_launch(const void* table, const void* idx,
                                  const void* base, const void* mask,
                                  void* out, int N, int V, int D, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != DT_F32 && dtype != DT_BF16) return (int)cudaErrorInvalidValue;
  const int elem = dtype == DT_F32 ? 4 : 2;
  const long row_bytes = (long)D * elem;
  if (dtype == DT_F32) {
    const uint32_t nan32 = 0x7FC00000u;
    if (row_bytes % 16 == 0)
      return launch<uint4>(table, idx, base, mask, out, N, V,
                           (int)(row_bytes / 16),
                           make_uint4(nan32, nan32, nan32, nan32), s);
    return launch<uint32_t>(table, idx, base, mask, out, N, V, D, nan32, s);
  }
  const uint16_t nan16 = 0x7FC0u;  // bfloat16 quiet NaN
  if (row_bytes % 16 == 0) {
    const uint32_t w = ((uint32_t)nan16 << 16) | nan16;
    return launch<uint4>(table, idx, base, mask, out, N, V,
                         (int)(row_bytes / 16), make_uint4(w, w, w, w), s);
  }
  return launch<uint16_t>(table, idx, base, mask, out, N, V, D, nan16, s);
}

extern "C" const char* gather_rows_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

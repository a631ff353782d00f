// K5 moe_histogram: per-expert counts of fenced router ids.
//
// Replaces: src/repro/kernels/moe_dispatch.py `moe_histogram` (body
// `_kernel`; the TPU kernel walks (256, K) id blocks along a sequential
// grid, fences each block in VMEM and adds a one-hot (blk*K, E) sum into an
// output block that stays resident across the grid, padding T up to a
// block multiple with ids it subtracts again afterwards).
//
// What it computes: counts[e] = #{ i : (ids[i] & mask) | base == e } for e in
// [0, E); a fenced id outside [0, E) is dropped.  The fence is applied to
// each id before it forms a bin address, so a forged router id can never
// count into (or address) a bin outside the tenant's expert extent.
//
// What bounds it on the H100: bytes, and at the serve shapes launch latency.
// It reads n = T * K int32 ids once and writes E counts (T = 8 at decode,
// up to 512 at prefill, K = 8, E = 128: at most 16 KB in, 512 B out), with
// two integer ops and one shared-memory atomic per id.
//
// Design: the TPU's sequential grid with a resident accumulator becomes
// blocks that run in no order, each with a private shared-memory histogram:
// a grid-stride loop over the ids adds int32 atomics into the block's bins,
// then each block adds its non-zero bins into the global counts, which the
// entry point zeroes on the same stream first.  Integer atomics commute, so
// the counts are deterministic whatever the order.  No padding of T is
// needed: the loop bound masks the ragged edge.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132;  // one per SM is plenty for <= 16K ids

__global__ void __launch_bounds__(kThreads) moe_histogram_kernel(
    const int* __restrict__ ids, int n, int base, int mask, int E,
    int* __restrict__ counts) {
  extern __shared__ int bins[];
  for (int e = threadIdx.x; e < E; e += kThreads) bins[e] = 0;
  __syncthreads();
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    // Guardian fence on the bin address.
    const int e = fence_id(ids[i], base, mask);
    if (e >= 0 && e < E) atomicAdd(&bins[e], 1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kThreads) {
    const int c = bins[e];
    if (c) atomicAdd(&counts[e], c);
  }
}

extern "C" int moe_histogram_launch(const void* ids, int n, int base,
                                    int mask, int E, void* counts,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = sizeof(int) * (size_t)E;
  if (E <= 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  int rc = (int)cudaMemsetAsync(counts, 0, smem, s);
  if (rc) return rc;
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  moe_histogram_kernel<<<blocks, kThreads, smem, s>>>(
      (const int*)ids, n, base, mask, E, (int*)counts);
  return (int)cudaGetLastError();
}

extern "C" const char* moe_histogram_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

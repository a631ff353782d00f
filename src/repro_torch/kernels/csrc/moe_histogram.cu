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
// What bounds it on the H100: launch latency.  It reads n = T * K int32 ids
// once and writes E counts (T = 8 at decode, up to 512 at prefill, K = 8,
// E = 128: at most 16 KB in, 512 B out, under 0.01 us at 3.35 TB/s), so a
// call costs what one device operation costs; the floor is one launch.
//
// Design: one launch, no memset, no global atomics.  Up to 8,192 ids
// (IDS_PER_CTA in the wrapper; every serve-path call) run on one CTA of
// 1,024 threads: it zeroes an int32 histogram in shared memory, adds each
// fenced id with a shared-memory atomic (four loads a thread in flight),
// and writes all E bins, zeros included, straight to `counts`.  Past that,
// a cluster of up to 8 CTAs takes the ids in a cluster-wide stride, each into its own
// shared histogram; rank 0 sums the ranks' bins through distributed shared
// memory in rank order and writes them.  Integer sums are exact, so the
// counts are deterministic; any n is accepted (the stride loop covers it).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;    // THREADS in moe_histogram.py
constexpr int kMaxCluster = 8;    // MAX_CLUSTER in moe_histogram.py
constexpr int kBatch = 4;         // id loads a thread has in flight

__global__ void __launch_bounds__(kThreads) moe_histogram_kernel(
    const int* __restrict__ ids, int n, int base, int mask, int E,
    int* __restrict__ counts) {
  extern __shared__ int bins[];
  const int ranks = gridDim.x, rank = blockIdx.x;
  for (int e = threadIdx.x; e < E; e += kThreads) bins[e] = 0;
  __syncthreads();
  const int stride = ranks * kThreads;
  for (int i0 = rank * kThreads + threadIdx.x; i0 < n;
       i0 += kBatch * stride) {
    int bin[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * stride;
      // Guardian fence on the bin address.
      bin[u] = i < n ? fence_id(ids[i], base, mask) : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (bin[u] >= 0 && bin[u] < E) atomicAdd(&bins[bin[u]], 1);
  }
  __syncthreads();
  if (ranks == 1) {
    for (int e = threadIdx.x; e < E; e += kThreads) counts[e] = bins[e];
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every rank's bins are complete and visible
  if (rank == 0)
    for (int e = threadIdx.x; e < E; e += kThreads) {
      int c = 0;
      for (int r = 0; r < ranks; ++r) c += cl.map_shared_rank(bins, r)[e];
      counts[e] = c;
    }
  cl.sync();  // the bins stay alive until rank 0 has read them
}

// `ctas`: the cluster size the wrapper picked (`cluster_ctas`: 1 up to
// 8,192 ids, one more CTA for each further 8,192, at most kMaxCluster).
extern "C" int moe_histogram_launch(const void* ids, int n, int base,
                                    int mask, int E, void* counts, int ctas,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = sizeof(int) * (size_t)E;
  if (E <= 0 || smem > 48 * 1024 || n < 0 || ctas < 1 || ctas > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const int* ip = (const int*)ids;
  int* cp = (int*)counts;
  if (ctas == 1) {
    moe_histogram_kernel<<<1, kThreads, smem, s>>>(ip, n, base, mask, E, cp);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int rc = (int)cudaLaunchKernelEx(&cfg, moe_histogram_kernel, ip, n,
                                         base, mask, E, cp);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

extern "C" const char* moe_histogram_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

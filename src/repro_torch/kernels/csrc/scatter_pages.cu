// K2 scatter_pages: fenced prefill KV page write into the global pool.
//
// Replaces: src/repro/kernels/fenced_scatter.py `fenced_scatter` (the TPU
// kernel fences the destination page id in its output BlockSpec index map,
// one scalar (base, mask) pair, in place through input_output_aliases).
//
// What it computes: for every (row b, logical page p) of a prefill, the
// page of tokens [p*page, (p+1)*page) of k_src[b] / v_src[b] is stored at
// physical page resolve_page((page_ids[b, p] & mask) | base) of k_pool /
// v_pool, in place.  Beyond the TPU kernel it takes:
//   * per-id (base, mask) — the serve path fences each batch row with its
//     own tenant's virtual page extent;
//   * the page_map translation and the `& (P-1)` pool clamp, so the fence
//     and the translation both sit on the *store* address;
//   * ragged prompts — tokens at or past S are written as zeros, the same
//     bytes the reference's pad-to-a-page-multiple writes;
//   * both pools in one launch (grid.z selects K or V).
// Duplicate destinations are the rule, not the exception: every parked
// batch row resolves to the garbage page 0.  GPU blocks run in no order, so
// the kernel makes the result deterministic and last-writer-wins, as the
// TPU's in-order grid is: a page write is skipped when a later id resolves
// to the same physical page (N is a few dozen ids, so the scan is cheap).
//
// What bounds it on the H100: bytes — it reads each written page of K and V
// once and writes it once (4 * N * page * KH * D * elem bytes).
//
// Design: one block per (token within the page, id, pool); the block's
// thread 0 resolves the fenced physical page and the last-writer test, and
// the threads copy the token's KH*D row with 16-byte vector stores.

#include "common.cuh"

template <typename W>
__global__ void scatter_pages_kernel(
    W* __restrict__ k_pool, W* __restrict__ v_pool,
    const W* __restrict__ k_src, const W* __restrict__ v_src,
    const int* __restrict__ page_ids, const int* __restrict__ base,
    const int* __restrict__ mask, const int* __restrict__ page_map,
    int n_map, int n_ids, int n_per_row, int S, int page, int row_words,
    int phys_mask) {
  const int t = blockIdx.x;      // token within the page
  const int i = blockIdx.y;      // id: row i / n_per_row, page i % n_per_row
  const int which = blockIdx.z;  // 0: K, 1: V
  __shared__ int s_phys, s_skip;
  if (threadIdx.x == 0) {
    // Guardian fence + translation + clamp on the store address.
    const int phys = resolve_page(fence_id(page_ids[i], base[i], mask[i]),
                                  page_map, n_map, phys_mask);
    int skip = 0;
    for (int j = i + 1; j < n_ids; ++j) {
      if (resolve_page(fence_id(page_ids[j], base[j], mask[j]), page_map,
                       n_map, phys_mask) == phys) {
        skip = 1;  // a later id owns this page: last writer wins
        break;
      }
    }
    s_phys = phys;
    s_skip = skip;
  }
  __syncthreads();
  if (s_skip) return;
  const int b = i / n_per_row;
  const int s = (i % n_per_row) * page + t;
  W* dst = (which ? v_pool : k_pool) + ((size_t)s_phys * page + t) * row_words;
  if (s < S) {
    const W* src = (which ? v_src : k_src) + ((size_t)b * S + s) * row_words;
    for (int w = threadIdx.x; w < row_words; w += blockDim.x) dst[w] = src[w];
  } else {
    W z;
    memset(&z, 0, sizeof(W));
    for (int w = threadIdx.x; w < row_words; w += blockDim.x) dst[w] = z;
  }
}

template <typename W>
static int launch(void* k_pool, void* v_pool, const void* k_src,
                  const void* v_src, const void* page_ids, const void* base,
                  const void* mask, const void* page_map, int n_map,
                  int n_ids, int n_per_row, int S, int page, int row_words,
                  int phys_mask, cudaStream_t stream) {
  dim3 grid(page, n_ids, 2);
  scatter_pages_kernel<W><<<grid, 128, 0, stream>>>(
      (W*)k_pool, (W*)v_pool, (const W*)k_src, (const W*)v_src,
      (const int*)page_ids, (const int*)base, (const int*)mask,
      (const int*)page_map, n_map, n_ids, n_per_row, S, page, row_words,
      phys_mask);
  return (int)cudaGetLastError();
}

extern "C" int scatter_pages_launch(void* k_pool, void* v_pool,
                                    const void* k_src, const void* v_src,
                                    const void* page_ids, const void* base,
                                    const void* mask, const void* page_map,
                                    int n_map, int n_ids, int n_per_row,
                                    int S, int page, int row_elems,
                                    int elem_bytes, int n_pool_pages,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int phys_mask = n_pool_pages - 1;
  const long row_bytes = (long)row_elems * elem_bytes;
  if (row_bytes % 16 == 0)
    return launch<uint4>(k_pool, v_pool, k_src, v_src, page_ids, base, mask,
                         page_map, n_map, n_ids, n_per_row, S, page,
                         (int)(row_bytes / 16), phys_mask, s);
  if (elem_bytes == 4)
    return launch<uint32_t>(k_pool, v_pool, k_src, v_src, page_ids, base,
                            mask, page_map, n_map, n_ids, n_per_row, S, page,
                            row_elems, phys_mask, s);
  return launch<uint16_t>(k_pool, v_pool, k_src, v_src, page_ids, base, mask,
                          page_map, n_map, n_ids, n_per_row, S, page,
                          row_elems, phys_mask, s);
}

extern "C" const char* scatter_pages_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

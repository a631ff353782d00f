// K2 scatter_pages: fenced prefill KV page write into the global pool.
//
// Replaces: src/repro/kernels/fenced_scatter.py `fenced_scatter` (the TPU
// kernel fences the destination page id in its output BlockSpec index map,
// one scalar (base, mask) pair, in place through input_output_aliases, and
// casts the pages to the pool's type in its body).
//
// What it computes: for every (row b, logical page p) of a prefill, the
// page of tokens [p*page, (p+1)*page) of k_src[b] / v_src[b] is stored at
// physical page resolve_page((page_ids[b, p] & mask) | base) of k_pool /
// v_pool, in place, converted to the pool's type (bf16 -> f32 is exact,
// f32 -> bf16 rounds to nearest even, as Tensor.to does; into a float8
// e4m3 pool both round to nearest even and give NaN past 464, as jnp's
// astype does — the reference's kv_dtype "f8").  Beyond the TPU
// kernel it takes:
//   * the fence by value (one int pair for every id) or as int32 operands
//     read through (row, id) strides — per row (stride 0 over the pages)
//     or per id — so neither is broadcast or filled before the launch;
//   * page ids through their (row, id) strides, so a column slice of the
//     page table is read in place;
//   * the page_map translation and the `& (P-1)` pool clamp, so the fence
//     and the translation both sit on the *store* address;
//   * ragged prompts — tokens at or past S are written as zeros without
//     being read, the same bytes the reference's pad-to-a-page-multiple
//     writes;
//   * both pools in one launch (grid.z selects K or V).
// Duplicate destinations are the rule, not the exception: every parked
// batch row resolves to the garbage page 0.  GPU blocks run in no order, so
// the kernel makes the result deterministic and last-writer-wins, as the
// TPU's in-order grid is: a page is written only by the last id that
// resolves to it.
//
// What bounds it on the H100: bytes — for each kept page of K and V, its
// source tokens read once and the whole page written once.  At the serve
// shapes (8 rows, one 64-token page each, 5 distinct pages) that is 9.5 MB
// at stablelm-3b and 1.9 MB at qwen3-moe-30b-a3b: 2.8 / 0.6 us at 3.35
// TB/s, under the card's launch floor, so what counts is the latency
// before the first store and the bytes in flight.
//
// Design:
//   * One block per (chunk of a page, id, pool), 256 threads.  The wrapper
//     picks the chunk count (`chunks_per_page` in scatter_pages.py): at
//     least one block per SM for each pool when every id is kept, at least
//     one group a thread, and at most kUnroll groups a thread (no thread
//     loops).  stablelm-3b's 640 KB f32 pages take 40 chunks of 16 KB;
//     qwen3-moe's 128 KB pages 17 chunks of about 7.5 KB.  In a diagnostic
//     on the H100 (not in the repo) neither 8 groups a thread, nor half or
//     twice these chunk counts, nor resolving the ids before the loads was
//     faster at both paths' shapes.
//   * A group is G elements moved as one access: 16 bytes of the wider
//     type, so every warp-wide load and store covers whole 32-byte sectors
//     (G = 4 when either side is f32 — bf16 -> f32 loads 8 bytes and
//     stores 16 — and G = 8 when both are bf16 or bf16 goes into float8;
//     a float8 pool stores 4 or 8 bytes a group).  Token rows are a
//     multiple of 8 elements and the operands 16-byte aligned (the
//     wrapper refuses others; every configuration of the repo complies).
//   * The source loads go first: a chunk's source address depends only on
//     (row, page, chunk), not on the fenced id, so each thread issues its
//     kUnroll loads before anything else and the id chain (ids and fence,
//     then the page map) runs while they are in flight.
//   * Ids are resolved once, in parallel: each warp resolves the block's
//     id and the ids after it.  Up to 32 ids, lane j resolves id j (one
//     round of two dependent loads) and __match_any_sync on the resolved
//     pages tells whether a later lane holds the same page.  Past 32 ids
//     the warp compares the block's page with 32 later ids a round, by a
//     warp vote; no shared memory and no block barrier either way.  A
//     block whose id is not the last writer of its page exits there.
//   * Conversion in registers, on the raw bits: bf16 -> f32 is a 16-bit
//     shift, f32 -> bf16 __floats2bfloat162_rn, -> float8 the hardware's
//     saturating round-to-nearest-even cvt inside +-464, NaN past it.
// No TMA and no wgmma: the kernel is a copy.

#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

constexpr int kThreads = 256;  // threads a block
constexpr int kUnroll = 4;     // groups a thread holds in flight

struct Args {
  void* pool[2];
  const void* src[2];
  const int* page_ids;
  int ids_row, ids_col;
  const int* base_ids;
  int base_row, base_col, base;
  const int* mask_ids;
  int mask_row, mask_col, mask;
  const int* page_map;
  int n_map, n_ids, n_per_row, S, page, row_groups, phys_mask;
  int groups_per_chunk;
};

// The raw bits of G consecutive elements of T, as one load or store.
template <int N> struct BitsOf;
template <> struct BitsOf<16> { using T = uint4; };
template <> struct BitsOf<8> { using T = uint2; };
template <> struct BitsOf<4> { using T = uint32_t; };
template <typename T, int G> using Bits = typename BitsOf<sizeof(T) * G>::T;

__device__ __forceinline__ uint32_t f32x2_to_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(__uint_as_float(a), __uint_as_float(b));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One value as a float8 e4m3 byte, as jnp's astype casts: round to nearest
// even (the saturating cvt, exact inside the range), NaN with the value's
// sign past 464 (where round to nearest leaves the largest finite, 448).
__device__ __forceinline__ uint32_t f32_to_fp8(float f) {
  if (!(fabsf(f) <= 464.f)) return signbit(f) ? 0xFFu : 0x7Fu;
  return (uint32_t)__nv_cvt_float_to_fp8(f, __NV_SATFINITE, __NV_E4M3);
}

// G float32 or bfloat16 values (their raw bits) as G float8 bytes, the
// first in the lowest byte.
template <typename TS, int G>
__device__ __forceinline__ Bits<__nv_fp8_e4m3, G> to_fp8(Bits<TS, G> x) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&x);
  uint32_t out[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < G; ++e) {
    uint32_t bits;  // the value's float32 bits (a bf16 is the top half)
    if constexpr (sizeof(TS) == 4) {
      bits = w[e];
    } else {
      bits = e % 2 ? w[e / 2] & 0xFFFF0000u : w[e / 2] << 16;
    }
    out[e / 4] |= f32_to_fp8(__uint_as_float(bits)) << (8 * (e % 4));
  }
  if constexpr (G == 4) {
    return out[0];
  } else {
    return make_uint2(out[0], out[1]);
  }
}

// G elements in TS bits -> the same elements in TP bits: a copy, an exact
// widening (bf16 -> f32 is a 16-bit shift) or a narrowing that rounds to
// nearest even (into float8: past its range, NaN).
template <typename TS, typename TP, int G>
__device__ __forceinline__ Bits<TP, G> convert(Bits<TS, G> x) {
  if constexpr (std::is_same<TS, TP>::value) {
    return x;
  } else if constexpr (std::is_same<TP, __nv_fp8_e4m3>::value) {
    return to_fp8<TS, G>(x);
  } else if constexpr (std::is_same<TS, __nv_bfloat16>::value) {
    return make_uint4(x.x << 16, x.x & 0xFFFF0000u, x.y << 16,
                      x.y & 0xFFFF0000u);
  } else {
    return make_uint2(f32x2_to_bf16x2(x.x, x.y), f32x2_to_bf16x2(x.z, x.w));
  }
}

// Id j (row j / n_per_row, page j % n_per_row): fence, translate, clamp.
__device__ __forceinline__ int resolve(const Args& a, int j) {
  const int r = j / a.n_per_row, c = j % a.n_per_row;
  const int id = a.page_ids[r * a.ids_row + c * a.ids_col];
  const int base = a.base_ids ? a.base_ids[r * a.base_row + c * a.base_col]
                              : a.base;
  const int mask = a.mask_ids ? a.mask_ids[r * a.mask_row + c * a.mask_col]
                              : a.mask;
  return resolve_page(fence_id(id, base, mask), a.page_map, a.n_map,
                      a.phys_mask);
}

// The physical page of id i, and whether i is the last id that resolves to
// it (the page's only writer).  Called by every lane of a warp.
__device__ __forceinline__ bool last_writer(const Args& a, int i,
                                            int* phys) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (a.n_ids <= 32) {
    // pages are >= 0: the -1 of lanes past the ids matches no page
    const int v = lane < a.n_ids ? resolve(a, lane) : -1;
    const unsigned same = __match_any_sync(all, v);
    *phys = __shfl_sync(all, v, i);
    const unsigned mine = __shfl_sync(all, same, i);
    return ((mine >> i) >> 1) == 0u;  // no later lane holds the page
  }
  *phys = resolve(a, i);
  for (int j0 = i + 1; j0 < a.n_ids; j0 += 32) {
    const int j = j0 + lane;
    if (__any_sync(all, j < a.n_ids && resolve(a, j) == *phys)) return false;
  }
  return true;
}

template <typename TS, typename TP, int G>
__global__ void __launch_bounds__(kThreads) scatter_pages_kernel(Args a) {
  using In = Bits<TS, G>;
  using Out = Bits<TP, G>;
  const int i = blockIdx.y;      // id: row i / n_per_row, page i % n_per_row
  const int which = blockIdx.z;  // 0: K, 1: V
  const int b = i / a.n_per_row, p = i % a.n_per_row;
  const int page_groups = a.page * a.row_groups;
  const int g0 = blockIdx.x * a.groups_per_chunk;
  const int g1 = min(g0 + a.groups_per_chunk, page_groups);
  // groups of this page that hold source tokens (the rest are zeros)
  const int held = max(0, min(a.page, a.S - p * a.page)) * a.row_groups;
  const In* src = reinterpret_cast<const In*>(
      static_cast<const TS*>(a.src[which]) +
      ((size_t)b * a.S + (size_t)p * a.page) * a.row_groups * G);
  In buf[kUnroll];
  int gb = g0 + threadIdx.x;
  // the source loads go out before the id chain: they do not depend on it
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int g = gb + u * kThreads;
    if (g < g1 && g < held) buf[u] = src[g];
  }
  int phys;
  if (!last_writer(a, i, &phys)) return;  // a later id owns this page
  Out* dst = reinterpret_cast<Out*>(static_cast<TP*>(a.pool[which]) +
                                    (size_t)phys * page_groups * G);
  while (true) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = gb + u * kThreads;
      if (g < g1) dst[g] = g < held ? convert<TS, TP, G>(buf[u]) : Out{};
    }
    gb += kUnroll * kThreads;
    if (gb >= g1) break;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = gb + u * kThreads;
      if (g < g1 && g < held) buf[u] = src[g];
    }
  }
}

template <typename TS, typename TP, int G>
static int launch(Args a, int row_elems, int chunks, cudaStream_t stream) {
  a.row_groups = row_elems / G;
  const int page_groups = a.page * a.row_groups;
  a.groups_per_chunk = (page_groups + chunks - 1) / chunks;
  dim3 grid(chunks, a.n_ids, 2);
  scatter_pages_kernel<TS, TP, G><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// One instantiation per (source, pool) pair: 16-byte accesses of the
// wider type, 4 elements when either side is f32, 8 when the wider is bf16.
template <typename TS, typename TP>
static int launch_pair(const Args& a, int row_elems, int group, int chunks,
                       cudaStream_t s) {
  constexpr int kG = 16 / (int)(sizeof(TS) > sizeof(TP) ? sizeof(TS)
                                                        : sizeof(TP));
  if (group != kG || row_elems % kG != 0) return (int)cudaErrorInvalidValue;
  return launch<TS, TP, kG>(a, row_elems, chunks, s);
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

extern "C" int scatter_pages_launch(
    void* k_pool, void* v_pool, const void* k_src, const void* v_src,
    const void* page_ids, int ids_row, int ids_col, const void* base_ids,
    int base_row, int base_col, int base, const void* mask_ids,
    int mask_row, int mask_col, int mask, const void* page_map, int n_map,
    int B, int n_per_row, int S, int page, int row_elems, int n_pool_pages,
    int src_dtype, int pool_dtype, int group, int chunks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool dtypes_ok = (src_dtype == DT_F32 || src_dtype == DT_BF16) &&
                         (pool_dtype == DT_F32 || pool_dtype == DT_BF16 ||
                          pool_dtype == DT_FP8E4M3);
  if (!dtypes_ok || chunks < 1) return (int)cudaErrorInvalidValue;
  if (!(aligned16(k_pool) && aligned16(v_pool) && aligned16(k_src) &&
        aligned16(v_src)))
    return (int)cudaErrorMisalignedAddress;
  if (B * n_per_row == 0) return 0;
  Args a;
  a.pool[0] = k_pool;
  a.pool[1] = v_pool;
  a.src[0] = k_src;
  a.src[1] = v_src;
  a.page_ids = (const int*)page_ids;
  a.ids_row = ids_row;
  a.ids_col = ids_col;
  a.base_ids = (const int*)base_ids;
  a.base_row = base_row;
  a.base_col = base_col;
  a.base = base;
  a.mask_ids = (const int*)mask_ids;
  a.mask_row = mask_row;
  a.mask_col = mask_col;
  a.mask = mask;
  a.page_map = (const int*)page_map;
  a.n_map = n_map;
  a.n_ids = B * n_per_row;
  a.n_per_row = n_per_row;
  a.S = S;
  a.page = page;
  a.phys_mask = n_pool_pages - 1;
  typedef __nv_bfloat16 bf16;
  typedef __nv_fp8_e4m3 fp8;
  if (src_dtype == DT_BF16)
    return pool_dtype == DT_F32
               ? launch_pair<bf16, float>(a, row_elems, group, chunks, s)
           : pool_dtype == DT_BF16
               ? launch_pair<bf16, bf16>(a, row_elems, group, chunks, s)
               : launch_pair<bf16, fp8>(a, row_elems, group, chunks, s);
  return pool_dtype == DT_F32
             ? launch_pair<float, float>(a, row_elems, group, chunks, s)
         : pool_dtype == DT_BF16
             ? launch_pair<float, bf16>(a, row_elems, group, chunks, s)
             : launch_pair<float, fp8>(a, row_elems, group, chunks, s);
}

extern "C" const char* scatter_pages_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

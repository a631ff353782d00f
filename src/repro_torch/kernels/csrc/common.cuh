// Shared helpers of the repro_torch Hopper kernels: element conversions and
// the Guardian fence, which every kernel applies to an index before that
// index forms a global-memory address.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element-type codes passed from Python (see kernels/_build.py DTYPE_CODE).
enum DTypeCode { DT_F32 = 0, DT_BF16 = 1, DT_FP8E4M3 = 2 };

#define NEG_INF_F (-1e30f)

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Round a float to type T and back: the value a T operand would carry.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// The Guardian bitwise fence (the paper's Listing 1): two integer
// instructions that pin an untrusted id into [base, base + mask + 1).
__device__ __forceinline__ int fence_id(int id, int base, int mask) {
  return (id & mask) | base;
}

// Virtual -> physical page of the global paged pool: translate a fenced
// virtual id through the manager-owned page map (a virtual id outside the
// map resolves to the allocator-owned garbage page 0), then clamp into the
// power-of-two pool.  Without a map the fenced id is the physical id.
__device__ __forceinline__ int resolve_page(int virt, const int* page_map,
                                           int n_map, int phys_mask) {
  int phys = virt;
  if (page_map != nullptr) {
    phys = (virt >= 0 && virt < n_map) ? page_map[virt] : 0;
  }
  return phys & phys_mask;
}

// Set a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB; returns the CUDA error code.
template <typename K>
static int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

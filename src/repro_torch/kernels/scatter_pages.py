"""K2 wrapper: fenced prefill KV page write (``csrc/scatter_pages.cu``).

Replaces ``repro/kernels/fenced_scatter.py``'s ``fenced_scatter``.  Both
pools are written in place by one launch, from K/V in their own type (the
kernel widens or narrows to the pool's), with the page ids and any tensor
fence read through their strides: a call is one device operation.  The
wrapper calls the custom op ``repro_torch::scatter_pages``, which declares
both pools mutated: a CPU pool runs the plain version
(:func:`repro_torch.kernels.ref.scatter_pages_ref`), a CUDA pool launches
the kernel or raises, and a fake pool (a trace) is left as it is.  What
the kernel addresses is declared in :mod:`repro_torch.kernels.access`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, check_device, \
    dtype_code, fence_args, join_fence, ptr, sm_count, split_fence, \
    stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("scatter_pages", "scatter_pages.cu",
                [_P] * 5 + [_I, _I, _P] + [_I] * 3 + [_P] + [_I] * 3
                + [_P] + [_I] * 11 + [_P])

#: the kernel's threads a block and groups a thread holds in flight
#: (``kThreads``, ``kUnroll`` in the source)
THREADS, UNROLL = 256, 4


def chunks_per_page(n_ids: int, groups_per_page: int, n_sm: int) -> int:
    """Blocks each (id, pool) page is split over: enough that the ids'
    pages of one pool cover every SM, but at least one group a thread and
    at most :data:`UNROLL` (no thread loops).  stablelm-3b's 8 ids of
    40,960 groups on 132 SMs take 40; qwen3-moe's 8,192 groups 17."""
    most = max(1, groups_per_page // THREADS)
    least = -(-groups_per_page // (THREADS * UNROLL))
    return max(least, min(most, -(-n_sm // max(n_ids, 1))))


def group_size(k_src, k_pool) -> int:
    """Elements a thread moves as one access: 16 bytes of the wider of the
    source and pool types, 4 when either is float32, 8 when the wider is
    bfloat16 (into a float8 pool too)."""
    return 16 // max(k_src.element_size(), k_pool.element_size())


def fence_view(v, B: int, n: int, device):
    """A K2 fence operand: an int stays an int (passed by value); a tensor
    — one value, per row (B,) or per id (B, n) — becomes an int32 (B, n)
    view on ``device`` whose strides the kernel reads (nothing is filled
    or copied for it)."""
    if not isinstance(v, torch.Tensor):
        return int(v)
    v = v.to(device=device, dtype=torch.int32)
    if v.dim() == 1 and v.numel() == B:
        v = v[:, None]
    return v.expand(B, n)


def _strided(v):
    """``(pointer, row stride, id stride, value)`` of a fence operand."""
    p, val = fence_args(v)
    rs, cs = v.stride() if isinstance(v, torch.Tensor) else (0, 0)
    return [p, rs, cs, val]


def launch_args(k_pool, v_pool, k_src, v_src, ids, base, mask, page_map,
                chunks: int):
    """The C entry point's arguments, in order, but for the stream: page
    ids (B, n) and tensor fences (from :func:`fence_view`) as pointers with
    their (row, id) strides, an int fence by value, the (source, pool)
    dtype pair, the group size and the chunk count."""
    B, S = k_src.shape[:2]
    P, page, KH, D = k_pool.shape
    n = ids.shape[1]
    return [ptr(k_pool), ptr(v_pool), ptr(k_src), ptr(v_src), ptr(ids),
            ids.stride(0), ids.stride(1), *_strided(base), *_strided(mask),
            ctypes.c_void_p(None) if page_map is None else ptr(page_map),
            0 if page_map is None else page_map.shape[0], B, n, S, page,
            KH * D, P, dtype_code(k_src.dtype), dtype_code(k_pool.dtype),
            group_size(k_src, k_pool), chunks]


@torch.library.custom_op("repro_torch::scatter_pages",
                         mutates_args=("k_pool", "v_pool"),
                         device_types="cpu")
def scatter_pages_op(k_pool: torch.Tensor, v_pool: torch.Tensor,
                     k_src: torch.Tensor, v_src: torch.Tensor,
                     ids: torch.Tensor, base_ids: Optional[torch.Tensor],
                     mask_ids: Optional[torch.Tensor], base: int, mask: int,
                     page_map: Optional[torch.Tensor]) -> None:
    """The plain version, for CPU tensors."""
    KERNEL.plain_calls += 1
    ref.scatter_pages_ref(k_pool, v_pool, k_src, v_src, ids,
                          join_fence(base_ids, base),
                          join_fence(mask_ids, mask), page_map)


@scatter_pages_op.register_kernel("cuda")
def _cuda(k_pool, v_pool, k_src, v_src, ids, base_ids, mask_ids, base, mask,
      page_map):
    if k_src.dtype != v_src.dtype or k_pool.dtype != v_pool.dtype:
        raise TypeError("scatter_pages: K and V differ in dtype")
    if k_src.shape != v_src.shape or k_pool.shape != v_pool.shape \
            or k_src.shape[2:] != k_pool.shape[2:]:
        raise ValueError("scatter_pages: K/V shapes differ")
    pmap = page_map.to(torch.int32) if page_map is not None else None
    check_cuda("scatter_pages", k_pool, v_pool, k_src, v_src,
               *(() if pmap is None else (pmap,)))
    B, n = ids.shape
    page, KH, D = k_pool.shape[1:]
    if (KH * D) % 8 or any(t.data_ptr() % 16 for t in (k_pool, v_pool,
                                                       k_src, v_src)):
        raise ValueError("scatter_pages: the kernel takes token rows of a "
                         "multiple of 8 elements and 16-byte aligned "
                         f"operands, got KH*D={KH * D}")
    chunks = chunks_per_page(B * n, page * KH * D // group_size(k_src, k_pool),
                             sm_count(k_pool.device))
    KERNEL.launch(*launch_args(k_pool, v_pool, k_src, v_src, ids,
                               join_fence(base_ids, base),
                               join_fence(mask_ids, mask), pmap, chunks),
                  stream_of(k_pool))


@scatter_pages_op.register_fake
def _fake(k_pool, v_pool, k_src, v_src, ids, base_ids, mask_ids, base, mask,
      page_map):
    return None


def scatter_pages(k_pool, v_pool, k_src, v_src, page_ids, fence_base,
                  fence_mask, page_map=None):
    """Write k_src/v_src (B,S,KH,D), float32 or bfloat16, into k_pool/
    v_pool (P,page,KH,D), float32, bfloat16 or float8_e4m3fn (cast as jnp
    casts: :func:`repro_torch.kernels.ref.to_pool`), at page ids (B,
    ceil(S/page)) — any strides, e.g. a column slice of the page table —
    fenced with ``(id & mask) | base`` (base and mask: ints, or tensors of
    one value, per row (B,) or per id (B, n)), translated through
    ``page_map`` and clamped to the power-of-two pool.  The source is
    converted to the pool's type.  Updates the pools in place and returns
    them.  On the card a token row (KH*D) must be a multiple of 8
    elements and the operands 16-byte aligned."""
    B, S = k_src.shape[:2]
    P, page = k_pool.shape[:2]
    n = page_ids.shape[1]
    if n * page < S or (n - 1) * page >= S:
        raise ValueError(f"scatter_pages: {n} pages do not fit S={S} "
                         f"tokens of {page}")
    if P & (P - 1):
        raise ValueError(f"scatter_pages needs a pow2 pool, got P={P}")
    dev = k_pool.device
    check_device("scatter_pages", k_pool)
    ids = page_ids.to(device=dev, dtype=torch.int32)
    (base_ids, base), (mask_ids, mask) = (
        split_fence(fence_view(v, B, n, dev))
        for v in (fence_base, fence_mask))
    scatter_pages_op(k_pool, v_pool, k_src, v_src, ids, base_ids, mask_ids,
                     base, mask, page_map)
    return k_pool, v_pool

"""K2 wrapper: fenced prefill KV page write (``csrc/scatter_pages.cu``).

Replaces ``repro/kernels/fenced_scatter.py``'s ``fenced_scatter``.  Both
pools are written in place by one launch.  A CPU pool takes the plain
version (:func:`repro_torch.kernels.ref.scatter_pages_ref`); a CUDA pool
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, per_id, ptr, \
    stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("scatter_pages", "scatter_pages.cu",
                [_P] * 8 + [_I] * 8 + [_P])


def scatter_pages(k_pool, v_pool, k_src, v_src, page_ids, fence_base,
                  fence_mask, page_map=None):
    """Write k_src/v_src (B,S,KH,D) into k_pool/v_pool (P,page,KH,D) at
    page ids (B, ceil(S/page)) fenced with ``(id & mask) | base`` (base
    and mask: scalars, per-row (B,) or per-id (B, n) tensors), translated
    through ``page_map`` and clamped to the power-of-two pool.  Updates
    the pools in place and returns them."""
    B, S = k_src.shape[:2]
    P, page = k_pool.shape[:2]
    n = page_ids.shape[1]
    if n * page < S or (n - 1) * page >= S:
        raise ValueError(f"scatter_pages: {n} pages do not fit S={S} "
                         f"tokens of {page}")
    if P & (P - 1):
        raise ValueError(f"scatter_pages needs a pow2 pool, got P={P}")
    ids = page_ids.to(torch.int32).reshape(-1).contiguous()
    dev = k_pool.device

    def per_page(v):
        if isinstance(v, torch.Tensor) and v.dim() == 1 and v.numel() == B:
            v = v[:, None]
        if isinstance(v, torch.Tensor):
            v = v.to(dev).expand(B, n).reshape(-1)
        return per_id(v, B * n, dev)

    base, mask = per_page(fence_base), per_page(fence_mask)
    if dev.type == "cpu":
        KERNEL.plain_calls += 1
        return ref.scatter_pages_ref(k_pool, v_pool, k_src, v_src,
                                     ids.reshape(B, n), base.reshape(B, n),
                                     mask.reshape(B, n), page_map)
    if dev.type != "cuda":
        raise ValueError(f"scatter_pages: unsupported device {dev}")
    if k_src.dtype != k_pool.dtype or v_src.dtype != v_pool.dtype:
        raise TypeError("scatter_pages: source and pool dtypes differ")
    pmap = page_map.to(torch.int32) if page_map is not None else None
    check_cuda("scatter_pages", k_pool, v_pool, k_src, v_src, ids, base,
               mask, *(() if pmap is None else (pmap,)))
    KH, D = k_pool.shape[2:]
    KERNEL.launch(ptr(k_pool), ptr(v_pool), ptr(k_src), ptr(v_src),
                  ptr(ids), ptr(base), ptr(mask),
                  ctypes.c_void_p(pmap.data_ptr() if pmap is not None
                                  else None),
                  0 if pmap is None else pmap.shape[0], B * n, n, S, page,
                  KH * D, k_pool.element_size(), P, stream_of(k_pool))
    return k_pool, v_pool

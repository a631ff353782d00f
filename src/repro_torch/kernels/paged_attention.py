"""K1 wrapper: fenced paged decode attention (``csrc/paged_attention.cu``).

Replaces ``repro/kernels/fenced_paged_attention.py``'s
``fenced_paged_attention``.  A CPU query takes the plain version
(:func:`repro_torch.kernels.ref.paged_attention_ref`); a CUDA query
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, dtype_code, \
    per_id, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("paged_attention", "paged_attention.cu",
                [_P] * 8 + [_I, _P] + [_I] * 8 + [_P])


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, fence_base,
                    fence_mask, page_map=None):
    """q (B,H,D) float32 or bfloat16; pools (P,page,KH,D) (a layer view of
    the global pool, float32 on the card);
    page_table (B, max_pages) virtual or physical ids; seq_lens (B,);
    base/mask scalars or (B,); optional page_map (n_virt,).  Returns
    (B,H,D) in q's dtype."""
    B, H, D = q.shape
    P, page, KH = k_pages.shape[:3]
    if P & (P - 1):
        raise ValueError(f"paged_attention needs a pow2 pool, got P={P}")
    dev = q.device
    base, mask = per_id(fence_base, B, dev), per_id(fence_mask, B, dev)
    if dev.type == "cpu":
        KERNEL.plain_calls += 1
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                       seq_lens, base, mask, page_map)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {dev}")
    if k_pages.dtype != torch.float32 or v_pages.dtype != torch.float32:
        raise TypeError("paged_attention: the kernel reads a float32 pool, "
                        f"got {k_pages.dtype}")
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    pmap = page_map.to(torch.int32) if page_map is not None else None
    check_cuda("paged_attention", q, k_pages, v_pages, table, lens, base,
               mask, *(() if pmap is None else (pmap,)))
    out = torch.empty_like(q)
    KERNEL.launch(ptr(q), ptr(k_pages), ptr(v_pages), ptr(table), ptr(lens),
                  ptr(base), ptr(mask),
                  ctypes.c_void_p(pmap.data_ptr() if pmap is not None
                                  else None),
                  0 if pmap is None else pmap.shape[0], ptr(out), B, H, KH,
                  D, page, table.shape[1], P, dtype_code(q.dtype),
                  stream_of(q))
    return out

"""K1 wrapper: fenced paged decode attention (``csrc/paged_attention.cu``).

Replaces ``repro/kernels/fenced_paged_attention.py``'s
``fenced_paged_attention``.  A CPU query takes the plain version
(:func:`repro_torch.kernels.ref.paged_attention_ref`); a CUDA query
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, dtype_code, \
    fence_args, fence_operand, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("paged_attention", "paged_attention.cu",
                [_P] * 7 + [_I, _I, _P, _I, _P] + [_I] * 9 + [_P])

#: the largest cluster the kernel launches (the portable size)
MAX_CLUSTER = 8


def cluster_size(pairs: int, n_sm: int) -> int:
    """CTAs a (sequence, KV head) pair is split over: the largest power of
    two up to :data:`MAX_CLUSTER` whose ``pairs * C`` CTAs still fit one
    wave of one CTA per SM, at least 1.  qwen3-moe-30b-a3b's 32 pairs on
    132 SMs get 4; stablelm-3b's 256 pairs get 1."""
    c = 1
    while 2 * c <= MAX_CLUSTER and pairs * 2 * c <= n_sm:
        c *= 2
    return c


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_args(q, k_pages, v_pages, table, lens, base, mask, page_map,
                out, cluster: int):
    """The C entry point's arguments, in order, but for the stream: the
    fence (``base``/``mask`` from :func:`fence_operand`) by value, or as
    per-row pointers."""
    B, H, D = q.shape
    P, page, KH = k_pages.shape[:3]
    (base_rows, base_val), (mask_rows, mask_val) = fence_args(base), \
        fence_args(mask)
    return [ptr(q), ptr(k_pages), ptr(v_pages), ptr(table), ptr(lens),
            base_rows, mask_rows, base_val, mask_val,
            ctypes.c_void_p(None) if page_map is None else ptr(page_map),
            0 if page_map is None else page_map.shape[0], ptr(out), B, H,
            KH, D, page, table.shape[1], P, cluster, dtype_code(q.dtype)]


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, fence_base,
                    fence_mask, page_map=None):
    """q (B,H,D) float32 or bfloat16; pools (P,page,KH,D) (a layer view of
    the global pool, float32 on the card);
    page_table (B, max_pages) virtual or physical ids; seq_lens (B,);
    base/mask ints or (B,) tensors; optional page_map (n_virt,).  Returns
    (B,H,D) in q's dtype.

    An int fence reaches the kernel by value; a tensor fence is one int32
    operand per row.  On the card the kernel takes D a multiple of 4 up to
    128 and (H / KH) * D up to 2,048."""
    B, H, D = q.shape
    P, page, KH = k_pages.shape[:3]
    if P & (P - 1):
        raise ValueError(f"paged_attention needs a pow2 pool, got P={P}")
    dev = q.device
    base, mask = (fence_operand(v, B, dev) for v in (fence_base, fence_mask))
    if dev.type == "cpu":
        KERNEL.plain_calls += 1
        base, mask = (v if isinstance(v, torch.Tensor)
                      else torch.full((B,), v, dtype=torch.int32)
                      for v in (base, mask))
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                       seq_lens, base, mask, page_map)
    if dev.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {dev}")
    if k_pages.dtype != torch.float32 or v_pages.dtype != torch.float32:
        raise TypeError("paged_attention: the kernel reads a float32 pool, "
                        f"got {k_pages.dtype}")
    if H % KH or D % 4 or D > 128 or (H // KH) * D > 2048:
        raise ValueError(f"paged_attention: the kernel takes D % 4 == 0, "
                         f"D <= 128 and (H/KH)*D <= 2048, got H={H}, "
                         f"KH={KH}, D={D}")
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    pmap = page_map.to(torch.int32) if page_map is not None else None
    per_row = [t for t in (base, mask) if isinstance(t, torch.Tensor)]
    check_cuda("paged_attention", q, k_pages, v_pages, table, lens,
               *per_row, *(() if pmap is None else (pmap,)))
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: the pools must be 16-byte "
                         "aligned (float4 loads)")
    out = torch.empty_like(q)
    cluster = cluster_size(B * KH, _sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    KERNEL.launch(*launch_args(q, k_pages, v_pages, table, lens, base, mask,
                               pmap, out, cluster), stream_of(q))
    return out

"""K1 wrapper: fenced paged decode attention (``csrc/paged_attention.cu``).

Replaces ``repro/kernels/fenced_paged_attention.py``'s
``fenced_paged_attention``.  The wrapper calls the custom op
``repro_torch::paged_attention``: a CPU query runs the plain version
(:func:`repro_torch.kernels.ref.paged_attention_ref`), a CUDA query
launches the kernel or raises, and a fake query (a trace) gets the
output's shape only.  What the kernel addresses is declared in
:mod:`repro_torch.kernels.access`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, check_device, \
    dtype_code, fence_args, fence_operand, heads_pair, join_fence, opt, \
    placements, ptr, sharding_rule, sm_count, split_fence, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("paged_attention", "paged_attention.cu",
                [_P] * 7 + [_I, _I, _P, _I, _P] + [_I] * 11 + [_P])

#: the largest cluster the kernel launches (the portable size)
MAX_CLUSTER = 8

#: the pool types the kernel reads (widening the narrow ones to float32)
POOL_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)


def cluster_size(pairs: int, n_sm: int) -> int:
    """CTAs a (sequence, KV head) pair is split over: the largest power of
    two up to :data:`MAX_CLUSTER` whose ``pairs * C`` CTAs still fit one
    wave of one CTA per SM, at least 1.  qwen3-moe-30b-a3b's 32 pairs on
    132 SMs get 4; stablelm-3b's 256 pairs get 1."""
    c = 1
    while 2 * c <= MAX_CLUSTER and pairs * 2 * c <= n_sm:
        c *= 2
    return c


def launch_args(q, k_pages, v_pages, table, lens, base, mask, page_map,
                out, cluster: int, window: int = 0):
    """The C entry point's arguments, in order, but for the stream: the
    fence (``base``/``mask`` from :func:`fence_operand`) by value, or as
    per-row pointers; the window (0: none) by value."""
    B, H, D = q.shape
    P, page, KH = k_pages.shape[:3]
    (base_rows, base_val), (mask_rows, mask_val) = fence_args(base), \
        fence_args(mask)
    return [ptr(q), ptr(k_pages), ptr(v_pages), ptr(table), ptr(lens),
            base_rows, mask_rows, base_val, mask_val,
            ctypes.c_void_p(None) if page_map is None else ptr(page_map),
            0 if page_map is None else page_map.shape[0], ptr(out), B, H,
            KH, D, page, table.shape[1], P, max(int(window), 0), cluster,
            dtype_code(q.dtype), dtype_code(k_pages.dtype)]


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=(),
                         device_types="cpu")
def paged_attention_op(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       seq_lens: torch.Tensor,
                       base_rows: Optional[torch.Tensor],
                       mask_rows: Optional[torch.Tensor], base: int,
                       mask: int, page_map: Optional[torch.Tensor],
                       window: int) -> torch.Tensor:
    """The plain version, for CPU tensors."""
    KERNEL.plain_calls += 1
    B = q.shape[0]
    base_r, mask_r = (
        t if t is not None else torch.full((B,), v, dtype=torch.int32)
        for t, v in ((base_rows, base), (mask_rows, mask)))
    return ref.paged_attention_ref(q, k_pages, v_pages, page_table,
                                   seq_lens, base_r, mask_r, page_map,
                                   window=window)


@paged_attention_op.register_kernel("cuda")
def _cuda(q, k_pages, v_pages, page_table, seq_lens, base_rows, mask_rows,
      base, mask, page_map, window):
    B, H, D = q.shape
    KH = k_pages.shape[2]
    if k_pages.dtype not in POOL_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError("paged_attention: the kernel reads a float32, a "
                        "bfloat16 or a float8_e4m3fn pool, got "
                        f"{k_pages.dtype} / {v_pages.dtype}")
    vec = 16 // k_pages.element_size()     # elements per 16-byte load
    if H % KH or D % vec or D > 128 or (H // KH) * D > 2048:
        raise ValueError(f"paged_attention: the kernel takes D % {vec} == 0 "
                         f"({k_pages.dtype} pool), D <= 128 and (H/KH)*D <= "
                         f"2048, got H={H}, KH={KH}, D={D}")
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    pmap = page_map.to(torch.int32) if page_map is not None else None
    per_row = [t for t in (base_rows, mask_rows) if t is not None]
    check_cuda("paged_attention", q, k_pages, v_pages, table, lens,
               *per_row, *(() if pmap is None else (pmap,)))
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: the pools must be 16-byte "
                         "aligned (16-byte loads)")
    out = torch.empty_like(q)
    cluster = cluster_size(B * KH, sm_count(q.device))
    KERNEL.launch(*launch_args(q, k_pages, v_pages, table, lens,
                               join_fence(base_rows, base),
                               join_fence(mask_rows, mask), pmap, out,
                               cluster, window), stream_of(q))
    return out


@paged_attention_op.register_fake
def _fake(q, k_pages, v_pages, page_table, seq_lens, base_rows, mask_rows,
      base, mask, page_map, window):
    return torch.empty_like(q)


@sharding_rule(torch.ops.repro_torch.paged_attention.default)
def _sharding(q, k_pages, v_pages, page_table, seq_lens, base_rows,
              mask_rows, base, mask, page_map, window):
    """Replicated; rows over a mesh dimension (q, the table, lengths and
    per-row fences split by row, the pool view whole: pages are global
    ids, so a pool split by slot is all-gathered first, as the
    reference's partitioned slot gather replicates its pool slice); or
    heads (q's heads and the pool's KV heads split alike, the rows whole;
    :func:`~repro_torch.kernels._build.heads_pair`)."""
    fences = lambda n: (opt(base_rows, n), opt(mask_rows, n))  # noqa: E731
    pmap = opt(page_map, "R")
    out = [(placements("R"), placements(
        "R", "R", "R", "R", "R", *fences("R"), None, None, pmap, None)),
        (placements("S0"), placements(
            "S0", "R", "R", "S0", "S0", *fences("S0"), None, None, pmap,
            None))]
    if heads_pair(q, q.shape[1], k_pages.shape[2]):
        out.append((placements("S1"), placements(
            "S1", "S2", "S2", "R", "R", *fences("R"), None, None, pmap,
            None)))
    return out


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, fence_base,
                    fence_mask, page_map=None, window: int = 0):
    """q (B,H,D) float32 or bfloat16; pools (P,page,KH,D) (a layer view of
    the global pool or the slab's flattened layer view), float32,
    bfloat16 or float8_e4m3fn (widened to float32 as they are read);
    page_table (B, max_pages) virtual or physical ids; seq_lens (B,);
    base/mask ints or (B,) tensors; optional page_map (n_virt,).  Returns
    (B,H,D) in q's dtype.

    An int fence reaches the kernel by value; a tensor fence is one int32
    operand per row.  ``window`` > 0 narrows row b to its last ``window``
    held tokens (positions t >= seq_lens[b] - window), the reference's
    windowed ``decode_attention``.  On the card the kernel takes D a
    multiple of 4 (of 8 over a bfloat16 pool, of 16 over a float8 one) up
    to 128 and (H / KH) * D up to 2,048."""
    B = q.shape[0]
    P = k_pages.shape[0]
    if P & (P - 1):
        raise ValueError(f"paged_attention needs a pow2 pool, got P={P}")
    check_device("paged_attention", q)
    (base_rows, base), (mask_rows, mask) = (
        split_fence(fence_operand(v, B, q.device))
        for v in (fence_base, fence_mask))
    from repro_torch.distributed.partition import heads_like, \
        heads_split, is_dtensor
    if is_dtensor(q):
        # a partitioned trace: each rank runs its share of the heads
        q, H = heads_split(q, 1)
        k_pages, v_pages = (heads_like(q, t, 1, 2, H, whole=True)
                            for t in (k_pages, v_pages))
        out = paged_attention_op(q, k_pages, v_pages, page_table, seq_lens,
                                 base_rows, mask_rows, base, mask, page_map,
                                 int(window))
        return out if out.shape[1] == H else out[:, :H]
    return paged_attention_op(q, k_pages, v_pages, page_table, seq_lens,
                              base_rows, mask_rows, base, mask, page_map,
                              int(window))

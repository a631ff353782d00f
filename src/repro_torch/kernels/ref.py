"""Plain PyTorch versions of every kernel of the port (the ``ref.py``
contract, mirroring ``repro/kernels/ref.py``).

Each function computes its kernel's exact semantics — fence included —
with ordinary tensor operations.  The wrappers take these for tensors on
the CPU (the test suite); on the card they are the yardstick each CUDA
kernel is held against.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def fence_ref(idx: torch.Tensor, base, mask) -> torch.Tensor:
    """``(idx & mask) | base`` in int32."""
    return torch.bitwise_or(torch.bitwise_and(idx.to(torch.int32), mask),
                            base)


def resolve_pages(ids: torch.Tensor, base, mask,
                  page_map: Optional[torch.Tensor],
                  n_pool_pages: int) -> torch.Tensor:
    """Fenced virtual ids -> physical pool pages: fence, translate through
    ``page_map`` (a virtual id outside the map resolves to the garbage page
    0, as the reference's fill-mode take gives INT_MIN & (P-1) = 0), clamp
    into the power-of-two pool."""
    phys = fence_ref(ids, base, mask)
    if page_map is not None:
        n_map = page_map.shape[0]
        ok = (phys >= 0) & (phys < n_map)
        mapped = page_map.to(torch.int32)[phys.clamp(0, n_map - 1).long()]
        phys = torch.where(ok, mapped, torch.zeros_like(mapped))
    return torch.bitwise_and(phys, n_pool_pages - 1)


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                        fence_base, fence_mask, page_map=None):
    """q (B,H,D); pools (P,page,KH,D) -> (B,H,D).  float32 math over K/V
    rounded to the query's dtype."""
    B, H, D = q.shape
    P, page, KH, _ = k_pages.shape
    G = H // KH
    phys = resolve_pages(page_table, fence_base[:, None],
                         fence_mask[:, None], page_map, P).long()
    S = phys.shape[1] * page
    k = k_pages[phys].reshape(B, S, KH, D).to(q.dtype).float()
    v = v_pages[phys].reshape(B, S, KH, D).to(q.dtype).float()
    qg = q.float().reshape(B, KH, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < seq_lens.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, H, D).to(q.dtype)


def scatter_pages_ref(k_pool, v_pool, k_src, v_src, page_ids,
                      fence_base, fence_mask, page_map=None):
    """Write a prefill's K/V (B,S,KH,D) as whole pages into the pools
    (P,page,KH,D) at the fenced, translated, clamped ids ``page_ids``
    (B, ceil(S/page)); tokens past S write zeros; duplicate destinations
    resolve last-writer-wins.  In place; returns the pools."""
    B, S, KH, D = k_src.shape
    P, page = k_pool.shape[:2]
    n = page_ids.shape[1]
    pad = n * page - S

    def per_row(v):   # (B,) per-row operands broadcast over the pages
        return v[:, None] if isinstance(v, torch.Tensor) and v.dim() == 1 \
            else v

    phys = resolve_pages(page_ids, per_row(fence_base), per_row(fence_mask),
                         page_map, P).reshape(-1)
    # every id writes its destination's last writer's page, so duplicates
    # store identical bytes (no data-dependent shape: the verifier traces
    # this function)
    order = torch.arange(phys.numel(), device=phys.device)
    last = torch.where(phys[None, :] == phys[:, None], order[None, :],
                       torch.full_like(order, -1)[None, :]).amax(dim=1)
    for pool, src in ((k_pool, k_src), (v_pool, v_src)):
        pages = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, pad))
        pages = pages.reshape(B * n, page, KH, D).to(pool.dtype)
        pool[phys.long()] = pages[last]
    return k_pool, v_pool


def gather_rows_ref(table, idx, fence_base, fence_mask):
    """Fenced row gather: table (V, D), idx (N,) -> (N, D).  Negative
    fenced ids in [-V, 0) wrap once; ids outside [-V, V) give NaN rows
    (jnp.take's fill mode) — never an out-of-table read."""
    V = table.shape[0]
    row = fence_ref(idx, fence_base, fence_mask)
    row = torch.where(row < 0, row + V, row)
    ok = (row >= 0) & (row < V)
    out = table[row.clamp(0, V - 1).long()]
    return torch.where(ok[:, None], out,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))


def moe_histogram_ref(expert_ids, num_experts, fence_base, fence_mask):
    """Fenced expert histogram: ids (T, K) -> int32 counts (num_experts,)
    of ``(id & mask) | base``; fenced ids outside ``[0, num_experts)`` are
    dropped, as the TPU kernel's one-hot against ``iota(E)`` drops them.
    (``repro/kernels/ref.py``'s scatter-add wraps ids in ``[-E, 0)``
    NumPy-style instead; no fence the serve path builds yields one.)"""
    fenced = fence_ref(expert_ids, fence_base, fence_mask).reshape(-1, 1)
    experts = torch.arange(num_experts, dtype=torch.int32,
                           device=fenced.device)
    return (fenced == experts).sum(dim=0, dtype=torch.int32)


def flash_attention_ref(q, k, v):
    """Causal attention: q (B,S,H,D), k/v (B,S,KH,D) -> (B,S,H,D), float32
    math."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.float().reshape(B, S, KH, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    causal = pos[None, :] <= pos[:, None]
    s = torch.where(causal[None, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)

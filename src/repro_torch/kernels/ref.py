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

#: the float8 pool type, its largest finite value's rounding boundary
#: (values up to 464 round to 448, past it jnp's cast gives NaN) and its
#: NaN byte
FP8 = torch.float8_e4m3fn
FP8_LIMIT = 464.0
FP8_NAN = 0x7F


def to_pool(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` cast to a pool's ``dtype`` as jnp's ``astype`` casts: to
    float8 e4m3 by round to nearest even, NaN (sign kept) past its range,
    where torch's cast saturates to +-448."""
    if dtype != FP8 or x.dtype == FP8:
        return x.to(dtype)
    y = x.to(FP8).view(torch.uint8)
    nan = torch.where(torch.signbit(x), FP8_NAN | 0x80, FP8_NAN).to(
        torch.uint8)
    return torch.where(x.abs() <= FP8_LIMIT, y, nan).view(FP8)


def pool_bytes(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor's bytes as ``uint8`` (the same storage), any other
    tensor as it is: float8 values move through byte views (torch lacks
    float8 ``gather`` / ``index_copy_`` kernels on some devices)."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


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


def take_pages(pool: torch.Tensor, phys: torch.Tensor) -> torch.Tensor:
    """``pool[phys]``; a float8 pool's pages are gathered as bytes."""
    return pool_bytes(pool)[phys].view(pool.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                        fence_base, fence_mask, page_map=None, window=0):
    """q (B,H,D); pools (P,page,KH,D) -> (B,H,D).  float32 math over K/V
    rounded to the query's dtype (a bfloat16 or float8 pool is widened,
    exactly).  Row b attends to positions t <
    seq_lens[b] and, when ``window`` > 0, t >= seq_lens[b] - window (the
    reference's ``decode_attention`` mask); a row with no such position
    is the uniform mean over every position of its table."""
    B, H, D = q.shape
    P, page, KH, _ = k_pages.shape
    G = H // KH
    phys = resolve_pages(page_table, fence_base[:, None],
                         fence_mask[:, None], page_map, P).long()
    S = phys.shape[1] * page
    k = take_pages(k_pages, phys).reshape(B, S, KH, D).to(q.dtype).float()
    v = take_pages(v_pages, phys).reshape(B, S, KH, D).to(q.dtype).float()
    qg = q.float().reshape(B, KH, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * (1.0 / math.sqrt(D))
    pos = torch.arange(S, device=q.device)
    lens = seq_lens.to(q.device)[:, None]
    valid = pos[None, :] < lens
    if window > 0:
        valid = valid & (pos[None, :] >= lens - window)
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
    resolve last-writer-wins; the pages are cast to the pool's type as jnp
    casts (:func:`to_pool`).  In place; returns the pools."""
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
        pages = torch.nn.functional.pad(pool_bytes(to_pool(src, pool.dtype)),
                                        (0, 0, 0, 0, 0, pad))
        pool_bytes(pool)[phys.long()] = pages.reshape(B * n, page, KH,
                                                      D)[last]
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


def gather_rows_grad_ref(table, grad, idx, fence_base, fence_mask):
    """The gradient of ``table`` through :func:`gather_rows_ref` — K3's
    backward: each row of ``grad`` (N, D) added into the (V, D) result at
    its id's fenced row, the address the gather loaded (a negative fenced
    id in [-V, 0) wrapped once).  An id whose gather formed no address (a
    NaN row) is dropped onto a spare row past the table, as jnp's
    fill-mode ``take`` drops its gradient.  Sums in float32 through
    ``index_put_(accumulate=True)``, which adds a destination's rows in
    the order of the ids on the card as on the CPU (a deterministic sum,
    unlike float atomics), then casts to ``table``'s dtype."""
    V, D = table.shape
    row = fence_ref(idx, fence_base, fence_mask)
    row = torch.where(row < 0, row + V, row)
    ok = (row >= 0) & (row < V)
    dest = torch.where(ok, row, torch.full_like(row, V)).long()
    acc = torch.zeros((V + 1, D), dtype=torch.float32, device=grad.device)
    acc.index_put_((dest,), grad.float(), accumulate=True)
    return acc[:V].to(table.dtype)


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


def _attention_probs(q, k, causal, window):
    """float32 softmax of the masked, scaled scores, (B, KH, G, Sq, Skv),
    and the query in float32 as (B, Sq, KH, G, D)."""
    B, S, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, KH, H // KH, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    band = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        band = band & (kpos[None, :] <= pos[:, None])
    if window > 0:
        band = band & (kpos[None, :] > pos[:, None] - window)
    s = torch.where(band[None, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    return torch.softmax(s, dim=-1), qg


def flash_attention_ref(q, k, v, causal=True, window=0):
    """Attention: q (B,Sq,H,D), k/v (B,Skv,KH,D) -> (B,Sq,H,D), float32
    math.  Query row i attends to keys j <= i when ``causal`` and j > i -
    window when ``window`` > 0 (``repro/models/layers.py``'s
    ``chunked_attention`` masks); Skv may differ from Sq when not causal
    (cross-attention)."""
    p, _ = _attention_probs(q, k, causal, window)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(q.shape).to(q.dtype)


def flash_attention_grad_ref(q, k, v, grad, causal=True, window=0):
    """The gradient of :func:`flash_attention_ref` — K4's backward, by
    recomputation from q, k, v: P = softmax of the masked, scaled scores in
    float32, then dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dP * P)),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), each KV head summing its
    query group.  Returns (dq, dk, dv) in the operands' dtypes."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    p, qg = _attention_probs(q, k, causal, window)
    do = grad.float().reshape(B, S, KH, H // KH, D)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))

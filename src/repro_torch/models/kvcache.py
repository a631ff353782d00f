"""KV cache for serving — the global paged pool with Guardian fencing.

The pool is ``(L, P_total, page, KH, D)``: one flat page pool shared by
every tenant, with per-request page lists in *virtual* page ids.  Virtual
ids are fenced into the owning tenant's extent (space "kv", per-row
params on the serve path), translated virt->phys through the
manager-owned ``GuardSpec.page_map`` and clamped into the pool (space
"page") — see :func:`repro_torch.models.guard.fence_pages`.  Elastic
compaction rewrites the map instead of moving KV bytes.

Pool writes happen in place (the reference threads a new pool value
through each step): the functions below update ``cache.k`` / ``cache.v``
and return a cache over the same tensors.  The prefill page write runs the
fenced-scatter kernel (K2) and decode attention the paged-attention kernel
(K1), which reads the layer view ``k[l]`` in place; the slab layout of the
reference waits for a later port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import paged_attention, scatter_pages
from repro_torch.models.guard import GuardSpec, fence, fence_pages, \
    kernel_fence

PAGE_SIZE = 64

_INT32_MIN = -(1 << 31)


@dataclasses.dataclass
class PagedKVCache:
    """Global paged KV pool: k/v ``(L, P_total, page, KH, D)``;
    page_table holds *virtual* page ids (slot_ids are unused and kept for
    layout compatibility with the reference)."""

    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    page_table: torch.Tensor     # (B, P) int32 virtual page ids
    slot_ids: torch.Tensor       # (B,) int32
    seq_lens: torch.Tensor       # (B,) int32: tokens currently cached

    @property
    def global_paged(self) -> bool:
        return self.k is not None and self.k.dim() == 5

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def init_global_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                         total_pages: int, *, page_size: int = PAGE_SIZE,
                         dtype=torch.float32,
                         n_layers: Optional[int] = None,
                         device="cuda") -> PagedKVCache:
    """One ``(L, total_pages, page, KH, D)`` pool shared by every tenant;
    each batch row carries ``max_len // page_size`` virtual page ids."""
    L = n_layers if n_layers is not None else cfg.decoder_layers
    pages_per_req = max(max_len // page_size, 1)
    shape = (L, total_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        page_table=torch.zeros((batch, pages_per_req), **i32),
        slot_ids=torch.zeros((batch,), **i32),
        seq_lens=torch.zeros((batch,), **i32),
    )


def _require_global(cache: PagedKVCache) -> None:
    if not cache.global_paged:
        raise NotImplementedError(
            "the slab KV layout is not ported yet; serve with paged=True")


def _fenced_phys_pages(table: torch.Tensor,
                       guard: Optional[GuardSpec]) -> torch.Tensor:
    """Virtual page ids -> fenced physical page ids (kv fence, page_map,
    page clamp)."""
    return fence_pages(guard, fence(guard, "kv", table))


def gather_layer_kv(cache: PagedKVCache, layer: int,
                    guard: Optional[GuardSpec] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full paged KV history of every request at one layer: (B, S_max, KH,
    D) each.  The decode path reads the pool through K1 instead; this
    gather serves windowed attention on the CPU."""
    _require_global(cache)
    phys = _fenced_phys_pages(cache.page_table, guard).long()
    k_p, v_p = cache.k[layer][phys], cache.v[layer][phys]
    B, P, page, KH, D = k_p.shape
    return k_p.reshape(B, P * page, KH, D), v_p.reshape(B, P * page, KH, D)


def append_token_kv(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                    v_new: torch.Tensor,
                    guard: Optional[GuardSpec] = None) -> PagedKVCache:
    """Write one new token's K,V per request at ``layer`` (decode step), in
    place.  k_new/v_new: (B, 1, KH, D).  The page is fenced, translated
    and clamped; the in-page offset comes from the host-owned seq_lens."""
    _require_global(cache)
    page = cache.page_size
    pos = cache.seq_lens.long()
    logical = pos // page
    n_tab = cache.page_table.shape[1]
    virt = cache.page_table.gather(1, logical.clamp(max=n_tab - 1)[:, None])
    virt = torch.where(logical[:, None] < n_tab, virt,
                       torch.full_like(virt, _INT32_MIN))[:, 0]
    phys = _fenced_phys_pages(virt, guard).long()
    off = pos % page
    cache.k[layer, phys, off] = k_new[:, 0].to(cache.k.dtype)
    cache.v[layer, phys, off] = v_new[:, 0].to(cache.v.dtype)
    return cache


def write_prefill_kv(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor,
                     guard: Optional[GuardSpec] = None) -> PagedKVCache:
    """Write a full prefill's K,V (B, S, KH, D) as whole pages at
    ``layer``, through the fenced-scatter kernel (K2), in place.  The
    ragged last page is zero-filled (the reference pads S to a page
    multiple); the kernel fences each row's virtual page ids with that
    row's extent on the store address."""
    _require_global(cache)
    S = k_new.shape[1]
    n_pages = -(-S // cache.page_size)
    ids, base, mask, page_map = kernel_fence(
        guard, cache.page_table[:, :n_pages])
    scatter_pages(cache.k[layer], cache.v[layer],
                  k_new.to(cache.k.dtype).contiguous(),
                  v_new.to(cache.v.dtype).contiguous(),
                  ids, base, mask, page_map)
    return cache


def paged_decode_attention(cache: PagedKVCache, layer: int,
                           q: torch.Tensor, kv_len: torch.Tensor,
                           guard: Optional[GuardSpec] = None
                           ) -> torch.Tensor:
    """Decode attention straight off the pool's layer view through the
    paged-attention kernel (K1): q (B,1,H,D) over each row's first
    ``kv_len`` cached tokens -> (B,1,H,D)."""
    _require_global(cache)
    ids, base, mask, page_map = kernel_fence(guard, cache.page_table)
    o = paged_attention(q[:, 0].contiguous(), cache.k[layer],
                        cache.v[layer], ids, kv_len, base, mask, page_map)
    return o[:, None]


def advance(cache: PagedKVCache, n: int = 1) -> PagedKVCache:
    return dataclasses.replace(cache, seq_lens=cache.seq_lens + n)

"""KV caches for serving — the slab pool and the global paged pool, with
Guardian fencing.

Two layouts, told apart by rank:

1. **Slab** (6-dim): k/v ``(L, slots, P, page, KH, D)``.  A *slot* is a
   pow2-partitionable sequence slot (tenants own contiguous pow2 slot
   ranges), and pages within a slot's slab are indirected through a
   per-row page table.  Two data-dependent index spaces, two fences:
   slot ids in space "kv" (the row's tenant extent), page ids in space
   "page" (the slab, ``[0, P)``).  Decode attention runs the
   paged-attention kernel (K1) over the layer view flattened to
   ``(slots * P, page, KH, D)``: row b's page ids are ``fenced_slot * P +
   fenced_page``, fenced here in torch, and K1 gets the identity fence
   (its ``& (slots * P - 1)`` clamp keeps every id inside the view).  The
   prefill write has the reference's two formulations, ``permute`` (the
   serve default) and ``scatter``, both plain PyTorch.
2. **Global paged** (5-dim): k/v ``(L, P_total, page, KH, D)``: one flat
   page pool shared by every tenant, with per-request page lists in
   *virtual* page ids.  Virtual ids are fenced into the owning tenant's
   extent (space "kv", per-row params on the serve path), translated
   virt->phys through the manager-owned ``GuardSpec.page_map`` and
   clamped into the pool (space "page") — see
   :func:`repro_torch.models.guard.fence_pages`.  Elastic compaction
   rewrites the map instead of moving KV bytes.  The prefill page write
   runs the fenced-scatter kernel (K2) and decode attention K1, which
   reads the layer view ``k[l]`` in place.

Pool writes happen in place (the reference threads a new pool value
through each step): the functions below update ``cache.k`` / ``cache.v``
and return a cache over the same tensors.  Where several rows write one
slab address (parked rows share the engine's scratch slot; a forged slot
id may alias a co-row's), the last row writes, as the reference's
sequential scatter does; every row is redirected to the last writer's
value, so the stores are deterministic on the card too.  The ``permute``
write's one-hot contraction instead *sums* the slabs of rows sharing a
slot, exactly as the reference's does.

A pool may be ``float8_e4m3fn`` (the reference's ``kv_dtype="f8"``): values
are cast to it as jnp's ``astype`` casts (``kernels/ref.py``'s
``to_pool``), its bytes move as ``uint8`` (``pool_bytes``: torch lacks
float8 ``gather`` / ``index_copy_`` kernels), the ``permute`` write sums in
float32 and rounds as XLA's float8 dot does, and K1 widens it to float32
as it loads.

Recurrent state (the hybrid's Mamba2 blocks, xLSTM) lives in the same slot
discipline: :class:`StateCache`, ``(L, slots, *state)`` pools with fenced
slot ids (space "state").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import einsum, is_dtensor, \
    rank_block, split_over
from repro_torch.kernels import paged_attention, scatter_pages
from repro_torch.kernels.ref import FP8, FP8_NAN, pool_bytes, to_pool
from repro_torch.models.guard import GuardSpec, fence, fence_pages, \
    kernel_fence

PAGE_SIZE = 64

_INT32_MIN = -(1 << 31)

def zeros(shape, dtype, device) -> torch.Tensor:
    """A zeroed pool (a float8 one zeroed as bytes: +0 is byte 0)."""
    if dtype == FP8:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(FP8)
    return torch.zeros(shape, dtype=dtype, device=device)


def store(view: torch.Tensor, idx, value: torch.Tensor) -> None:
    """``view[idx] = value`` cast to the view's dtype (``to_pool``), in
    place.  ``idx`` is a tuple of (N,) index tensors (or one) into the
    leading dims of ``view``, ``value`` (N, *rest); on a partitioned trace
    a view split by slot stores by :func:`_store_split`."""
    if is_dtensor(view):
        return _store_split(view, idx if isinstance(idx, tuple) else (idx,),
                            value)
    pool_bytes(view)[idx] = pool_bytes(to_pool(value, view.dtype))


def _store_split(view, idx: tuple, value) -> None:
    """:func:`store` into a DTensor view, the masked local store the
    reference's partitioner makes of a scatter into an operand split along
    the scattered dim: the ids and values gathered over the mesh dims that
    split the view's leading (slot) dim, so every rank sees every row's
    store; each rank shifts the slot ids to its own block and keeps the
    rows that land there.  A row landing elsewhere stores what its address
    holds, or the value of the last kept row storing there (so the kept
    stores win whatever order the device applies them in).  The value's
    trailing dims take the view's placements (a KV head split over the
    model axis stays split)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, n = view.device_mesh, len(idx)
    split = split_over(view, 0)
    rep = [Replicate()] * mesh.ndim
    val_pl = [Shard(pl.dim - n + 1) if isinstance(pl, Shard) and pl.dim >= n
              else Replicate() for pl in view.placements]
    ids = [i.redistribute(mesh, rep).to_local() if is_dtensor(i) else i
           for i in idx]
    value = value.redistribute(mesh, val_pl).to_local() \
        if is_dtensor(value) else value
    local = view.to_local()
    rows = local.shape[0]
    slot = ids[0].long() - rank_block(mesh, split) * rows
    kept = (slot >= 0) & (slot < rows)
    lidx = (slot.clamp(0, rows - 1), *(i.long() for i in ids[1:]))
    key = lidx[0]
    for i, size in zip(lidx[1:], local.shape[1:n]):
        key = key * size + i
    order = torch.arange(key.numel(), device=key.device)
    writer = torch.where((key[None, :] == key[:, None]) & kept[None, :],
                         order[None, :], torch.full_like(order, -1)[None, :]
                         ).amax(dim=1)
    new = pool_bytes(to_pool(value, view.dtype))[writer.clamp(min=0)]
    held = pool_bytes(local)[lidx]
    take = (writer >= 0).reshape(-1, *(1,) * (new.dim() - 1))
    pool_bytes(local)[lidx] = torch.where(take, new, held)


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV pool, in either layout (see the module docstring):

    * slab (6-dim): k/v ``(L, slots, P, page, KH, D)`` — page_table holds
      slab-relative logical->physical page ids, slot_ids pick the slab;
    * global (5-dim): k/v ``(L, P_total, page, KH, D)`` — page_table holds
      *virtual* page ids into the shared pool (slot_ids are unused and
      kept for layout compatibility with the reference).

    ``k`` / ``v`` are ``None`` in a serve engine's meta half
    (:func:`repro_torch.launch.steps.split_cache_pool`)."""

    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    page_table: torch.Tensor     # (B, P) int32
    slot_ids: torch.Tensor       # (B,) int32: request -> pool slot
    seq_lens: torch.Tensor       # (B,) int32: tokens currently cached

    @property
    def global_paged(self) -> bool:
        return self.k is not None and self.k.dim() == 5

    @property
    def pages_per_slot(self) -> int:
        return self.k.shape[1] if self.global_paged else self.k.shape[2]

    @property
    def page_size(self) -> int:
        return self.k.shape[2] if self.global_paged else self.k.shape[3]

    @property
    def max_len(self) -> int:
        return self.page_table.shape[1] * self.page_size


def kv_cache_spec(cfg: ModelConfig, batch: int, max_len: int, *,
                  slots: Optional[int] = None, page_size: int = PAGE_SIZE,
                  dtype=torch.bfloat16, n_layers: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """Shapes and dtypes of the slab cache, as tensors on the ``meta``
    device (nothing allocated): k/v ``(L, slots, P, page, KH, D)`` with
    ``slots`` defaulting to ``pow2(batch)``, page_table ``(batch, P)``,
    slot_ids and seq_lens ``(batch,)``."""
    L = n_layers if n_layers is not None else cfg.decoder_layers
    slots = slots or _pow2_at_least(batch)
    pages = max(max_len // page_size, 1)
    kv_shape = (L, slots, pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    meta = dict(device="meta")
    return {
        "k": torch.empty(kv_shape, dtype=dtype, **meta),
        "v": torch.empty(kv_shape, dtype=dtype, **meta),
        "page_table": torch.empty((batch, pages), dtype=torch.int32, **meta),
        "slot_ids": torch.empty((batch,), dtype=torch.int32, **meta),
        "seq_lens": torch.empty((batch,), dtype=torch.int32, **meta),
    }


def kv_cache_axes() -> Dict[str, Tuple]:
    """Logical sharding axes of the slab cache, in
    :func:`kv_cache_spec`'s order."""
    kv = (None, "pages", None, None, "kv_heads", None)
    return {"k": kv, "v": kv, "page_table": ("batch", None),
            "slot_ids": ("batch",), "seq_lens": ("batch",)}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  slots: Optional[int] = None, page_size: int = PAGE_SIZE,
                  dtype=torch.bfloat16, n_layers: Optional[int] = None,
                  device="cuda") -> PagedKVCache:
    """The slab cache of :func:`kv_cache_spec`, zeroed, with the identity
    page table (fresh slabs) and ``slot_ids = arange(batch)``."""
    spec = kv_cache_spec(cfg, batch, max_len, slots=slots,
                         page_size=page_size, dtype=dtype,
                         n_layers=n_layers)
    pages = spec["page_table"].shape[1]
    i32 = dict(dtype=torch.int32, device=device)
    return PagedKVCache(
        k=zeros(spec["k"].shape, dtype, device),
        v=zeros(spec["v"].shape, dtype, device),
        page_table=torch.arange(pages, **i32)[None, :].repeat(batch, 1),
        slot_ids=torch.arange(batch, **i32),
        seq_lens=torch.zeros((batch,), **i32),
    )


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
        k=zeros(shape, dtype, device),
        v=zeros(shape, dtype, device),
        page_table=torch.zeros((batch, pages_per_req), **i32),
        slot_ids=torch.zeros((batch,), **i32),
        seq_lens=torch.zeros((batch,), **i32),
    )


# ---------------------------------------------------------------------------
# Index helpers
# ---------------------------------------------------------------------------

def _fenced_phys_pages(table: torch.Tensor,
                       guard: Optional[GuardSpec]) -> torch.Tensor:
    """Global layout: virtual page ids -> fenced physical page ids (kv
    fence, page_map, page clamp)."""
    return fence_pages(guard, fence(guard, "kv", table))


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A negative id wraps once, as NumPy-style indexing does."""
    return torch.where(idx < 0, idx + n, idx)


def _in_range(idx: torch.Tensor, n: int) -> torch.Tensor:
    """An index a store may form: wrapped once, then clamped into ``[0,
    n)``.  The reference promises its stores in bounds; a fenced id
    always is, and this keeps an unfenced one (``guard=None``) from
    reaching a torch op out of range."""
    return _wrap(idx, n).clamp(0, n - 1)


def _take_fill(t: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.take`` / ``take_along_axis`` in fill mode along ``dim``: a
    negative id wraps once, an id outside ``[-n, n)`` reads NaN.  ``idx``
    indexes ``t`` along ``dim``; for ``dim > 0`` it carries the leading
    batch axes of ``t`` (take_along_axis).  A float8 ``t`` is read as
    bytes, NaN its NaN byte."""
    if t.dtype == FP8:
        return _take_fill(t.view(torch.uint8), idx, dim).view(FP8)
    n = t.shape[dim]
    idx = _wrap(idx, n)
    ok = (idx >= 0) & (idx < n)
    safe = idx.clamp(0, n - 1).long()
    if dim == 0:
        out = t[safe]
    else:
        shape = tuple(safe.shape) + (1,) * (t.dim() - safe.dim())
        out = torch.gather(t, dim, safe.reshape(shape).expand(
            *safe.shape, *t.shape[dim + 1:]))
    okb = ok.reshape(tuple(ok.shape) + (1,) * (out.dim() - ok.dim()))
    fill = FP8_NAN if t.dtype == torch.uint8 else float("nan")
    return torch.where(okb, out, torch.full((), fill, dtype=t.dtype,
                                            device=t.device))


def _last_writer(keys: torch.Tensor) -> torch.Tensor:
    """For each of the N flattened store addresses ``keys``, the position
    of the last one equal to it: every store then writes its last
    writer's value, so duplicates resolve last-writer-wins in any order
    the device applies them.  (N, N) compares, no data-dependent shape."""
    keys = keys.reshape(-1)
    order = torch.arange(keys.numel(), device=keys.device)
    return torch.where(keys[None, :] == keys[:, None], order[None, :],
                       torch.full_like(order, -1)[None, :]).amax(dim=1)


def _slab_rows(cache: PagedKVCache, guard: Optional[GuardSpec],
               table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab layout: the rows' fenced slot ids (B,) (space "kv") and the
    fenced page ids of ``table`` (space "page")."""
    return fence(guard, "kv", cache.slot_ids), fence(guard, "page", table)


@dataclasses.dataclass(frozen=True)
class SlabDecodePlan:
    """What every layer of one slab decode step shares, computed once a
    step: the append's store address ``(slot, page, offset)`` per row
    (in range, duplicates redirected by ``last``) and K1's page ids into
    the flattened ``(slots * P, page, KH, D)`` layer view."""

    slot: torch.Tensor
    page: torch.Tensor
    offset: torch.Tensor
    last: torch.Tensor
    view_pages: torch.Tensor


def decode_plan(cache: PagedKVCache, guard: Optional[GuardSpec] = None
                ) -> Optional[SlabDecodePlan]:
    """The per-step plan of a slab decode (``None`` for the global
    layout, whose layers fence their own page ids)."""
    if cache.global_paged:
        return None
    S, P, page = cache.k.shape[1], cache.pages_per_slot, cache.page_size
    slots, pages = _slab_rows(cache, guard, cache.page_table)
    pos = cache.seq_lens.to(torch.int32)
    logical = torch.div(pos, page, rounding_mode="floor")
    offset = pos - logical * page
    n_tab = cache.page_table.shape[1]
    phys = cache.page_table.gather(
        1, logical.clamp(0, n_tab - 1).long()[:, None])[:, 0]
    phys = torch.where((logical >= 0) & (logical < n_tab), phys,
                       torch.full_like(phys, _INT32_MIN))
    phys = _in_range(fence(guard, "page", phys), P)
    slot = _in_range(slots, S)
    offset = _in_range(offset, page)
    key = (slot.long() * P + phys) * page + offset
    # K1 reads the slab of the fenced slot; the kernel's own clamp keeps
    # an id inside the view whatever the fences gave
    view_pages = slots[:, None] * P + pages
    return SlabDecodePlan(slot=slot.long(), page=phys.long(),
                          offset=offset.long(), last=_last_writer(key),
                          view_pages=view_pages.to(torch.int32))


# ---------------------------------------------------------------------------
# Fenced read / write paths
# ---------------------------------------------------------------------------

def gather_layer_kv(cache: PagedKVCache, layer: int,
                    guard: Optional[GuardSpec] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full paged KV history of every request at one layer: (B, S_max, KH,
    D) each.  The decode path reads the pool through K1 instead; this
    gather is the reference's formulation, which the tests hold K1's view
    against.  Slab layout: the fenced
    slot's slab, its pages through the fenced page table (a fenced id out
    of the pool reads NaN, as the reference's fill-mode take does)."""
    if cache.global_paged:
        phys = _fenced_phys_pages(cache.page_table, guard).long()
        k_p, v_p = cache.k[layer][phys], cache.v[layer][phys]
    else:
        slots, pages = _slab_rows(cache, guard, cache.page_table)
        k_p, v_p = (_take_fill(_take_fill(pool[layer], slots, 0), pages, 1)
                    for pool in (cache.k, cache.v))
    B, P, page, KH, D = k_p.shape
    return k_p.reshape(B, P * page, KH, D), v_p.reshape(B, P * page, KH, D)


def append_token_kv(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                    v_new: torch.Tensor, guard: Optional[GuardSpec] = None,
                    plan: Optional[SlabDecodePlan] = None) -> PagedKVCache:
    """Write one new token's K,V per request at ``layer`` (decode step), in
    place.  k_new/v_new: (B, 1, KH, D).  Global layout: the page is
    fenced, translated and clamped; the in-page offset comes from the
    host-owned seq_lens.  Slab layout: slot and page fenced, at the
    step's :class:`SlabDecodePlan` (computed here when not given)."""
    if not cache.global_paged:
        plan = plan or decode_plan(cache, guard)
        idx = (plan.slot, plan.page, plan.offset)
        store(cache.k[layer], idx, k_new[:, 0][plan.last])
        store(cache.v[layer], idx, v_new[:, 0][plan.last])
        return cache
    page = cache.page_size
    pos = cache.seq_lens.long()
    logical = pos // page
    n_tab = cache.page_table.shape[1]
    virt = cache.page_table.gather(1, logical.clamp(max=n_tab - 1)[:, None])
    virt = torch.where(logical[:, None] < n_tab, virt,
                       torch.full_like(virt, _INT32_MIN))[:, 0]
    phys = _fenced_phys_pages(virt, guard).long()
    off = pos % page
    store(cache.k[layer], (phys, off), k_new[:, 0])
    store(cache.v[layer], (phys, off), v_new[:, 0])
    return cache


@dataclasses.dataclass(frozen=True)
class SlabPrefillPlan:
    """What every layer of one slab prefill shares (``mode`` "permute":
    the per-slab inverse page permutation ``inv``, its write mask
    ``wrote``, the rows' slot ids and the slot one-hot ``oh`` with the
    owned-slot mask; "scatter": the store address per (row, page) and its
    last writer)."""

    mode: str
    n_pages: int
    slots: torch.Tensor
    inv: Optional[torch.Tensor] = None
    wrote: Optional[torch.Tensor] = None
    oh: Optional[torch.Tensor] = None
    owned: Optional[torch.Tensor] = None
    pages: Optional[torch.Tensor] = None
    last: Optional[torch.Tensor] = None


def prefill_plan(cache: PagedKVCache, S: int,
                 guard: Optional[GuardSpec] = None,
                 mode: str = "permute") -> Optional[SlabPrefillPlan]:
    """The per-prefill plan of a slab write of ``S`` tokens (``None`` for
    the global layout)."""
    if cache.global_paged:
        return None
    if mode not in ("permute", "scatter"):
        raise ValueError(f"unknown slab write mode {mode!r}")
    n_pages = -(-S // cache.page_size)
    slots, pages = _slab_rows(cache, guard, cache.page_table[:, :n_pages])
    B, P_slab, S_slots = slots.shape[0], cache.pages_per_slot, \
        cache.k.shape[1]
    if mode == "scatter":
        slot = _in_range(slots, S_slots).long()[:, None].expand(B, n_pages)
        page = _in_range(pages, P_slab).long()
        return SlabPrefillPlan(
            mode=mode, n_pages=n_pages, slots=slot, pages=page,
            last=_last_writer(slot * P_slab + page))
    # (1) the inverse page permutation and write mask of each row's slab:
    # of equal page ids in a row the last logical page writes; an id
    # outside the slab writes nothing
    pg = _wrap(pages, P_slab)
    logical = torch.arange(n_pages, device=pages.device)
    hit = pg[:, :, None] == torch.arange(P_slab, device=pages.device)
    last = torch.where(hit, logical[None, :, None],
                       torch.full_like(logical, -1)[None, :, None]).amax(1)
    # (3) the slot one-hot (an id outside the pool is a zero row, as
    # jax.nn.one_hot gives) and the slots some row owns
    oh = slots[:, None] == torch.arange(S_slots, device=slots.device)
    return SlabPrefillPlan(
        mode=mode, n_pages=n_pages, slots=slots, inv=last.clamp(min=0),
        wrote=last >= 0, oh=oh, owned=oh.any(dim=0))


def _permute_write(pool: torch.Tensor, layer: int, new_pg: torch.Tensor,
                   plan: SlabPrefillPlan) -> None:
    """The reference's collective-free slab write, at one layer: each
    row's slab materialised through its inverse permutation (old
    contents kept where it wrote nothing), placed into the slot rows by a
    one-hot contraction — rows sharing a slot *sum* — and written over
    the owned slots of the layer.  ``new_pg`` is in the pool's dtype.  A
    float8 pool's slabs move as bytes and are placed in float32, each sum
    rounded through float16 to float8, as XLA computes the reference's
    float8 one-hot dot."""
    B = new_pg.shape[0]
    inv = plan.inv[:, :, None, None, None].expand(
        -1, -1, *new_pg.shape[2:])
    slab_new = torch.gather(pool_bytes(new_pg), 1, inv.long())
    pool_l = pool[layer]
    old = pool_bytes(_take_fill(pool_l, plan.slots, 0))
    slab = torch.where(plan.wrote[:, :, None, None, None], slab_new, old)
    if is_dtensor(slab):
        # a partitioned trace: the one-hot contraction over the rows with
        # the pool's dims kept apart (a KV head split over the model axis
        # stays split; a flattened row would mix split and whole dims)
        dt = torch.float32 if pool.dtype == FP8 else pool.dtype
        placed = einsum("bs,bpokd->spokd", plan.oh.to(dt),
                        (slab.view(FP8) if pool.dtype == FP8
                         else slab).to(dt))
        placed = pool_bytes(to_pool(placed.half(), FP8)) \
            if pool.dtype == FP8 else placed
    elif pool.dtype == FP8:
        placed = plan.oh.float().t() @ slab.view(FP8).float().reshape(B, -1)
        placed = pool_bytes(to_pool(placed.half(), FP8))
    else:
        placed = plan.oh.to(pool.dtype).t() @ slab.reshape(B, -1)
    pool_bytes(pool_l).copy_(torch.where(
        plan.owned[:, None, None, None, None],
        placed.reshape(pool_l.shape), pool_bytes(pool_l)))


def write_prefill_kv(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor,
                     guard: Optional[GuardSpec] = None,
                     mode: str = "permute",
                     plan: Optional[SlabPrefillPlan] = None
                     ) -> PagedKVCache:
    """Write a full prefill's K,V (B, S, KH, D) as whole pages at
    ``layer``, in place; the ragged last page is zero-filled (the
    reference pads S to a page multiple).

    Global layout: through the fenced-scatter kernel (K2), which fences
    each row's virtual page ids with that row's extent on the store
    address, reads the page table's column slice in place and converts
    K,V to the pool's type as it stores, so under a BITWISE guard (or the
    identity fence) the write is one device operation.

    Slab layout, plain PyTorch in either of the reference's formulations
    (``mode``; ``plan`` from :func:`prefill_plan`, computed here when not
    given): ``permute`` (the serve default) places each row's slab by a
    one-hot contraction, so rows sharing a slot sum; ``scatter`` stores
    the pages directly, the last writer winning."""
    if cache.global_paged:
        S = k_new.shape[1]
        n_pages = -(-S // cache.page_size)
        ids, base, mask, page_map = kernel_fence(
            guard, cache.page_table[:, :n_pages])
        scatter_pages(cache.k[layer], cache.v[layer], k_new, v_new, ids,
                      base, mask, page_map)
        return cache
    B, S, KH, D = k_new.shape
    plan = plan or prefill_plan(cache, S, guard, mode)
    page = cache.page_size
    pad = plan.n_pages * page - S
    for pool, new in ((cache.k, k_new), (cache.v, v_new)):
        new_pg = pool_bytes(to_pool(new, pool.dtype))
        if pad:
            new_pg = torch.nn.functional.pad(new_pg, (0, 0, 0, 0, 0, pad))
        new_pg = new_pg.reshape(B, plan.n_pages, page, KH, D)
        if plan.mode == "scatter":
            pool_bytes(pool[layer])[plan.slots, plan.pages] = \
                new_pg.reshape(B * plan.n_pages, page, KH, D)[
                    plan.last].reshape(new_pg.shape)
        else:
            _permute_write(pool, layer, new_pg.view(pool.dtype), plan)
    return cache


def paged_decode_attention(cache: PagedKVCache, layer: int,
                           q: torch.Tensor, kv_len: torch.Tensor,
                           guard: Optional[GuardSpec] = None,
                           plan: Optional[SlabDecodePlan] = None,
                           window: int = 0) -> torch.Tensor:
    """Decode attention straight off the pool's layer view through the
    paged-attention kernel (K1): q (B,1,H,D) over each row's first
    ``kv_len`` cached tokens -> (B,1,H,D), under a sliding ``window`` the
    last ``window`` of them (0: all).  Slab layout: the layer view
    flattened to ``(slots * P, page, KH, D)``, the page ids and their
    fences from the step's :class:`SlabDecodePlan`, the identity fence."""
    if cache.global_paged:
        ids, base, mask, page_map = kernel_fence(guard, cache.page_table)
        k_l, v_l = cache.k[layer], cache.v[layer]
    else:
        plan = plan or decode_plan(cache, guard)
        ids, base, mask, page_map = plan.view_pages, 0, -1, None
        k_l, v_l = (pool[layer].flatten(0, 1) for pool in (cache.k,
                                                           cache.v))
    o = paged_attention(q[:, 0].contiguous(), k_l, v_l, ids, kv_len, base,
                        mask, page_map, window=window)
    return o[:, None]


def advance(cache: PagedKVCache, n: int = 1) -> PagedKVCache:
    return dataclasses.replace(cache, seq_lens=cache.seq_lens + n)


# ---------------------------------------------------------------------------
# SSM / recurrent state pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StateCache:
    """Recurrent state pool: ``pools`` maps state name -> ``(L_kind, slots,
    *state_shape)`` tensors; slot ids are fenced with the row's tenant
    partition (space "state").  ``pools`` is ``{}`` in a serve engine's
    meta half (:func:`repro_torch.launch.steps.split_cache_pool`)."""

    pools: Dict[str, torch.Tensor]
    slot_ids: torch.Tensor       # (B,) int32
    seq_lens: torch.Tensor       # (B,) int32

    def read(self, name: str, layer: int,
             guard: Optional[GuardSpec] = None) -> torch.Tensor:
        """Each row's state at ``layer``: (B, *state_shape).  A fenced id
        out of the pool reads NaN, as the reference's fill-mode take does."""
        slots = fence(guard, "state", self.slot_ids)
        return _take_fill(self.pools[name][layer], slots, 0)

    def write(self, name: str, layer: int, value: torch.Tensor,
              guard: Optional[GuardSpec] = None) -> "StateCache":
        """Store each row's ``value`` (B, *state_shape) at its fenced slot
        of ``layer``, in place; rows sharing a slot resolve last writer
        wins (the reference promises the store in bounds; an unfenced id is
        kept inside the pool)."""
        pool = self.pools[name]
        slot = _in_range(fence(guard, "state", self.slot_ids),
                         pool.shape[1]).long()
        store(pool[layer], slot, value[_last_writer(slot)])
        return self


def with_slot_ids(cache, slot_ids: torch.Tensor):
    """``cache`` with every half's slot ids set to ``slot_ids``: a slab
    :class:`PagedKVCache` or a :class:`StateCache`, or a hybrid cache,
    which carries them in its KV and its state half (an encoder-decoder
    cache in its KV half)."""
    if hasattr(cache, "kv"):
        halves = {"kv": dataclasses.replace(cache.kv, slot_ids=slot_ids)}
        if hasattr(cache, "state"):
            halves["state"] = dataclasses.replace(cache.state,
                                                  slot_ids=slot_ids)
        return dataclasses.replace(cache, **halves)
    return dataclasses.replace(cache, slot_ids=slot_ids)

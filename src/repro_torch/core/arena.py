"""Shared device arenas — the "single GPU address space" of the paper.

The grdManager reserves all device memory at startup (§4.2.1: "a custom
allocator that initially reserves all GPU memory and splits it into
partitions").  Here the reservation is a set of **arena tensors** on the
manager's device, each an ``(num_slots, *slot_shape)`` tensor whose axis 0
is the shared slot space that partitions carve up:

* the **flat arena** (slot_shape=()) models raw device DRAM for the
  client-facing malloc/memcpy/kernel API;
* structured arenas back the serving data paths: KV page pools
  (:class:`PoolArena` + :class:`PagePool`, :func:`make_kv_page_arena`)
  and recurrent state pools (:func:`make_state_arena`).

Arena writes happen in place; the manager is the only holder of the live
buffer, which is what enforces "applications do not have direct access to
the GPU" (§5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.fence import (
    FenceParams,
    FencePolicy,
    guarded_dynamic_slice,
    guarded_dynamic_update_slice,
    guarded_take,
    guarded_update,
)
from repro_torch.core.partition import is_pow2


@dataclasses.dataclass(frozen=True)
class ArenaSpec:
    """Static description of one shared arena tensor."""

    name: str
    num_slots: int                       # pow2 — the partitionable axis
    slot_shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if not is_pow2(self.num_slots):
            raise ValueError(
                f"arena {self.name!r}: num_slots {self.num_slots} not pow2")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_slots, *self.slot_shape)

    def abstract(self) -> torch.Tensor:
        """A stand-in for dry runs: a ``meta`` tensor of the spec's shape
        and dtype (nothing allocated)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    def allocate(self, device) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=device)

    @property
    def slot_bytes(self) -> int:
        n = 1
        for d in self.slot_shape:
            n *= d
        return n * torch.empty((), dtype=self.dtype).element_size()

    @property
    def total_bytes(self) -> int:
        return self.num_slots * max(self.slot_bytes, 1)


class PoolArena:
    """A live *pytree* arena — framework-plane pools (KV page pools, SSM
    state pools) registered with the manager so the manager, not the
    serving engine, holds the only reference to the device buffers.

    Unlike :class:`Arena` there is no flat spec: the buffer is an
    arbitrary pytree whose slot-indexed tensors share the manager's
    global slot space on axis 1.  Trusted kernels declaring
    ``pool_arena=<name>`` have the pool threaded through their compiled
    steps (and through every row of a fused multi-engine step) exactly
    like the flat arena — one live pool, engines only ever see the value
    the manager hands their step.  Steps update the pool tensors in place
    and hand the same tensors back, so ``buf`` keeps naming the live
    buffers.
    """

    def __init__(self, buf: Any):
        self.buf = buf
        #: Optional :class:`PagePool` when the pool is the global paged KV
        #: layout (virtual page extents + manager-owned page_map).
        self.pages: Optional["PagePool"] = None


class PagePool:
    """Virtual->physical page allocator for the global paged KV pool.

    Tenant partitions on the manager's buddy allocator are *virtual* page
    extents; device-side page tables hold virtual ids that are fenced into
    the tenant's extent and then translated through :attr:`page_map` (the
    operand behind ``GuardSpec.page_map``).  Physical pages are handed out
    FIFO from a free list, so elastic compaction / resize is a host-side
    rewrite of the map — zero relocation copy steps on device.

    Invariant: every virtual id inside a bound extent maps to a physical
    page owned by exactly one extent; released physical pages return to
    the free list only after their map entries are retargeted to 0 (page
    0 stays allocator-owned as the scratch/garbage page every unbound
    virtual id resolves to).
    """

    def __init__(self, total_pages: int, virt_pages: int):
        import numpy as np
        if total_pages < 1:
            raise ValueError("PagePool needs at least 1 physical page")
        self.total_pages = total_pages
        self.page_map = np.zeros((virt_pages,), np.int32)
        # phys page 0 is the sink for unbound virtual ids — never handed out
        self._free = list(range(1, total_pages))
        self._extents: Dict[str, Tuple[int, int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.total_pages - 1 - len(self._free)

    def occupancy(self) -> float:
        denom = max(self.total_pages - 1, 1)
        return self.used_pages / denom

    def extent_of(self, tenant: str) -> Optional[Tuple[int, int]]:
        return self._extents.get(tenant)

    def bind_extent(self, tenant: str, base: int, size: int) -> None:
        """Back virtual pages [base, base+size) with physical pages.

        Called when a tenant partition is created or grown; idempotent per
        (tenant, extent) — a grow rebinds only the newly added tail."""
        old = self._extents.get(tenant)
        lo, hi = base, base + size
        if old is not None:
            if old[0] != base:
                raise ValueError(
                    f"bind_extent({tenant}): base moved {old[0]}->{base}; "
                    "use rebase_extent")
            if size < old[1]:
                raise ValueError(
                    f"bind_extent({tenant}): shrink {old[1]}->{size}; "
                    "use shrink_extent")
            lo = base + old[1]                 # extend the tail only
        need = hi - lo
        if need > len(self._free):
            raise MemoryError(
                f"page pool exhausted: need {need}, free {len(self._free)}")
        for v in range(lo, hi):
            self.page_map[v] = self._free.pop(0)
        self._extents[tenant] = (base, size)

    def shrink_extent(self, tenant: str, new_size: int) -> None:
        base, size = self._extents[tenant]
        for v in range(base + new_size, base + size):
            self._free.append(int(self.page_map[v]))
            self.page_map[v] = 0
        self._extents[tenant] = (base, new_size)

    def release_extent(self, tenant: str) -> None:
        base, size = self._extents.pop(tenant, (0, 0))
        for v in range(base, base + size):
            phys = int(self.page_map[v])
            if phys:
                self._free.append(phys)
            self.page_map[v] = 0

    def rebase_extent(self, tenant: str, new_base: int) -> None:
        """Move a tenant's *virtual* extent — the zero-copy compaction
        primitive.  Physical pages keep their bytes; only map rows move."""
        base, size = self._extents[tenant]
        if new_base == base:
            return
        phys = [int(self.page_map[v]) for v in range(base, base + size)]
        for v in range(base, base + size):
            self.page_map[v] = 0
        for i, p in enumerate(phys):
            self.page_map[new_base + i] = p
        self._extents[tenant] = (new_base, size)

    def owner_of_phys(self, phys: int) -> Optional[str]:
        """Debug/audit: which tenant extent maps to a physical page."""
        for t, (base, size) in self._extents.items():
            for v in range(base, base + size):
                if int(self.page_map[v]) == phys:
                    return t
        return None


class Arena:
    """A live arena: spec + current buffer on ``device``.  Dynamic access
    goes through the fenced accessors, so the fence policy is applied
    uniformly; the manager validates every host-initiated range against
    the bounds table before the unfenced ones run.  Writes land in
    place."""

    def __init__(self, spec: ArenaSpec, buf: Optional[torch.Tensor] = None,
                 device="cuda"):
        self.spec = spec
        self.device = torch.device(device)
        self.buf = spec.allocate(self.device) if buf is None else buf

    # -- fenced row access ------------------------------------------------
    def read_rows(self, idx, params: FenceParams,
                  policy: FencePolicy = FencePolicy.BITWISE
                  ) -> torch.Tensor:
        return guarded_take(self.buf, idx, params, policy)

    def write_rows(self, idx, values, params: FenceParams,
                   policy: FencePolicy = FencePolicy.BITWISE) -> None:
        guarded_update(self.buf, idx, values, params, policy)

    def read_range(self, start, length: int, params: FenceParams,
                   policy: FencePolicy = FencePolicy.BITWISE
                   ) -> torch.Tensor:
        return guarded_dynamic_slice(self.buf, start, length, params, policy)

    def write_range(self, start, values, params: FenceParams,
                    policy: FencePolicy = FencePolicy.BITWISE) -> None:
        guarded_dynamic_update_slice(
            self.buf, start, torch.as_tensor(values, device=self.buf.device),
            params, policy)

    # -- unfenced (manager-internal, pre-validated) -----------------------
    def unsafe_read_range(self, start: int, length: int) -> torch.Tensor:
        return self.buf[start:start + length].clone()

    def unsafe_write_range(self, start: int, values) -> None:
        values = torch.as_tensor(values, dtype=self.buf.dtype)
        self.buf[start:start + values.shape[0]] = values.to(self.device)

    def zero_range(self, start: int, length: int) -> None:
        """Scrub a partition on tenant teardown (no cross-tenant leaks)."""
        self.buf[start:start + length] = 0

    @property
    def nbytes(self) -> int:
        return self.spec.total_bytes


def make_kv_page_arena(num_pages: int, page_size: int, num_kv_heads: int,
                       head_dim: int, dtype=torch.bfloat16,
                       name: str = "kv_pages") -> ArenaSpec:
    """Paged-KV pool: slot = one page of K and V (stacked on a leading 2)."""
    return ArenaSpec(name=name, num_slots=num_pages,
                     slot_shape=(2, page_size, num_kv_heads, head_dim),
                     dtype=dtype)


def make_state_arena(num_cells: int, state_dim: int, head_dim: int,
                     dtype=torch.float32,
                     name: str = "ssm_state") -> ArenaSpec:
    """SSM / recurrent state pool (zamba2's Mamba2 layers, xLSTM cells)."""
    return ArenaSpec(name=name, num_slots=num_cells,
                     slot_shape=(state_dim, head_dim), dtype=dtype)


def make_flat_arena(num_slots: int, dtype=torch.float32,
                    name: str = "device_dram") -> ArenaSpec:
    """The raw device-DRAM model used by the client malloc/memcpy API."""
    return ArenaSpec(name=name, num_slots=num_slots, slot_shape=(),
                     dtype=dtype)

"""Power-of-two arena partitioning — Guardian §4.2.1.

Guardian reserves all device memory at startup and carves it into *contiguous,
power-of-two sized, size-aligned* partitions, one per tenant.  Contiguity +
pow2 alignment is what makes the bounds metadata two scalars (``base``,
``mask = size - 1``) and the fence two bitwise instructions (§4.4).

On TPU the arena is a *slot space*: slot 0..N-1 of a shared HBM tensor
(KV pages, embedding rows, SSM state cells, MoE buffer rows).  A partition is
a contiguous slot range.  The buddy allocator below maintains the paper's two
invariants:

  I1  size is a power of two,
  I2  base is aligned to size  (``base % size == 0``),

which together guarantee ``(x & mask) | base`` maps *any* integer into
``[base, base + size)`` and is the identity on in-partition values.  These
invariants are property-tested in ``tests/test_partition.py``.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n <= 0:
        raise ValueError(f"size must be positive, got {n}")
    return 1 << (n - 1).bit_length()


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class Partition:
    """One tenant's contiguous slot range.  ``mask == size - 1``."""

    tenant_id: str
    base: int
    size: int

    def __post_init__(self):
        if not is_pow2(self.size):
            raise ValueError(f"partition size {self.size} not a power of two")
        if self.base % self.size != 0:
            raise ValueError(
                f"partition base {self.base} not aligned to size {self.size}"
            )

    @property
    def mask(self) -> int:
        return self.size - 1

    @property
    def end(self) -> int:
        return self.base + self.size

    def contains(self, lo: int, hi: Optional[int] = None) -> bool:
        """Range check used for host-initiated transfers (§4.2.2)."""
        hi = lo + 1 if hi is None else hi
        return self.base <= lo and hi <= self.end

    def bounds_row(self) -> Tuple[int, int, int]:
        """(base, mask, size) — the row passed to kernels as scalar operands.

        The paper stores these in two registers; we pass them as SMEM scalars.
        """
        return (self.base, self.mask, self.size)


class OutOfArenaMemory(Exception):
    pass


class UnknownTenant(KeyError):
    pass


class BuddyAllocator:
    """Classic buddy allocator over ``total`` slots (``total`` pow2).

    Free lists per order; split on alloc, coalesce buddies on free.  All
    blocks it hands out satisfy I1/I2 by construction.
    """

    def __init__(self, total: int):
        if not is_pow2(total):
            raise ValueError(f"arena total {total} must be a power of two")
        self.total = total
        self._max_order = total.bit_length() - 1
        # order -> sorted list of free block bases
        self._free: Dict[int, List[int]] = {o: [] for o in range(self._max_order + 1)}
        self._free[self._max_order] = [0]
        self._allocated: Dict[int, int] = {}  # base -> order

    def _order_for(self, size: int) -> int:
        return next_pow2(size).bit_length() - 1

    def alloc(self, size: int) -> Tuple[int, int]:
        """Returns (base, rounded_size).  Raises OutOfArenaMemory."""
        order = self._order_for(size)
        if order > self._max_order:
            raise OutOfArenaMemory(
                f"request {size} exceeds arena total {self.total}"
            )
        # Find the smallest order >= `order` with a free block.
        o = order
        while o <= self._max_order and not self._free[o]:
            o += 1
        if o > self._max_order:
            raise OutOfArenaMemory(
                f"no free block of {1 << order} slots (arena fragmented/full)"
            )
        base = self._free[o].pop(0)
        # Split down to the requested order.  The split buddy is above every
        # block already free at that order's prefix we could have split from,
        # but not necessarily the list tail — insort keeps the order without
        # the O(n log n) re-sort (hot on tenant churn: every quarantine
        # eviction frees and re-splits partitions).
        while o > order:
            o -= 1
            buddy = base + (1 << o)
            bisect.insort(self._free[o], buddy)
        self._allocated[base] = order
        return base, 1 << order

    def free(self, base: int) -> None:
        if base not in self._allocated:
            raise KeyError(f"free of unallocated base {base}")
        order = self._allocated.pop(base)
        # Coalesce with buddy while possible (binary search per level —
        # the free lists are maintained sorted).
        while order < self._max_order:
            buddy = base ^ (1 << order)
            lst = self._free[order]
            i = bisect.bisect_left(lst, buddy)
            if i < len(lst) and lst[i] == buddy:
                lst.pop(i)
                base = min(base, buddy)
                order += 1
            else:
                break
        bisect.insort(self._free[order], base)

    # -- elastic resizing (core/elastic.py) ------------------------------ #
    def grow_in_place(self, base: int) -> Optional[int]:
        """Double an allocated block in place when its right-hand buddy is
        free: ``[base, base+size)`` becomes ``[base, base+2*size)``.

        Returns the new size, or None when the block cannot grow without
        moving (base not aligned to 2*size — the buddy lies *below* and
        absorbing it would change the base — or the buddy is occupied).
        The caller relocates instead (:mod:`repro_torch.core.elastic`).
        """
        if base not in self._allocated:
            raise KeyError(f"grow of unallocated base {base}")
        order = self._allocated[base]
        if order >= self._max_order:
            return None
        if base % (1 << (order + 1)) != 0:
            return None                      # buddy is below: base would move
        buddy = base + (1 << order)
        lst = self._free[order]
        i = bisect.bisect_left(lst, buddy)
        if i >= len(lst) or lst[i] != buddy:
            return None                      # buddy occupied or split
        lst.pop(i)
        self._allocated[base] = order + 1
        return 1 << (order + 1)

    def shrink_in_place(self, base: int, new_size: int) -> int:
        """Shrink an allocated block to ``new_size`` (pow2, <= current),
        keeping its base and freeing the vacated upper buddies.  Returns
        the new size.  Invariants I1/I2 hold by construction: ``base`` was
        aligned to the old (larger) size, hence to every smaller one."""
        if base not in self._allocated:
            raise KeyError(f"shrink of unallocated base {base}")
        if not is_pow2(new_size):
            raise ValueError(f"shrink target {new_size} not a power of two")
        order = self._allocated[base]
        new_order = new_size.bit_length() - 1
        if new_order > order:
            raise ValueError(
                f"shrink target {new_size} exceeds block size {1 << order}")
        while order > new_order:
            order -= 1
            # free the upper half at each level (coalesce-safe: its buddy
            # — the kept lower half — stays allocated)
            bisect.insort(self._free[order], base + (1 << order))
        self._allocated[base] = new_order
        return new_size

    def free_slots(self) -> int:
        return sum(len(v) << o for o, v in self._free.items())

    def largest_free_block(self) -> int:
        """Size of the largest currently-free block — what the *next*
        allocation can get without anyone moving (the admission
        controller's fragmentation probe)."""
        for o in range(self._max_order, -1, -1):
            if self._free[o]:
                return 1 << o
        return 0

    def peek_alloc(self, size: int) -> Optional[int]:
        """The base :meth:`alloc` *would* return for ``size``, without
        allocating: the lowest free base at the smallest adequate order
        (splitting keeps the popped base).  None when no block fits —
        the compaction planner's read-only placement probe."""
        order = self._order_for(size)
        if order > self._max_order:
            return None
        for o in range(order, self._max_order + 1):
            if self._free[o]:
                return self._free[o][0]
        return None


class PartitionBoundsTable:
    """Guardian's *partition bounds table* (§4.2.1).

    Maps tenant -> Partition and exports the dense (base, mask, size) arrays
    that kernels consume as scalar operands.  Thread-safe: the manager mutates
    it from the control thread while launch paths read it.
    """

    def __init__(self, total_slots: int):
        self.total_slots = total_slots
        self._alloc = BuddyAllocator(total_slots)
        self._parts: Dict[str, Partition] = {}
        self._lock = threading.Lock()

    def create(self, tenant_id: str, requested_slots: int) -> Partition:
        with self._lock:
            if tenant_id in self._parts:
                raise ValueError(f"tenant {tenant_id!r} already has a partition")
            base, size = self._alloc.alloc(requested_slots)
            part = Partition(tenant_id=tenant_id, base=base, size=size)
            self._parts[tenant_id] = part
            return part

    def destroy(self, tenant_id: str) -> None:
        with self._lock:
            part = self._parts.pop(tenant_id, None)
            if part is None:
                raise UnknownTenant(tenant_id)
            self._alloc.free(part.base)

    def lookup(self, tenant_id: str) -> Partition:
        try:
            return self._parts[tenant_id]
        except KeyError:
            raise UnknownTenant(tenant_id) from None

    def tenants(self) -> List[str]:
        return list(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def free_slots(self) -> int:
        return self._alloc.free_slots()

    def largest_free_block(self) -> int:
        return self._alloc.largest_free_block()

    # -- elastic resizing (core/elastic.py) ------------------------------ #
    def grow(self, tenant_id: str) -> Optional[Partition]:
        """Double a tenant's partition in place (buddy absorb).  Returns
        the new Partition, or None when in-place growth is impossible
        (the elastic manager relocates instead)."""
        with self._lock:
            part = self.lookup(tenant_id)
            new_size = self._alloc.grow_in_place(part.base)
            if new_size is None:
                return None
            new = Partition(tenant_id=tenant_id, base=part.base,
                            size=new_size)
            self._parts[tenant_id] = new
            return new

    def shrink(self, tenant_id: str, new_slots: int) -> Partition:
        """Shrink a tenant's partition in place to ``next_pow2(new_slots)``
        slots, keeping its base.  The caller guarantees the tenant's live
        data already fits below the new boundary (repacked first)."""
        with self._lock:
            part = self.lookup(tenant_id)
            size = next_pow2(max(new_slots, 1))
            if size >= part.size:
                return part
            self._alloc.shrink_in_place(part.base, size)
            new = Partition(tenant_id=tenant_id, base=part.base, size=size)
            self._parts[tenant_id] = new
            return new

    def relocate(self, tenant_id: str, new_slots: int
                 ) -> Tuple[Partition, Partition]:
        """Move a tenant to a freshly-allocated extent of
        ``next_pow2(new_slots)`` slots.  Both extents are allocated while
        this returns — the caller copies device data old -> new, then
        commits with :meth:`release_old` (or rolls back by freeing the
        new base).  Returns ``(old, new)``."""
        with self._lock:
            old = self.lookup(tenant_id)
            base, size = self._alloc.alloc(new_slots)
            new = Partition(tenant_id=tenant_id, base=base, size=size)
            self._parts[tenant_id] = new
            return old, new

    def release_old(self, old: Partition) -> None:
        """Return a relocated-away extent to the allocator (the device
        copy landed; the old slots were scrubbed)."""
        with self._lock:
            self._alloc.free(old.base)

    def bounds_arrays(self) -> Dict[str, np.ndarray]:
        """Dense arrays (one row per tenant, sorted by id) — for batched
        multi-tenant kernels that fence per-row with a tenant-id lookup."""
        ids = sorted(self._parts)
        base = np.array([self._parts[t].base for t in ids], dtype=np.int32)
        mask = np.array([self._parts[t].mask for t in ids], dtype=np.int32)
        size = np.array([self._parts[t].size for t in ids], dtype=np.int32)
        return {"tenant_ids": ids, "base": base, "mask": mask, "size": size}


class IntraPartitionAllocator:
    """First-fit free-list allocator *within* one partition.

    Serves a tenant's malloc()/free() calls from its own partition
    (§4.2.1: "allocation calls of each application are served from its
    partition").  No cross-tenant metadata — everything here is in
    partition-relative slot units.
    """

    def __init__(self, part: Partition):
        self.part = part
        self._free: List[Tuple[int, int]] = [(0, part.size)]  # (rel_base, len)
        self._live: Dict[int, int] = {}  # rel_base -> len

    def alloc(self, n: int) -> int:
        if n <= 0:
            raise ValueError("alloc size must be positive")
        for i, (b, ln) in enumerate(self._free):
            if ln >= n:
                if ln == n:
                    self._free.pop(i)
                else:
                    self._free[i] = (b + n, ln - n)
                self._live[b] = n
                return b
        raise OutOfArenaMemory(
            f"tenant {self.part.tenant_id!r}: no {n} contiguous free slots"
        )

    def free(self, rel_base: int) -> None:
        n = self._live.pop(rel_base, None)
        if n is None:
            raise KeyError(f"free of unallocated offset {rel_base}")
        bisect.insort(self._free, (rel_base, n))
        # coalesce
        merged: List[Tuple[int, int]] = []
        for b, ln in self._free:
            if merged and merged[-1][0] + merged[-1][1] == b:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((b, ln))
        self._free = merged

    def live_bytes(self) -> int:
        return sum(self._live.values())

    def live_span(self) -> int:
        """One past the highest live slot (0 when nothing is live) — the
        minimum in-place partition size that loses no data."""
        return max((b + n for b, n in self._live.items()), default=0)

    def repack_plan(self) -> List[Tuple[int, int, int]]:
        """Compaction plan: ``(old_rel, new_rel, len)`` moves that pack
        every live allocation to the front of the partition, in ascending
        offset order.  Ascending order with ``new <= old`` per move makes
        the sequential device copy overlap-safe (a later move's source is
        never clobbered by an earlier move's destination).  No state is
        mutated — apply with :meth:`commit_repack`."""
        moves: List[Tuple[int, int, int]] = []
        cursor = 0
        for b in sorted(self._live):
            n = self._live[b]
            if b != cursor:
                moves.append((b, cursor, n))
            cursor += n
        return moves

    def commit_repack(self, part: Partition,
                      moves: List[Tuple[int, int, int]]) -> None:
        """Apply a repack plan (device copy already landed) and rebase the
        allocator onto ``part`` — the tenant's (possibly resized /
        relocated) partition.  Live offsets shift per the plan; the free
        list becomes one tail extent."""
        remap = {old: new for old, new, _ in moves}
        self._live = {remap.get(b, b): n for b, n in self._live.items()}
        self.part = part
        used = sum(self._live.values())
        if used > part.size:
            raise OutOfArenaMemory(
                f"tenant {part.tenant_id!r}: {used} live slots exceed "
                f"resized partition ({part.size})")
        self._free = [(used, part.size - used)] if used < part.size else []

    def rebase(self, part: Partition) -> None:
        """Adopt a resized partition without moving live data (in-place
        grow/shrink, or a relocation that preserved relative offsets).
        Free space is recomputed against the new size."""
        if self.live_span() > part.size:
            raise OutOfArenaMemory(
                f"tenant {part.tenant_id!r}: live span {self.live_span()} "
                f"exceeds resized partition ({part.size})")
        old_size = self.part.size
        self.part = part
        if part.size > old_size:
            self._free.append((old_size, part.size - old_size))
        else:
            self._free = [(b, min(ln, part.size - b))
                          for b, ln in self._free if b < part.size]
        # coalesce (mirrors free())
        self._free.sort()
        merged: List[Tuple[int, int]] = []
        for b, ln in self._free:
            if merged and merged[-1][0] + merged[-1][1] == b:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((b, ln))
        self._free = merged

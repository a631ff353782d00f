"""Device-side per-tenant violation telemetry — fault *attribution* for
Guardian's CHECK mode (§4.4, "detect invalid accesses and return from the
kernel"), grown into an accounting substrate.

The CHECK fence is the only bounds mode that *detects* out-of-bounds
accesses (BITWISE/MODULO contain silently).  Detection alone is not
containment policy: to quarantine a misbehaving tenant the manager needs to
know *who* violated, *how often*, and *through which access class* — without
synchronizing the device on every launch.

:class:`ViolationLog` is that substrate: a ``(T, K)`` int32 array living in
device memory beside the scheduler's
:class:`~repro_torch.core.fence.FenceTable`, one row per tenant and one column
per access class (:class:`ViolationKind`: gather / scatter / dynamic-slice /
dynamic-update).  CHECK launches fold their per-row violation counts into
the log on the device (an in-place ``log[row] += counts`` — no host
round-trip on the hot path); the host only syncs when a
:class:`~repro_torch.core.quarantine.QuarantineManager` polls the log or the
operator asks for :meth:`GuardianManager.violation_report`.

Rows are assigned on tenant registration and recycled on removal, so the
log's capacity bounds the number of *co-resident* tenants, not the number of
tenants over the manager's lifetime.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional

import numpy as np
import torch


class ViolationKind(enum.IntEnum):
    """Access classes the sandbox fences — the log's column space.

    Mirrors the four rewrite sites of the tenant-kernel sandboxer: gather
    / scatter index columns and dynamic-slice / dynamic-update start
    offsets.
    """

    GATHER = 0
    SCATTER = 1
    SLICE = 2
    UPDATE = 3


NUM_KINDS = len(ViolationKind)

#: Column order of a log row, for reports and CSV headers.
KIND_NAMES = tuple(k.name.lower() for k in ViolationKind)


class ViolationLog:
    """Per-tenant, per-kind OOB counters in device memory.

    The buffer is a ``(T, K)`` int32 device tensor updated in place.  Host
    reads (:meth:`snapshot`, :meth:`counts`) synchronize; the ``dirty`` flag lets
    the QuarantineManager skip the sync entirely when no CHECK launch has
    run since its last poll (BITWISE/MODULO traffic never touches the
    log).  Only the poller clears the flag — operator reads
    (``violation_report`` etc.) must not suppress containment.
    """

    def __init__(self, capacity: int = 64, device="cuda"):
        if capacity < 1:
            raise ValueError("ViolationLog capacity must be >= 1")
        self.capacity = capacity
        self.device = torch.device(device)
        self.buf: torch.Tensor = torch.zeros(
            (capacity, NUM_KINDS), dtype=torch.int32, device=self.device)
        self._row_of: Dict[str, int] = {}
        self._free_rows: List[int] = list(range(capacity - 1, -1, -1))
        #: True iff a CHECK launch may have written since the poller's last
        #: look.  Set by the launch paths, cleared ONLY by the quarantine
        #: poll (QuarantineManager.poll) — never by plain reads.
        self.dirty = False

    # ------------------------------------------------------------------ #
    # Row lifecycle                                                      #
    # ------------------------------------------------------------------ #
    def assign(self, tenant_id: str) -> int:
        """Give ``tenant_id`` a log row (idempotent), growing the table
        when full — the ``(T, K)`` buffer is elastic like the fence
        tables, so ``capacity`` is a starting size, not a tenant cap."""
        row = self._row_of.get(tenant_id)
        if row is not None:
            return row
        if not self._free_rows:
            self._grow(self.capacity * 2)
        row = self._free_rows.pop()
        self._row_of[tenant_id] = row
        return row

    def _grow(self, new_capacity: int) -> None:
        """Double the device table.  Existing rows keep their indices
        (staged row-id vectors and in-flight attributions stay valid);
        the new rows join the free list *below* the old pop position, so
        assignment order continues ascending through the fresh block.
                """
        if new_capacity <= self.capacity:
            return
        pad = torch.zeros((new_capacity - self.capacity, NUM_KINDS),
                          dtype=torch.int32, device=self.device)
        self.buf = torch.cat([self.buf, pad], dim=0)
        self._free_rows = (
            list(range(new_capacity - 1, self.capacity - 1, -1))
            + self._free_rows)
        self.capacity = new_capacity

    def release(self, tenant_id: str) -> None:
        """Recycle a tenant's row, zeroing it for the next occupant."""
        row = self._row_of.pop(tenant_id, None)
        if row is None:
            return
        self.buf[row] = 0
        self._free_rows.append(row)

    def row_of(self, tenant_id: str) -> Optional[int]:
        return self._row_of.get(tenant_id)

    def tenants(self) -> List[str]:
        return list(self._row_of)

    # ------------------------------------------------------------------ #
    # Device-side accumulation                                           #
    # ------------------------------------------------------------------ #
    def add(self, tenant_id: str, counts) -> None:
        """Fold a ``(K,)`` count vector into the tenant's row.

        ``counts`` may be a device tensor (the output of a CHECK launch) — the
        update stays on device; nothing synchronizes here.
        """
        row = self._row_of[tenant_id]
        self.buf[row] += torch.as_tensor(counts, dtype=torch.int32).to(
            self.device)
        self.dirty = True

    def reset(self, tenant_id: str) -> None:
        """Zero one tenant's counters (re-admission wipes the slate)."""
        row = self._row_of.get(tenant_id)
        if row is not None:
            self.buf[row] = 0

    # ------------------------------------------------------------------ #
    # Host-side reads (synchronizing)                                    #
    # ------------------------------------------------------------------ #
    def snapshot(self) -> np.ndarray:
        """Host copy of the full ``(T, K)`` table (``dirty`` untouched)."""
        return self.buf.cpu().numpy()

    def counts(self, tenant_id: str,
               snap: Optional[np.ndarray] = None) -> Dict[str, int]:
        """{kind name: count} for one tenant (pass ``snap`` to amortize)."""
        row = self._row_of[tenant_id]
        snap = self.snapshot() if snap is None else snap
        return {name: int(snap[row, k])
                for k, name in enumerate(KIND_NAMES)}

    def total(self, tenant_id: str,
              snap: Optional[np.ndarray] = None) -> int:
        row = self._row_of[tenant_id]
        snap = self.snapshot() if snap is None else snap
        return int(snap[row].sum())

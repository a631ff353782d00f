"""Allocation-pressure telemetry — the host-side substrate the elastic
partition subsystem (:mod:`repro_torch.core.elastic`) reasons over.

Guardian sizes a tenant's partition once at registration; making the
partitions *elastic* needs a signal that says when a partition is too
small (allocations bumping against the top) or too large (mostly idle
reservation).  That signal must never touch the launch hot path: like the
:class:`~repro_torch.core.violations.ViolationLog`, pressure is **sampled at
drain-cycle boundaries** behind a dirty flag — a cycle in which no
tenant's allocator moved costs one boolean read.

Everything here is host arithmetic over allocator metadata the manager
already owns (``IntraPartitionAllocator.live_bytes``, partition sizes, the
serve engine's occupied-slot counts): no device sync, ever.  The same
:class:`Ewma` smoother feeds the scheduler's adaptive-lookahead budget
(arrival rates over drain cycles — see
:class:`~repro_torch.core.scheduler.BatchedLaunchScheduler`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple


class Ewma:
    """Exponentially-weighted moving average with a first-sample seed.

    ``alpha`` weights the newest sample; the first update seeds the value
    exactly (no bias toward an arbitrary zero start).  Deterministic —
    the adaptive-lookahead tests mirror it with plain arithmetic.
    """

    def __init__(self, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.value = 0.0
        self.samples = 0

    def update(self, x: float) -> float:
        if self.samples == 0:
            self.value = float(x)
        else:
            self.value = self.alpha * float(x) + (1 - self.alpha) * self.value
        self.samples += 1
        return self.value


@dataclasses.dataclass
class PressureSample:
    """One tenant's allocation pressure at a drain-cycle boundary.

    ``utilization`` is live slots / partition size (instantaneous);
    ``ewma`` the smoothed series the watermarks compare against.
    ``shrinkable`` records whether the sampler knows how to *move* the
    tenant's live data (suballoc-tracked raw tenants repack; serve
    engines report occupancy but own their slot placement, so the
    elastic manager may grow or relocate them wholesale but never
    shrink them in place).
    """

    tenant_id: str
    live: int
    size: int
    ewma: float
    shrinkable: bool = True
    #: intra-partition allocation failures since the last sample — the
    #: hard grow signal (a tenant hitting its ceiling is past any
    #: watermark debate)
    failures: int = 0

    @property
    def utilization(self) -> float:
        return self.live / self.size if self.size else 1.0


class PressureTracker:
    """Per-tenant allocation-pressure accounting, dirty-flag gated.

    The manager calls :meth:`note_alloc` / :meth:`note_free` /
    :meth:`note_failure` from its (host-side) allocator paths — each is a
    dict write plus a flag set.  The elastic manager calls
    :meth:`sample` at drain-cycle boundaries; a clean tracker returns
    ``[]`` without touching any per-tenant state.  Serve engines report
    slot occupancy through :meth:`observe` (they have no suballocator),
    which marks the tenant non-shrinkable — see
    :class:`PressureSample`.
    """

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self.dirty = False
        self._ewma: Dict[str, Ewma] = {}
        self._dirty_tenants: set = set()
        self._observed: Dict[str, Tuple[int, int]] = {}  # tenant -> (live, size)
        self._failures: Dict[str, int] = {}

    # -- hot-path notes (host dict writes only) ------------------------- #
    def note_alloc(self, tenant_id: str) -> None:
        self._dirty_tenants.add(tenant_id)
        self.dirty = True

    note_free = note_alloc

    def note_failure(self, tenant_id: str) -> None:
        """An intra-partition allocation failed — the partition is hard
        full regardless of what the watermarks say."""
        self._failures[tenant_id] = self._failures.get(tenant_id, 0) + 1
        self._dirty_tenants.add(tenant_id)
        self.dirty = True

    def observe(self, tenant_id: str, live: int, size: int) -> None:
        """Serve-plane occupancy report (used slots / partition slots).
        Marks the tenant dirty and non-shrinkable."""
        self._observed[tenant_id] = (int(live), int(size))
        self._dirty_tenants.add(tenant_id)
        self.dirty = True

    def clear_failures(self, tenant_id: str) -> None:
        """The failure was already acted on (the malloc path grew the
        partition inline) — it must not drive a second grow at the next
        poll."""
        self._failures.pop(tenant_id, None)

    def forget(self, tenant_id: str) -> None:
        self._ewma.pop(tenant_id, None)
        self._observed.pop(tenant_id, None)
        self._failures.pop(tenant_id, None)
        self._dirty_tenants.discard(tenant_id)

    # -- cycle-boundary sampling ---------------------------------------- #
    def sample(self, live_of) -> List[PressureSample]:
        """Samples for every tenant dirtied since the last call.

        ``live_of(tenant_id) -> Optional[(live, size)]`` resolves a raw
        tenant's suballocator state; serve-observed tenants use their
        reported occupancy instead.  Consumes the dirty set.
        """
        if not self.dirty:
            return []
        out: List[PressureSample] = []
        for t in sorted(self._dirty_tenants):
            if t in self._observed:
                live, size = self._observed[t]
                shrinkable = False
            else:
                resolved = live_of(t)
                if resolved is None:
                    continue
                live, size = resolved
                shrinkable = True
            ew = self._ewma.get(t)
            if ew is None:
                ew = self._ewma[t] = Ewma(self.alpha)
            util = live / size if size else 1.0
            out.append(PressureSample(
                tenant_id=t, live=live, size=size,
                ewma=ew.update(util), shrinkable=shrinkable,
                failures=self._failures.pop(t, 0)))
        self._dirty_tenants.clear()
        self.dirty = False
        return out

    def ewma_of(self, tenant_id: str) -> Optional[float]:
        ew = self._ewma.get(tenant_id)
        return ew.value if ew is not None and ew.samples else None


def total_arrival_rate(ewmas: Iterable[Ewma]) -> float:
    """Sum of seeded per-tenant arrival-rate EWMAs (ops per drain cycle)
    — the *compute pressure* signal.  Feeds two consumers: the adaptive
    lookahead derivation below, and compute-aware admission
    (``ElasticPolicy.compute_watermark``): a best-effort admission
    waitlists while this total says the scheduler is already saturated
    enough to threaten a latency-critical tenant's budget.  Unseeded
    trackers contribute nothing (a cold scheduler exerts no pressure).
    """
    return sum(ew.value for ew in ewmas if ew.samples)


def derive_lookahead(rates: Iterable[float], max_fuse: int,
                     cap: int) -> int:
    """Adaptive cross-cycle lookahead budget from observed arrival rates.

    ``rates`` are per-tenant EWMA arrivals per drain cycle.  The budget
    is the expected number of cycles an under-filled batch must wait for
    compatible arrivals to fill it — ``ceil((max_fuse - 1) / total)`` —
    clamped to ``[0, cap]``:

    * dense traffic (``total >= max_fuse - 1``) fills batches within one
      cycle, so holding costs latency for nothing → budget 1;
    * sparse traffic would wait unboundedly → ``cap`` bounds the tail;
    * no observed traffic (cold scheduler) → 0, the flush-every-cycle
      default, so adaptive mode changes nothing until it has data.

    Pure host arithmetic, mirrored by the deterministic sweep in
    ``tests/test_scheduler.py``.
    """
    total = sum(rates)
    if total <= 0.0 or max_fuse <= 1:
        return 0
    need = (max_fuse - 1) / total
    budget = int(need) if need == int(need) else int(need) + 1
    return max(0, min(budget, cap))

"""Elastic partition subsystem — dynamic spatial sharing for Guardian.

Guardian's partitions are carved once at tenant registration (§4.2.1:
tenants "declare memory needs at init") and never move.  That is the
static-slice model ParvaGPU and Tally attack: a bursty tenant either
over-reserves (wasted HBM) or is rejected outright when the arena is
full.  The dynamic ``(base, mask)`` / magic-modulo FenceTable rows the
launch path already ships are exactly what makes *live resizing* free of
recompiles — bounds are launch-time operands, never compiled constants —
so the missing piece is a control plane.  This module is that control
plane, owning the tenant memory lifecycle end to end:

    WAITLISTED ──admit──▶ ACTIVE ◀──────┐
                            │ grow/shrink│
                            ▼            │
                         RESIZING ───────┤
                            │            │
                            ▼            │
                        COMPACTING ──────┘

* **Admission control** (:meth:`ElasticManager.admit`): when the arena
  cannot host a new tenant, the request parks on a FIFO **waitlist**
  instead of failing.  Departures and quarantine evictions re-drive
  admission; before waitlisting, the controller tries to *make room* —
  shrinking idle over-reservations below the low watermark and running a
  compaction pass — so fragmentation, not true capacity, never rejects.
* **Live grow/shrink**: per-tenant allocation pressure
  (:class:`~repro_torch.core.pressure.PressureTracker` — live slots over
  partition size, EWMA-smoothed, plus hard intra-partition allocation
  failures) is sampled at **drain-cycle boundaries** behind a dirty flag,
  the same no-hot-path-sync discipline as the ViolationLog.  A tenant
  above the high watermark doubles (in place when its buddy is free,
  relocating otherwise); one below the low watermark halves after an
  on-device repack.
* **On-device compaction**: relocation copies a tenant's live
  allocations to a new extent through a *trusted relocation step*
  (:func:`repro_torch.launch.steps.build_flat_relocation_step`) dispatched via
  the BatchedLaunchScheduler between drain cycles; the tenant's
  FenceTable/magic rows, partition scalars, MODULO specializations and
  scheduler table stagings are rewritten atomically with the move, and
  outstanding :class:`~repro_torch.core.interception.DevicePtr` handles are
  translated transparently at their next validated use.  Co-tenant
  bytes are never read or written (the step is fenced to the moving
  tenant's source/destination extents), so co-resident generations stay
  bit-identical — asserted in ``tests/test_elastic.py``.

Serve engines participate through the event subscription
(:meth:`subscribe`): a resize event for a serving tenant moves its KV
pool slots (``build_pool_relocation_step``) and remaps its request slot
ids, so ServeEngine pools resize with their tenants.

Resizes that *move* data only run while the tenant is idle (nothing
queued or pending for it, no serve run in flight — see :meth:`hold`);
in-place growth is always safe (the base never changes, so staged
launch operands stay valid).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.partition import (
    OutOfArenaMemory,
    Partition,
    UnknownTenant,
    next_pow2,
)
from repro_torch.core.pressure import PressureSample, PressureTracker
from repro_torch.core.telemetry import SCHEDULER_TRACK
from repro_torch.core.tenantclass import TenantClassPolicy, as_class_policy


class ElasticError(Exception):
    """An elastic operation could not run (busy tenant, no capacity)."""


class ElasticState(enum.Enum):
    """Lifecycle of a tenant's *extent* (orthogonal to the quarantine
    machine, which tracks conduct): see the module diagram."""

    WAITLISTED = "waitlisted"
    ACTIVE = "active"
    RESIZING = "resizing"
    COMPACTING = "compacting"


class AdmissionStatus(enum.Enum):
    ADMITTED = "admitted"
    WAITLISTED = "waitlisted"
    #: registration failed for a non-capacity reason (banned/evicted id,
    #: duplicate id, bad arguments) — the entry leaves the waitlist; no
    #: amount of freed capacity can ever admit it
    REJECTED = "rejected"


@dataclasses.dataclass
class ElasticPolicy:
    """Knobs of the elastic control plane.

    ``auto_resize`` gates the poll-driven grow/shrink (off by default:
    a manager without elastic opt-in behaves exactly like the static
    design); admission control and the explicit resize API are always
    available.
    """

    high_watermark: float = 0.85     # EWMA utilization that triggers grow
    low_watermark: float = 0.25      # EWMA utilization that triggers shrink
    ewma_alpha: float = 0.5
    min_slots: int = 8               # floor under auto-shrink + probation
    auto_resize: bool = False
    #: opt-in like auto_resize: a malloc hitting the partition ceiling
    #: grows inline instead of raising.  Off by default — a
    #: default-configured manager keeps the paper's reserve-at-init
    #: semantics (over-malloc fails, co-tenant headroom is never
    #: silently consumed)
    grow_on_failure: bool = False
    compact_on_admit: bool = True    # admission may defragment
    shrink_for_admission: bool = True  # admission may reclaim idle reserves
    #: compute-aware admission (None = off, the arena-bytes-only
    #: behavior): while any latency-critical tenant is registered and the
    #: scheduler's total EWMA arrival rate (ops per drain cycle,
    #: ``BatchedLaunchScheduler.arrival_rate_total``) is at or above this
    #: watermark, *best-effort-classed* admissions waitlist even when the
    #: arena has room — a compute-saturating tenant must not degrade LC
    #: p99 on arrival.  Retried every poll; the EWMA decays as traffic
    #: thins, so deferred tenants admit themselves once pressure drops.
    compute_watermark: Optional[float] = None
    #: proactive compaction at *idle* drain cycles (the serve plane's
    #: page-table-rewrite compaction is near-free, so waiting for an
    #: admission to need the hole is pure fragmentation debt).  Off by
    #: default; ``compact_interval`` is the number of consecutive idle
    #: drain cycles between passes.
    background_compact: bool = False
    compact_interval: int = 8


@dataclasses.dataclass(frozen=True)
class ResizeEvent:
    """One committed extent change, broadcast to subscribers *after* the
    device copy landed and the host tables were rewritten — both extents
    are described so listeners (serve engines) can remap without touching
    the bounds table."""

    tenant_id: str
    kind: str                        # "grow" | "shrink" | "relocate"
    old_base: int
    old_size: int
    new_base: int
    new_size: int

    @property
    def moved(self) -> bool:
        return self.new_base != self.old_base


@dataclasses.dataclass
class Admission:
    """Handle returned by :meth:`ElasticManager.admit` — mutated in place
    when a waitlisted tenant is finally admitted."""

    tenant_id: str
    requested_slots: int
    status: AdmissionStatus
    client: Optional[Any] = None     # GuardianClient once admitted
    policy: Optional[Any] = None     # per-tenant FencePolicy override
    weight: int = 1
    #: scheduler drain-cycle stamp at admit() — the waitlist-age clock
    #: (-1: admitted before the telemetry layer stamped it)
    enqueue_cycle: int = -1
    #: normalized TenantClassPolicy (or None), forwarded to
    #: register_tenant on admission; best-effort entries are the ones
    #: compute-aware admission may defer
    tenant_class: Optional[TenantClassPolicy] = None


class ElasticManager:
    """Owns the tenant memory lifecycle for a GuardianManager.

    Constructed by the manager (like the QuarantineManager); all state is
    host-side.  Device work — the relocation copies — rides the
    scheduler's trusted-step path via transient one-shot kernels.
    """

    def __init__(self, manager, policy: Optional[ElasticPolicy] = None):
        self.manager = manager
        self.policy = policy if policy is not None else ElasticPolicy()
        self.pressure = PressureTracker(alpha=self.policy.ewma_alpha)
        self.waitlist: Deque[Admission] = collections.deque()
        self.events: List[str] = []
        self._listeners: List[Callable[[ResizeEvent], None]] = []
        self._state: Dict[str, ElasticState] = {}
        #: serve runs in flight: data-moving resizes defer while > 0
        self._holds = 0
        #: capacity freed since the last waitlist drive
        self._retry_waitlist = False
        #: reentrancy guard: a shrink *inside* a waitlist-driven
        #: make-room pass frees capacity, which must not re-enter the
        #: drain that triggered it
        self._draining = False
        #: per-resize-event relocation-step dedupe (see _notify); None
        #: outside a notification
        self._event_dispatched = None
        #: tenants whose extents are *virtual* (page-table-indirected —
        #: the global paged serve pool): relocation commits bounds + a
        #: host-side map rewrite only, no device copy step
        self._virtual: set = set()
        #: consecutive idle drain cycles (background-compaction cadence)
        self._idle_cycles = 0
        #: lifetime counters (benchmark / introspection surface)
        self.stats = {"admitted": 0, "waitlisted": 0, "grows": 0,
                      "shrinks": 0, "relocations": 0, "compactions": 0,
                      "compute_deferred": 0, "reloc_steps": 0}

    def _tel(self):
        """The manager's flight recorder, or None when disabled — every
        elastic record path goes through host dict writes only."""
        tel = getattr(self.manager, "telemetry", None)
        return tel if tel is not None and tel.enabled else None

    # ------------------------------------------------------------------ #
    # Introspection + subscriptions                                      #
    # ------------------------------------------------------------------ #
    def state_of(self, tenant_id: str) -> Optional[ElasticState]:
        return self._state.get(tenant_id)

    def subscribe(self, callback: Callable[[ResizeEvent], None]) -> None:
        """Resize observers (serve engines move pool slots + remap their
        request slot ids; operators log)."""
        self._listeners.append(callback)

    def _notify(self, ev: ResizeEvent) -> None:
        # one dedupe scope per event: two co-hosted engines serving the
        # same tenant both observe the resize, but the shared pool must
        # move exactly once (a second copy-then-zero pass would read the
        # already-zeroed source) — dispatch_relocation keys on the step
        # name, which encodes (pool, src, dst, size)
        self._event_dispatched = set()
        try:
            for cb in self._listeners:
                cb(ev)
        finally:
            self._event_dispatched = None

    def mark_virtual(self, tenant_id: str) -> None:
        """Declare ``tenant_id``'s extent virtual: its slot ids are page
        numbers indirected through a manager-owned page map (the global
        paged serve pool), so relocation/compaction needs no device copy
        — the subscriber rewrites the map and the KV bytes stay put."""
        self._virtual.add(tenant_id)

    def is_virtual(self, tenant_id: str) -> bool:
        return tenant_id in self._virtual

    def hold(self) -> None:
        """Enter a serve run: data-moving resizes defer until released
        (a run's staged guards/slot ids must never go stale mid-flight)."""
        self._holds += 1

    def release(self) -> None:
        self._holds = max(self._holds - 1, 0)

    def forget(self, tenant_id: str) -> None:
        """Tenant teardown: drop pressure history and extent state."""
        self.pressure.forget(tenant_id)
        self._state.pop(tenant_id, None)

    def _busy(self, tenant_id: str) -> bool:
        """May the tenant's data move right now?  Queued or pending ops
        carry device-staged absolute addresses; a serve run holds staged
        guards — either makes a move unsafe until the next boundary."""
        if self._holds > 0:
            return True
        q = self.manager._queues.get(tenant_id)
        if q:
            return True
        return any(r.tenant_id == tenant_id
                   for r in self.manager.scheduler._pending)

    # ------------------------------------------------------------------ #
    # Admission control                                                  #
    # ------------------------------------------------------------------ #
    def admit(self, tenant_id: str, requested_slots: int,
              policy=None, weight: int = 1,
              tenant_class=None) -> Admission:
        """Admission-controlled registration: the tenant is registered
        when the arena can host it (making room by shrinking idle
        reserves and compacting if needed), and **waitlisted** otherwise
        — re-driven on every departure/eviction.  The waitlist is FIFO
        with *backfill*: the head has first claim on every freed slot
        (and is the only entry allowed to trigger a compaction pass),
        but a later entry may fill a hole the head cannot use anyway —
        small tenants are never head-of-line blocked behind a large one.
        Returns the admission handle; ``handle.client`` is the
        GuardianClient once admitted.

        ``tenant_class`` (any ``register_tenant`` class spec) rides the
        admission: with ``ElasticPolicy.compute_watermark`` set, a
        best-effort-classed entry also waitlists while scheduler
        arrival-rate pressure threatens a registered latency-critical
        tenant — see :meth:`_compute_saturated`."""
        adm = Admission(tenant_id=tenant_id,
                        requested_slots=requested_slots,
                        status=AdmissionStatus.WAITLISTED,
                        policy=policy, weight=weight,
                        enqueue_cycle=self.manager.scheduler._cycle,
                        tenant_class=as_class_policy(tenant_class))
        # never clobber a live tenant's extent state: a duplicate admit
        # of an ACTIVE tenant will be REJECTED by registration, and its
        # existing state must survive that
        if self._state.get(tenant_id) in (None, ElasticState.WAITLISTED):
            self._state[tenant_id] = ElasticState.WAITLISTED
        self.waitlist.append(adm)
        self._drain_waitlist()
        if adm.status is AdmissionStatus.WAITLISTED:
            self.stats["waitlisted"] += 1
            self.events.append(
                f"waitlist {tenant_id} ({requested_slots} slots)")
            tel = self._tel()
            if tel is not None:
                tel.registry.inc("waitlisted", tenant=tenant_id)
                tel.event("waitlist", tenant_id,
                          slots=requested_slots)
        return adm

    def _try_admit(self, adm: Admission, make_room: bool = True) -> bool:
        mgr = self.manager
        if self._compute_saturated(adm):
            # compute (not memory) is the bottleneck: keep waitlisted and
            # re-check at every poll — the arrival EWMA decays as traffic
            # thins, so the deferral is self-releasing
            self._retry_waitlist = True
            return False
        need = next_pow2(max(adm.requested_slots, 1))
        if mgr.bounds.largest_free_block() < need:
            if not make_room or not self._make_room(need):
                return False
        try:
            adm.client = mgr.register_tenant(
                adm.tenant_id, adm.requested_slots,
                policy=adm.policy, weight=adm.weight,
                tenant_class=adm.tenant_class)
        except OutOfArenaMemory:
            return False
        except Exception as e:
            # non-capacity failure (banned id, duplicate, bad args):
            # freed capacity can never fix it — reject instead of
            # wedging the waitlist or aborting a co-tenant's drain.
            # Only the WAITLISTED marker is dropped: a duplicate admit
            # of a live tenant must not erase its ACTIVE state.
            adm.status = AdmissionStatus.REJECTED
            if self._state.get(adm.tenant_id) is ElasticState.WAITLISTED:
                self._state.pop(adm.tenant_id, None)
            self.events.append(f"reject {adm.tenant_id}: {e}")
            return False
        adm.status = AdmissionStatus.ADMITTED
        self._state[adm.tenant_id] = ElasticState.ACTIVE
        self.stats["admitted"] += 1
        self.events.append(
            f"admit {adm.tenant_id} ({adm.requested_slots} slots)")
        tel = self._tel()
        if tel is not None:
            if adm.enqueue_cycle >= 0:
                age = mgr.scheduler._cycle - adm.enqueue_cycle
                tel.registry.observe("waitlist_age_cycles", age,
                                     tenant=adm.tenant_id)
            tel.event("admit", adm.tenant_id,
                      slots=adm.requested_slots)
        return True

    def _compute_saturated(self, adm: Admission) -> bool:
        """Compute-aware admission check: defer a *best-effort-classed*
        admission while (a) ``compute_watermark`` is configured, (b) some
        latency-critical tenant is registered, and (c) the scheduler's
        total EWMA arrival rate is at or above the watermark.  Class-less
        and latency-critical admissions never defer on compute — only
        memory can hold them back (the pre-class behavior)."""
        wm = self.policy.compute_watermark
        if wm is None:
            return False
        if adm.tenant_class is None or not adm.tenant_class.is_best_effort:
            return False
        mgr = self.manager
        if not any(cp.is_latency_critical
                   for cp in mgr.class_policies().values()):
            return False
        if mgr.scheduler.arrival_rate_total() < wm:
            return False
        self.stats["compute_deferred"] += 1
        self.events.append(f"compute-defer {adm.tenant_id}")
        tel = self._tel()
        if tel is not None:
            tel.registry.inc("compute_deferred", tenant=adm.tenant_id)
            tel.event("compute_defer", adm.tenant_id,
                      rate=round(mgr.scheduler.arrival_rate_total(), 3))
        return True

    def _make_room(self, need_slots: int) -> bool:
        """Try to open a ``need_slots`` hole: reclaim idle
        over-reservations first (cheap, in place), defragment second
        (relocations).  Returns True when the hole exists."""
        mgr = self.manager
        if self.policy.shrink_for_admission:
            for t in sorted(mgr.bounds.tenants()):
                if mgr.bounds.largest_free_block() >= need_slots:
                    return True
                ew = self.pressure.ewma_of(t)
                if ew is None or ew >= self.policy.low_watermark:
                    continue
                sub = mgr._suballoc.get(t)
                if sub is None or self._busy(t):
                    continue
                try:
                    self.shrink(t)
                except (ElasticError, UnknownTenant):
                    continue
        if mgr.bounds.largest_free_block() >= need_slots:
            return True
        if self.policy.compact_on_admit:
            self.compact(need_slots=need_slots)
        return mgr.bounds.largest_free_block() >= need_slots

    def withdraw(self, tenant_id: str) -> bool:
        """A WAITLISTED tenant departs before ever being admitted: drop
        its entry so it neither blocks the queue nor gets admitted (and
        counted) after it logically left.  Returns True if an entry was
        removed; a no-op for admitted/unknown tenants (use
        ``remove_tenant`` for live ones)."""
        for adm in list(self.waitlist):
            if (adm.tenant_id == tenant_id
                    and adm.status is AdmissionStatus.WAITLISTED):
                self.waitlist.remove(adm)
                self._state.pop(tenant_id, None)
                self.events.append(f"withdraw {tenant_id}")
                tel = self._tel()
                if tel is not None:
                    tel.event("withdraw", tenant_id)
                return True
        return False

    def notify_capacity_freed(self) -> None:
        """A departure/eviction returned slots: re-drive admission from
        the waitlist at the next opportunity (immediately when nothing is
        in flight)."""
        self._retry_waitlist = True
        if self._holds == 0:
            self._drain_waitlist()

    def _drain_waitlist(self) -> None:
        if self._draining:
            return
        self._draining = True
        try:
            self._retry_waitlist = False
            # FIFO with backfill: entries are tried in arrival order.
            # Only the head may reshape the arena (shrink idle reserves,
            # compact) — backfilled entries take holes as they find
            # them, so they can never consume effort or extents the
            # head's make-room pass would have claimed.
            remaining: Deque[Admission] = collections.deque()
            try:
                head = True
                while self.waitlist:
                    adm = self.waitlist.popleft()
                    if self._try_admit(adm, make_room=head):
                        continue
                    if adm.status is AdmissionStatus.REJECTED:
                        continue      # permanently inadmissible: dropped
                    remaining.append(adm)
                    head = False
            finally:
                # crash-safe: entries already deferred re-join ahead of
                # anything not yet examined
                remaining.extend(self.waitlist)
                self.waitlist = remaining
        finally:
            self._draining = False

    def probation_slots_for(self, tenant_id: str) -> int:
        """Probation partition size for a quarantine readmission probe:
        the smallest pow2 extent that holds the tenant's live data, but
        never below the policy floor (the admission controller sizes
        readmission probes)."""
        sub = self.manager._suballoc.get(tenant_id)
        span = sub.live_span() if sub is not None else 0
        return max(self.policy.min_slots, next_pow2(max(span, 1)))

    def apply_probation(self, tenant_id: str) -> Optional[Partition]:
        """Shrink a probe-readmitted tenant to its probation extent (a
        serve tenant — no suballocator — keeps its partition: its slot
        placement belongs to the engine)."""
        sub = self.manager._suballoc.get(tenant_id)
        if sub is None or self._busy(tenant_id):
            return None
        part = self.manager.bounds.lookup(tenant_id)
        target = self.probation_slots_for(tenant_id)
        if target >= part.size:
            return part
        return self.shrink(tenant_id, target)

    # ------------------------------------------------------------------ #
    # Resize primitives                                                  #
    # ------------------------------------------------------------------ #
    def grow(self, tenant_id: str) -> Partition:
        """Double a tenant's partition: in place when the right-hand
        buddy is free (no data moves, always safe), by relocation to a
        fresh 2x extent otherwise (requires the tenant idle)."""
        mgr = self.manager
        old = mgr.bounds.lookup(tenant_id)
        self._state[tenant_id] = ElasticState.RESIZING
        try:
            new = mgr.bounds.grow(tenant_id)
            if new is not None:
                sub = mgr._suballoc.get(tenant_id)
                if sub is not None:
                    sub.rebase(new)
                self._commit_resize(tenant_id, "grow", old, new)
                return new
            return self._relocate(tenant_id, old.size * 2, kind="grow")
        finally:
            self._state[tenant_id] = ElasticState.ACTIVE

    def shrink(self, tenant_id: str,
               new_slots: Optional[int] = None) -> Partition:
        """Halve (or shrink to ``new_slots``) a raw tenant's partition in
        place: live allocations are packed to the front by an on-device
        repack step, then the vacated upper buddies return to the arena.
        Serve tenants (no suballocator) are not shrinkable — their slot
        placement belongs to the engine."""
        mgr = self.manager
        old = mgr.bounds.lookup(tenant_id)
        sub = mgr._suballoc.get(tenant_id)
        if sub is None:
            raise ElasticError(
                f"shrink: tenant {tenant_id!r} has no suballocator "
                "(serve tenants own their slot placement)")
        if self._busy(tenant_id):
            raise ElasticError(
                f"shrink: tenant {tenant_id!r} has work in flight; "
                "resizes run at drain-cycle boundaries")
        live = sub.live_bytes()
        target = next_pow2(max(
            new_slots if new_slots is not None else old.size // 2,
            live, 1))
        if target >= old.size:
            return old
        self._state[tenant_id] = ElasticState.RESIZING
        try:
            plan = sub.repack_plan()
            moves = tuple((old.base + s, old.base + d, ln)
                          for s, d, ln in plan)
            zeros = ((old.base + target, old.size - target),)
            self._run_flat_relocation(
                tenant_id, moves, zeros,
                src_extent=(old.base, old.size),
                dst_extent=(old.base, old.size))
            new = mgr.bounds.shrink(tenant_id, target)
            sub.commit_repack(new, plan)
            self._remap_ptrs(tenant_id, old.base, plan, new.base)
            self._commit_resize(tenant_id, "shrink", old, new)
            self.stats["shrinks"] += 1
            self.notify_capacity_freed()
            return new
        finally:
            self._state[tenant_id] = ElasticState.ACTIVE

    def relocate(self, tenant_id: str, new_slots: int) -> Partition:
        """Move a tenant to a fresh extent of ``new_slots`` (pow2-rounded)
        slots — the explicit form of what grow/compaction do."""
        self._state[tenant_id] = ElasticState.RESIZING
        try:
            return self._relocate(tenant_id, new_slots, kind="relocate")
        finally:
            self._state[tenant_id] = ElasticState.ACTIVE

    def _relocate(self, tenant_id: str, new_slots: int,
                  kind: str) -> Partition:
        mgr = self.manager
        if self._busy(tenant_id):
            raise ElasticError(
                f"{kind}: tenant {tenant_id!r} has work in flight; "
                "resizes run at drain-cycle boundaries")
        sub = mgr._suballoc.get(tenant_id)
        old = mgr.bounds.lookup(tenant_id)
        # validate BEFORE any device work: a destination too small for
        # the live data would clobber it (the fenced writes wrap) and
        # the failure would land after the old extent was zeroed
        target = next_pow2(max(new_slots, 1))
        if sub is not None and sub.live_bytes() > target:
            raise ElasticError(
                f"{kind}: tenant {tenant_id!r} has {sub.live_bytes()} "
                f"live slots; a {target}-slot extent cannot hold them")
        if sub is None and target < old.size:
            raise ElasticError(
                f"{kind}: tenant {tenant_id!r} owns its slot placement "
                "(serve tenant); its extent never shrinks by relocation")
        old, new = mgr.bounds.relocate(tenant_id, new_slots)
        if sub is not None and sub.live_span() > new.size:
            plan = sub.repack_plan()        # pack to fit the new extent
        else:
            plan = []                       # offsets preserved wholesale
        try:
            if sub is not None and sub.live_bytes() > 0:
                # EVERY live block crosses to the new extent — the plan
                # only lists blocks whose relative offset changes, and a
                # block already packed at its final offset still has to
                # be copied out of the extent being vacated
                rel_map = {s: d for s, d, _ in plan}
                moves = tuple(
                    (old.base + b, new.base + rel_map.get(b, b), n)
                    for b, n in sorted(sub._live.items()))
            elif tenant_id in self._virtual:
                # virtual extent (global paged pool): the slot ids are
                # page numbers behind a host-owned map — the subscriber
                # rewrites the map, no bytes move and nothing needs
                # scrubbing (the vacated range is numbers, not data)
                moves = ()
            else:
                # no suballocator (serve tenant): the engine listener
                # moves the pool slots; the flat extent is copied
                # wholesale so raw arena bytes follow too
                span = min(old.size, new.size)
                moves = ((old.base, new.base, span),)
            zeros = ((old.base, old.size),) if moves else ()
            self._run_flat_relocation(
                tenant_id, moves, zeros,
                src_extent=(old.base, old.size),
                dst_extent=(new.base, new.size))
        except Exception:
            # roll the bounds back: free the new extent, restore the old
            mgr.bounds._alloc.free(new.base)
            mgr.bounds._parts[tenant_id] = old
            raise
        if sub is not None:
            if plan:
                sub.commit_repack(new, plan)
            else:
                sub.rebase(new)
        self._remap_ptrs(tenant_id, old.base, plan, new.base)
        mgr.bounds.release_old(old)
        self._commit_resize(tenant_id, kind, old, new)
        self.stats["relocations"] += 1
        if kind == "grow":
            self.stats["grows"] += 1
        return new

    def compact(self, need_slots: Optional[int] = None) -> int:
        """Defragmentation pass: repeatedly relocate idle tenants to
        lower free extents until no tenant can move down (or the
        requested hole exists).  Returns the number of extents moved.
        Buddy coalescing turns the vacated upper extents into the large
        contiguous block a waiting admission needs."""
        mgr = self.manager
        if self._holds > 0:
            return 0
        moved = 0
        progress = True
        while progress:
            if (need_slots is not None
                    and mgr.bounds.largest_free_block() >= need_slots):
                break
            progress = False
            for t in sorted(mgr.bounds.tenants(),
                            key=lambda t: mgr.bounds.lookup(t).base):
                if self._busy(t):
                    continue
                part = mgr.bounds.lookup(t)
                # read-only placement probe: where would the allocator
                # put this extent right now?  Only a strictly lower base
                # is a packing improvement worth a device copy.
                dest = mgr.bounds._alloc.peek_alloc(part.size)
                if dest is None or dest >= part.base:
                    continue
                self._state[t] = ElasticState.COMPACTING
                try:
                    self._relocate(t, part.size, kind="relocate")
                finally:
                    self._state[t] = ElasticState.ACTIVE
                moved += 1
                progress = True
        if moved:
            self.stats["compactions"] += 1
            self.events.append(f"compact: moved {moved} extent(s)")
            tel = self._tel()
            if tel is not None:
                tel.registry.inc("compactions")
                tel.event("compaction", SCHEDULER_TRACK, extents=moved)
        return moved

    # ------------------------------------------------------------------ #
    # Device + host commit plumbing                                      #
    # ------------------------------------------------------------------ #
    def _run_flat_relocation(self, tenant_id: str,
                             moves: Tuple[Tuple[int, int, int], ...],
                             zeros: Tuple[Tuple[int, int], ...],
                             src_extent: Tuple[int, int],
                             dst_extent: Tuple[int, int]) -> None:
        """Dispatch the on-device copy as a one-shot trusted step through
        the scheduler (same path as any framework-plane kernel)."""
        if not moves and not zeros:
            return
        tel = self._tel()
        if tel is not None and moves:
            tel.registry.observe(
                "compaction_slots_moved",
                sum(n for _, _, n in moves), tenant=tenant_id)
        from repro_torch.launch.steps import build_flat_relocation_step
        fn = build_flat_relocation_step(tuple(moves), tuple(zeros),
                                        src_extent, dst_extent)
        name = (f"elastic.relocate[{tenant_id}:"
                f"{src_extent}->{dst_extent}:{hash((moves, zeros)) & 0xffffffff:x}]")
        self.dispatch_relocation(tenant_id, name, fn)

    def dispatch_relocation(self, tenant_id: str, name: str, fn,
                            pool_arena: Optional[str] = None) -> Any:
        """Register a transient trusted relocation kernel, dispatch it
        immediately through the BatchedLaunchScheduler (between drain
        cycles — never interleaved with tenant work), and drop the
        symbol (relocation plans are one-shot; they must not accrete in
        ``pointer_to_symbol``).  Serve engines use this for their pool
        moves (``pool_arena=``); within one resize notification a given
        step name dispatches at most once, so N subscribers sharing a
        pool never repeat the same move."""
        if self._event_dispatched is not None:
            if name in self._event_dispatched:
                return None
            self._event_dispatched.add(name)
        mgr = self.manager
        mgr.pointer_to_symbol.pop(name, None)   # paranoid: never stale
        mgr.register_trusted_kernel(name, fn, pool_arena=pool_arena)
        self.stats["reloc_steps"] += 1
        try:
            return mgr._dispatch_trusted_direct(tenant_id, name)
        finally:
            mgr.pointer_to_symbol.pop(name, None)

    def _remap_ptrs(self, tenant_id: str, old_base: int,
                    plan: List[Tuple[int, int, int]],
                    new_base: int) -> None:
        """Teach the manager's pointer translation about the move:
        outstanding DevicePtrs minted against the old extent resolve to
        their new absolute addresses on next use."""
        sub = self.manager._suballoc.get(tenant_id)
        if sub is None:
            return
        rel_map = {s: d for s, d, _ in plan}
        mapping = {}
        for new_rel in sub._live:
            # commit_repack/rebase already ran: _live holds NEW offsets
            old_rel = next((s for s, d in rel_map.items() if d == new_rel),
                           new_rel)
            old_abs = old_base + old_rel
            new_abs = new_base + new_rel
            if old_abs != new_abs:
                mapping[old_abs] = new_abs
        if mapping:
            self.manager._compose_ptr_remap(tenant_id, mapping)

    def _commit_resize(self, tenant_id: str, kind: str,
                       old: Partition, new: Partition) -> None:
        """Host-table rewrite for a committed extent change: purge every
        compiled/staged artifact keyed on the old bounds (fence-table
        stagings, MODULO magic specializations, partition scalars —
        the manager's fence_table() key includes the bounds, so the
        (T, 2)/(T, 4) rows rebuild on next read), then notify."""
        mgr = self.manager
        mgr._purge_symbol_caches(old)
        mgr._part_scalars.pop(tenant_id, None)
        if kind == "grow" and new.base == old.base:
            self.stats["grows"] += 1
        ev = ResizeEvent(tenant_id=tenant_id, kind=kind,
                         old_base=old.base, old_size=old.size,
                         new_base=new.base, new_size=new.size)
        self.events.append(
            f"{kind} {tenant_id}: [{old.base},{old.base + old.size}) -> "
            f"[{new.base},{new.base + new.size})")
        tel = self._tel()
        if tel is not None:
            tel.registry.inc("resizes", tenant=tenant_id)
            tel.event("resize", tenant_id, kind=kind,
                      old_base=old.base, old_size=old.size,
                      new_base=new.base, new_size=new.size)
        self._notify(ev)

    # ------------------------------------------------------------------ #
    # Drain-cycle boundary poll                                          #
    # ------------------------------------------------------------------ #
    def maybe_poll(self, idle: bool = False) -> None:
        """Cheap cadence gate called by the manager's drain loop — one
        flag read when nothing changed (the ViolationLog discipline).

        ``idle=True`` marks a drain cycle that dispatched no work; with
        ``policy.background_compact`` every ``compact_interval``-th
        consecutive idle cycle runs a proactive compaction pass, so
        fragmentation is paid down while the device would sit idle
        anyway (for virtual/paged tenants the pass is pure host
        bookkeeping — page-map rewrites, zero copy steps)."""
        if self._holds > 0:
            return
        if idle and self.policy.background_compact:
            self._idle_cycles += 1
            if self._idle_cycles >= self.policy.compact_interval:
                self._idle_cycles = 0
                self.compact()
        elif not idle:
            self._idle_cycles = 0
        if not self.pressure.dirty and not self._retry_waitlist:
            return
        self.poll()

    def poll(self) -> List[str]:
        """Sample pressure and apply watermark-driven resizes (when
        ``auto_resize``); then re-drive waitlist admission.  Returns the
        tenants resized this poll."""
        mgr = self.manager

        def live_of(t):
            sub = mgr._suballoc.get(t)
            if sub is None:
                return None
            try:
                part = mgr.bounds.lookup(t)
            except UnknownTenant:
                return None
            return sub.live_bytes(), part.size

        samples = self.pressure.sample(live_of)
        tel = self._tel()
        if tel is not None:
            for s in samples:
                tel.registry.set_gauge("arena_utilization",
                                       s.utilization, tenant=s.tenant_id)
        resized: List[str] = []
        if self.policy.auto_resize:
            for s in samples:
                if self._auto_resize_one(s):
                    resized.append(s.tenant_id)
        if self._retry_waitlist:
            self._drain_waitlist()
        return resized

    def _auto_resize_one(self, s: PressureSample) -> bool:
        mgr = self.manager
        state = mgr.quarantine.state_of(s.tenant_id)
        if state is not None and not state.admissible:
            return False
        try:
            part = mgr.bounds.lookup(s.tenant_id)
        except UnknownTenant:
            return False
        if s.failures > 0 or s.ewma > self.policy.high_watermark:
            if part.size >= mgr.bounds.total_slots:
                return False
            try:
                self.grow(s.tenant_id)
                return True
            except (ElasticError, OutOfArenaMemory):
                return False
        if (s.shrinkable and s.ewma < self.policy.low_watermark
                and part.size > self.policy.min_slots
                and not self._busy(s.tenant_id)):
            try:
                new = self.shrink(
                    s.tenant_id,
                    max(part.size // 2, self.policy.min_slots))
                return new.size < part.size
            except ElasticError:
                return False
        return False

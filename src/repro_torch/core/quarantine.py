"""Tenant quarantine & partition reclamation — the containment *policy*
layer on top of Guardian's detection machinery.

The paper's claim is that fencing lets erroneous applications keep running
without harming co-tenants; a production manager additionally needs to
*react*: a tenant whose kernels keep tripping the CHECK fence is burning
device cycles on clamped accesses and is, by definition, buggy or hostile.
This module drives the reaction as an explicit lifecycle:

    ACTIVE ──quarantine()──▶ QUARANTINED ──evict()──▶ EVICTED
       ▲                         │                       │
       └──── (= READMITTED) ◀────┴──── readmit() ────────┘

* **QUARANTINED** — the tenant's queued ops are dropped and new device
  calls are rejected (:class:`TenantQuarantined`); its partition and data
  survive, so a false positive is recoverable via :meth:`readmit`.
* **EVICTED** — the partition is scrubbed (``Arena.zero_range``), returned
  to the buddy allocator, and the tenant's compiled entries are purged from
  the per-kernel jit/symbol caches.  EVICTED is terminal: the *only* edge
  out is an explicit :meth:`readmit`, after which the tenant must register
  again to obtain a fresh partition.
* **READMITTED** — behaviourally ACTIVE (tracked separately so operators
  can see a tenant has a history); counters are wiped on re-admission.

Transition legality is enforced by :class:`QuarantineStateMachine` (pure,
host-only — also reused by the serving engine, which has no
GuardianManager).  *When* to transition is a pluggable
:class:`QuarantinePolicy`; :class:`ThresholdPolicy` quarantines after N
logged violations and optionally evicts after M.  The
:class:`QuarantineManager` polls the device-side
:class:`~repro_torch.core.violations.ViolationLog` at drain-cycle boundaries
(never on the per-access hot path) and applies the policy.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.violations import KIND_NAMES, ViolationLog


class QuarantineError(Exception):
    """Illegal lifecycle transition (e.g. evicting an ACTIVE tenant)."""


class TenantQuarantined(QuarantineError):
    """A quarantined/evicted tenant attempted a device call."""


class TenantState(enum.Enum):
    ACTIVE = "active"
    QUARANTINED = "quarantined"
    EVICTED = "evicted"
    READMITTED = "readmitted"

    @property
    def admissible(self) -> bool:
        """May the tenant issue device calls / hold queued ops?"""
        return self in (TenantState.ACTIVE, TenantState.READMITTED)


# state -> states reachable in one legal transition
_LEGAL = {
    TenantState.ACTIVE: {TenantState.QUARANTINED},
    TenantState.READMITTED: {TenantState.QUARANTINED},
    TenantState.QUARANTINED: {TenantState.EVICTED, TenantState.READMITTED},
    # EVICTED is terminal except explicit re-admission:
    TenantState.EVICTED: {TenantState.READMITTED},
}


@dataclasses.dataclass
class TenantRecord:
    """Host-side lifecycle record (survives eviction, unlike the log row)."""

    tenant_id: str
    state: TenantState = TenantState.ACTIVE
    quarantines: int = 0
    readmissions: int = 0
    #: final per-kind counts snapshotted when the log row was recycled
    final_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    reason: str = ""
    #: automatic-readmission probe state: drain cycles spent QUARANTINED
    #: (the tenant's ops are dropped, so every cycle is clean by
    #: construction) and whether the tenant currently serves on
    #: probation — first logged violation on probation evicts
    clean_cycles: int = 0
    probation: bool = False
    #: scheduler drain-cycle stamps backing *rate-based* policies: the
    #: cycle the tenant was (re)admitted, and the cycles elapsed since —
    #: refreshed by the poll so policy objects stay pure functions of
    #: (counts, record).  A readmission resets the clock along with the
    #: wiped counters.
    admit_cycle: int = 0
    cycles_observed: int = 0


class QuarantineStateMachine:
    """Pure transition enforcement — no device or manager coupling.

    The serving engine drives one of these directly; the
    :class:`QuarantineManager` wraps one with device-side actions.
    """

    def __init__(self):
        self._records: Dict[str, TenantRecord] = {}

    # ------------------------------------------------------------------ #
    def admit(self, tenant_id: str) -> TenantRecord:
        """First registration -> ACTIVE.  Re-registering an EVICTED id
        without an explicit readmit() is the attack the state machine
        exists to stop, so it raises."""
        rec = self._records.get(tenant_id)
        if rec is None:
            rec = TenantRecord(tenant_id=tenant_id)
            self._records[tenant_id] = rec
            return rec
        if rec.state is TenantState.EVICTED:
            raise QuarantineError(
                f"tenant {tenant_id!r} is EVICTED; only an explicit "
                "readmit() may clear that state")
        return rec

    def forget(self, tenant_id: str) -> None:
        """Voluntary teardown of a healthy tenant drops the record; an
        EVICTED record is retained (the ban must survive the teardown)."""
        rec = self._records.get(tenant_id)
        if rec is not None and rec.state is not TenantState.EVICTED:
            del self._records[tenant_id]

    # ------------------------------------------------------------------ #
    def _transition(self, tenant_id: str, to: TenantState) -> TenantRecord:
        rec = self._records.get(tenant_id)
        if rec is None:
            raise QuarantineError(f"unknown tenant {tenant_id!r}")
        if to not in _LEGAL[rec.state]:
            raise QuarantineError(
                f"illegal transition {rec.state.name} -> {to.name} "
                f"for tenant {tenant_id!r}")
        rec.state = to
        return rec

    def quarantine(self, tenant_id: str, reason: str = "") -> TenantRecord:
        rec = self._transition(tenant_id, TenantState.QUARANTINED)
        rec.quarantines += 1
        rec.reason = reason
        return rec

    def evict(self, tenant_id: str, reason: str = "") -> TenantRecord:
        rec = self._transition(tenant_id, TenantState.EVICTED)
        if reason:
            rec.reason = reason
        return rec

    def readmit(self, tenant_id: str) -> TenantRecord:
        rec = self._transition(tenant_id, TenantState.READMITTED)
        rec.readmissions += 1
        rec.reason = ""
        return rec

    # ------------------------------------------------------------------ #
    def state_of(self, tenant_id: str) -> Optional[TenantState]:
        rec = self._records.get(tenant_id)
        return rec.state if rec else None

    def record_of(self, tenant_id: str) -> Optional[TenantRecord]:
        return self._records.get(tenant_id)

    def check_admission(self, tenant_id: str, api: str = "call") -> None:
        rec = self._records.get(tenant_id)
        if rec is not None and not rec.state.admissible:
            raise TenantQuarantined(
                f"{api}: tenant {tenant_id!r} is {rec.state.name}"
                + (f" ({rec.reason})" if rec.reason else ""))

    def records(self) -> List[TenantRecord]:
        return list(self._records.values())


# --------------------------------------------------------------------------- #
# Policies                                                                    #
# --------------------------------------------------------------------------- #


class QuarantinePolicy:
    """Decides transitions from a tenant's logged violation counts.

    ``counts`` is the tenant's {kind: n} dict; ``record`` its lifecycle
    record.  Subclass (or duck-type) to weight kinds, rate-limit, etc.
    """

    def should_quarantine(self, tenant_id: str, counts: Dict[str, int],
                          record: TenantRecord) -> bool:
        raise NotImplementedError

    def should_evict(self, tenant_id: str, counts: Dict[str, int],
                     record: TenantRecord) -> bool:
        return False


@dataclasses.dataclass
class ThresholdPolicy(QuarantinePolicy):
    """Quarantine past ``quarantine_after`` total violations; evict past
    ``evict_after`` (None = never auto-evict — operator decides)."""

    quarantine_after: int = 8
    evict_after: Optional[int] = None

    def should_quarantine(self, tenant_id, counts, record):
        return sum(counts.values()) >= self.quarantine_after

    def should_evict(self, tenant_id, counts, record):
        return (self.evict_after is not None
                and sum(counts.values()) >= self.evict_after)


@dataclasses.dataclass
class WeightedRatePolicy(QuarantinePolicy):
    """Threshold policy over *weighted* violation counts, with optional
    rate triggers (the richer policies the ROADMAP carried over).

    ``weights`` maps violation kinds to multipliers (unlisted kinds
    weigh 1.0) — a corrupting ``scatter`` can count 4x a stray
    ``gather``.  The absolute thresholds compare the weighted total;
    the ``*_rate`` triggers compare weighted violations *per drain
    cycle since admission* (``record.cycles_observed``, floored at
    ``min_cycles`` so one early violation can't spike the rate before
    there is a baseline).  Any trigger set to None is inert; with both
    absolute and rate triggers set, either may fire.

    This is also the policy a :class:`~repro_torch.core.tenantclass.
    TenantClassPolicy`'s containment knobs build — per-tenant class
    policies override the manager-global policy in the quarantine poll.
    """

    quarantine_after: Optional[float] = 8
    evict_after: Optional[float] = None
    quarantine_rate: Optional[float] = None
    evict_rate: Optional[float] = None
    min_cycles: int = 4
    weights: Dict[str, float] = dataclasses.field(default_factory=dict)

    def weighted_total(self, counts: Dict[str, int]) -> float:
        return sum(n * self.weights.get(kind, 1.0)
                   for kind, n in counts.items())

    def _rate(self, weighted: float, record: TenantRecord) -> float:
        cycles = max(getattr(record, "cycles_observed", 0),
                     self.min_cycles, 1)
        return weighted / cycles

    def should_quarantine(self, tenant_id, counts, record):
        w = self.weighted_total(counts)
        if self.quarantine_after is not None and w >= self.quarantine_after:
            return True
        return (self.quarantine_rate is not None and w > 0
                and self._rate(w, record) >= self.quarantine_rate)

    def should_evict(self, tenant_id, counts, record):
        w = self.weighted_total(counts)
        if self.evict_after is not None and w >= self.evict_after:
            return True
        return (self.evict_rate is not None and w > 0
                and self._rate(w, record) >= self.evict_rate)


# --------------------------------------------------------------------------- #
# The manager-side driver                                                     #
# --------------------------------------------------------------------------- #


class QuarantineManager:
    """Polls the ViolationLog and applies a policy against a
    :class:`~repro_torch.core.manager.GuardianManager`.

    Polling happens at drain-cycle boundaries (``maybe_poll`` from
    ``run_queued``) — the fused launch path never synchronizes.  A poll is
    skipped outright while the log is clean (no CHECK launch ran), so
    BITWISE/MODULO traffic pays nothing.
    """

    def __init__(self, manager, policy: Optional[QuarantinePolicy] = None,
                 poll_every: int = 1,
                 readmit_after: Optional[int] = None):
        if poll_every < 1:
            raise ValueError("poll_every must be >= 1")
        if readmit_after is not None and readmit_after < 1:
            raise ValueError("readmit_after must be >= 1 (or None)")
        self.manager = manager
        self.policy = policy if policy is not None else ThresholdPolicy()
        self.machine = QuarantineStateMachine()
        self.poll_every = poll_every
        #: automatic readmission probes: a QUARANTINED tenant is
        #: re-admitted after this many clean drain cycles into a
        #: *probation* partition sized by the elastic admission
        #: controller; its first logged violation on probation evicts.
        #: None (default) keeps readmission operator-only.
        self.readmit_after = readmit_after
        self._cycles_since_poll = 0
        self.events: List[str] = []   # human-readable transition trail
        # transition observers: (tenant_id, new_state) callbacks fired on
        # every quarantine/evict/readmit — the hook that propagates
        # manager-side containment into the serving plane (the engine
        # drops the tenant's pending requests and scrubs its pool slots).
        # EVICTED fires *before* partition reclamation so listeners can
        # still read the tenant's bounds.
        self._listeners: List[Callable[[str, TenantState], None]] = []

    # -- registration hooks (called by the manager) --------------------- #
    def admit(self, tenant_id: str) -> None:
        fresh = self.machine.record_of(tenant_id) is None
        rec = self.machine.admit(tenant_id)
        if fresh:
            # rate-based policies measure violations per cycle since
            # admission — stamp the clock on the record's first life
            # (a duplicate registration must not reset a live clock)
            rec.admit_cycle = self.manager.scheduler._cycle

    def forget(self, tenant_id: str) -> None:
        self.machine.forget(tenant_id)

    def check_admission(self, tenant_id: str, api: str = "call") -> None:
        self.machine.check_admission(tenant_id, api)

    def state_of(self, tenant_id: str) -> Optional[TenantState]:
        return self.machine.state_of(tenant_id)

    # -- polling --------------------------------------------------------- #
    def maybe_poll(self) -> None:
        """Cheap cadence gate for the drain loop.  ``dirty`` latches until
        poll() consumes it, so the counter only advances on dirty cycles.
        Readmission probes advance unconditionally — their clock is clean
        cycles, which are exactly the cycles the dirty gate skips."""
        self._advance_probes()
        if not self.manager.violog.dirty:
            return
        self._cycles_since_poll += 1
        if self._cycles_since_poll >= self.poll_every:
            self.poll()

    def _advance_probes(self) -> None:
        """Count QUARANTINED tenants' clean cycles (their ops are dropped,
        so every quarantined cycle is violation-free by construction) and
        probe-readmit those past ``readmit_after``."""
        if self.readmit_after is None:
            return
        for rec in self.machine.records():
            if rec.state is not TenantState.QUARANTINED:
                continue
            rec.clean_cycles += 1
            if rec.clean_cycles >= self.readmit_after:
                self.readmit_probe(rec.tenant_id)

    def readmit_probe(self, tenant_id: str) -> None:
        """Automatic probation readmission: counters wiped like a manual
        readmit, but the tenant comes back into a *probation* partition
        sized by the elastic admission controller (the smallest pow2
        extent holding its live data, floored at the policy minimum) and
        its next logged violation evicts — no second quarantine."""
        self.readmit(tenant_id)
        rec = self.machine.record_of(tenant_id)
        rec.probation = True
        rec.clean_cycles = 0
        elastic = getattr(self.manager, "elastic", None)
        if elastic is not None:
            elastic.apply_probation(tenant_id)
        self.events.append(f"probe-readmit {tenant_id} (probation)")
        self._emit(tenant_id, "probe_readmit")

    def poll(self) -> List[str]:
        """Read the log once and apply the policy.  Returns the tenant ids
        transitioned this poll (quarantined or evicted)."""
        self._cycles_since_poll = 0
        log: ViolationLog = self.manager.violog
        log.dirty = False          # only the poller consumes the flag
        snap = log.snapshot()
        tel = getattr(self.manager, "telemetry", None)
        transitioned: List[str] = []
        for tenant_id in log.tenants():
            rec = self.machine.record_of(tenant_id)
            if rec is None:
                continue
            # refresh the rate clock before the policy reads the record
            # (policies stay pure functions of (counts, record))
            rec.cycles_observed = max(
                self.manager.scheduler._cycle - rec.admit_cycle, 0)
            policy = self.policy_for(tenant_id)
            counts = log.counts(tenant_id, snap=snap)
            if tel is not None and tel.enabled:
                # piggyback on the poll's (already dirty-gated) sync: the
                # registry's violation gauges update only here, never on
                # the launch path
                for kind, n in counts.items():
                    tel.registry.set_gauge(f"violations_{kind}", n,
                                           tenant=tenant_id)
            if (rec.probation and rec.state.admissible
                    and sum(counts.values()) > 0):
                # probation (probe-readmitted) tenants get no second
                # threshold: the first logged violation evicts (via the
                # legal QUARANTINED hop — EVICTED is never entered from
                # an admissible state directly)
                self.quarantine(
                    tenant_id,
                    reason=f"probation violation ({self._fmt(counts)})")
                self.evict(tenant_id, reason="probation violation")
                transitioned.append(tenant_id)
                continue
            if rec.state.admissible and policy.should_quarantine(
                    tenant_id, counts, rec):
                self.quarantine(
                    tenant_id,
                    reason=f"{sum(counts.values())} logged violations "
                           f"({self._fmt(counts)})")
                transitioned.append(tenant_id)
                rec = self.machine.record_of(tenant_id)
            if (rec.state is TenantState.QUARANTINED
                    and policy.should_evict(tenant_id, counts, rec)):
                self.evict(tenant_id)
                transitioned.append(tenant_id)
        return transitioned

    def policy_for(self, tenant_id: str) -> QuarantinePolicy:
        """The policy governing this tenant: a registered
        :class:`~repro_torch.core.tenantclass.TenantClassPolicy` with any
        containment knob set overrides the manager-global policy
        (containment and QoS are configured in one object)."""
        class_of = getattr(self.manager, "class_policy_of", None)
        cp = class_of(tenant_id) if class_of is not None else None
        if cp is not None:
            override = cp.quarantine_policy()
            if override is not None:
                return override
        return self.policy

    @staticmethod
    def _fmt(counts: Dict[str, int]) -> str:
        return " ".join(f"{k}={v}" for k, v in counts.items() if v)

    # -- transition observers -------------------------------------------- #
    def subscribe(self, callback: Callable[[str, TenantState], None]) -> None:
        """Register a transition observer (serving engines, operators).

        ``callback(tenant_id, new_state)`` fires after the state machine
        transitions but — for EVICTED — *before* the partition is
        reclaimed, so the listener can still resolve the tenant's bounds
        (the serve engine scrubs its pool slots with them)."""
        self._listeners.append(callback)

    def _notify(self, tenant_id: str, state: TenantState) -> None:
        for cb in self._listeners:
            cb(tenant_id, state)

    # -- transitions with device-side actions ---------------------------- #
    def quarantine(self, tenant_id: str, reason: str = "") -> None:
        """QUARANTINED: drop queued ops, reject new calls; data survives."""
        rec = self.machine.quarantine(tenant_id, reason=reason)
        rec.clean_cycles = 0            # the probe clock starts now
        self.manager._drop_tenant_ops(tenant_id)
        self.events.append(f"quarantine {tenant_id}: {reason}")
        self._emit(tenant_id, "quarantine", reason=reason)
        self._notify(tenant_id, TenantState.QUARANTINED)

    def evict(self, tenant_id: str, reason: str = "") -> None:
        """EVICTED: scrub + free the partition, purge compiled entries."""
        log: ViolationLog = self.manager.violog
        rec = self.machine.evict(tenant_id, reason=reason)
        rec.probation = False
        if log.row_of(tenant_id) is not None:
            rec.final_counts = log.counts(tenant_id)
        self._notify(tenant_id, TenantState.EVICTED)   # bounds still live
        self.manager._evict_tenant(tenant_id)
        self.events.append(f"evict {tenant_id}")
        self._emit(tenant_id, "evict", reason=reason)
        # an eviction frees slots: the elastic waitlist re-drives admission
        elastic = getattr(self.manager, "elastic", None)
        if elastic is not None:
            elastic.notify_capacity_freed()

    def readmit(self, tenant_id: str) -> None:
        """Back to service.  A QUARANTINED tenant keeps its partition; an
        EVICTED one must register again for a fresh one.  Counters reset —
        re-admission wipes the slate (an operator readmit also clears any
        probation: it is an explicit trust statement)."""
        rec = self.machine.readmit(tenant_id)
        rec.probation = False
        rec.clean_cycles = 0
        # wiped counters restart the rate-based policies' clock too
        rec.admit_cycle = self.manager.scheduler._cycle
        rec.cycles_observed = 0
        self.manager.violog.reset(tenant_id)
        self.events.append(f"readmit {tenant_id}")
        self._emit(tenant_id, "readmit")
        self._notify(tenant_id, TenantState.READMITTED)

    def _emit(self, tenant_id: str, name: str, **args) -> None:
        """Mirror a lifecycle transition into the flight recorder: a
        counter plus a trace event on the tenant's track (host dict
        writes — the poll already synchronized where needed)."""
        tel = getattr(self.manager, "telemetry", None)
        if tel is None or not tel.enabled:
            return
        tel.registry.inc(f"{name}s", tenant=tenant_id)
        tel.event(name, tenant_id,
                  **{k: v for k, v in args.items() if v})

"""Batched multi-tenant launch scheduler — the grdManager's launch
multiplexer (Guardian §4.2.3–§4.2.4).

The scheduler coalesces *compatible* pending launches from different
tenants into one batch per drain cycle:

* Compatibility = same kernel symbol, same fence policy, same operand
  signature (tensor shapes/dtypes + static launch dims); policies never
  mix in one batch (the policy is part of the signature).
* A batch of T sandboxed tenant launches takes one
  :class:`~repro_torch.core.fence.FenceTable` — ``(T, 2)`` int32 ``(base,
  mask)`` rows, or for MODULO the ``(T, 4)`` magic rows ``(base, size, m,
  s)`` — staged on the device once per tenant set.  Row r runs the
  kernel's sandboxed twin fenced with tenant r's own row, so a forged
  index in r's operands only wraps inside r's partition; rows run in
  submission order, each seeing the arena the row before it left.  As
  the reference compiles the T rows into one binary, the port captures
  them into one CUDA graph per (kernel, policy, operand signature, width)
  (:meth:`GuardianManager._launch_compiled`): the fence rows and the
  ViolationLog row ids are staged into the graph at dispatch, so any T
  co-located tenants replay it and a partition the elastic plane moved
  is fenced at its new row.
* CHECK batches attribute faults per row and **commit selectively**:
  each row's fenced stores are logged (:class:`~repro_torch.core.sandbox.
  UndoLog`), a row whose ``ok`` is false has exactly those elements
  restored on the device before the next row runs, and its per-kind
  counts fold into the device-side ViolationLog — no host sync, all
  inside the graph.  A CHECK batch whose kernel carries a fully proven
  *symbolic* bounds proof rides the plain fused path instead
  (``proven_steps``).
* Trusted batches — the serving engines' prefill/decode steps, internally
  fenced multi-row programs — run as the sequential composition of their
  solo steps: row r runs engine r's step, threading the manager arena and
  the shared pool arena row to row, so engine r+1's step sees engine r's
  pool updates exactly as in the per-launch drain.  Only compiled steps
  (``jit_trusted``) fuse; a fused batch runs as one CUDA graph per
  (kernel, operand signature, width) — :mod:`repro_torch.core.stepgraph`.

Fairness: requests are taken strictly in arrival order (the manager's
round-robin cycle order).  A request that cannot join the open batch
head-of-line blocks its tenant — later ops of that tenant never jump the
queue — so per-tenant program order is preserved while unrelated tenants
still fuse.

Cross-cycle lookahead (``lookahead_cycles > 0``): an under-filled fusable
batch may be *held* across drain-cycle flushes so compatible requests
from later cycles can join, under a per-request latency budget of
``lookahead_cycles // tenant_weight`` cycles; the end-of-drain flush
(``drain=True``) executes everything unconditionally, so ``run_queued()``
still returns with every result handle filled.

SLO-aware tenant classes (:mod:`repro_torch.core.tenantclass`) resolve
their hold budget through the class, and a latency-critical tenant whose
EWMA queue age breaches its budget makes the cycle-boundary flush defer
all-best-effort batches.  Tenants without a class policy see exactly the
class-less behaviour.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, \
    Sequence, Set, Tuple

import torch

from repro_torch.core.fence import FencePolicy, FenceTable
from repro_torch.core.pressure import Ewma, derive_lookahead, \
    total_arrival_rate
from repro_torch.core.stepgraph import StepGraph, tree_flatten
from repro_torch.core.telemetry import Histogram, QUEUE_AGE_BOUNDS, \
    SCHEDULER_TRACK


class LRUCache(collections.OrderedDict):
    """Capacity-bounded dict with least-recently-used eviction.

    The jit/symbol caches (per-kernel specializations, fused-step
    binaries) grow one entry per (kernel, signature, width) — unbounded
    under many-kernel churn (ROADMAP: symbol-cache growth).  This keeps
    dict semantics (the purge paths iterate and ``del`` keys) while
    refreshing recency on read and evicting the coldest entry past
    ``capacity``; ``evictions`` counts what was dropped (an evicted
    binary recompiles on next use — a latency blip, never a correctness
    event); ``graph_evictions`` counts the :class:`StepGraph` objects among
    them (dropping one frees its CUDA graph and private memory pool; a
    later call of its key recaptures).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        super().__init__()
        self.capacity = capacity
        self.evictions = 0
        self.graph_evictions = 0

    def __getitem__(self, key):
        val = super().__getitem__(key)
        self.move_to_end(key)
        return val

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self.capacity:
            # not OrderedDict.popitem: its C implementation re-enters the
            # subclass __getitem__ on the already-removed key
            cold = next(iter(self))
            if isinstance(super().__getitem__(cold), StepGraph):
                self.graph_evictions += 1
            super().__delitem__(cold)
            self.evictions += 1


def _leaf_sig(leaf: Any) -> Tuple:
    if isinstance(leaf, torch.Tensor):
        return ("a", tuple(leaf.shape), leaf.dtype)
    return ("v", leaf)


def _arg_signature(args: Sequence[Any]) -> Tuple:
    """Structural signature of post-arena operands: tensors by (shape,
    dtype), static (launch-dim-like) args by value, nested operands (the
    trusted serve steps' params/cache/guard trees) by structure + per-leaf
    signature, so two engines' steps over the same model shape compare
    equal and fuse."""
    sig = []
    for a in args:
        if isinstance(a, torch.Tensor):
            sig.append(("d", tuple(a.shape), a.dtype))
        elif isinstance(a, (bool, int, float, complex, str, bytes,
                            type(None), enum.Enum)):
            sig.append(("s", a))
        else:
            struct, leaves = tree_flatten(a)
            sig.append(("t", struct, tuple(_leaf_sig(l) for l in leaves)))
    return tuple(sig)


@dataclasses.dataclass
class LaunchRequest:
    """One augmented launch, held until the next scheduler flush.

    ``call_args`` are the post-arena operands exactly as the tenant passed
    them (device-staged ptr scalars first, then kernel args); the
    ``(base, mask)`` augmentation happens at fuse/execute time, from the
    tenant's partition then, so the request stays policy- and
    bounds-agnostic until dispatch.
    """

    tenant_id: str
    name: str
    policy: FencePolicy
    entry: Any                      # manager._KernelEntry
    call_args: Tuple
    #: launch output, set at dispatch (the enqueue-path return handle:
    #: callers read it after the drain — how the serving engine gets its
    #: step logits back through the shared scheduler)
    result: Any = dataclasses.field(default=None, repr=False)
    #: trusted entries fuse (set at launch time): a fused trusted batch is
    #: the sequential composition of its rows' solo steps
    trusted_fusable: bool = False
    #: scheduler drain-cycle stamp, set at submit (-1 = never submitted,
    #: i.e. executed directly through the per-launch path)
    submit_cycle: int = dataclasses.field(default=-1, repr=False)

    _sig: Optional[Tuple] = dataclasses.field(default=None, repr=False)

    @property
    def signature(self) -> Tuple:
        if self._sig is None:
            self._sig = (self.name, self.policy, _arg_signature(self.call_args))
        return self._sig

    @property
    def fusable(self) -> bool:
        if getattr(self.entry, "trusted", False):
            return self.trusted_fusable
        return self.policy in (FencePolicy.BITWISE, FencePolicy.CHECK,
                               FencePolicy.MODULO)

    def repolicy(self, policy: FencePolicy) -> None:
        """Re-resolve the fence policy at drain time.  The effective policy
        is snapshotted at enqueue, but the tenant set may change before the
        op is selected (a standalone tenant's NONE-policy launch must not
        execute native once a second tenant shares the arena)."""
        if policy is not self.policy:
            self.policy = policy
            self._sig = None


@dataclasses.dataclass
class SchedulerStats:
    """Throughput counters for the benchmark + fairness tests.

    Counters are exact over the scheduler's lifetime; ``batch_widths``
    keeps only the most recent steps (the scheduler is sized for billions
    of launches — per-step lists must not grow without bound).
    """

    fused_steps: int = 0            # multi-row device dispatches
    single_steps: int = 0           # per-launch (unbatched) dispatches
    batched_launches: int = 0       # launches that rode in fused steps
    check_steps: int = 0            # dispatches through the CHECK commit path
    #: CHECK batches re-routed to the plain fused path because the kernel
    #: carries a fully-proven *symbolic* bounds proof (violations are
    #: statically impossible — no ViolationLog plumbing needed)
    proven_steps: int = 0
    #: arena bytes the CHECK commit path logged for selective rollback —
    #: the elements rows stored, each saved once (a rollback re-reads and
    #: rewrites them); counted from shapes on the host, no sync
    rollback_bytes: int = 0
    max_batch_width: int = 0
    #: launches that fused *across* drain cycles: dispatched in a width>1
    #: step at a later cycle than they were submitted (the lookahead win)
    lookahead_fused: int = 0
    #: all-best-effort batches deferred at a cycle boundary because a
    #: latency-critical tenant's EWMA queue age breached its budget
    be_preemptions: int = 0
    #: queue age (dispatch cycle - submit cycle) summed over dispatched
    #: scheduler launches, + the sample count backing mean_queue_age
    queue_age_sum: int = 0
    age_samples: int = 0
    #: the adaptive scheduler's current cross-cycle budget (0 when
    #: adaptation is off or the scheduler is cold)
    lookahead_budget: int = 0
    batch_widths: Deque[int] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=4096))
    #: per-launch queue ages of the most recent dispatches (latency-budget
    #: tests; bounded like batch_widths)
    queue_ages: Deque[int] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=4096))
    #: fixed-bucket queue-age histogram over the scheduler's LIFETIME
    #: (the deque above keeps only recent samples) — the p50/p90/p99
    #: source for metrics_report and the throughput benchmark.  A few
    #: ints per dispatch: always on, independent of the manager's
    #: telemetry switch.
    queue_age_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(QUEUE_AGE_BOUNDS))
    #: lifetime queue-age histograms split by tenant class (the ROADMAP's
    #: "per-class p50/p99 queue age") — populated only for tenants
    #: registered with a class policy, so a class-less scheduler carries
    #: an empty dict and pays nothing
    class_queue_age: Dict[str, Histogram] = dataclasses.field(
        default_factory=dict)

    @property
    def total_launches(self) -> int:
        return self.batched_launches + self.single_steps

    @property
    def device_steps(self) -> int:
        return self.fused_steps + self.single_steps

    @property
    def mean_batch_width(self) -> float:
        """Exact lifetime mean width of fused steps (singles excluded)."""
        return self.batched_launches / self.fused_steps \
            if self.fused_steps else 0.0

    @property
    def launches_per_step(self) -> float:
        """Mean launches per device dispatch over ALL steps (the batching
        win the benchmark gates on).  A fresh scheduler has dispatched
        nothing — report 0.0 rather than dividing by zero."""
        return self.total_launches / self.device_steps \
            if self.device_steps else 0.0

    @property
    def fused_fraction(self) -> float:
        """Share of launches that rode in fused steps (0.0 when idle)."""
        return self.batched_launches / self.total_launches \
            if self.total_launches else 0.0

    @property
    def mean_queue_age(self) -> float:
        """Mean drain cycles a launch waited before dispatch (0.0 when
        idle or when every launch dispatched in its submission cycle —
        the no-lookahead invariant)."""
        return self.queue_age_sum / self.age_samples \
            if self.age_samples else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "total_launches": float(self.total_launches),
            "device_steps": float(self.device_steps),
            "fused_steps": float(self.fused_steps),
            "check_steps": float(self.check_steps),
            "proven_steps": float(self.proven_steps),
            "mean_batch_width": self.mean_batch_width,
            "max_batch_width": float(self.max_batch_width),
            "launches_per_step": self.launches_per_step,
            "fused_fraction": self.fused_fraction,
            "lookahead_fused": float(self.lookahead_fused),
            "mean_queue_age": self.mean_queue_age,
            "lookahead_budget": float(self.lookahead_budget),
            "be_preemptions": float(self.be_preemptions),
        }

    def queue_age_percentiles(
            self, qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
        """p50/p90/p99 queue age in drain cycles, from the lifetime
        histogram (the ROADMAP's "per-class p50/p99 queue age" — the
        deque-backed mean alone cannot answer tail-latency questions).
        Zeros when nothing has dispatched."""
        return self.queue_age_hist.percentiles(qs)

    def queue_age_percentiles_by_class(
            self, qs: Sequence[float] = (50, 90, 99)
    ) -> Dict[str, Dict[str, float]]:
        """Per-tenant-class queue-age percentiles (empty for a class-less
        scheduler) — the reference's SLO-isolation benchmark gate source."""
        return {cls: h.percentiles(qs)
                for cls, h in sorted(self.class_queue_age.items())}


class BatchedLaunchScheduler:
    """Coalesces pending cross-tenant launches into fused device steps.

    Owned by a :class:`~repro_torch.core.manager.GuardianManager`; the manager
    submits augmented :class:`LaunchRequest`s during its round-robin drain
    cycle and flushes at the end of each cycle.
    """

    def __init__(self, manager, max_fuse: int = 8,
                 lookahead_cycles: int = 0,
                 fused_cache_capacity: int = 128,
                 adaptive_lookahead: bool = False,
                 adaptive_lookahead_cap: int = 8):
        if max_fuse < 1:
            raise ValueError("max_fuse must be >= 1")
        if lookahead_cycles < 0:
            raise ValueError("lookahead_cycles must be >= 0")
        if adaptive_lookahead_cap < 0:
            raise ValueError("adaptive_lookahead_cap must be >= 0")
        self.manager = manager
        self.max_fuse = max_fuse
        #: cross-cycle latency budget: an under-filled fusable batch may
        #: be held up to this many drain cycles (scaled down by the
        #: tenants' weights) waiting for compatible requests; 0 restores
        #: the flush-every-cycle behaviour exactly
        self.lookahead_cycles = lookahead_cycles
        #: adaptive mode (ROADMAP: budget from observed arrival rates):
        #: when the static knob is 0, the effective budget is derived per
        #: cycle from per-tenant EWMA arrival rates —
        #: ``ceil((max_fuse - 1) / total_rate)`` clamped to the cap (see
        #: pressure.derive_lookahead).  A nonzero ``lookahead_cycles``
        #: overrides adaptation entirely (the static knob wins).
        self.adaptive_lookahead = adaptive_lookahead
        self.adaptive_lookahead_cap = adaptive_lookahead_cap
        self._arrival_ewma: Dict[str, Ewma] = {}
        self._cycle_arrivals: Dict[str, int] = {}
        self._adaptive_budget = 0
        #: arrival-rate EWMAs update when *any* consumer needs them:
        #: adaptive lookahead, compute-aware admission
        #: (ElasticPolicy.compute_watermark), or a registered tenant
        #: class — see enable_arrival_tracking().  Off by default so a
        #: consumer-less scheduler's flush stays byte-identical.
        self._track_arrivals = adaptive_lookahead
        # -- tenant-class state (inert until a class policy registers) --
        #: per-tenant queue-age EWMA, one sample per drain cycle (the max
        #: age the tenant dispatched or still holds) — the signal
        #: best-effort preemption compares against LC budgets
        self._qage_ewma: Dict[str, Ewma] = {}
        #: max dispatched queue age per classed tenant *this flush*
        self._flush_max_age: Dict[str, int] = {}
        #: latched per flush: defer all-best-effort batches this cycle
        self._preempting = False
        #: latched per flush: any class-policied tenant registered
        self._class_tracking = False
        self._cycle = 0
        self._pending: List[LaunchRequest] = []
        # (name, policy, arg-sig, T, resident operands) -> fused tenant
        # StepGraph, and ("trusted", name, policy, arg-sig, T, resident
        # operands) -> fused trusted StepGraph; LRU-bounded (one graph per
        # signature×width)
        self._fused_cache: Dict[Tuple, Callable] = LRUCache(
            fused_cache_capacity)
        # ((base, mask), ...) -> device-staged FenceTable (re-staging the
        # same tenant set's rows every flush costs a host->device put);
        # LRU-bounded — compositions are combinatorial in the tenants
        self._table_cache: Dict[Tuple, FenceTable] = LRUCache(512)
        # (tenant_id, ...) -> device-staged ViolationLog row ids of a CHECK
        # batch (invalidated when a tenant's log row is recycled)
        self._vrow_cache: Dict[Tuple[str, ...], torch.Tensor] = LRUCache(
            512)
        self.stats = SchedulerStats()
        # tenant ids of the most recent device steps, in dispatch order
        # (fairness tests / debugging; bounded — see SchedulerStats)
        self.dispatch_log: Deque[Tuple[str, ...]] = collections.deque(
            maxlen=4096)
        # cached flight-recorder histogram handles (tenant -> queue-age
        # hist, plus the global fused-width hist) — the per-launch record
        # paths observe through these instead of paying the registry
        # lookup per sample; re-resolved when registry.epoch moves
        # (forget_tenant)
        self._tel_hists: Dict[str, Histogram] = {}
        self._tel_width_hist: Optional[Histogram] = None
        self._tel_epoch = -1

    def _tel_registry(self):
        """The enabled flight recorder's registry (or None), with the
        cached histogram handles invalidated on epoch change."""
        tel = getattr(self.manager, "telemetry", None)
        if tel is None or not tel.enabled:
            return None
        reg = tel.registry
        if not reg.enabled:        # registry toggled off independently
            return None
        if reg.epoch != self._tel_epoch:
            self._tel_hists.clear()
            self._tel_width_hist = None
            self._tel_epoch = reg.epoch
        return reg

    # ------------------------------------------------------------------ #
    def submit(self, req: LaunchRequest) -> None:
        req.submit_cycle = self._cycle
        if self._track_arrivals:
            self._cycle_arrivals[req.tenant_id] = \
                self._cycle_arrivals.get(req.tenant_id, 0) + 1
        self._pending.append(req)

    def enable_arrival_tracking(self) -> None:
        """Turn on per-tenant arrival-rate EWMAs (idempotent).  Called by
        the manager when a consumer beyond adaptive lookahead appears: a
        tenant registers with a class policy, or the elastic policy sets
        ``compute_watermark``.  Tracking alone never changes scheduling —
        the adaptive budget is only derived when ``adaptive_lookahead``
        is set (the class-less bit-identical guarantee)."""
        self._track_arrivals = True

    def arrival_rate_total(self) -> float:
        """EWMA total arrivals per drain cycle across tenants — the
        compute-pressure signal elastic admission compares against
        ``ElasticPolicy.compute_watermark``.  0.0 while tracking is off
        or cold."""
        return total_arrival_rate(self._arrival_ewma.values())

    @property
    def current_lookahead(self) -> int:
        """The effective cross-cycle budget this drain cycle: the static
        knob when set, else the arrival-rate-derived adaptive budget."""
        if self.lookahead_cycles > 0 or not self.adaptive_lookahead:
            return self.lookahead_cycles
        return self._adaptive_budget

    def _update_arrival_rates(self) -> None:
        """End-of-cycle EWMA update over this cycle's submissions (every
        known tenant decays with an explicit 0 on idle cycles, so a
        burst's influence fades) + re-derivation of the adaptive
        budget."""
        for t in set(self._arrival_ewma) | set(self._cycle_arrivals):
            ew = self._arrival_ewma.get(t)
            if ew is None:
                ew = self._arrival_ewma[t] = Ewma(alpha=0.5)
            ew.update(self._cycle_arrivals.get(t, 0))
        self._cycle_arrivals.clear()
        if not self.adaptive_lookahead:
            # tracking serves compute-aware admission / class telemetry
            # only: the budget (and its stats mirror) must stay untouched
            return
        self._adaptive_budget = derive_lookahead(
            (ew.value for ew in self._arrival_ewma.values()),
            self.max_fuse, self.adaptive_lookahead_cap)
        self.stats.lookahead_budget = self._adaptive_budget

    @property
    def pending(self) -> int:
        return len(self._pending)

    def drop_tenant(self, tenant_id: str) -> int:
        """Discard a tenant's not-yet-dispatched requests (quarantine path).
        Returns how many were dropped."""
        kept = [r for r in self._pending if r.tenant_id != tenant_id]
        dropped = len(self._pending) - len(kept)
        self._pending = kept
        return dropped

    def invalidate_tenant_rows(self, tenant_id: str) -> None:
        """Forget a departing tenant: staged row-id vectors naming it (its
        ViolationLog row is being recycled), its arrival rate (a departed
        tenant must not keep inflating the adaptive budget) and its
        queue-age EWMA (a departed LC tenant must not keep preempting
        best-effort co-tenants)."""
        for key in [k for k in self._vrow_cache if tenant_id in k]:
            del self._vrow_cache[key]
        self._arrival_ewma.pop(tenant_id, None)
        self._cycle_arrivals.pop(tenant_id, None)
        self._qage_ewma.pop(tenant_id, None)
        self._flush_max_age.pop(tenant_id, None)

    def invalidate_table_rows(self, bounds: Tuple[int, int]) -> None:
        """Drop staged FenceTables referencing a dead partition's
        ``(base, mask)`` — called by the manager on partition
        reclamation."""
        for key in [k for k in self._table_cache if bounds in k[0]]:
            del self._table_cache[key]

    def flush(self, drain: bool = True) -> None:
        """Coalesce and execute pending requests, oldest first.

        ``drain=False`` is the manager's cycle-boundary flush under
        lookahead: an under-filled fusable batch whose members still have
        latency budget (see ``lookahead_cycles``) is **held** so
        compatible requests from later drain cycles can join.  A held
        tenant head-of-line blocks its own later requests for the rest of
        the flush (program order), but unrelated tenants keep executing.
        ``drain=True`` (the end-of-drain flush, and the only mode when
        lookahead is off) executes everything unconditionally, so
        ``run_queued()`` always returns with every result handle filled.

        Tenant classes add one more cycle-boundary decision: when a
        latency-critical tenant's EWMA queue age has breached its budget
        (:meth:`_lc_budget_breached`, computed from signals through the
        *previous* cycle — preemption is decided at the boundary, never
        mid-flush), every all-best-effort batch is deferred like a
        lookahead hold.  ``drain=True`` ignores preemption entirely: a
        drain's final flush fills every result handle, class or no
        class.
        """
        if self._track_arrivals:
            # fold this cycle's arrivals into the EWMA before deciding
            # holds: the budget always reflects traffic through *this*
            # cycle (deterministic — mirrored in tests/test_scheduler.py)
            self._update_arrival_rates()
        self._class_tracking = self.manager.has_class_tenants
        self._preempting = (self._class_tracking and not drain
                            and self._lc_budget_breached())
        if self._class_tracking:
            self._flush_max_age.clear()
        work, self._pending = self._pending, []
        held: List[LaunchRequest] = []
        blocked: Set[str] = set()
        while work:
            # requests of held tenants defer in submission order
            while work and work[0].tenant_id in blocked:
                held.append(work.pop(0))
            if not work:
                break
            batch, work = self._take_batch(work, blocked)
            preempt = self._preempting and self._all_best_effort(batch)
            if not drain and (preempt or self._should_hold(batch)):
                held.extend(batch)
                blocked.update(r.tenant_id for r in batch)
                if preempt:
                    self.stats.be_preemptions += 1
                tel = getattr(self.manager, "telemetry", None)
                if tel is not None and tel.enabled:
                    name = "be_preempt" if preempt else "lookahead_hold"
                    tel.registry.inc(
                        "be_preemptions" if preempt else "lookahead_holds")
                    tel.event(name, SCHEDULER_TRACK,
                              width=len(batch),
                              tenants=",".join(r.tenant_id for r in batch))
            else:
                self._execute(batch)
        self._pending = held
        if self._class_tracking:
            self._observe_class_queue_ages(held)
        self._cycle += 1

    # ------------------------------------------------------------------ #
    def _take_batch(
        self, pending: List[LaunchRequest],
        blocked: Iterable[str] = (),
    ) -> Tuple[List[LaunchRequest], List[LaunchRequest]]:
        """Oldest request opens the batch; later compatible requests join
        unless their tenant is head-of-line blocked (an earlier op of the
        same tenant was deferred — joining would reorder that tenant).
        ``blocked`` seeds the block set (tenants already held by the
        lookahead pass this flush)."""
        head = pending[0]
        batch = [head]
        rest: List[LaunchRequest] = []
        blocked = set(blocked)
        for req in pending[1:]:
            if (head.fusable and req.fusable
                    and len(batch) < self.max_fuse
                    and req.tenant_id not in blocked
                    and req.signature == head.signature):
                batch.append(req)
            else:
                rest.append(req)
                blocked.add(req.tenant_id)
        return batch, rest

    def _should_hold(self, batch: List[LaunchRequest]) -> bool:
        """Cross-cycle lookahead policy: hold an under-filled fusable
        batch while every member still has latency budget (see
        :meth:`_hold_budget`).  A priority tenant's op in the batch
        shrinks the whole batch's wait, so a batch containing a
        zero-budget tenant always dispatches in its submission cycle
        (lookahead can never starve it)."""
        if self.current_lookahead <= 0 or len(batch) >= self.max_fuse:
            return False
        if not batch[0].fusable:
            return False
        budget = min(self._hold_budget(r.tenant_id) for r in batch)
        if budget <= 0:
            return False
        oldest = max(self._cycle - r.submit_cycle for r in batch)
        return oldest < budget

    def _hold_budget(self, tenant_id: str) -> int:
        """Max drain cycles a tenant's op may wait for a fuller batch:
        ``lookahead // weight`` for best-effort tenants, forced to 0 once
        a *priority* tenant (weight > 1) reaches ``weight >= lookahead``
        — without the cutoff, ``weight == lookahead`` would leave a
        budget of 1 and a documented-zero-latency tenant could still
        wait one cycle.  Weight-1 tenants always keep the full budget
        (they are the ones lookahead exists for).  ``lookahead`` is the
        *effective* budget — the static knob, or the adaptive
        arrival-rate derivation when the knob is 0.

        A classed tenant resolves ``lookahead`` through its
        :class:`~repro_torch.core.tenantclass.TenantClassPolicy` first
        (per-class override, capped at the SLO budget for
        latency-critical tenants) before the weight math applies; a
        class-less tenant sees exactly the pre-class arithmetic."""
        cp = self.manager.class_policy_of(tenant_id)
        look = (cp.hold_budget(self.current_lookahead)
                if cp is not None else self.current_lookahead)
        w = max(self.manager.weight_of(tenant_id), 1)
        if w == 1:
            return look
        if w >= look:
            return 0
        return look // w

    # -- tenant-class machinery (inert while no tenant is classed) ------ #
    def _lc_budget_breached(self) -> bool:
        """True when any latency-critical tenant's EWMA queue age has
        reached its SLO budget — the signal that arms best-effort
        preemption for this flush.  The EWMA must hold a *positive*
        observation: a budget of 0 means zero tolerance for any queueing,
        not a standing veto while every observed age is 0 (which would
        starve best-effort tenants forever)."""
        for tid, cp in self.manager.class_policies().items():
            if not cp.is_latency_critical:
                continue
            ew = self._qage_ewma.get(tid)
            if (ew is not None and ew.samples and ew.value > 0
                    and ew.value >= cp.queue_age_budget):
                return True
        return False

    def _all_best_effort(self, batch: List[LaunchRequest]) -> bool:
        """Preemption only defers batches made *entirely* of best-effort
        ops — a mixed batch carries latency-critical work and must not
        wait on its co-members' account."""
        for r in batch:
            cp = self.manager.class_policy_of(r.tenant_id)
            if cp is None or not cp.is_best_effort:
                return False
        return True

    def _observe_class_queue_ages(self, held: List[LaunchRequest]) -> None:
        """One EWMA sample per classed tenant per flush: the max of the
        ages it dispatched this flush and the current ages of its ops
        still held at flush end, else 0.  The explicit 0 on idle/fully-
        dispatched cycles makes the signal *decay* — a latency-critical
        tenant that went quiet (or departed mid-breach, see
        :meth:`invalidate_tenant_rows`) releases best-effort preemption
        instead of pinning it forever."""
        held_age: Dict[str, int] = {}
        for r in held:
            if r.submit_cycle >= 0:
                age = self._cycle - r.submit_cycle
                if age > held_age.get(r.tenant_id, -1):
                    held_age[r.tenant_id] = age
        for tid, cp in self.manager.class_policies().items():
            sample = max(self._flush_max_age.get(tid, 0),
                         held_age.get(tid, 0))
            ew = self._qage_ewma.get(tid)
            if ew is None:
                ew = self._qage_ewma[tid] = Ewma(cp.ewma_alpha)
            ew.update(sample)

    # ------------------------------------------------------------------ #
    def _execute(self, batch: List[LaunchRequest]) -> None:
        self.dispatch_log.append(tuple(r.tenant_id for r in batch))
        tel = getattr(self.manager, "telemetry", None)
        if tel is not None and not tel.enabled:
            tel = None
        # cached per-tenant histogram handles: this loop is per-launch
        # on the fused drain (telemetry.overhead bench row)
        reg = self._tel_registry() if tel is not None else None
        hists = self._tel_hists if reg is not None else None
        flushed_held = False
        for r in batch:
            if r.submit_cycle >= 0:
                age = self._cycle - r.submit_cycle
                self.stats.queue_age_sum += age
                self.stats.age_samples += 1
                self.stats.queue_ages.append(age)
                self.stats.queue_age_hist.observe(age)
                if hists is not None:
                    h = hists.get(r.tenant_id)
                    if h is None:
                        h = hists[r.tenant_id] = reg.hist(
                            "queue_age_cycles", r.tenant_id)
                    h.observe(age)
                if self._class_tracking:
                    cp = self.manager.class_policy_of(r.tenant_id)
                    if cp is not None:
                        cls = cp.tenant_class.value
                        ch = self.stats.class_queue_age.get(cls)
                        if ch is None:
                            ch = self.stats.class_queue_age[cls] = \
                                Histogram(QUEUE_AGE_BOUNDS)
                        ch.observe(age)
                        if hists is not None:
                            key = "class:" + cls
                            h = hists.get(key)
                            if h is None:
                                h = hists[key] = reg.hist(
                                    "queue_age_cycles", key)
                            h.observe(age)
                        if age > self._flush_max_age.get(r.tenant_id, -1):
                            self._flush_max_age[r.tenant_id] = age
                if age > 0 and len(batch) > 1:
                    self.stats.lookahead_fused += 1
                    flushed_held = True
        if flushed_held and tel is not None and tel.enabled:
            # a held batch finally dispatching — the lookahead payoff
            tel.event("lookahead_flush", SCHEDULER_TRACK,
                      width=len(batch),
                      tenants=",".join(r.tenant_id for r in batch))
        if getattr(batch[0].entry, "trusted", False):
            # internally-fenced engine step: width-N batches run as the
            # sequential composition of their rows' solo steps
            self._execute_trusted(batch)
            return
        if batch[0].policy is FencePolicy.CHECK:
            # A fully proven *symbolic* bounds proof holds for every
            # partition: no access can stray, so the CHECK plumbing (ok
            # predicates, ViolationLog attribution, selective commit) is
            # dead weight — ride the plain fused path instead.
            head = batch[0]
            proof = self.manager.symbolic_proof(
                head.entry, head.call_args, arg_sig=head.signature[2])
            if proof is not None:
                self.stats.proven_steps += 1
                if tel is not None and tel.enabled:
                    tel.registry.inc("proven_steps")
                    tel.event("proven_step", SCHEDULER_TRACK,
                              kernel=head.name, width=len(batch))
                for r in batch:
                    r.repolicy(FencePolicy.BITWISE)
            else:
                # CHECK always takes the attributing commit path (any
                # width): a width-1 CHECK step contains and logs, it does
                # not raise, so its semantics match the fused case
                self._execute_check(batch)
                return
        if len(batch) == 1:
            self.stats.single_steps += 1
            self.manager._execute_request(batch[0])
            return

        mgr = self.manager
        T = len(batch)
        head = batch[0]
        modulo = head.policy is FencePolicy.MODULO
        table = self._staged_table(batch, with_magic=modulo)
        build = self._build_fused_modulo if modulo else self._build_fused
        t0 = time.perf_counter_ns()
        _, outs = mgr._launch_compiled(
            self._fused_cache, (*head.signature, T), self._name(head, T),
            lambda: build(head.entry, head.signature[2], T),
            (mgr.arena.buf,),
            (table.magic if modulo else table.rows, *self._flat_dyn(batch)))
        mgr.launch_stats.dispatch_ns.append(time.perf_counter_ns() - t0)
        for req, out in zip(batch, outs):
            req.result = out
        self._record_step(T)

    @staticmethod
    def _name(head: LaunchRequest, T: int) -> str:
        return f"{head.name} [{head.policy.value}] x{T}"

    @staticmethod
    def _flat_dyn(batch: List[LaunchRequest]) -> List[torch.Tensor]:
        """The rows' tensor operands, in order (launch dimensions are in
        the signature)."""
        return [a for req in batch for a in req.call_args
                if isinstance(a, torch.Tensor)]

    def _staged_table(self, batch: List[LaunchRequest],
                      with_magic: bool = False) -> FenceTable:
        """The batch's fence rows, from each tenant's partition at
        dispatch (one the elastic plane resized while the launch waited
        is fenced at its new row)."""
        parts = [self.manager.bounds.lookup(r.tenant_id) for r in batch]
        key = (tuple((p.base, p.mask) for p in parts), with_magic)
        table = self._table_cache.get(key)
        if table is None:
            table = FenceTable.from_partitions(
                parts, with_magic=with_magic, device=self.manager.device)
            self._table_cache[key] = table
        return table

    def _staged_vrows(self, batch: List[LaunchRequest]) -> torch.Tensor:
        key = tuple(r.tenant_id for r in batch)
        vrows = self._vrow_cache.get(key)
        if vrows is None:
            vrows = torch.tensor(
                [self.manager.violog.assign(r.tenant_id) for r in batch],
                dtype=torch.int64, device=self.manager.device)
            self._vrow_cache[key] = vrows
        return vrows

    def _record_step(self, T: int) -> None:
        reg = self._tel_registry()
        if reg is not None:
            h = self._tel_width_hist
            if h is None:
                h = self._tel_width_hist = reg.hist("fused_step_width")
            h.observe(T)
        if T == 1:
            self.stats.single_steps += 1
            return
        self.stats.fused_steps += 1
        self.stats.batched_launches += T
        self.stats.max_batch_width = max(self.stats.max_batch_width, T)
        self.stats.batch_widths.append(T)

    # ------------------------------------------------------------------ #
    def _execute_trusted(self, batch: List[LaunchRequest]) -> None:
        """Trusted (framework-plane) dispatch.  Width 1 goes through the
        manager's per-launch path (compiled there under ``jit_trusted``);
        width N — only compiled steps fuse — runs every engine's step in
        submission order as one compiled step: one CUDA graph per
        (trusted kernel, operand signature, width), keyed besides by the
        identity of every row's resident operands (two engines with equal
        shapes and different weights never share a graph).  The arena
        threads through rows untouched (trusted steps carry their own
        internal fences), so the fused step is exactly the sequential
        composition of the solo steps."""
        mgr = self.manager
        T = len(batch)
        if T == 1:
            self.stats.single_steps += 1
            mgr._execute_request(batch[0])
            return
        head = batch[0]
        entry = head.entry
        ops = mgr._trusted_operands(entry, [r.call_args for r in batch])
        key = ("trusted", *head.signature, T, ops.key())
        graph = self._fused_cache.get(key)
        if graph is None:
            if entry.verify:
                # the fused step composes solo steps of this one signature
                # in sequence: the solo proof covers it
                mgr._verify_trusted(entry, head.call_args, head.signature[2])
            graph = mgr._step_graph(
                f"{entry.name} x{T}",
                self._build_fused_trusted(entry, len(head.call_args), T), ops)
            self._fused_cache[key] = graph
        t0 = time.perf_counter_ns()
        res = mgr._run_compiled(graph, ops, mgr._trusted_resident(entry))
        if entry.pool_arena is None:
            new_arena, outs = res
        else:
            new_arena, mgr.arenas[entry.pool_arena].buf, outs = res
        mgr.arena.buf = new_arena
        mgr.launch_stats.dispatch_ns.append(time.perf_counter_ns() - t0)
        for req, out in zip(batch, outs):
            req.result = out
        self._record_step(T)

    def _build_fused_trusted(self, entry, n_args: int, T: int) -> Callable:
        """The width-T composition a fused graph records: rows execute in
        submission order, threading the arena — and the entry's pool
        arena, when declared — row to row, so engine r+1's step sees
        engine r's pool updates exactly as in the per-launch drain.  Its
        arguments are the arena (and pool), then the rows' call arguments
        one after the other."""
        def rows(flat):
            return [flat[r * n_args:(r + 1) * n_args] for r in range(T)]

        if entry.pool_arena is None:
            def fused(arena, *flat):
                outs = []
                for row in rows(flat):
                    arena, out = entry.fn(arena, *row)
                    outs.append(out)
                return arena, tuple(outs)
        else:
            def fused(arena, pool, *flat):
                outs = []
                for row in rows(flat):
                    arena, pool, out = entry.fn(arena, pool, *row)
                    outs.append(out)
                return arena, pool, tuple(outs)
        return fused

    # ------------------------------------------------------------------ #
    def _execute_check(self, batch: List[LaunchRequest]) -> None:
        """CHECK-mode dispatch with per-row attribution + selective
        commit: every row's checked twin runs with an undo log, a row whose
        ``ok`` is false has its stores restored before the next row runs,
        and each row's per-kind violation counts fold into the manager's
        device-side ViolationLog — one compiled step, no host sync (the
        QuarantineManager polls the log at cycle boundaries).  The log
        buffer is resident; the rows' fence rows and log row ids are
        staged."""
        mgr = self.manager
        T = len(batch)
        head = batch[0]
        t0 = time.perf_counter_ns()
        # a kernel whose rollback saves the partition (a while or a cond
        # that stores) keys the rows' partition sizes by value
        spans = tuple(mgr.bounds.lookup(r.tenant_id).size for r in batch) \
            if mgr._saves_partition(head) else None
        _, _, (outs, rollback_bytes) = mgr._launch_compiled(
            self._fused_cache, (*head.signature, T, spans),
            self._name(head, T),
            lambda: self._build_fused_check(head.entry, head.signature[2],
                                            T, spans),
            (mgr.arena.buf, mgr.violog.buf),
            (self._staged_table(batch).rows, self._staged_vrows(batch),
             *self._flat_dyn(batch)))
        mgr.violog.dirty = True
        mgr.launch_stats.dispatch_ns.append(time.perf_counter_ns() - t0)
        for req, out in zip(batch, outs):
            req.result = out
        self.stats.rollback_bytes += rollback_bytes
        self.stats.check_steps += 1
        self._record_step(T)

    @staticmethod
    def _rows_of(arg_sig: Tuple, T: int, flat_dyn: Sequence[Any]):
        """Each row's call operands: its tensors from ``flat_dyn`` in
        order, launch dimensions from the signature."""
        n_dyn = sum(1 for kind, *_ in arg_sig if kind == "d")
        for r in range(T):
            row_dyn = iter(flat_dyn[r * n_dyn:(r + 1) * n_dyn])
            yield r, [next(row_dyn) if kind == "d" else spec[0]
                      for kind, *spec in arg_sig]

    def _build_fused_check(self, entry, arg_sig: Tuple, T: int,
                           spans: Optional[Tuple[int, ...]] = None
                           ) -> Callable:
        """CHECK twin of :meth:`_build_fused`: rows carry dynamic ``(base,
        size)`` bounds and commit selectively — an offending row's stores
        are undone before the next row sees the arena, so co-tenant rows
        land exactly as in their standalone runs.  Returns ``(arena,
        violog, (outs, rollback bytes))``; the bytes the rows logged follow
        from the shapes alone, so a replay returns the capture's count."""
        rows_of = self._rows_of

        def fused(arena, violog, rows, vrows, *flat_dyn):
            outs, logged = [], 0
            for r, call in rows_of(arg_sig, T, flat_dyn):
                (arena, out), ok, counts, nbytes = entry.checked_dyn(
                    arena, rows[r, 0], rows[r, 1] + 1, *call,
                    span=None if spans is None else spans[r])
                logged += nbytes
                # counts are nonzero exactly where ok is false — fold
                # unconditionally (in-bounds rows add zeros)
                violog.index_add_(0, vrows[r:r + 1],
                                  counts.to(violog.device).view(1, -1))
                outs.append(out)
            return arena, violog, (tuple(outs), logged)

        return fused

    def _build_fused(self, entry, arg_sig: Tuple, T: int) -> Callable:
        """One fused step per (kernel, operand signature, width): the
        ``(base, mask)`` rows are dynamic operands, so any T co-located
        tenants share it; rows run in submission order, threading the
        arena."""
        rows_of = self._rows_of

        def fused(arena, rows, *flat_dyn):
            outs = []
            for r, call in rows_of(arg_sig, T, flat_dyn):
                arena, out = entry.fenced_dyn(arena, rows[r, 0], rows[r, 1],
                                              *call)
                outs.append(out)
            return arena, tuple(outs)

        return fused

    def _build_fused_modulo(self, entry, arg_sig: Tuple, T: int) -> Callable:
        """MODULO twin of :meth:`_build_fused`: rows come from the magic
        row table — ``(base, size, m, s)`` per tenant — so the reciprocal
        division runs with dynamic constants, bit-identical to the
        per-launch path's static per-partition twin."""
        rows_of = self._rows_of

        def fused(arena, magic_rows, *flat_dyn):
            outs = []
            for r, call in rows_of(arg_sig, T, flat_dyn):
                m = magic_rows[r]
                arena, out = entry.modulo_dyn(arena, m[0], m[1], m[2], m[3],
                                              *call)
                outs.append(out)
            return arena, tuple(outs)

        return fused


def round_robin_interleave(
    by_tenant: Dict[str, List[Any]], limit: Optional[int] = None,
    weights: Optional[Dict[str, int]] = None,
) -> List[Any]:
    """Weighted round-robin interleave across per-tenant FIFO queues — the
    drain-cycle selection order of §4.2.4, factored out so the serving
    engine's batch-row assignment and the manager's queue drain share one
    fairness policy.  Tenants are visited in sorted-id order; each cycle
    takes up to ``weights[t]`` items per tenant (default 1 — strict
    round-robin); ``limit`` caps the result.
    """
    queues = {t: list(q) for t, q in sorted(by_tenant.items()) if q}
    weights = weights or {}
    order: List[Any] = []
    while queues and (limit is None or len(order) < limit):
        for t in sorted(queues):
            for _ in range(min(max(weights.get(t, 1), 1), len(queues[t]))):
                if limit is not None and len(order) >= limit:
                    break
                order.append(queues[t].pop(0))
            if not queues[t]:
                del queues[t]
    return order

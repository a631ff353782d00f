"""GuardianManager — the ``grdManager`` analogue (Guardian §4.2).

The manager is the **only entity with device access**: it owns the arena
tensors (on its ``device``), the partition bounds table, and the symbol
table of registered kernels.  Tenants reach it exclusively through
:class:`~repro_torch.core.interception.GuardianClient`.

Responsibilities (paper section in parentheses):

* **Memory partitioning** (§4.2.1): buddy-allocated pow2 partitions out of
  the reserved arena; per-tenant intra-partition allocator serves malloc().
* **Transfer validation** (§4.2.2): every host-initiated copy is checked
  against the bounds table; violations raise :class:`GuardianViolation`
  without touching the device.
* **Kernel invocation** (§4.2.3): ``pointer_to_symbol`` maps kernel name →
  entry.  A tenant kernel (:meth:`GuardianManager.register_kernel`) is a
  plain PyTorch function over the arena; the sandboxer
  (:mod:`repro_torch.core.sandbox`) traces it into an aten graph and runs
  it with every arena access fenced — the launch is *augmented* with the
  partition's ``(base, mask)`` scalars — or natively when the tenant runs
  standalone.  *Trusted* kernels — framework-plane steps such as the
  serving engine's prefill/decode, internally fenced per row from
  :meth:`GuardianManager.fence_table` — run as they are, compiled into
  one CUDA graph per (step, operand signature, width) under
  ``jit_trusted`` (:mod:`repro_torch.core.stepgraph`).
* **Spatial multiplexing** (§4.2.4): per-tenant queues drained
  round-robin; the selected launches go to the
  :class:`BatchedLaunchScheduler`, which coalesces compatible launches of
  different tenants into one batch per cycle (per-row fence rows from a
  :class:`FenceTable`; CHECK rows commit selectively).  Every tenant
  launch on the card — a per-launch twin or a fused batch — replays one
  CUDA graph per (kernel, policy, operand signature, width), as the
  reference runs each through ``jax.jit``: its fence rows, row scalars
  and log row ids are staged into the graph at dispatch, never frozen.
* **Fault containment**: a device-side per-tenant
  :class:`~repro_torch.core.violations.ViolationLog` polled by the
  :class:`~repro_torch.core.quarantine.QuarantineManager` at drain-cycle
  boundaries drives the tenant lifecycle (ACTIVE → QUARANTINED → EVICTED |
  READMITTED); eviction scrubs and frees the partition.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import enum
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.arena import Arena, ArenaSpec, PoolArena, \
    make_flat_arena
from repro_torch.core.elastic import ElasticManager, ElasticPolicy
from repro_torch.core.fence import FenceParams, FencePolicy, FenceTable, \
    require_pow2_sizes
from repro_torch.core.interception import DevicePtr, GuardianClient
from repro_torch.core.partition import (
    IntraPartitionAllocator,
    OutOfArenaMemory,
    Partition,
    PartitionBoundsTable,
    UnknownTenant,
)
from repro_torch.core.quarantine import (
    QuarantineError,
    QuarantineManager,
    QuarantinePolicy,
)
from repro_torch.core.sandbox import UndoLog, sandbox
from repro_torch.core.scheduler import (
    BatchedLaunchScheduler,
    LaunchRequest,
    LRUCache,
    _arg_signature,
)
from repro_torch.core.stepgraph import GraphMaker, Operands, \
    StepCaptureError, StepGraph, tree_flatten, tree_unflatten
from repro_torch.core.telemetry import DRAIN_TRACK, Telemetry
from repro_torch.core.tenantclass import ClassSpec, TenantClassPolicy, \
    as_class_policy
from repro_torch.core.verifier import GuardianStaticViolation, \
    SandboxError, SandboxProof, VerifierError, verify as verify_kernel
from repro_torch.core.violations import ViolationLog


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a machine without
    one raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs a CUDA device; pass device='cpu' to "
            "run on the CPU")
    return dev


class GuardianViolation(Exception):
    """An operation strayed outside the tenant's partition and was fenced at
    the call level (transfers) or detected by CHECK mode (kernels)."""


class SharingMode(enum.Enum):
    TIME_SHARE = "time_share"   # paper baseline: one tenant at a time + sync
    SPATIAL = "spatial"         # concurrent streams, round-robin issue


class RunningMean:
    """A count and a sum: the mean of a series without keeping it."""

    __slots__ = ("count", "total")

    def __init__(self):
        self.count = 0
        self.total = 0

    def add(self, value: int) -> None:
        self.count += 1
        self.total += value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


@dataclasses.dataclass
class LaunchStats:
    """Table 5 analogue: cycles -> nanoseconds on the host, a running
    count and sum per field (a server's lifetime of launches must not
    grow a list)."""

    lookup_ns: RunningMean = dataclasses.field(default_factory=RunningMean)
    augment_ns: RunningMean = dataclasses.field(default_factory=RunningMean)
    dispatch_ns: RunningMean = dataclasses.field(
        default_factory=RunningMean)

    def summary(self) -> Dict[str, float]:
        return {
            "lookup_ns": self.lookup_ns.mean,
            "augment_ns": self.augment_ns.mean,
            "dispatch_ns": self.dispatch_ns.mean,
        }


@dataclasses.dataclass
class _KernelEntry:
    name: str
    fn: Callable
    arena_argnums: Tuple[int, ...]
    #: the sandboxed twins of a tenant kernel, one per fence mode:
    #: ``native(arena, *args)`` (NONE — the reference's out-of-range
    #: semantics, no fence), ``fenced_dyn(arena, base, mask, *args)``,
    #: ``checked_dyn(arena, base, size, *args) -> ((arena, out), ok,
    #: counts, rollback bytes)`` (a launch whose ``ok`` is false has its
    #: stores undone on the device before it returns) and
    #: ``modulo_dyn(arena, base, size, m, s, *args)``
    native: Optional[Callable] = None
    fenced_dyn: Optional[Callable] = None
    checked_dyn: Optional[Callable] = None
    #: ``saves_partition(arena, base, size, call_args)``: whether a CHECK
    #: launch of these operands saves the row's partition (a ``while`` or
    #: ``cond`` that stores into the arena) — then the graph's key holds
    #: the partition's size; answered once per operand signature, in
    #: ``partition_saving``
    saves_partition: Optional[Callable] = None
    partition_saving: Dict[Tuple, bool] = dataclasses.field(
        default_factory=dict)
    modulo_dyn: Optional[Callable] = None
    #: per-partition static MODULO twins, keyed (base, size): the bounds
    #: are constants of the twin (the reference's specialization), so its
    #: programs and graphs live under the mode ``f"mod{base}.{size}"``
    modulo_static: Dict[Tuple[int, int], Callable] = dataclasses.field(
        default_factory=dict)
    #: framework-plane kernels (serving-engine steps): already fenced
    #: internally via a GuardSpec built from the manager's fence table
    trusted: bool = False
    #: name of a manager :class:`PoolArena` threaded through the step as
    #: its second argument — ``fn(arena, pool, *args) -> (arena, pool,
    #: out)``.  The manager reads the live pool at dispatch and commits
    #: the returned one, so N engines sharing the pool (and fused rows of
    #: one batch) always see each other's updates.
    pool_arena: Optional[str] = None
    #: trusted-step argument positions (arena = 0, the pool not counted)
    #: whose tensors a compiled step addresses in place, keyed by identity
    #: and never copied — the port's counterpart of the reference's
    #: ``donate_argnums`` (see :mod:`repro_torch.core.stepgraph`)
    resident_argnums: Tuple[int, ...] = ()
    #: a trusted step declared eager (``capture=False``) never runs as a
    #: CUDA graph and never fuses, even under ``jit_trusted``
    capture: bool = True
    #: planned sandbox programs keyed (mode, argument signature), the
    #: per-launch twins' :class:`StepGraph` objects keyed (mode, "graph",
    #: signature, resident operands) — together the port's counterpart of
    #: the reference's per-(kernel, mode, signature) jit cache; the mode
    #: leads both keys, so a purge by mode drops both — and a trusted
    #: step's graphs keyed ("trusted", signature, resident operands);
    #: LRU-bounded by the manager's ``jit_cache_capacity``
    jit_cache: Dict[Tuple, Callable] = dataclasses.field(
        default_factory=dict)
    #: run the static verifier over each new trace (PROVEN sites lose
    #: their fence, REFUTED kernels raise at trace time)
    verify: bool = False
    #: fence-aware convention ``fn(arena, base, mask, *args)``: the row
    #: scalars are forwarded *into* the kernel (Listing 1 made visible)
    fence_aware: bool = False
    #: verifier proofs keyed by trace signature, beside the program cache
    proofs: Dict[Tuple, Any] = dataclasses.field(default_factory=dict)


def _program(entry: _KernelEntry, mode: str, sb, fp: FenceParams,
             args: Tuple):
    """The sandboxed twin's program for ``args`` from the entry's program
    cache (traced, verified and planned once per (mode, signature))."""
    key = (mode, _arg_signature(args))
    prog = entry.jit_cache.get(key)
    if prog is None:
        prog = sb.program(fp, args)
        entry.jit_cache[key] = prog
    return prog


def _run_twin(entry: _KernelEntry, mode: str, sb, fp: FenceParams,
              args: Tuple, undo: Optional[UndoLog] = None):
    """One launch of a sandboxed twin through the entry's program cache
    (planned at the first call of a graph's key, which runs eagerly before
    its capture, so the capture finds the program planned)."""
    return sb.run(_program(entry, mode, sb, fp, args), fp, args, undo)


@dataclasses.dataclass
class _QueuedOp:
    tenant_id: str
    kind: str                 # "launch" | "h2d" | "d2d"
    payload: Tuple


class GuardianManager:
    """Sole owner of device arenas; executes validated calls for tenants."""

    def __init__(
        self,
        total_slots: int = 1 << 20,
        dtype=torch.float32,
        policy: FencePolicy = FencePolicy.BITWISE,
        mode: SharingMode = SharingMode.SPATIAL,
        standalone_fast_path: bool = True,
        extra_arenas: Sequence[ArenaSpec] = (),
        batch_launches: bool = True,
        max_fuse: int = 8,
        max_tenants: int = 64,
        quarantine_policy: Optional[QuarantinePolicy] = None,
        quarantine_poll_every: int = 1,
        jit_trusted: bool = True,
        jit_cache_capacity: int = 64,
        lookahead_cycles: int = 0,
        adaptive_lookahead: bool = False,
        adaptive_lookahead_cap: int = 8,
        elastic_policy: Optional[ElasticPolicy] = None,
        readmit_after: Optional[int] = None,
        telemetry: bool = True,
        device="cuda",
    ):
        """``device`` is where the arenas and fence tables live: the card
        by default, the CPU only when the caller asks for it."""
        self.device = require_device(device)
        self.policy = policy
        self.mode = mode
        self.standalone_fast_path = standalone_fast_path
        self.batch_launches = batch_launches
        #: run trusted (framework-plane) steps as compiled steps — one CUDA
        #: graph per (step, operand signature, width), see
        #: :mod:`repro_torch.core.stepgraph` — and let compatible trusted
        #: steps of several serve engines fuse into one.  False is the
        #: eager, unfused fallback (equal results by regression test).
        self.jit_trusted = jit_trusted
        #: the compiled steps' graphs (one side stream they warm up and
        #: capture on), and the memory pool every tenant graph captures
        #: into with the graph that holds it (created at the first capture
        #: on a CUDA device; see _tenant_pool)
        self._graphs = GraphMaker(self.device)
        self._graph_pool = None
        #: LRU capacity of each kernel entry's specialization cache
        self.jit_cache_capacity = jit_cache_capacity
        self.scheduler = BatchedLaunchScheduler(
            self, max_fuse=max_fuse, lookahead_cycles=lookahead_cycles,
            adaptive_lookahead=adaptive_lookahead,
            adaptive_lookahead_cap=adaptive_lookahead_cap)

        # Flight recorder (core/telemetry.py): per-tenant metrics registry
        # + lifecycle event trace, fed from host state at drain-cycle
        # boundaries — never a device sync.  ``telemetry=False`` turns
        # every record path into a single-branch no-op (asserted
        # byte-identical in tests/test_telemetry.py).
        self.telemetry = Telemetry(self, enabled=telemetry)
        # the compiled steps record their spans in the same trace
        self._graphs.trace = self.telemetry.trace

        # Fault containment: device-side per-tenant violation telemetry
        # (filled by CHECK launches, in-kernel, no host sync) + the host-side
        # lifecycle driver that polls it at drain-cycle boundaries.
        self.violog = ViolationLog(capacity=max_tenants, device=self.device)
        self.quarantine = QuarantineManager(
            self, policy=quarantine_policy, poll_every=quarantine_poll_every,
            readmit_after=readmit_after)

        # §4.2.1 — reserve all device memory up front.
        self.arena = Arena(make_flat_arena(total_slots, dtype),
                           device=self.device)
        self.arenas: Dict[str, Any] = {"device_dram": self.arena}
        for spec in extra_arenas:
            self.arenas[spec.name] = Arena(spec, device=self.device)

        self.bounds = PartitionBoundsTable(total_slots)
        self._suballoc: Dict[str, IntraPartitionAllocator] = {}
        self._clients: Dict[str, GuardianClient] = {}

        # Elastic partitions: admission waitlist, watermark-driven
        # grow/shrink, on-device compaction (core/elastic.py).  Pointer
        # translation maps an outstanding DevicePtr's minted address to
        # its post-relocation home — composed per move, resolved at the
        # next validated use, so tenants never observe their extent
        # moving.  Maps are keyed per *relocation epoch* (the epoch the
        # ptr was minted in): an address reused by a later extent never
        # aliases a stale handle's translation.
        self.elastic = ElasticManager(self, policy=elastic_policy)
        self._ptr_remap: Dict[str, Dict[int, Dict[int, int]]] = {}
        self._ptr_epoch: Dict[str, int] = {}
        # compute-aware admission reads the scheduler's total arrival-rate
        # EWMA; turn the (otherwise adaptive-lookahead-only) tracking on
        # up front so the signal is warm by the first admission decision
        if self.elastic.policy.compute_watermark is not None:
            self.scheduler.enable_arrival_tracking()

        # §4.2.3 — pointerToSymbol: kernel name -> kernel entry.
        self.pointer_to_symbol: Dict[str, _KernelEntry] = {}
        # partition scalars pre-staged on device (the "augment" fast path:
        # the two extra parameters are reused, not re-uploaded per launch;
        # elastic resizes drop stale entries)
        self._part_scalars: Dict[str, Tuple[Any, Any, Any]] = {}
        # per-tenant fence-policy overrides (None -> manager default); lets
        # one arena mix e.g. MODULO and CHECK tenants — each policy group
        # fuses separately (the policy is part of the batch signature)
        self._tenant_policy: Dict[str, Optional[FencePolicy]] = {}
        # per-tenant weighted-round-robin weights: a weight-w tenant
        # drains up to w ops per cycle and divides the lookahead hold
        # budget of any batch its ops join (priority against starvation)
        self._tenant_weight: Dict[str, int] = {}
        # per-tenant SLO class policies (core/tenantclass.py).  Empty
        # until some tenant registers with one — and while empty, every
        # class code path in the scheduler stays cold (class-less
        # behavior is bit-identical to the pre-class manager).
        self._tenant_class: Dict[str, TenantClassPolicy] = {}
        # all-tenant fence table for the serving plane (one (T,2) bitwise +
        # (T,4) magic row staging, rebuilt only when the partition set
        # changes — the engine-side twin of the scheduler's batch tables)
        self._fence_table: Optional[FenceTable] = None
        self._fence_table_key: Tuple = ()
        self._fence_table_row: Dict[str, int] = {}

        self._queues: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict())
        self.launch_stats = LaunchStats()
        self.violations: List[str] = []
        self._export_tables: Dict[int, Dict[str, Any]] = {
            # minimal cudaGetExportTable implementation (§4.1): enough
            # entries for the simulated "closed-source" libraries to run.
            7: {"contextLocalStorageInterface": lambda: None},
            11: {"memcpyAsyncDispatch": lambda: None},
        }

    # ------------------------------------------------------------------ #
    # Tenant lifecycle                                                   #
    # ------------------------------------------------------------------ #
    def register_tenant(self, tenant_id: str, requested_slots: int,
                        policy: Optional[FencePolicy] = None,
                        weight: int = 1,
                        tenant_class: Optional[ClassSpec] = None,
                        ) -> GuardianClient:
        """Tenants declare memory needs at init (§4.2.1: "normal in cloud
        environments, where users buy instances with specific resources").

        Returns the tenant's :class:`GuardianClient` — the only handle
        through which the tenant may touch the device.

        ``policy`` overrides the manager default for this tenant's
        launches (e.g. a CHECK canary beside MODULO production tenants);
        the standalone fast path still applies when eligible.  NONE is
        refused: an unfenced per-tenant override would bypass isolation
        against co-tenants (the native fast path is granted automatically
        — and revoked at drain time — by ``standalone_fast_path``).

        ``weight`` (>= 1) is the tenant's weighted-round-robin share: up
        to ``weight`` of its ops drain per cycle, and the scheduler's
        cross-cycle lookahead divides its hold budget by the weight, so a
        priority tenant is never starved waiting for a fuller batch.

        ``tenant_class`` attaches an SLO class: a
        :class:`~repro_torch.core.tenantclass.TenantClassPolicy`, a bare
        :class:`~repro_torch.core.tenantclass.TenantClass` (or its string
        value ``"latency_critical"`` / ``"best_effort"``) for that
        class's factory defaults, or None for the class-less pre-class
        behavior (bit-identical by regression test).  The policy carries
        the queue-age SLO budget, a per-class lookahead override, and
        optional per-tenant quarantine thresholds — see
        :mod:`repro_torch.core.tenantclass`.

        An EVICTED tenant id is refused until explicitly readmitted
        (``manager.quarantine.readmit``) — eviction must survive a
        re-registration attempt."""
        cls_policy = as_class_policy(tenant_class)
        if weight < 1:
            raise ValueError(f"tenant weight must be >= 1, got {weight}")
        if policy is FencePolicy.NONE:
            raise ValueError(
                "per-tenant policy NONE would run unfenced beside "
                "co-tenants; the standalone fast path is automatic "
                "(standalone_fast_path=True), never a grantable override")
        # log row before partition: a capacity failure here must not leak
        # an allocated partition under an id that can never register again.
        # Roll back only state THIS call created — a failed duplicate
        # registration must not release a live tenant's row or record
        # (that would let a rogue tenant reset its own violation counters).
        new_record = self.quarantine.machine.record_of(tenant_id) is None
        self.quarantine.admit(tenant_id)
        new_row = self.violog.row_of(tenant_id) is None
        try:
            self.violog.assign(tenant_id)
            part = self.bounds.create(tenant_id, requested_slots)
        except Exception:
            if new_row and self.violog.row_of(tenant_id) is not None:
                self.violog.release(tenant_id)
            if new_record:
                self.quarantine.forget(tenant_id)
            raise
        self._suballoc[tenant_id] = IntraPartitionAllocator(part)
        self._queues[tenant_id] = collections.deque()
        self._tenant_policy[tenant_id] = policy
        self._tenant_weight[tenant_id] = weight
        if cls_policy is not None:
            self._tenant_class[tenant_id] = cls_policy
            # class machinery feeds on arrival-rate + queue-age EWMAs;
            # start collecting from this tenant's first submit on
            self.scheduler.enable_arrival_tracking()
        client = GuardianClient(self, tenant_id)
        self._clients[tenant_id] = client
        # the tenant set changed: no unfenced (NONE) graph may outlive it
        self._purge_native_entries()
        if self.telemetry.enabled:
            self.telemetry.registry.inc("tenants_registered")
            extra = {}
            if cls_policy is not None:
                extra["tenant_class"] = cls_policy.tenant_class.value
            self.telemetry.event("register", tenant_id,
                                 slots=part.size, weight=weight,
                                 policy=self.policy_of(tenant_id).value,
                                 **extra)
        return client

    def remove_tenant(self, tenant_id: str) -> None:
        """Voluntary teardown of a healthy tenant (quarantine eviction goes
        through :meth:`_evict_tenant`, which keeps the lifecycle record).

        Refused for a quarantined tenant: teardown + re-registration would
        otherwise launder the quarantine into a fresh ACTIVE record with
        zeroed counters.  The operator must evict (ban) or readmit first.
        """
        state = self.quarantine.state_of(tenant_id)
        if state is not None and not state.admissible:
            raise QuarantineError(
                f"remove_tenant: tenant {tenant_id!r} is {state.name}; "
                "evict or readmit it instead (teardown must not launder "
                "the quarantine)")
        if self.telemetry.enabled:
            self.telemetry.registry.inc("tenants_removed")
            self.telemetry.event("remove", tenant_id)
        self._reclaim_partition(tenant_id)
        self.quarantine.forget(tenant_id)
        # a departure frees slots: re-drive admission from the waitlist
        self.elastic.notify_capacity_freed()

    def _reclaim_partition(self, tenant_id: str) -> None:
        """Scrub + free a tenant's partition and drop every per-tenant
        artifact that could outlive it — including compiled symbol-cache
        entries (a removed tenant's cached unfenced binary must never be
        launchable again)."""
        part = self.bounds.lookup(tenant_id)
        # Scrub before the slots can be re-issued to another tenant.
        self.arena.zero_range(part.base, part.size)
        self.bounds.destroy(tenant_id)
        self._purge_symbol_caches(part)
        self.scheduler.invalidate_tenant_rows(tenant_id)
        self.violog.release(tenant_id)
        self._suballoc.pop(tenant_id, None)
        self._queues.pop(tenant_id, None)
        self._clients.pop(tenant_id, None)
        self._part_scalars.pop(tenant_id, None)
        self._tenant_policy.pop(tenant_id, None)
        self._tenant_weight.pop(tenant_id, None)
        self._tenant_class.pop(tenant_id, None)
        self._ptr_remap.pop(tenant_id, None)
        self._ptr_epoch.pop(tenant_id, None)
        self.elastic.forget(tenant_id)
        self.telemetry.forget_tenant(tenant_id)

    def _purge_symbol_caches(self, part: Partition) -> None:
        """Evict per-tenant planned state from the program caches when a
        partition dies or moves (the elastic plane calls this on every
        resize):

        * NONE-policy ("native") programs and graphs: planned while some
          tenant ran standalone; they carry no fence, so none may survive
          a tenant-set change.
        * The partition's static MODULO twins, their programs and their
          graphs (the bounds are constants of those).
        * Scheduler fence-table stagings that reference the dead bounds.
          The fused graphs stay: their fence rows are staged at dispatch.
        """
        self._purge_native_entries()
        for entry in self.pointer_to_symbol.values():
            for key in [k for k in entry.jit_cache
                        if k[0] == f"mod{part.base}.{part.size}"]:
                del entry.jit_cache[key]
            entry.modulo_static.pop((part.base, part.size), None)
        self.scheduler.invalidate_table_rows((part.base, part.mask))

    # -- quarantine/eviction hooks (driven by QuarantineManager) -------- #
    def _drop_tenant_ops(self, tenant_id: str) -> None:
        """Quarantine: discard everything queued or pending for the tenant
        (its in-flight work must not keep landing) and purge standalone
        programs (the tenant set effectively changed)."""
        q = self._queues.get(tenant_id)
        if q is not None:
            q.clear()
        self.scheduler.drop_tenant(tenant_id)
        self._purge_native_entries()

    def _purge_native_entries(self) -> None:
        """No NONE-policy (unfenced) program or graph survives a
        tenant-set or lifecycle change — the next standalone tenant plans
        and captures afresh."""
        for entry in self.pointer_to_symbol.values():
            for key in [k for k in entry.jit_cache if k[0] == "native"]:
                del entry.jit_cache[key]

    def _evict_tenant(self, tenant_id: str) -> None:
        """Eviction: drop ops, then scrub + reclaim the partition."""
        self._drop_tenant_ops(tenant_id)
        self._reclaim_partition(tenant_id)

    def fence_params_for(self, tenant_id: str) -> FenceParams:
        """The tenant's partition as static fence params."""
        return FenceParams.from_partition(self.bounds.lookup(tenant_id))

    def policy_of(self, tenant_id: str) -> FencePolicy:
        """The tenant's configured fence policy (override or default) —
        before standalone fast-path resolution."""
        return self._tenant_policy.get(tenant_id) or self.policy

    def weight_of(self, tenant_id: str) -> int:
        """The tenant's weighted-round-robin share (1 = plain RR)."""
        return self._tenant_weight.get(tenant_id, 1)

    def class_policy_of(self, tenant_id: str
                        ) -> Optional[TenantClassPolicy]:
        """The tenant's SLO class policy, or None for a class-less tenant
        (which sees exactly the pre-class scheduler behavior)."""
        return self._tenant_class.get(tenant_id)

    def class_policies(self) -> Dict[str, TenantClassPolicy]:
        """All classed tenants' policies, keyed by tenant id — the
        scheduler's preemption scan and elastic admission's LC-presence
        check both iterate this.  The live dict (do not mutate)."""
        return self._tenant_class

    @property
    def has_class_tenants(self) -> bool:
        """True when any registered tenant carries a class policy — the
        master switch for the scheduler's class bookkeeping (flush-time
        EWMA samples, per-class histograms, preemption checks)."""
        return bool(self._tenant_class)

    def fence_table(self) -> Tuple[FenceTable, Dict[str, int]]:
        """Stacked fence rows for every registered tenant, magic table
        included — the serving plane's per-row guard source (§4.2.4).

        Rebuilt only when the partition set changes (the key includes the
        bounds: a tenant destroyed and re-registered under the same name
        may land on a different partition).  Returns ``(table, row_of)``
        where ``row_of[tenant] -> table row`` feeds tenant-id columns for
        :meth:`FenceTable.gather`.  Pow2 sizes are validated on the host
        before staging — a traced FenceParams.mask cannot
        (fence.require_pow2_sizes contract).
        """
        ids = tuple(sorted(self.bounds.tenants()))
        parts = [self.bounds.lookup(t) for t in ids]
        key = tuple((t, p.base, p.size) for t, p in zip(ids, parts))
        if self._fence_table is None or self._fence_table_key != key:
            self._fence_table = FenceTable.from_partitions(
                parts, with_magic=True, device=self.device)
            self._fence_table_key = key
            self._fence_table_row = {t: i for i, t in enumerate(ids)}
        return self._fence_table, self._fence_table_row

    def _scalars_for(self, tenant_id: str, part: Partition):
        """Device-staged ``(base, mask, size)`` int32 scalars per tenant —
        the two extra kernel parameters, reused rather than re-uploaded
        each launch.  Pow2 is validated before staging."""
        cached = self._part_scalars.get(tenant_id)
        if cached is None or cached[3] != (part.base, part.size):
            require_pow2_sizes(part.size)
            dev = self.device
            cached = tuple(torch.tensor(v, dtype=torch.int32, device=dev)
                           for v in (part.base, part.mask, part.size)) + (
                (part.base, part.size),)
            self._part_scalars[tenant_id] = cached
        return cached[:3]

    @property
    def standalone(self) -> bool:
        return len(self.bounds) <= 1

    def _effective_policy(self, tenant_id: Optional[str] = None
                          ) -> FencePolicy:
        policy = self._tenant_policy.get(tenant_id) or self.policy
        if (self.standalone and self.standalone_fast_path
                and policy is not FencePolicy.CHECK):
            return FencePolicy.NONE  # §4.2.3 native fast path
        return policy

    # ------------------------------------------------------------------ #
    # Memory management (§4.2.1, §4.2.2)                                 #
    # ------------------------------------------------------------------ #
    def malloc(self, tenant_id: str, n_slots: int) -> DevicePtr:
        self.quarantine.check_admission(tenant_id, "cudaMalloc")
        sub = self._suballoc.get(tenant_id)
        if sub is None:
            raise UnknownTenant(tenant_id)
        try:
            rel = sub.alloc(n_slots)
            self.elastic.pressure.note_alloc(tenant_id)
        except OutOfArenaMemory:
            # the partition is hard full: record the pressure event and —
            # when the elastic policy allows — grow it right here (an
            # in-place grow is free; a relocation runs only if the tenant
            # is idle) so the tenant's malloc succeeds instead of failing
            self.elastic.pressure.note_failure(tenant_id)
            if not self.elastic.policy.grow_on_failure:
                raise
            from repro_torch.core.elastic import ElasticError
            while True:
                try:
                    self.elastic.grow(tenant_id)
                except (ElasticError, OutOfArenaMemory):
                    raise OutOfArenaMemory(
                        f"tenant {tenant_id!r}: no {n_slots} contiguous "
                        "free slots and the partition cannot grow")
                try:
                    rel = sub.alloc(n_slots)
                    # handled inline: the poll must not grow a second time
                    self.elastic.pressure.clear_failures(tenant_id)
                    break
                except OutOfArenaMemory:
                    continue
        part = self.bounds.lookup(tenant_id)
        return DevicePtr(tenant_id=tenant_id, addr=part.base + rel,
                         length=n_slots,
                         epoch=self._ptr_epoch.get(tenant_id, 0))

    def free(self, tenant_id: str, ptr: DevicePtr) -> None:
        sub = self._suballoc.get(tenant_id)
        if sub is None:
            raise UnknownTenant(tenant_id)
        part = self.bounds.lookup(tenant_id)
        addr = self._resolve_ptr(tenant_id, ptr)
        self._validate_range(tenant_id, addr, ptr.length, "cudaFree")
        sub.free(addr - part.base)
        self._ptr_remap.get(tenant_id, {}).get(ptr.epoch, {}).pop(
            ptr.addr, None)
        self.elastic.pressure.note_free(tenant_id)

    # -- elastic pointer translation ------------------------------------ #
    def _resolve_ptr(self, tenant_id: str, ptr: DevicePtr) -> int:
        """Translate a DevicePtr minted before an elastic relocation to
        its current home.  Identity for never-moved tenants (one dict
        miss).  The lookup is keyed by the ptr's mint epoch, so a ptr
        minted *after* a move never aliases a stale entry even when a
        later extent reuses the address; forged/interior addresses
        translate only on an exact mint-base match — anything else is
        validated as-is and fails closed like before."""
        return self._ptr_remap.get(tenant_id, {}).get(
            ptr.epoch, {}).get(ptr.addr, ptr.addr)

    def _compose_ptr_remap(self, tenant_id: str,
                           mapping: Dict[int, int]) -> None:
        """Fold a relocation's ``current_abs -> new_abs`` map into every
        epoch's translation table (chasing prior entries so a ptr minted
        N moves ago still resolves in one lookup) and open a fresh epoch
        for post-move mints.

        The fold hits EVERY epoch up to and including the current one: a
        ptr minted in an old epoch at an address no intermediate move
        touched has no entry there — its block sat still until now, so
        the current move's ``old -> new`` applies to it verbatim
        (setdefault: chained entries, already composed above, win)."""
        maps = self._ptr_remap.setdefault(tenant_id, {})
        epoch = self._ptr_epoch.get(tenant_id, 0)
        maps.setdefault(epoch, {})
        for em in maps.values():
            for k in list(em):
                em[k] = mapping.get(em[k], em[k])
            for old, new in mapping.items():
                em.setdefault(old, new)
        self._ptr_epoch[tenant_id] = epoch + 1

    def _validate_range(self, tenant_id: str, addr: int, length: int,
                        api: str) -> Partition:
        """§4.2.2: every host-initiated transfer is checked against the
        partition bounds table.  Fail-closed on any mismatch — and on a
        quarantined/evicted caller (fault containment extends to the
        transfer plane)."""
        self.quarantine.check_admission(tenant_id, api)
        part = self.bounds.lookup(tenant_id)
        if length < 0 or not part.contains(addr, addr + max(length, 0)):
            msg = (f"{api}: tenant {tenant_id!r} range [{addr},"
                   f"{addr + length}) outside partition "
                   f"[{part.base},{part.end})")
            self.violations.append(msg)
            raise GuardianViolation(msg)
        return part

    def memcpy_h2d(self, tenant_id: str, ptr: DevicePtr,
                   host: np.ndarray) -> None:
        flat = torch.as_tensor(np.asarray(host).reshape(-1)).to(
            self.arena.spec.dtype)
        addr = self._resolve_ptr(tenant_id, ptr)
        self._validate_range(tenant_id, addr, flat.numel(), "cudaMemcpyH2D")
        if self.mode is SharingMode.SPATIAL:
            self._enqueue(tenant_id, "h2d", (addr, flat))
        else:
            self.arena.unsafe_write_range(addr, flat)

    def memcpy_d2h(self, tenant_id: str, ptr: DevicePtr,
                   n_slots: Optional[int] = None) -> np.ndarray:
        n = ptr.length if n_slots is None else n_slots
        addr = self._resolve_ptr(tenant_id, ptr)
        self._validate_range(tenant_id, addr, n, "cudaMemcpyD2H")
        self.run_queued()  # reads are synchronizing, like cudaMemcpy
        addr = self._resolve_ptr(tenant_id, ptr)   # the drain may move
        return self.arena.unsafe_read_range(addr, n).cpu().numpy()

    def memcpy_d2d(self, tenant_id: str, dst: DevicePtr, src: DevicePtr,
                   n_slots: int) -> None:
        # check destination AND source (§4.2.2: "we check the destination
        # and/or the source pointers")
        src_addr = self._resolve_ptr(tenant_id, src)
        dst_addr = self._resolve_ptr(tenant_id, dst)
        self._validate_range(tenant_id, src_addr, n_slots, "cudaMemcpyD2D")
        self._validate_range(tenant_id, dst_addr, n_slots, "cudaMemcpyD2D")
        if self.mode is SharingMode.SPATIAL:
            self._enqueue(tenant_id, "d2d", (dst_addr, src_addr, n_slots))
        else:
            data = self.arena.unsafe_read_range(src_addr, n_slots)
            self.arena.unsafe_write_range(dst_addr, data)

    # ------------------------------------------------------------------ #
    # Kernel registration & launch (§4.2.3)                              #
    # ------------------------------------------------------------------ #
    def register_pool(self, name: str, buf: Any) -> PoolArena:
        """Adopt a framework-plane pool (a pytree of slot-indexed device
        tensors — a serving engine's KV/state pool) as a manager-owned
        arena.  Idempotent by name: engines sharing a manager and a model
        shape converge on one live pool, which is what lets their fused
        steps address one KV slot space (§4.2.1 applied to the serving
        plane).  Returns the (possibly pre-existing) :class:`PoolArena`.
        """
        pool = self.arenas.get(name)
        if pool is None:
            pool = PoolArena(buf)
            self.arenas[name] = pool
        return pool

    def register_kernel(self, name: str, fn: Callable,
                        arena_argnums: Sequence[int] = (0,),
                        verify: bool = True,
                        fence_aware: bool = False) -> None:
        """Offline sandboxing (§4.3, §4.4) of a tenant kernel.

        ``fn(arena, *args) -> (arena, out)``: a plain PyTorch function over
        the flat arena, storing in place (``arena[idx] = v``) and returning
        the arena it was given; ``out`` may be any pytree of tensors (use
        ``None`` for stores-only kernels).  Tensor arguments are launch
        operands; any other argument is a launch dimension baked into the
        plan.  The sandboxer traces the kernel on fake tensors at its first
        launch of each argument signature and *fails closed*
        (:class:`~repro_torch.core.sandbox.SandboxError`) on anything it
        cannot contain.

        ``verify=True`` (default) runs the static bounds verifier over
        every new trace: PROVEN sites get **no runtime fence**, and a
        kernel with a provably out-of-bounds site raises
        :class:`~repro_torch.core.verifier.GuardianStaticViolation` at
        trace time.  ``verify=False`` restores fence-everything behaviour.

        ``fence_aware=True`` declares the Listing-1 convention
        ``fn(arena, base, mask, *args)``: the launch row's scalars are
        forwarded *into* the kernel, and a kernel applying its own ``(idx &
        mask) | base`` proves itself row-exact for every partition.
        """
        if name in self.pointer_to_symbol:
            return  # idempotent: many clients may load the same module

        arena_argnums = tuple(arena_argnums)
        bound = (1, 2) if fence_aware else ()

        def on_proof(proof: SandboxProof) -> None:
            holder = self.pointer_to_symbol.get(name)
            if holder is not None:
                holder.proofs[("row", proof.arg_sig)] = proof

        def make(policy, count=False, check=verify):
            return sandbox(fn, arena_argnums=arena_argnums, policy=policy,
                           count_violations=count, verify=check,
                           bound_argnums=bound, on_proof=on_proof)

        native_sb = make(FencePolicy.NONE, check=False)
        fenced_sb = make(FencePolicy.BITWISE)
        checked_sb = make(FencePolicy.CHECK, count=True)
        modulo_sb = make(FencePolicy.MODULO)

        def row(base, size, mask=None, **magic) -> FenceParams:
            fp = FenceParams(base=base, size=size, **magic)
            if mask is not None:
                fp.__dict__["mask"] = mask      # no recompute per launch
            return fp

        def kargs(arena, base, mask, args):
            # fence-aware kernels see the row scalars as leading args
            return (arena, base, mask, *args) if fence_aware else \
                (arena, *args)

        def native(arena, *args):
            out, _ = _run_twin(entry, "native", native_sb, None,
                               (arena, *args))
            return out

        def fenced_dyn(arena, base, mask, *args):
            # the two extra kernel parameters of Listing 1
            fp = row(base, mask + 1, mask)
            out, _ = _run_twin(entry, "bitwise", fenced_sb, fp,
                               kargs(arena, base, mask, args))
            return out

        def checked_dyn(arena, base, size, *args, span=None):
            # the stores of a launch whose ok is false never land: each
            # is logged before it is made and undone on the device, with
            # no host sync, before the next launch sees the arena (a
            # while body's or a cond branch's after the row's partition,
            # ``span`` slots, is saved before the node)
            fp = row(base, size)
            undo = UndoLog(span)
            written, ok, counts = _run_twin(
                entry, "check", checked_sb, fp,
                kargs(arena, base, size - 1, args), undo)
            undo.rollback(ok)
            return written, ok, counts, undo.nbytes

        def saves_partition(arena, base, size, args):
            # plans the CHECK program of these operands; the size tensor
            # stands in for the mask, which has its signature
            return _program(entry, "check", checked_sb, row(base, size),
                            kargs(arena, base, size, args)).saves_partition

        def modulo_dyn(arena, base, size, m, s, *args):
            # one magic row of the FenceTable: the four extra parameters
            # that make MODULO a dynamic (fusable) mode
            fp = row(base, size, magic_m=m, magic_s=s)
            out, _ = _run_twin(entry, "modulo", modulo_sb, fp,
                               kargs(arena, base, size - 1, args))
            return out

        entry = _KernelEntry(
            name=name, fn=fn, arena_argnums=arena_argnums,
            native=native, fenced_dyn=fenced_dyn, checked_dyn=checked_dyn,
            saves_partition=saves_partition, modulo_dyn=modulo_dyn,
            jit_cache=LRUCache(self.jit_cache_capacity),
            verify=verify, fence_aware=fence_aware,
            proofs=LRUCache(self.jit_cache_capacity))
        self.pointer_to_symbol[name] = entry

    def register_trusted_kernel(self, name: str, fn: Callable,
                                arena_argnums: Sequence[int] = (0,),
                                resident_argnums: Sequence[int] = (),
                                pool_arena: Optional[str] = None,
                                capture: bool = True,
                                verify: bool = False,
                                ) -> None:
        """Register a *framework-plane* kernel — an engine step that is
        already fenced internally (per-row GuardSpec built from this
        manager's :meth:`fence_table`).

        Trusted kernels ride the queues and the scheduler drain —
        ordering, quarantine drops and launch telemetry are shared — and
        are never batched with tenant kernels (the signature includes the
        kernel name).  With ``jit_trusted`` (the default) a launch runs
        as a compiled step, one CUDA graph per operand signature (see
        :mod:`repro_torch.core.stepgraph`), and compatible trusted steps
        of different engines fuse into one compiled step (the sequential
        composition of their solo steps); with ``jit_trusted=False`` it
        runs eagerly and unfused.  A compiled step must write the arena
        and its pool in place and hand the same tensors back.

        ``resident_argnums`` are argument positions (arena = 0, the pool
        not counted) whose tensors a compiled step addresses in place —
        large operands such as an engine's weights, keyed by identity and
        never copied; every other tensor operand is copied into the
        graph's own input at dispatch.  ``capture=False`` declares a step
        eager (and unfused) whatever ``jit_trusted`` says: the elastic
        relocation steps, dispatched once each.

        ``pool_arena`` names a manager pool (see :meth:`register_pool`)
        threaded through the step: the contract becomes
        ``fn(arena, pool, *args) -> (arena, pool, out)``; the manager
        supplies the live pool at dispatch and commits the returned one
        (the pool is never a caller operand — the manager stays the only
        entity with device access, §4.2).

        ``verify=True`` replaces blind trust with a proof obligation: the
        first dispatch of each operand signature — solo compiled, eager or
        fused with other engines' steps — runs the static verifier in
        *extent mode* (every access into the arena or the pool, the
        hand-written kernels' declared accesses included, must be proven
        inside the accessed operand's extent or a guard partition found
        among the operands) and raises
        :class:`~repro_torch.core.verifier.GuardianStaticViolation` unless
        the step is **fully** proven.  The proof traces the step on fake
        tensors of this manager's device (nothing is allocated or
        launched) and is cached per signature beside the step graphs.

        Only engine code may register trusted kernels."""
        if name in self.pointer_to_symbol:
            return
        if pool_arena is not None and pool_arena not in self.arenas:
            raise ValueError(f"pool arena {pool_arena!r} not registered "
                             "(register_pool first)")
        self.pointer_to_symbol[name] = _KernelEntry(
            name=name, fn=fn, arena_argnums=tuple(arena_argnums),
            trusted=True, pool_arena=pool_arena,
            resident_argnums=tuple(resident_argnums), capture=capture,
            jit_cache=LRUCache(self.jit_cache_capacity), verify=verify,
            proofs=LRUCache(self.jit_cache_capacity))

    def _modulo_exec(self, entry: _KernelEntry, part: Partition) -> Callable:
        """The per-launch MODULO twin of one partition: static bounds and
        magic constants (the reference's per-partition specialization).
        A fence-aware kernel's row scalars come in as staged arguments."""
        key = (part.base, part.size)
        if key not in entry.modulo_static:
            fp = FenceParams(base=part.base, size=part.size)
            sb = sandbox(entry.fn, arena_argnums=entry.arena_argnums,
                         policy=FencePolicy.MODULO, verify=entry.verify,
                         bound_argnums=(1, 2) if entry.fence_aware else ())
            mode = f"mod{part.base}.{part.size}"

            def modulo_entry(arena, *args):
                out, _ = _run_twin(entry, mode, sb, fp, (arena, *args))
                return out

            entry.modulo_static[key] = modulo_entry
        return entry.modulo_static[key]

    # ------------------------------------------------------------------ #
    # Static bounds proofs (core/verifier.py)                            #
    # ------------------------------------------------------------------ #
    def _verifier_args(self, entry: _KernelEntry, call_args: Sequence[Any]):
        if entry.fence_aware:
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            return (self.arena.buf, zero, zero, *call_args), (1, 2)
        return (self.arena.buf, *call_args), ()

    def symbolic_proof(self, entry: _KernelEntry, call_args: Tuple,
                       arg_sig: Optional[Tuple] = None,
                       ) -> Optional[SandboxProof]:
        """Symbolic-row proof for a tenant kernel at one operand signature,
        computed on first need (on fake tensors) and cached beside the
        program cache.  A *fully proven symbolic* proof holds for every
        partition, so the scheduler may route CHECK batches of this
        signature onto the plain fused path.  ``None`` when the kernel is
        not fully provable (or not verifiable at all)."""
        if entry.trusted or not entry.verify:
            return None
        key = ("sym", _arg_signature(call_args) if arg_sig is None
               else arg_sig)
        proof = entry.proofs.get(key)
        if proof is None:
            args, bound = self._verifier_args(entry, call_args)
            try:
                proof = verify_kernel(
                    entry.fn, args, arena_argnums=entry.arena_argnums,
                    bound_argnums=bound, params=None, mode="row")
            except Exception:
                proof = False    # not verifiable; never retry this sig
            entry.proofs[key] = proof
        if proof and proof.symbolic and proof.fully_proven:
            return proof
        return None

    def _trusted_args(self, entry: _KernelEntry, call_args: Sequence[Any]
                      ) -> Tuple[Tuple, Tuple[int, ...]]:
        """A trusted step's full operands and the positions of the arena
        and its pool (the tainted arguments of its extent-mode proof)."""
        if entry.pool_arena is not None:
            return (self.arena.buf, self.arenas[entry.pool_arena].buf,
                    *call_args), (0, 1)
        return (self.arena.buf, *call_args), (0,)

    def _verify_trusted(self, entry: _KernelEntry, call_args: Tuple,
                        arg_sig: Optional[Tuple] = None) -> SandboxProof:
        """The extent-mode proof obligation of a ``verify=True`` trusted
        step, once per operand signature (``arg_sig`` reuses one already
        computed): traced on fake tensors of the manager's device, so it
        allocates and launches nothing.  Raises
        :class:`GuardianStaticViolation` unless every site is proven."""
        key = ("extent", _arg_signature(call_args) if arg_sig is None
               else arg_sig)
        proof = entry.proofs.get(key)
        if proof is not None:
            return proof
        args, arena_argnums = self._trusted_args(entry, call_args)
        try:
            proof = verify_kernel(entry.fn, args,
                                  arena_argnums=arena_argnums,
                                  mode="extent", device=self.device)
        except (SandboxError, VerifierError) as e:
            raise GuardianStaticViolation(
                f"trusted kernel {entry.name!r} registered with verify=True "
                f"cannot be traced for its proof: {e}") from e
        if not proof.fully_proven:
            raise GuardianStaticViolation(
                f"trusted kernel {entry.name!r} registered with "
                f"verify=True but only {proof.n_proven}/"
                f"{len(proof.sites)} access sites are proven:\n"
                + proof.format_table())
        entry.proofs[key] = proof
        return proof

    def sandbox_report(self, name: str,
                       example_args: Sequence[Any] = ()) -> SandboxProof:
        """Per-site verifier classification of a registered kernel — the
        operator surface for "why does this site still fence?".  A tenant
        kernel is verified against the *symbolic* fence row (valid for
        every partition); a trusted step in extent mode, traced on fake
        tensors of the manager's device.  ``example_args`` are the
        kernel's operands after the arena (and the pool, for a step that
        threads one); meta tensors stand in for shapes."""
        entry = self.pointer_to_symbol.get(name)
        if entry is None:
            raise GuardianViolation(
                f"unknown kernel {name!r}: symbol not in grdLib")
        if entry.trusted:
            args, arena_argnums = self._trusted_args(entry, example_args)
            return verify_kernel(entry.fn, args, arena_argnums=arena_argnums,
                                 mode="extent", device=self.device)
        args, bound = self._verifier_args(entry, example_args)
        return verify_kernel(entry.fn, args,
                             arena_argnums=entry.arena_argnums,
                             bound_argnums=bound, params=None, mode="row")

    def _on_device(self, a):
        """A launch operand with every tensor in it on the manager's
        device — a graph stages device tensors only: a host tensor would
        reach a kernel as a scalar read at capture and frozen there."""
        struct, leaves = tree_flatten(a)
        return tree_unflatten(struct, [
            t.to(self.device, non_blocking=True)
            if isinstance(t, torch.Tensor) and t.device != self.device
            else t for t in leaves])

    def launch_kernel(self, tenant_id: str, name: str,
                      ptrs: Sequence[DevicePtr] = (),
                      args: Sequence[Any] = (),
                      enqueue: bool = False) -> Any:
        # -- lookup (Table 5 "Lookup GPU kernel") ------------------------
        t0 = time.perf_counter_ns()
        self.quarantine.check_admission(tenant_id, "cudaLaunchKernel")
        entry = self.pointer_to_symbol.get(name)
        if entry is None:
            raise GuardianViolation(
                f"unknown kernel {name!r}: symbol not in grdLib "
                "(application would fail to start, §4.1)")
        self.bounds.lookup(tenant_id)       # an unknown tenant raises
        t1 = time.perf_counter_ns()
        self.launch_stats.lookup_ns.add(t1 - t0)

        remap = self._ptr_remap.get(tenant_id)
        ptr_args = tuple(
            p.addr_on(self.device) if not remap
            or p.addr not in remap.get(p.epoch, ())
            else torch.tensor(remap[p.epoch][p.addr], dtype=torch.int32,
                              device=self.device)
            for p in ptrs)
        if not entry.trusted:
            args = tuple(self._on_device(a) for a in args)
        req = LaunchRequest(tenant_id=tenant_id, name=name,
                            policy=self._effective_policy(tenant_id),
                            entry=entry, call_args=(*ptr_args, *args),
                            trusted_fusable=self._compiles(entry))
        if enqueue or self.mode is SharingMode.SPATIAL:
            self._enqueue(tenant_id, "launch", (req,))
            # the request doubles as the result handle: req.result holds
            # the kernel output once a drain dispatches it
            return req
        self._execute_request(req)
        return req.result

    def _dispatch_trusted_direct(self, tenant_id: str, name: str) -> Any:
        """Dispatch a trusted kernel *now* through the scheduler's
        execution path, outside the queue discipline — the elastic
        relocation path, which runs at drain-cycle boundaries when the
        moving tenant has nothing queued (so interleaving with tenant
        work is impossible by construction).  ``_execute`` is entered
        directly rather than submit+flush: a relocation is maintenance,
        not traffic — it must neither count as a tenant arrival for the
        adaptive-lookahead EWMA nor force-drain batches the lookahead is
        deliberately holding.  Same trusted execution path and stats as
        any scheduled step."""
        entry = self.pointer_to_symbol[name]
        req = LaunchRequest(
            tenant_id=tenant_id, name=name,
            policy=self._effective_policy(tenant_id),
            entry=entry, call_args=(),
            trusted_fusable=self._compiles(entry))
        self.scheduler._execute([req])
        return req.result

    def _execute_request(self, req: LaunchRequest) -> Any:
        """Per-launch (unbatched) dispatch of one request — the standalone
        fast path, width-1 scheduler batches, TIME_SHARE and
        ``batch_launches=False`` land here (MODULO keeps its static
        per-partition twin on this path; fused MODULO rides the
        scheduler's magic-row table).  CHECK on the scheduler path never
        does: the scheduler diverts every CHECK batch to its
        contain-and-log commit path; the raising CHECK below is the
        per-launch paths' only.

        A trusted step is internally fenced: it runs with the arena (and
        its pool arena) threaded through — compiled (keyed by operand
        signature) unless ``jit_trusted`` is off or the step is declared
        eager; its pool writes land in place and the step hands the same
        tensors back."""
        entry = req.entry
        if not entry.trusted:
            return self._execute_tenant(req)
        t1 = time.perf_counter_ns()
        if self._compiles(entry):
            res = self._trusted_exec(entry, req.call_args,
                                     arg_sig=req.signature[2])
        else:
            if entry.verify:
                self._verify_trusted(entry, req.call_args, req.signature[2])
            res = entry.fn(*self._trusted_args(entry, req.call_args)[0])
        if entry.pool_arena is None:
            new_arena, out = res
        else:
            new_arena, self.arenas[entry.pool_arena].buf, out = res
        self.arena.buf = new_arena
        self.launch_stats.dispatch_ns.add(time.perf_counter_ns() - t1)
        req.result = out
        return out

    # -- compiled trusted steps (core/stepgraph.py) --------------------- #
    def _compiles(self, entry: _KernelEntry) -> bool:
        """Whether ``entry`` runs (and fuses) as a compiled step."""
        return entry.trusted and self.jit_trusted and entry.capture

    def _trusted_operands(self, entry: _KernelEntry,
                          rows: Sequence[Tuple]) -> Operands:
        """A compiled step's operands: the arena (and the entry's pool),
        then each row's call arguments; the arena, the pool and the
        declared resident positions are resident."""
        lead = [self.arena.buf]
        if entry.pool_arena is not None:
            lead.append(self.arenas[entry.pool_arena].buf)
        args, flags = list(lead), [True] * len(lead)
        for call_args in rows:
            args.extend(call_args)
            flags.extend(i + 1 in entry.resident_argnums
                         for i in range(len(call_args)))
        return Operands.of(args, flags)

    def _step_graph(self, name: str, fn: Callable, ops: Operands,
                    pool=None) -> StepGraph:
        return self._graphs.graph(name, fn, ops, pool)

    def _tenant_pool(self):
        """The one memory pool of this manager's tenant graphs (``None``
        on the CPU).  Sharing it is sound: every replay runs on the one
        stream the manager dispatches on, one after the other, and each
        graph's outputs that are not resident are copied out of the pool
        (:meth:`StepGraph.run`) before a later replay can reuse the memory
        of another graph's temporaries; a graph's own persistent outputs
        stay allocated while it lives, and its staged inputs live outside
        the pool.  A pool per graph would pin each graph's temporaries —
        hundreds of MB for one library kernel at 2**24 slots.  A pool
        whose last graph died cannot be captured into again, and a purge
        may drop every tenant graph: a one-operation graph captured into
        the pool with it lives as long as the manager and holds it."""
        if self.device.type != "cuda":
            return None
        if self._graph_pool is None:
            pool = torch.cuda.graph_pool_handle()
            anchor = torch.cuda.CUDAGraph()
            with torch.cuda.graph(anchor, pool=pool):
                torch.zeros(1, device=self.device)
            self._graph_pool = (pool, anchor)
        return self._graph_pool[0]

    def _run_compiled(self, graph: StepGraph, ops: Operands,
                      want: Sequence[torch.Tensor]) -> Any:
        """Run ``graph`` on ``ops``; the first results must be ``want`` —
        the resident tensors the step was given (the arena, and the pool
        or the ViolationLog buffer where it takes them), which a replay
        writes in place."""
        return self._graphs.run(
            graph, ops, want,
            "the arena (and its pool or the violation log)")

    def _launch_compiled(self, cache, key: Tuple, name: str,
                         build: Callable[[], Callable],
                         resident: Sequence[torch.Tensor],
                         staged: Sequence[Any]) -> Any:
        """Run a tenant step compiled — the counterpart of the
        reference's ``_specialized_jit`` and of the scheduler's fused
        ``jax.jit`` binaries.  The step ``build()`` makes is called as
        ``fn(*resident, *staged)`` and hands ``resident`` back first.  Its
        :class:`StepGraph` lives in ``cache`` under ``key`` (which holds
        every launch dimension by value) plus the identity of the
        resident tensors, and captures into the manager's tenant pool at
        the key's first call.  Every tensor in ``staged`` — row scalars,
        fence and magic rows, log row ids, pointers, operands — is copied
        into the graph at dispatch, so T co-located tenants share one
        graph and a partition that moved is fenced at its new row."""
        ops = Operands.of((*resident, *staged),
                          [True] * len(resident) + [False] * len(staged))
        key = (*key, ops.key())
        graph = cache.get(key)
        if graph is None:
            graph = self._step_graph(name, build(), ops, self._tenant_pool())
            cache[key] = graph
        return self._run_compiled(graph, ops, resident)

    def _trusted_exec(self, entry: _KernelEntry, call_args: Tuple,
                      arg_sig: Optional[Tuple] = None) -> Tuple:
        """Run a trusted step compiled: its :class:`StepGraph` is cached in
        ``entry.jit_cache`` (LRU-bounded by ``jit_cache_capacity``) under
        ``("trusted", operand signature, resident operands)``.  ``arg_sig``
        reuses a signature already computed for the request."""
        ops = self._trusted_operands(entry, [call_args])
        key = ("trusted",
               _arg_signature(call_args) if arg_sig is None else arg_sig,
               ops.key())
        graph = entry.jit_cache.get(key)
        if graph is None:
            graph = self._trusted_graph(entry, call_args, key, ops)
        return self._run_compiled(graph, ops, self._trusted_resident(entry))

    def _trusted_graph(self, entry: _KernelEntry, call_args: Tuple,
                       key: Tuple, ops: Operands) -> StepGraph:
        """A new graph of ``entry``'s step for ``call_args``, verified
        where the step asks for it, in ``entry.jit_cache`` under
        ``key``."""
        if entry.verify:
            self._verify_trusted(entry, call_args, key[1])
        graph = self._step_graph(entry.name, entry.fn, ops)
        entry.jit_cache[key] = graph
        return graph

    def precompile(self, name: str, args: Tuple) -> bool:
        """Capture trusted kernel ``name``'s compiled step for the
        operands ``args`` without running it (:meth:`StepGraph.capture`):
        its graph joins the kernel's cache, where a later launch of that
        signature replays it.  Call it once the step has run compiled at
        another signature, whose first call loaded its kernels.  Nothing
        runs, so nothing is written, and no launch is recorded: no
        scheduler statistic or launch telemetry moves.  Returns whether a
        graph was made: not where the kernel does not compile
        (``jit_trusted`` off, a step declared eager) or where the graph
        exists already."""
        entry = self.pointer_to_symbol[name]
        if not self._compiles(entry):
            return False
        args = tuple(args)
        ops = self._trusted_operands(entry, [args])
        key = ("trusted", _arg_signature(args), ops.key())
        if key in entry.jit_cache:
            return False
        self._trusted_graph(entry, args, key, ops).capture(ops)
        return True

    def _trusted_resident(self, entry: _KernelEntry) -> List[torch.Tensor]:
        """The tensors a compiled trusted step hands back first: the arena
        and the leaves of its pool."""
        want = [self.arena.buf]
        if entry.pool_arena is not None:
            want += tree_flatten(self.arenas[entry.pool_arena].buf)[1]
        return want

    def _execute_tenant(self, req: LaunchRequest) -> Any:
        """One launch of a tenant kernel's twin under its policy, compiled:
        one graph per (mode, operand signature) in the entry's cache (see
        :meth:`_launch_compiled`).  The row scalars (``_scalars_for``) are
        staged operands; MODULO's per-partition twin has its bounds as
        constants, so its mode ``f"mod{base}.{size}"`` keys them by
        value.  A CHECK launch whose ``ok`` is false has its stores undone
        inside the graph; its counts reach the ViolationLog and the call
        raises.  The row is the tenant's partition at dispatch."""
        entry, policy = req.entry, req.policy
        part = self.bounds.lookup(req.tenant_id)
        # -- augment params (Table 5 "Augment kernel params") ------------
        t1 = time.perf_counter_ns()
        if policy is FencePolicy.NONE:
            mode, fn = "native", entry.native
        elif policy is FencePolicy.BITWISE:
            mode, fn = "bitwise", entry.fenced_dyn
        elif policy is FencePolicy.MODULO:
            mode = f"mod{part.base}.{part.size}"
            fn = self._modulo_exec(entry, part)
        elif policy is FencePolicy.CHECK:
            mode, fn = "check", entry.checked_dyn
        else:  # pragma: no cover
            raise ValueError(policy)
        lead = ()
        if policy is FencePolicy.CHECK:
            base_s, _, size_s = self._scalars_for(req.tenant_id, part)
            lead = (base_s, size_s)
            if self._saves_partition(req, base_s, size_s):
                # the rollback saves the partition: its size is in the key
                mode = f"check.{part.size}"
                fn = functools.partial(entry.checked_dyn, span=part.size)
        elif policy is FencePolicy.BITWISE or entry.fence_aware:
            # the two extra kernel parameters of Listing 1 (a fence-aware
            # kernel consumes them itself under every policy)
            lead = self._scalars_for(req.tenant_id, part)[:2]
        t2 = time.perf_counter_ns()
        self.launch_stats.augment_ns.add(t2 - t1)

        # -- dispatch ----------------------------------------------------
        res = self._launch_compiled(
            entry.jit_cache, (mode, "graph", req.signature[2]),
            f"{entry.name} [{mode}]", lambda: fn, (self.arena.buf,),
            (*lead, *req.call_args))
        self.launch_stats.dispatch_ns.add(time.perf_counter_ns() - t2)
        if policy is FencePolicy.CHECK:
            (_, out), ok, counts, _ = res
            # attribute even on the raising path: the log row is what the
            # quarantine policy reasons over
            self.violog.add(req.tenant_id, counts)
            if not bool(ok):        # the faulting launch never landed
                msg = (f"kernel {req.name!r} of tenant {req.tenant_id!r} "
                       "performed an out-of-bounds access (detected by "
                       "CHECK)")
                self.violations.append(msg)
                raise GuardianViolation(msg)
        else:
            _, out = res
        req.result = out
        return out

    def _saves_partition(self, req: LaunchRequest, base_s=None,
                         size_s=None) -> bool:
        """Whether a CHECK launch of ``req``'s kernel and operand signature
        saves the row's partition; planned once per signature, then a
        lookup.  ``base_s`` / ``size_s`` are the row's scalars when the
        caller has them."""
        entry, sig = req.entry, req.signature[2]
        saves = entry.partition_saving.get(sig)
        if saves is None:
            if base_s is None:
                base_s, _, size_s = self._scalars_for(
                    req.tenant_id, self.bounds.lookup(req.tenant_id))
            saves = entry.partition_saving[sig] = entry.saves_partition(
                self.arena.buf, base_s, size_s, req.call_args)
        return saves

    # ------------------------------------------------------------------ #
    # Spatial multiplexing (§4.2.4)                                      #
    # ------------------------------------------------------------------ #
    def _enqueue(self, tenant_id: str, kind: str, payload) -> None:
        self._queues[tenant_id].append(_QueuedOp(tenant_id, kind, payload))

    def _run_op(self, op: _QueuedOp) -> None:
        if op.kind == "launch":
            (req,) = op.payload
            # the tenant set may have changed since enqueue — a stale NONE
            # (native) policy must not run against a now-shared arena.
            # (Fusability never needs forcing here: BITWISE/CHECK/MODULO
            # all fuse natively now.)
            req.repolicy(self._effective_policy(req.tenant_id))
            if self.batch_launches and self.mode is SharingMode.SPATIAL:
                # selection: the fused execution happens at the cycle-end
                # scheduler flush, preserving round-robin selection order
                self.scheduler.submit(req)
            else:
                self._execute_request(req)
        elif op.kind == "h2d":
            addr, flat = op.payload
            self.arena.unsafe_write_range(addr, flat)
        elif op.kind == "d2d":
            dst, src, n = op.payload
            data = self.arena.unsafe_read_range(src, n)
            self.arena.unsafe_write_range(dst, data)
        else:  # pragma: no cover
            raise ValueError(op.kind)

    def run_queued(self) -> None:
        """Drain queues per the sharing mode.

        SPATIAL: weighted round-robin — up to ``weight`` ops per tenant
        per cycle ("selects GPU calls from different applications in a
        round-robin fashion", grown with per-tenant shares); ops within a
        tenant stay in-order, tenants interleave.  The launches selected
        in a cycle are submitted to the batched scheduler and flushed at
        the end of the cycle — compatible launches from different tenants
        fuse into one device step (one binary, per-row dynamic bounds).
        With ``lookahead_cycles`` the cycle-boundary flush may hold an
        under-filled batch for later cycles — classed tenants resolve
        their own hold budget (a latency-critical tenant is never held
        past ``min(lookahead, queue_age_budget)``), and a flush that
        starts with a latency-critical tenant's EWMA queue age at or
        above its budget defers all-best-effort batches to the next
        cycle (DESIGN.md §Performance isolation).  The final flush of
        the drain (``drain=True``) always executes everything —
        preemption included — so every result handle is filled when
        this returns.
        TIME_SHARE: drain each tenant fully then block (context switch).

        With host spans on (``telemetry.trace.spans``) the whole call is a
        ``manager.drain`` span; each cycle's ``drain_cycle`` event names it
        as its parent, and the containment and elastic polls are a
        ``manager.poll`` span.
        """
        trace = self.telemetry.trace
        spans = trace.spans
        if spans:
            drain = trace.open("manager.drain", self.scheduler._cycle)
        if self.mode is SharingMode.SPATIAL:
            tel = self.telemetry
            # hoisted bindings: this loop runs once per drain cycle and
            # the attribute chains below would re-resolve every cycle.
            # The GLOBAL drain-time histogram handle stays valid across
            # the drain (forget_tenant only drops tenant series).
            recording = tel.enabled
            if recording:
                reg = tel.registry
                drain_hist = reg.hist("drain_cycle_us", timing=True)
                n_cycles = 0
            pending = True
            while pending:
                t0 = time.perf_counter_ns() if recording else 0
                pending = False
                for t, q in self._queues.items():
                    for _ in range(min(self.weight_of(t), len(q))):
                        self._run_op(q.popleft())
                    pending = pending or bool(q)
                self.scheduler.flush(drain=not pending)
                if spans:
                    poll = trace.open("manager.poll")
                # containment check at the cycle boundary: a tenant crossing
                # the violation threshold here has its remaining queued ops
                # dropped while co-tenants keep draining (skipped entirely
                # while the log is clean — no sync on fenced-only traffic)
                self.quarantine.maybe_poll()
                # elastic boundary work: pressure-driven grow/shrink and
                # waitlist admission (one flag read when nothing changed —
                # host arithmetic only, never a device sync).  A drain
                # with no remaining work is an *idle* cycle — the window
                # background compaction is allowed to use.
                self.elastic.maybe_poll(idle=not pending)
                if spans:
                    trace.close(poll)
                if recording:
                    # dispatch wall time, not completion: nothing here
                    # blocks on the device (async dispatch stays async)
                    dur_us = (time.perf_counter_ns() - t0) / 1000.0
                    n_cycles += 1
                    drain_hist.observe(dur_us)
                    trace.emit(
                        "drain_cycle", DRAIN_TRACK,
                        self.scheduler._cycle,
                        dur_us=dur_us,
                        ts_us=trace.now_us() - dur_us,
                        parent=drain.sid if spans else None)
            if recording and n_cycles:
                reg.inc("drain_cycles", n_cycles)
        else:
            for q in self._queues.values():
                while q:
                    self._run_op(q.popleft())
                # context switch: full device sync between tenants
                self._device_sync()
            if spans:
                poll = trace.open("manager.poll")
            self.quarantine.maybe_poll()
            self.elastic.maybe_poll()
            if spans:
                trace.close(poll)
        if spans:
            trace.close(drain)

    def synchronize(self, tenant_id: Optional[str] = None) -> None:
        """Drain all queues (:meth:`run_queued`) and block until the
        device arena is ready — the result-handle barrier."""
        self.run_queued()
        self._device_sync()

    def _device_sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    # Introspection                                                      #
    # ------------------------------------------------------------------ #
    def export_table(self, table_id: int) -> Dict[str, Any]:
        if table_id not in self._export_tables:
            raise GuardianViolation(
                f"cudaGetExportTable: unknown table {table_id}")
        return self._export_tables[table_id]

    def violation_report(self) -> Dict[str, Any]:
        """Operator-facing fault-containment report (synchronizing).

        Per-tenant per-kind OOB counts from the device-side ViolationLog,
        the lifecycle state of every tenant the quarantine machine knows
        (evicted tenants report the counts snapshotted at eviction), the
        host-side transfer-violation strings, and the quarantine event
        trail.  A thin view over the flight recorder
        (:meth:`Telemetry.violation_view`) — same shape as ever.
        """
        return self.telemetry.violation_view()

    def jit_cache_stats(self) -> Dict[str, Any]:
        """Occupancy + eviction counters of every LRU-bounded compiled
        cache: per-kernel fenced specializations (``entries``) and the
        scheduler's fused-step binaries (``fused_entries``).  ``evictions``
        count cold binaries dropped at capacity — each costs one recompile
        on next use, never correctness (ROADMAP: symbol-cache growth under
        many-kernel churn).  A thin view over the flight recorder
        (:meth:`Telemetry.jit_cache_view`)."""
        return self.telemetry.jit_cache_view()

    def metrics_report(self) -> Dict[str, Any]:
        """The unified flight-recorder report: per-tenant rows (state,
        policy, SLO class, weight, extent, utilization, queue-age
        p50/p90/p99, violation counts), scheduler/launch/drain summaries
        (including per-class queue-age percentiles and the best-effort
        preemption count), jit-cache and elastic stats, registry
        counters/gauges, trace occupancy.
        Subsumes the five legacy surfaces (which remain as views).
        Synchronizing — an operator surface, never a hot-path call."""
        return self.telemetry.report()

    def memory_usage(self) -> Dict[str, Any]:
        """§2.2 memory-footprint claim: one context/arena overall vs one per
        client — report arena bytes + per-tenant live bytes."""
        per_tenant = {
            t: self._suballoc[t].live_bytes() for t in self.bounds.tenants()
        }
        return {
            "arena_bytes": self.arena.nbytes,
            "n_tenants": len(self.bounds),
            "tenant_live_slots": per_tenant,
            "free_slots": self.bounds.free_slots(),
        }

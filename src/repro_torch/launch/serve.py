"""Multi-tenant serving engine — Guardian's spatial sharing applied to a
shared LM server, on the GuardianManager launch path (paged branch).

One model (a dense or MoE transformer), one KV page pool, many
mutually-untrusting tenants.  The pool's virtual page space is carved
into contiguous pow2 partitions by the engine's
:class:`~repro_torch.core.manager.GuardianManager` (the same
buddy allocator, bounds table and quarantine lifecycle that fence raw
launches).  The engine owns **no fence table and no row-assignment policy
of its own**:

* every prefill/decode step is registered as a *trusted kernel* (built in
  :mod:`repro_torch.launch.steps`) and submitted as a
  :class:`~repro_torch.core.scheduler.LaunchRequest`, enqueued and drained
  by the shared :class:`BatchedLaunchScheduler`; steps run on the
  manager's device through the port's hand-written kernels, as compiled
  steps — one CUDA graph per (step, operand signature, width), see
  :mod:`repro_torch.core.stepgraph` — unless ``jit_steps=False`` asks for
  the eager fallback;
* N engines may **share one manager** (``manager=`` / ``name=``): their
  tenants partition one global page space over one physical page pool;
* per-row fence params come from :meth:`GuardianManager.fence_table`
  (bitwise rows + the MODULO magic row table), gathered through a
  tenant-id column: batch row b belongs to tenant t(b), so the virtual
  page ids of row b are fenced with t(b)'s extent before the page map
  translates them — a forged page table only wraps inside the forger's
  own pages;
* tenants may carry **per-tenant fence policies**: the step gathers a
  per-row policy-code column and dispatches per element;
* manager-side quarantine transitions propagate into the engine
  (pending requests dropped, the evicted tenant's pages scrubbed).

:func:`serve_continuous` drives paged engines per request: rows join and
leave at drain-cycle boundaries.  The slab layout, its lockstep driver
``serve_engines`` and the command line of the reference are not ported
yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.arena import PagePool
from repro_torch.core.elastic import ElasticError, ResizeEvent
from repro_torch.core.fence import FenceParams, FencePolicy
from repro_torch.core.manager import GuardianManager, require_device
from repro_torch.core.partition import OutOfArenaMemory
from repro_torch.core.quarantine import QuarantinePolicy, TenantState
from repro_torch.launch.steps import (
    build_trusted_serve_steps,
    join_cache_pool,
    split_cache_pool,
)
from repro_torch.models import get_model
from repro_torch.models import kvcache as KV
from repro_torch.models.guard import GuardSpec

#: The engine's own manager tenant: owns the scratch partition where idle
#: batch rows park (their fenced writes must never land in a tenant's
#: slots) and is the tenant id under which step launches are enqueued.
#: Engines sharing a manager suffix it (``__scratch.e1``, ...) so each
#: engine gets its own scratch partition and launch queue.
ENGINE_TENANT = "__scratch"


@dataclasses.dataclass
class Request:
    tenant: str
    rid: int
    prompt: np.ndarray
    slot: int                      # absolute slot in the shared pool
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: paged mode: the request's *virtual* page ids (allocated at join
    #: time from the tenant's page extent, freed when the row leaves)
    pages: List[int] = dataclasses.field(default_factory=list)
    #: per-request generation budget (continuous driver; None = the
    #: driver-level ``max_new_tokens``)
    max_new: Optional[int] = None
    #: earliest drain cycle this request may join (arrival-trace replay)
    arrive: int = 0


@dataclasses.dataclass
class _ContState:
    """One engine's in-flight state under the continuous driver
    (:func:`serve_continuous`): requests join and leave the fused step at
    drain-cycle boundaries, so a finished short request's row refills
    immediately instead of idling until the batch's longest request
    completes.  All sequence bookkeeping (page tables, seq lens, budgets)
    is host-authoritative — rebuilt into the meta operand every cycle —
    because a cycle may run *both* a prefill (joiners) and a decode
    (continuers) and the two steps' returned metas each advance every
    row."""

    rows: List[Optional[Request]]      # B entries; None = idle row
    left: np.ndarray                   # (B,) tokens still to emit
    lens: np.ndarray                   # (B,) host-authoritative seq lens
    nxt: torch.Tensor                  # (B,) device next-token operand
    #: per-cycle (tokens (B,) device array, row-owner rids) — tokens stay
    #: on device until _cont_finalize materializes the whole trail in one
    #: transfer
    trail: List[tuple] = dataclasses.field(default_factory=list)
    default_new: int = 16
    cycles: int = 0
    prefills: int = 0
    decodes: int = 0
    served: List[int] = dataclasses.field(default_factory=list)


def make_shared_manager(n_engines: int, max_batch: int = 8,
                        policy: FencePolicy = FencePolicy.BITWISE,
                        paged: bool = False, max_len: int = 256,
                        device="cuda", **kw) -> GuardianManager:
    """A GuardianManager sized so ``n_engines`` engines (each with its
    scratch partition plus up to one pool's worth of tenant slots) share
    one global slot space.  A guarded shared engine always fences, even
    while one tenant runs (``standalone_fast_path=False``).

    ``paged=True`` sizes the slot space in *virtual pages* instead of
    sequence slots (one slot per page — see ``ServeEngine(paged=True)``).
    The manager lives on ``device`` (the card unless the caller asks for
    the CPU); ``kw`` goes to :class:`GuardianManager` (``jit_trusted=False``
    gives the co-hosted engines the eager fallback)."""
    unit = max(max_len // KV.PAGE_SIZE, 1) if paged else 1
    return GuardianManager(
        total_slots=n_engines * 2 * _pow2(max_batch) * unit,
        policy=policy, standalone_fast_path=False, device=device, **kw)


class ServeEngine:
    """Continuous-batching multi-tenant server over the global paged KV
    pool.

    A thin client of its :class:`GuardianManager`: request bookkeeping and
    operand marshalling live here; partitioning, fencing rows, launch
    scheduling and quarantine live on the manager side.  Pass
    ``manager=`` (see :func:`make_shared_manager`) to co-host several
    engines on one manager.  ``params=`` injects weights (for example
    :func:`repro_torch.models.convert.params_from_jax` of the reference's
    weights); otherwise they are drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device``.  The engine runs on ``device`` (the card
    unless the caller asks for the CPU), which must be its manager's.

    ``jit_steps`` (the default) runs the prefill/decode steps compiled:
    the engine's own manager gets ``jit_trusted=jit_steps``.  A co-hosted
    engine takes its manager's setting and refuses ``jit_steps=False``.
    """

    def __init__(self, cfg, *, max_batch: int = 8, max_len: int = 256,
                 policy: FencePolicy = FencePolicy.BITWISE,
                 guard: bool = True, seed: int = 0,
                 quarantine_policy: Optional[QuarantinePolicy] = None,
                 manager: Optional[GuardianManager] = None,
                 name: Optional[str] = None,
                 jit_steps: bool = True,
                 telemetry: bool = True,
                 paged: bool = False,
                 max_inflight: Optional[int] = None,
                 temperature: float = 0.0,
                 top_k: int = 0,
                 params: Optional[Dict[str, Any]] = None,
                 device="cuda"):
        if not paged:
            raise NotImplementedError(
                "the slab serve layout is not ported yet; use paged=True")
        if temperature > 0 or top_k:
            raise NotImplementedError(
                "sampled decode is not ported yet (the reference draws from "
                "JAX's PRNG stream); serve greedy, temperature=0")
        self.device = require_device(device)
        if manager is not None and manager.device != self.device:
            raise ValueError(f"engine device {self.device} differs from "
                             f"its manager's {manager.device}")
        self.cfg = cfg
        self.api = get_model(cfg)
        self.guard_enabled = guard
        self.max_batch = max_batch
        self.max_len = max_len
        self.paged = paged
        self.max_inflight = min(max_inflight or max_batch, max_batch)
        #: virtual pages per request (= max_len / page size)
        self.pages_per_req = max(max_len // KV.PAGE_SIZE, 1)
        slot_unit = self.pages_per_req
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.api.init(gen, self.device)
        self.params = params
        if manager is None:
            # pool = 2x the batch slots; standalone_fast_path=False: a
            # guarded engine always fences, even with a single tenant
            n_slots = 2 * _pow2(max_batch) * slot_unit
            self.manager = GuardianManager(
                total_slots=n_slots, policy=policy,
                standalone_fast_path=False,
                quarantine_policy=quarantine_policy,
                jit_trusted=jit_steps, telemetry=telemetry,
                device=self.device)
            # parked rows only need ONE request's worth of scratch page
            # ids (they all resolve to the allocator-owned garbage page)
            scratch_slots = _pow2(self.pages_per_req)
            self.engine_tenant = ENGINE_TENANT
        else:
            # fencing, containment, step compilation and telemetry are
            # manager-wide concerns: refuse per-engine overrides instead of
            # silently ignoring them (configure them on the shared manager)
            if (policy is not FencePolicy.BITWISE
                    or quarantine_policy is not None or not jit_steps
                    or not telemetry):
                raise ValueError(
                    "policy/quarantine_policy/jit_steps/telemetry are owned "
                    "by the shared GuardianManager; configure them on the "
                    "manager (see make_shared_manager) instead of on a "
                    "co-hosted ServeEngine")
            self.manager = manager
            n_slots = manager.bounds.total_slots
            scratch_slots = _pow2(self.pages_per_req)
            policy = manager.policy
            if name is None:
                name = "e%d" % sum(
                    1 for t in manager.bounds.tenants()
                    if t.startswith(ENGINE_TENANT))
            self.engine_tenant = f"{ENGINE_TENANT}.{name}"
        self.policy = policy
        # Geometry-only pool key: the global page pool is one
        # (L, P, page, KH, D) tensor — engines serving *different* model
        # shapes with the same KV geometry share it (and the manager
        # drain), keeping model identity in the step key.
        self._n_phys = _pow2(n_slots)
        pool_key = (f"paged:L{cfg.decoder_layers}:kh{cfg.n_kv_heads}:"
                    f"d{cfg.head_dim}:pg{KV.PAGE_SIZE}:"
                    f"P{self._n_phys}:f32")
        step_key = (f"{cfg.name}:{cfg.family}:{cfg.n_layers}x"
                    f"{cfg.d_model}v{cfg.vocab}:{pool_key}")
        self._steps = build_trusted_serve_steps(self.api, pool_key,
                                                step_key=step_key)
        # A later co-hosted engine adopts the already-registered pool:
        # build its cache with a single-page pool instead (the meta half
        # is page-count independent).
        adopted = self._steps.pool_name in self.manager.arenas
        cache = KV.init_global_kv_cache(
            cfg, max_batch, max_len, 1 if adopted else self._n_phys,
            dtype=torch.float32, device=self.device)
        pool, self._meta = split_cache_pool(cache)
        self._client = self.manager.register_tenant(self.engine_tenant,
                                                    scratch_slots)
        self._scratch = self.manager.bounds.lookup(self.engine_tenant)
        #: tenants served through THIS engine (registered or submitted
        #: here) — scopes the eviction-time pool scrub to the engine that
        #: owns the evicted tenant's rows
        self._tenants: set = set()
        self.manager.quarantine.subscribe(self._on_transition)
        self.manager.elastic.subscribe(self._on_resize)
        self._pool = self._steps.register(self.manager, pool)
        if self._pool.pages is None:
            # one virt->phys allocator per pool arena, shared by every
            # co-hosted engine
            self._pool.pages = PagePool(self._n_phys, n_slots)
        self.rejected: List[int] = []     # rids dropped by quarantine
        self._requests: List[Request] = []
        #: rid -> RequestSpan handle (absent entirely when telemetry is
        #: off — every ledger call is None-tolerant)
        self._spans: Dict[int, Any] = {}
        self._rid = 0
        self.decode_steps = 0
        # evictions fired *during* a run are scrubbed at run-end
        self._in_run = False
        self._pending_scrubs: List[tuple] = []

    @property
    def cache(self):
        """The engine's full cache view: the manager-owned shared pool
        joined with this engine's per-batch meta.  Assignment splits the
        value back (pool half commits to the shared arena — visible to
        every co-hosted engine)."""
        return join_cache_pool(self._pool.buf, self._meta)

    @cache.setter
    def cache(self, value):
        self._pool.buf, self._meta = split_cache_pool(value)

    # ------------------------------------------------------------------ #
    # Tenant lifecycle (all state on the manager)                        #
    # ------------------------------------------------------------------ #
    @property
    def bounds(self):
        return self.manager.bounds

    @property
    def quarantine(self):
        """The shared lifecycle driver (manager-owned)."""
        return self.manager.quarantine

    def register_tenant(self, name: str, slots: int,
                        policy: Optional[FencePolicy] = None,
                        weight: int = 1,
                        tenant_class=None):
        """Carve a pool partition for ``name``; returns the Partition.

        ``policy`` optionally overrides the engine default for this
        tenant's rows (per-row mixed fencing); ``weight`` is the tenant's
        weighted-round-robin share of batch rows; ``tenant_class`` is any
        ``GuardianManager.register_tenant`` class spec (a
        TenantClassPolicy, a TenantClass, or ``"latency_critical"`` /
        ``"best_effort"``) attaching an SLO class to the tenant.  Note
        the engine's own *launches* ride under its scratch tenant, so a
        serve tenant's class governs admission and reporting; queue-age
        SLO enforcement applies to raw-launch tenants."""
        self.manager.register_tenant(name, slots, policy=policy,
                                     weight=weight,
                                     tenant_class=tenant_class)
        self._tenants.add(name)
        part = self.manager.bounds.lookup(name)
        # the tenant's partition is a *virtual page* extent: back it with
        # physical pages now (hand-over is all-or-nothing) and tell the
        # elastic plane resizes need no copy step
        self._pool.pages.bind_extent(name, part.base, part.size)
        self.manager.elastic.mark_virtual(name)
        return part

    def quarantine_tenant(self, name: str, reason: str = "") -> List[int]:
        """Reject the tenant via the manager's quarantine (the subscription
        drops its pending requests; new submissions raise).  Returns the
        dropped request ids."""
        before = len(self.rejected)
        self.manager.quarantine.quarantine(name, reason=reason)
        return self.rejected[before:]

    def evict_tenant(self, name: str) -> None:
        """Scrub the tenant's pool slots and return its partition to the
        buddy allocator (manager-side reclamation; the subscription scrubs
        the serve pool while the bounds are still resolvable)."""
        self.manager.quarantine.evict(name)

    def readmit_tenant(self, name: str) -> None:
        self.manager.quarantine.readmit(name)

    def _on_resize(self, ev: ResizeEvent) -> None:
        """Elastic extent changes propagate into the serving plane as a
        zero-copy resize: the extent is virtual pages, so the PagePool map
        is rewritten (bytes stay in their physical pages) together with the
        in-flight requests' virtual ids; no relocation step exists."""
        mine = ev.tenant_id in self._tenants \
            or ev.tenant_id == self.engine_tenant
        if not mine:
            return
        pages = self._pool.pages
        if ev.tenant_id != self.engine_tenant:
            if ev.moved:
                pages.rebase_extent(ev.tenant_id, ev.new_base)
                delta = ev.new_base - ev.old_base
                for r in self._requests:
                    if r.tenant == ev.tenant_id and not r.done and r.pages:
                        r.pages = [p + delta for p in r.pages]
            if ev.new_size > ev.old_size:
                pages.bind_extent(ev.tenant_id, ev.new_base, ev.new_size)
            elif ev.new_size < ev.old_size:
                pages.shrink_extent(ev.tenant_id, ev.new_size)
        else:
            self._scratch = self.manager.bounds.lookup(self.engine_tenant)

    def _on_transition(self, tenant_id: str, state: TenantState) -> None:
        """Manager-side quarantine events propagate into the serving plane
        (including transitions the engine never initiated)."""
        if tenant_id.startswith(ENGINE_TENANT):
            return
        if state is TenantState.EVICTED and tenant_id in self._tenants:
            # fires before partition reclamation: bounds still resolvable.
            # Translate the virtual extent to its physical pages BEFORE
            # releasing them (the map rows zero on release), then zero
            # those pages — the KV-leak barrier for the global pool
            part = self.manager.bounds.lookup(tenant_id)
            pages = self._pool.pages
            pm = pages.page_map
            phys = tuple(int(pm[v]) for v in
                         range(part.base, part.base + part.size)
                         if int(pm[v]))
            pages.release_extent(tenant_id)
            if self._in_run:
                self._pending_scrubs.append(phys)
            else:
                self.cache = _scrub_phys_pages(self.cache, phys)
        if not state.admissible:
            dropped = [r.rid for r in self._requests
                       if r.tenant == tenant_id and not r.done]
            self._requests = [r for r in self._requests
                              if r.done or r.tenant != tenant_id]
            self.rejected.extend(dropped)
            tel = self.manager.telemetry
            for rid in dropped:
                tel.spans.close(self._spans.pop(rid, None), "evicted")

    def submit(self, tenant: str, prompt, max_new: Optional[int] = None,
               arrive: int = 0) -> int:
        """Queue one generation request; returns the request id keyed in
        the driver's result dict.  Raises if the tenant is quarantined.

        ``max_new`` caps this request's generation below the driver-wide
        budget; ``arrive`` is the earliest drain cycle the request may
        join the batch (arrival-trace replay).  No page is claimed here —
        virtual pages are allocated when the request joins a batch row,
        so a queued request costs nothing until it runs."""
        self.manager.quarantine.check_admission(tenant, "submit")
        self.manager.bounds.lookup(tenant)
        # a manager-registered tenant becomes this engine's to serve (and
        # therefore to scrub on eviction) the moment it submits here
        self._tenants.add(tenant)
        rid = self._rid
        self._rid += 1
        self._requests.append(Request(
            tenant=tenant, rid=rid, prompt=np.asarray(prompt),
            slot=-1, max_new=max_new, arrive=arrive))
        tel = self.manager.telemetry
        if tel.enabled:
            tel.registry.inc("requests", tenant=tenant)
            # a future-arrival request defers its span clock
            self._open_span(tenant, rid, defer=arrive > 0)
        return rid

    def _open_span(self, tenant: str, rid: int,
                   defer: bool = False) -> None:
        """Open the request's span on the manager's ledger.  An SLO class
        on the tenant attaches its slack budget (latency-critical only —
        best-effort spans complete unbudgeted)."""
        tel = self.manager.telemetry
        if not tel.enabled:
            return
        cp = self.manager.class_policy_of(tenant)
        cls = cp.tenant_class.value if cp is not None else None
        budget = cp.queue_age_budget \
            if cp is not None and cp.is_latency_critical else None
        self._spans[rid] = tel.spans.open(tenant, rid, cls=cls,
                                          budget=budget, defer=defer)

    def withdraw(self, rid: int) -> bool:
        """Remove a queued (never-ran) request; returns True when
        withdrawn.  Refuses requests that are done, hold pool pages, or
        while a run is in flight — withdrawal is a queue operation, not a
        cancellation of device work."""
        for r in self._requests:
            if r.rid != rid:
                continue
            if r.done or r.pages or self._in_run:
                return False
            self._requests.remove(r)
            self.manager.telemetry.spans.close(
                self._spans.pop(rid, None), "withdrawn")
            return True
        return False

    # ------------------------------------------------------------------ #
    def _guard_for_rows(self, rows: List[Optional[Request]]
                        ) -> Optional[GuardSpec]:
        if not self.guard_enabled:
            return None
        table, row_of = self.manager.fence_table()
        # tenant-id column: batch row b -> fence-table row of its tenant
        # (idle rows park in the engine's scratch partition)
        cols = np.full((self.max_batch,), row_of[self.engine_tenant],
                       np.int32)
        pol = np.full((self.max_batch,), self.policy.code, np.int32)
        for i, r in enumerate(rows):
            if r is not None:
                cols[i] = row_of[r.tenant]
                pol[i] = self.manager.policy_of(r.tenant).code
        slot_params = table.gather(torch.as_tensor(cols))
        # row-mixed policies only when some tenant actually diverges from
        # the engine default (the homogeneous path stays unchanged)
        mixed = bool((pol != self.policy.code).any())
        row_policy = torch.as_tensor(pol).to(self.device) if mixed else None
        # kv space = per-row *virtual page* extents (the fence-table rows
        # ARE page extents); virt->phys goes through the manager-owned
        # map, then the "page" clamp keeps even a corrupted map entry
        # inside the pool tensor
        return GuardSpec(
            policy=self.policy,
            vocab=FenceParams(base=0, size=_pow2(self.cfg.vocab)),
            kv=slot_params,
            # expert ids are dispatch addresses (MoE family): fenced into
            # the pow2 expert extent, as the reference does
            expert=(FenceParams(base=0, size=_pow2(
                self.cfg.moe.num_experts)) if self.cfg.moe else None),
            page=FenceParams(base=0, size=self._n_phys),
            row_policy=row_policy,
            # a copy: the host map is rewritten in place at later cycle
            # boundaries, and a step must keep the map it was built with
            # (a compiled step stages it into its graph's input when it
            # runs, not before)
            page_map=torch.tensor(self._pool.pages.page_map,
                                  device=self.device),
        )

    # ------------------------------------------------------------------ #
    def run(self, max_new_tokens: int = 16) -> Dict[int, List[int]]:
        """Serve every pending request to completion (one-engine
        :func:`serve_continuous`)."""
        return serve_continuous([self], max_new_tokens=max_new_tokens)[0]

    def _apply_pending_scrubs(self) -> None:
        for phys in self._pending_scrubs:
            self.cache = _scrub_phys_pages(self.cache, phys)
        self._pending_scrubs.clear()

    # -- continuous batching (paged mode; serve_continuous drives) ----- #
    def _admissible(self, tenant: str) -> bool:
        state = self.manager.quarantine.state_of(tenant)
        return state is None or state.admissible

    def _used_pages(self, tenant: str) -> set:
        used: set = set()
        for r in self._requests:
            if r.tenant == tenant and not r.done:
                used.update(r.pages)
        return used

    def _alloc_pages(self, tenant: str) -> Optional[List[int]]:
        """``pages_per_req`` free virtual ids from the tenant's extent,
        growing through the elastic plane once when full (in paged mode a
        grow — even a relocating one — is host bookkeeping only, so it is
        safe at any drain-cycle boundary)."""
        part = self.manager.bounds.lookup(tenant)
        used = self._used_pages(tenant)
        free = [v for v in range(part.base, part.end) if v not in used]
        if len(free) < self.pages_per_req:
            try:
                part = self.manager.elastic.grow(tenant)
            except (ElasticError, OutOfArenaMemory):
                return None
            used = self._used_pages(tenant)
            free = [v for v in range(part.base, part.end)
                    if v not in used]
            if len(free) < self.pages_per_req:
                return None
        return free[:self.pages_per_req]

    def _cont_begin(self, max_new_tokens: int) -> _ContState:
        self._in_run = True
        B = self.max_batch
        return _ContState(rows=[None] * B,
                          left=np.zeros((B,), np.int64),
                          lens=np.zeros((B,), np.int64),
                          nxt=torch.zeros((B,), dtype=torch.int32,
                                          device=self.device),
                          default_new=max_new_tokens)

    def _cont_leave(self, st: _ContState) -> None:
        """Cycle boundary: rows whose request exhausted its budget (or
        whose tenant lost admissibility) leave — their virtual pages
        return to the tenant's free pool immediately."""
        tel = self.manager.telemetry
        for i, r in enumerate(st.rows):
            if r is None:
                continue
            if not self._admissible(r.tenant):
                r.pages = []
                st.rows[i] = None
                # span already closed by _on_transition; idempotent
                tel.spans.close(self._spans.pop(r.rid, None), "evicted")
                continue
            if st.left[i] <= 0:
                r.pages = []
                r.done = True
                st.served.append(r.rid)
                st.rows[i] = None
                tel.spans.close(self._spans.pop(r.rid, None), "complete")

    def _cont_join(self, st: _ContState) -> List[int]:
        """Refill idle rows from the admission queue (FIFO, gated on the
        request's arrival cycle and page availability).  Pages are
        allocated here — a queued request costs nothing until it joins.
        Returns the joined row indices (this cycle's prefill set)."""
        active = sum(1 for r in st.rows if r is not None)
        waiting = [r for r in self._requests
                   if not r.done and not r.pages
                   and r.arrive <= st.cycles
                   and self._admissible(r.tenant)]
        tel = self.manager.telemetry
        if tel.enabled:
            # deferred spans (future-arrival submits) start their clock
            # the cycle the request becomes eligible for admission
            for r in waiting:
                tel.spans.begin(self._spans.get(r.rid))
        # latency-critical requests admit ahead of class-less /
        # best-effort peers (stable: FIFO within a class — and a no-op
        # ordering when no tenant carries a class)
        def _lc_rank(req: Request) -> int:
            cp = self.manager.class_policy_of(req.tenant)
            return 0 if cp is not None and cp.is_latency_critical else 1
        waiting.sort(key=_lc_rank)
        joiners: List[int] = []
        stalled_rids: set = set()
        wi = 0
        for i in range(self.max_batch):
            if st.rows[i] is not None or active >= self.max_inflight:
                continue
            while wi < len(waiting):
                r = waiting[wi]
                wi += 1
                pages = self._alloc_pages(r.tenant)
                if pages is None:
                    # tenant page-full: later arrivals may fit
                    stalled_rids.add(r.rid)
                    continue
                r.pages = pages
                st.rows[i] = r
                st.left[i] = r.max_new if r.max_new is not None \
                    else st.default_new
                st.lens[i] = 0
                joiners.append(i)
                active += 1
                break
        if tel.enabled and waiting:
            # attribute this cycle's wait for the left-behind requests:
            # page-pool stall > bypassed-by-LC preempt > capacity hold >
            # plain queueing
            lc_joined = any(_lc_rank(st.rows[i]) == 0 for i in joiners)
            full = active >= self.max_inflight \
                or all(row is not None for row in st.rows)
            for r in waiting:
                if r.pages:
                    continue           # joined this cycle
                sp = self._spans.get(r.rid)
                if r.rid in stalled_rids:
                    tel.spans.phase(sp, "stall")
                elif lc_joined and _lc_rank(r) == 1:
                    tel.spans.phase(sp, "preempt")
                elif full:
                    tel.spans.phase(sp, "hold")
                else:
                    tel.spans.phase(sp, "queue")
        # allocator invariant: active requests never share a page, and
        # every page stays inside its owner's virtual extent (cheap host
        # ints — this is the join/leave-churn aliasing check)
        seen: Dict[int, str] = {}
        for r in st.rows:
            if r is None:
                continue
            part = self.manager.bounds.lookup(r.tenant)
            for p in r.pages:
                assert part.base <= p < part.end, \
                    f"page {p} outside {r.tenant} extent"
                assert p not in seen, \
                    f"page {p} aliased: {seen[p]} vs {r.tenant}"
                seen[p] = r.tenant
        return joiners

    def _cont_meta(self, st: _ContState, active: set):
        """Host-authoritative meta for one step: rows in ``active`` carry
        their real page table + seq len; every other row parks on the
        engine's scratch page ids (which the PagePool maps to the
        allocator-owned garbage page — parked writes land nowhere)."""
        B, P = self.max_batch, self.pages_per_req
        scratch = [self._scratch.base + (j % self._scratch.size)
                   for j in range(P)]
        pt = np.empty((B, P), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, r in enumerate(st.rows):
            if r is not None and i in active:
                pt[i] = r.pages
                lens[i] = int(st.lens[i])
            else:
                pt[i] = scratch
        dev = self.device
        return dataclasses.replace(
            self._meta, page_table=torch.as_tensor(pt).to(dev),
            slot_ids=torch.zeros((B,), dtype=torch.int32, device=dev),
            seq_lens=torch.as_tensor(lens).to(dev))

    def _cont_dispatch(self, st: _ContState, joiners: List[int]):
        """Enqueue this cycle's steps: one prefill covering the joiner
        rows and one decode covering the continuing rows (each step parks
        the other set on scratch pages, so their pool writes are
        disjoint and dispatch order is irrelevant).  Returns the result
        handles + row sets for :meth:`_cont_finish`."""
        continuers = [i for i, r in enumerate(st.rows)
                      if r is not None and i not in set(joiners)]
        tel = self.manager.telemetry
        if tel.enabled:
            for i in joiners:
                tel.spans.phase(self._spans.get(st.rows[i].rid),
                                "prefill")
            for i in continuers:
                tel.spans.phase(self._spans.get(st.rows[i].rid),
                                "decode")
        pre_req = dec_req = None
        plen = 0
        if joiners:
            # per-step guard: rows parked for THIS step fence to the
            # engine's scratch extent (whose virtual ids resolve to the
            # garbage page) — fencing them with their tenant's extent
            # would wrap the scratch ids INTO the tenant's live pages
            guard = self._guard_for_rows(
                [r if i in set(joiners) else None
                 for i, r in enumerate(st.rows)])
            plen = max(len(st.rows[i].prompt) for i in joiners)
            toks = np.zeros((self.max_batch, plen), np.int32)
            for i in joiners:
                toks[i, :len(st.rows[i].prompt)] = st.rows[i].prompt
            pre_req = self._client.launch_kernel(
                self._steps.prefill_name,
                args=(self.params, self._cont_meta(st, set(joiners)),
                      {"tokens": torch.as_tensor(toks).to(self.device)},
                      guard))
            st.prefills += 1
        if continuers:
            guard = self._guard_for_rows(
                [r if i in set(continuers) else None
                 for i, r in enumerate(st.rows)])
            meta = self._cont_meta(st, set(continuers))
            dec_req = self._client.launch_kernel(
                self._steps.decode_name,
                args=(self.params, meta, st.nxt, guard))
            st.decodes += 1
            self.decode_steps += 1
        return pre_req, dec_req, joiners, continuers, plen

    def _cont_finish(self, st: _ContState, pre_req, dec_req,
                     joiners: List[int], continuers: List[int],
                     plen: int) -> None:
        """Merge the cycle's results on device (no host sync), record the
        emitted tokens, advance budgets/lens."""
        if pre_req is not None and dec_req is not None:
            _, pre_nxt = pre_req.result
            _, dec_nxt = dec_req.result
            mask = np.zeros((self.max_batch,), bool)
            mask[joiners] = True
            nxt = torch.where(torch.as_tensor(mask).to(self.device),
                              pre_nxt, dec_nxt)
        elif pre_req is not None:
            _, nxt = pre_req.result
        elif dec_req is not None:
            _, nxt = dec_req.result
        else:
            st.cycles += 1
            return
        emitting = set(joiners) | set(continuers)
        owners = tuple(
            st.rows[i].rid if i in emitting and st.rows[i] is not None
            else None for i in range(self.max_batch))
        st.trail.append((nxt, owners))
        st.nxt = nxt
        for i in joiners:
            # the device wrote the *padded* wave length (lockstep
            # semantics: pad tokens are cached and attended)
            st.lens[i] = plen
            st.left[i] -= 1
        for i in continuers:
            st.lens[i] += 1
            st.left[i] -= 1
        st.cycles += 1

    def _cont_waiting(self, st: _ContState) -> bool:
        return any(not r.done and not r.pages
                   and self._admissible(r.tenant)
                   for r in self._requests)

    def _cont_gauges(self, st: _ContState) -> None:
        tel = self.manager.telemetry
        if not tel.enabled:
            return
        inflight: Dict[str, int] = {}
        for r in st.rows:
            if r is not None:
                inflight[r.tenant] = inflight.get(r.tenant, 0) + 1
        for t in self._tenants:
            tel.registry.set_gauge("serve_inflight",
                                   float(inflight.get(t, 0)), tenant=t)
            try:
                part = self.manager.bounds.lookup(t)
            except Exception:
                continue
            tel.registry.set_gauge(
                "page_occupancy",
                len(self._used_pages(t)) / max(part.size, 1), tenant=t)
        pages = self._pool.pages
        if pages is not None:
            tel.registry.set_gauge("pool_page_occupancy",
                                   pages.occupancy())

    def _cont_finalize(self, st: _ContState) -> Dict[int, List[int]]:
        self._in_run = False
        self._apply_pending_scrubs()
        if st.trail:
            # one transfer materializes every cycle's emitted tokens
            toks = torch.stack([t for t, _ in st.trail]).cpu().numpy()
            by_rid = {r.rid: r for r in self._requests}
            for c, (_, owners) in enumerate(st.trail):
                for i, rid in enumerate(owners):
                    if rid is not None and rid in by_rid:
                        by_rid[rid].generated.append(int(toks[c, i]))
        by_rid = {r.rid: r for r in self._requests}
        return {rid: by_rid[rid].generated for rid in st.served
                if rid in by_rid}


def serve_continuous(engines: List["ServeEngine"],
                     max_new_tokens: int = 16
                     ) -> List[Dict[int, List[int]]]:
    """Per-request continuous-batching driver for *paged* engines sharing
    one GuardianManager.

    Every drain cycle each engine (1) retires rows whose request
    exhausted its budget — their virtual pages free immediately — and
    (2) refills idle rows from the admission queue (FIFO, arrival-gated,
    capped by ``max_inflight``).  A cycle with joiners dispatches a
    prefill for the joining rows *and* a decode for the continuing rows;
    the two steps park each other's rows on scratch pages (all mapping to
    the allocator-owned garbage page), so their pool writes are disjoint
    and the merged next-token vector is a single on-device ``where`` —
    the loop never syncs to the host.  All engines' steps ride ONE
    manager drain per cycle.

    Unlike the lockstep driver this one takes no elastic hold: paged
    resizes and compactions are page-table rewrites (host bookkeeping,
    zero relocation copy steps), so they are safe at every cycle
    boundary.  Returns one ``rid -> tokens`` dict per engine, in order;
    per-request generations match a solo run of the same prompt (uniform
    prompt padding assumed, as everywhere)."""
    if not engines:
        return []
    mgr = engines[0].manager
    if any(e.manager is not mgr for e in engines[1:]):
        raise ValueError("serve_continuous needs engines sharing one "
                         "GuardianManager (see make_shared_manager)")
    states = [e._cont_begin(max_new_tokens) for e in engines]
    stalled = 0
    try:
        while True:
            handles = []
            busy = False
            dispatched = False
            eligible_waiting = False
            for e, st in zip(engines, states):
                e._cont_leave(st)
                joiners = e._cont_join(st)
                handles.append((e, st) + e._cont_dispatch(st, joiners))
                if handles[-1][2] is not None or handles[-1][3] is not None:
                    dispatched = True
                if any(r is not None for r in st.rows) \
                        or e._cont_waiting(st):
                    busy = True
                eligible_waiting = eligible_waiting or any(
                    not r.done and not r.pages and r.arrive <= st.cycles
                    and e._admissible(r.tenant) for r in e._requests)
            if not busy:
                break
            # eligible requests exist but nothing could join or run for
            # several consecutive cycles: every tenant is page-full with
            # no active rows to free them — fail loudly, don't spin
            stalled = stalled + 1 if (not dispatched
                                      and eligible_waiting) else 0
            if stalled > 3:
                raise RuntimeError(
                    "serve_continuous stalled: waiting requests but no "
                    "tenant can allocate pages (extents too small?)")
            mgr.run_queued()
            for e, st, pre, dec, joiners, continuers, plen in handles:
                e._cont_finish(st, pre, dec, joiners, continuers, plen)
                e._cont_gauges(st)
        return [e._cont_finalize(st) for e, st in zip(engines, states)]
    finally:
        for e in engines:
            e._in_run = False


def _pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


def _scrub_phys_pages(cache, phys):
    """Zero a set of *physical* pages of the global paged pool (axis 1 of
    the 5-dim k/v tensors), in place — the eviction scrub."""
    if not phys:
        return cache
    idx = torch.as_tensor(tuple(phys), dtype=torch.long,
                          device=cache.k.device)
    cache.k[:, idx] = 0
    cache.v[:, idx] = 0
    return cache

"""Multi-tenant serving engine — Guardian's spatial sharing applied to a
shared LM server, on the GuardianManager launch path.

One model (a dense, MoE, hybrid or xLSTM LM), one KV / state pool, many
mutually-untrusting tenants.  The pool's slot space is carved into
contiguous pow2 partitions by the engine's
:class:`~repro_torch.core.manager.GuardianManager` (the same buddy
allocator, bounds table and quarantine lifecycle that fence raw
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
  tenants partition one global slot space over one pool, and the
  scheduler coalesces compatible steps of different engines into one
  fused device step;
* per-row fence params come from :meth:`GuardianManager.fence_table`
  (bitwise rows + the MODULO magic row table), gathered through a
  tenant-id column: batch row b belongs to tenant t(b), so the slot (or
  virtual page) ids of row b are fenced with t(b)'s extent — a forged id
  only wraps inside the forger's own slots;
* batch-row selection uses the scheduler's shared
  :func:`~repro_torch.core.scheduler.round_robin_interleave` fairness
  policy, weighted by the tenants' round-robin shares;
* tenants may carry **per-tenant fence policies**: the step gathers a
  per-row policy-code column and dispatches per element; CHECK rows
  whose slot left their partition are counted into the manager's
  ViolationLog;
* manager-side quarantine transitions propagate into the engine
  (pending requests dropped, the evicted tenant's slots or pages
  scrubbed), and elastic resizes move a tenant's slab slots with it.

Two layouts (``paged=``): the **slab** pool (the default, as in the
reference) — a sequence slot per request, lockstep waves driven by
:func:`serve_engines` — and the **global paged** pool, driven per request
by :func:`serve_continuous`.  :func:`main` is the reference's command
line::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \
        --reduced --tenants 3 --requests 6 --tokens 16 \
        --policies modulo,check --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.arena import PagePool
from repro_torch.core.elastic import ElasticError, ResizeEvent
from repro_torch.core.fence import FenceParams, FencePolicy
from repro_torch.core.manager import GuardianManager, require_device
from repro_torch.core.partition import OutOfArenaMemory
from repro_torch.core.quarantine import QuarantinePolicy, TenantState
from repro_torch.core.scheduler import round_robin_interleave
from repro_torch.core.violations import NUM_KINDS, ViolationKind
from repro_torch.launch import sampling
from repro_torch.launch.steps import (
    build_pool_relocation_step,
    build_trusted_serve_steps,
    join_cache_pool,
    split_cache_pool,
)
from repro_torch.models import get_model
from repro_torch.models import kvcache as KV
from repro_torch.models.api import slab_only
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
class _RunState:
    """In-flight state of one engine's lockstep run: the driver
    (:func:`serve_engines`) enqueues one step per engine per drain."""

    rows: List[Request]
    slot_ids: np.ndarray
    meta: Any                      # cache meta (the pool lives on the manager)
    guard: Optional[GuardSpec]
    batch: Optional[Dict]          # prefill inputs; None once prefilled
    remaining: int
    nxt: Optional[torch.Tensor] = None
    #: any CHECK-policy row in this run? (policies are fixed per tenant at
    #: registration, so per-step attribution can skip entirely otherwise)
    has_check: bool = False
    #: per-step next-token tensors, kept on the device until _finalize —
    #: the decode loop never syncs, tokens materialise in one transfer
    trail: List[torch.Tensor] = dataclasses.field(default_factory=list)
    #: decode-step LaunchRequest signature, computed once per run (the
    #: operand structure is invariant across a run's decode steps)
    decode_sig: Optional[tuple] = None


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


def serve_steps(api, n_phys: int, verify: bool = False, **sampled):
    """The trusted prefill/decode steps of an engine serving ``api``'s
    model over a pool of ``n_phys`` physical pages.  The pool key is the
    geometry only — the global page pool is one (L, P, page, KH, D)
    tensor, so engines serving *different* model shapes with the same KV
    geometry share it (and the manager drain) — and the step key adds the
    model identity.  ``sampled`` (``temperature``, ``top_k``) goes to
    :func:`build_trusted_serve_steps`."""
    cfg = api.cfg
    pool_key = (f"paged:L{cfg.decoder_layers}:kh{cfg.n_kv_heads}:"
                f"d{cfg.head_dim}:pg{KV.PAGE_SIZE}:P{n_phys}:f32")
    step_key = (f"{cfg.name}:{cfg.family}:{cfg.n_layers}x"
                f"{cfg.d_model}v{cfg.vocab}:{pool_key}")
    return build_trusted_serve_steps(api, pool_key, step_key=step_key,
                                     verify=verify, **sampled)


def slab_serve_steps(api, n_slots: int, max_len: int, **sampled):
    """The trusted prefill/decode steps of a slab engine serving ``api``'s
    model over an ``n_slots``-slot space of ``max_len``-token slots: the
    pool key carries the model shape and the slot geometry, so co-hosted
    engines of one model share the pool and their steps' symbols."""
    cfg = api.cfg
    pool_key = (f"{cfg.name}:{cfg.family}:{cfg.n_layers}x"
                f"{cfg.d_model}v{cfg.vocab}:s{n_slots}:l{max_len}")
    return build_trusted_serve_steps(api, pool_key, **sampled)


def register_verified_steps(manager: GuardianManager, cfg, *,
                            max_batch: int = 8, max_len: int = 256):
    """Register on ``manager`` the steps a paged :class:`ServeEngine` of
    ``cfg`` built on it will dispatch, with their pool, under the
    extent-mode proof obligation (``verify=True``), before the engine
    exists: the engine's own registration is then a no-op by name, so its
    steps owe the proof at the first dispatch of each operand signature.
    (The engine keeps the reference's defaults and has no such switch.)
    Returns the bundle."""
    n_phys = _pow2(manager.bounds.total_slots)
    bundle = serve_steps(get_model(cfg), n_phys, verify=True)
    cache = KV.init_global_kv_cache(cfg, max_batch, max_len, n_phys,
                                    dtype=torch.float32,
                                    device=manager.device)
    bundle.register(manager, split_cache_pool(cache)[0])
    return bundle


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
    """Multi-tenant server over a slab KV pool (``paged=False``, the
    default: a sequence slot per request, lockstep waves through
    :func:`serve_engines`) or the global paged pool (``paged=True``:
    continuous batching through :func:`serve_continuous`).

    A thin client of its :class:`GuardianManager`: request bookkeeping and
    operand marshalling live here; partitioning, fencing rows, launch
    scheduling and quarantine live on the manager side.  Pass
    ``manager=`` (see :func:`make_shared_manager`) to co-host several
    engines on one manager: their compatible steps fuse into one device
    step per lockstep drain.  ``params=`` injects weights (for example
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
        self.device = require_device(device)
        self.temperature = temperature
        self.top_k = top_k
        self.api = get_model(cfg)
        if paged and cfg.family not in ("dense", "moe"):
            raise ValueError(slab_only(cfg.family))
        if manager is not None and manager.device != self.device:
            raise ValueError(f"engine device {self.device} differs from "
                             f"its manager's {manager.device}")
        self.cfg = cfg
        self.guard_enabled = guard
        self.max_batch = max_batch
        self.max_len = max_len
        self.paged = paged
        self.max_inflight = min(max_inflight or max_batch, max_batch)
        #: pages per request (= max_len / page size): virtual pages in
        #: paged mode, the slab's pages per slot otherwise
        self.pages_per_req = max(max_len // KV.PAGE_SIZE, 1)
        slot_unit = self.pages_per_req if paged else 1
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
            # paged: parked rows only need ONE request's worth of scratch
            # page ids (they all resolve to the allocator-owned garbage
            # page); slab: half the pool is the per-row scratch slots
            scratch_slots = _pow2(self.pages_per_req) if paged \
                else n_slots // 2
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
            scratch_slots = _pow2(self.pages_per_req) if paged \
                else _pow2(max_batch)
            policy = manager.policy
            if name is None:
                name = "e%d" % sum(
                    1 for t in manager.bounds.tenants()
                    if t.startswith(ENGINE_TENANT))
            self.engine_tenant = f"{ENGINE_TENANT}.{name}"
        self.policy = policy
        #: the manager's slot space (virtual pages in paged mode)
        self._n_slots = n_slots
        # ONE pool for the manager's full slot space, adopted by the
        # manager: co-hosted engines of the same model shape share it.
        # The pool's slot (page) axis is the next power of two, which K1's
        # clamp addresses; slots past the manager's space are never fenced
        # to.
        self._n_phys = _pow2(n_slots)
        sampled = dict(temperature=temperature, top_k=top_k)
        if paged:
            self._steps = serve_steps(self.api, self._n_phys, **sampled)
        else:
            self._steps = slab_serve_steps(self.api, n_slots, max_len,
                                           **sampled)
        # A later co-hosted engine adopts the already-registered pool:
        # build its cache with a single-slot pool instead (the meta half
        # is slot-count independent).
        adopted = self._steps.pool_name in self.manager.arenas
        n_pool = 1 if adopted else self._n_phys
        if paged:
            cache = KV.init_global_kv_cache(
                cfg, max_batch, max_len, n_pool, dtype=torch.float32,
                device=self.device)
        elif cfg.family == "ssm":
            cache = self.api.init_cache(max_batch, slots=n_pool,
                                        device=self.device)
        else:
            cache = self.api.init_cache(max_batch, max_len,
                                        dtype=torch.float32, slots=n_pool,
                                        device=self.device)
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
        if paged and self._pool.pages is None:
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
        #: sampled decode steps take a fresh key per decode, split from
        #: this one on the host (:mod:`repro_torch.launch.sampling`)
        self._sample_key = sampling.key(seed ^ 0x5EED) \
            if temperature > 0 else None
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

    def _pool_slots(self) -> int:
        """The slot space the engine's pool serves (the manager's; the
        slab pool tensor may hold up to the next power of two)."""
        return self._n_slots

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
        if self.paged:
            # the tenant's partition is a *virtual page* extent: back it
            # with physical pages now (hand-over is all-or-nothing) and
            # tell the elastic plane resizes need no copy step
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
        """Elastic extent changes propagate into the serving plane.

        Paged: a zero-copy resize — the extent is virtual pages, so the
        PagePool map is rewritten (bytes stay in their physical pages)
        together with the in-flight requests' virtual ids.  Slab: when a
        tenant served here (or this engine's scratch partition) moves, its
        KV slots move with it — a pool relocation step dispatched through
        the same trusted scheduler path as the serve steps — and its
        pending requests re-address.  Data-moving resizes only fire while
        the engine is idle (:func:`serve_engines` holds the elastic plane),
        so no staged guard or slot-id operand can go stale."""
        mine = ev.tenant_id in self._tenants \
            or ev.tenant_id == self.engine_tenant
        if not mine:
            return
        if self.paged:
            pages = self._pool.pages
            if ev.tenant_id != self.engine_tenant:
                if ev.moved:
                    pages.rebase_extent(ev.tenant_id, ev.new_base)
                    delta = ev.new_base - ev.old_base
                    for r in self._requests:
                        if r.tenant == ev.tenant_id and not r.done \
                                and r.pages:
                            r.pages = [p + delta for p in r.pages]
                if ev.new_size > ev.old_size:
                    pages.bind_extent(ev.tenant_id, ev.new_base,
                                      ev.new_size)
                elif ev.new_size < ev.old_size:
                    pages.shrink_extent(ev.tenant_id, ev.new_size)
            else:
                self._scratch = self.manager.bounds.lookup(
                    self.engine_tenant)
            return
        if ev.moved:
            size = min(ev.old_size, ev.new_size)
            name = (f"elastic.pool[{self._steps.pool_name}]:"
                    f"{ev.old_base}->{ev.new_base}x{size}")
            self.manager.elastic.dispatch_relocation(
                ev.tenant_id, name,
                build_pool_relocation_step(ev.old_base, ev.new_base, size),
                pool_arena=self._steps.pool_name)
            for r in self._requests:
                if r.tenant == ev.tenant_id and not r.done:
                    r.slot = ev.new_base + (r.slot - ev.old_base)
        if ev.tenant_id == self.engine_tenant:
            self._scratch = self.manager.bounds.lookup(self.engine_tenant)

    def _on_transition(self, tenant_id: str, state: TenantState) -> None:
        """Manager-side quarantine events propagate into the serving plane
        (including transitions the engine never initiated)."""
        if tenant_id.startswith(ENGINE_TENANT):
            return
        if state is TenantState.EVICTED and tenant_id in self._tenants:
            # fires before partition reclamation: bounds still resolvable.
            # Scoped to the owning engine (only it wrote the tenant's
            # slots).  This zeroing is the KV-leak barrier: the reclaimed
            # slots must hand over empty.
            part = self.manager.bounds.lookup(tenant_id)
            if self.paged:
                # translate the virtual extent to its physical pages
                # BEFORE releasing them (the map rows zero on release),
                # then zero those pages
                pages = self._pool.pages
                pm = pages.page_map
                scrub = ("phys", tuple(
                    int(pm[v]) for v in range(part.base,
                                              part.base + part.size)
                    if int(pm[v])))
                pages.release_extent(tenant_id)
            else:
                scrub = ("slots", part.base, part.size)
            if self._in_run:
                # a run in flight: scrub at its end
                self._pending_scrubs.append(scrub)
            else:
                self._scrub(scrub)
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
        join the batch (arrival-trace replay; continuous driver).  In
        paged mode no page is claimed here — virtual pages are allocated
        when the request joins a batch row, so a queued request costs
        nothing until it runs.  A slab request claims a KV slot from the
        tenant's partition now, growing it through the elastic control
        plane when hard-full."""
        self.manager.quarantine.check_admission(tenant, "submit")
        part = self.manager.bounds.lookup(tenant)
        # a manager-registered tenant becomes this engine's to serve (and
        # therefore to scrub on eviction) the moment it submits here
        self._tenants.add(tenant)
        if self.paged:
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
        used = {r.slot for r in self._requests if not r.done
                and r.tenant == tenant}
        free = [s for s in range(part.base, part.end) if s not in used]
        if not free:
            # the pool partition is hard full: grow it through the elastic
            # control plane (the listener moves the slots if the extent
            # relocates) and retry once
            try:
                part = self.manager.elastic.grow(tenant)
            except (ElasticError, OutOfArenaMemory):
                raise RuntimeError(f"tenant {tenant}: no free slots")
            used = {r.slot for r in self._requests if not r.done
                    and r.tenant == tenant}
            free = [s for s in range(part.base, part.end)
                    if s not in used]
            if not free:
                raise RuntimeError(f"tenant {tenant}: no free slots")
        rid = self._rid
        self._rid += 1
        self._requests.append(Request(tenant=tenant, rid=rid,
                                      prompt=np.asarray(prompt),
                                      slot=free[0]))
        tel = self.manager.telemetry
        if tel.enabled:
            tel.registry.inc("requests", tenant=tenant)
            self._open_span(tenant, rid)
        # occupancy report: the pressure tracker sees serve tenants too
        # (non-shrinkable — the engine owns slot placement)
        self.manager.elastic.pressure.observe(
            tenant, len(used) + 1, part.size)
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
        if not self.paged:
            # kv space = per-row slot extents; pages are fenced into the
            # slab (space "page")
            return GuardSpec(
                policy=self.policy,
                vocab=FenceParams(base=0, size=_pow2(self.cfg.vocab)),
                kv=slot_params,
                state=slot_params,
                expert=(FenceParams(base=0, size=_pow2(
                    self.cfg.moe.num_experts)) if self.cfg.moe else None),
                page=FenceParams(base=0, size=_pow2(self.pages_per_req)),
                row_policy=row_policy,
            )
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

    def _select_rows(self) -> List[Request]:
        """Batch-row assignment through the scheduler's shared weighted
        round-robin fairness policy (§4.2.4).  Quarantined tenants'
        requests never occupy a row."""
        by_tenant: Dict[str, List[Request]] = {}
        for r in self._requests:
            if r.done:
                continue
            state = self.manager.quarantine.state_of(r.tenant)
            if state is None or state.admissible:
                by_tenant.setdefault(r.tenant, []).append(r)
        weights = {t: self.manager.weight_of(t) for t in by_tenant}
        return round_robin_interleave(by_tenant, self.max_batch,
                                      weights=weights)

    def _attribute(self, rows: List[Request],
                   slot_ids: np.ndarray) -> None:
        """Per-step CHECK attribution for the serving plane: a CHECK row
        whose slot id left its owner's partition is a detected violation,
        computed on the host from the same bounds the in-step fence used.
        One GATHER count per offending row per step, folded into the
        manager's ViolationLog, so serve traffic feeds the same
        QuarantineManager poll as raw launches."""
        if not self.guard_enabled:
            return
        for i, r in enumerate(rows):
            state = self.manager.quarantine.state_of(r.tenant)
            if state is not None and not state.admissible:
                # quarantined/evicted mid-run: its bounds and log row may
                # already be reclaimed
                continue
            if self.manager.policy_of(r.tenant) is not FencePolicy.CHECK:
                continue
            part = self.manager.bounds.lookup(r.tenant)
            if not (part.base <= int(slot_ids[i]) < part.end):
                counts = np.zeros((NUM_KINDS,), np.int32)
                counts[int(ViolationKind.GATHER)] = 1
                self.manager.violog.add(r.tenant, counts)

    # ------------------------------------------------------------------ #
    def run(self, max_new_tokens: int = 16) -> Dict[int, List[int]]:
        """Serve every pending request: a slab engine one lockstep wave
        (:func:`serve_engines`), a paged one to completion
        (:func:`serve_continuous`).  Engines sharing a manager should run
        through the drivers instead, so their steps share drains."""
        if self.paged:
            return serve_continuous([self],
                                    max_new_tokens=max_new_tokens)[0]
        return serve_engines([self], max_new_tokens=max_new_tokens)[0]

    # -- lockstep phases (slab; serve_engines drives) ------------------ #
    def _begin(self, max_new_tokens: int) -> Optional[_RunState]:
        rows = self._select_rows()
        if not rows:
            return None
        self._in_run = True
        tel = self.manager.telemetry
        if tel.enabled:
            # requests the wave left behind (batch full) are *held* for
            # the whole run — _finalize reverts survivors to "queue"
            picked = {r.rid for r in rows}
            for r in self._requests:
                if not r.done and r.rid not in picked:
                    tel.spans.phase(self._spans.get(r.rid), "hold")
        B = self.max_batch
        plen = max(len(r.prompt) for r in rows)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(rows):
            toks[i, :len(r.prompt)] = r.prompt
        # idle rows park in the engine's scratch partition
        slot_ids = np.full((B,), self._scratch.base, np.int32)
        for i, r in enumerate(rows):
            slot_ids[i] = r.slot
        dev = self.device
        meta = _reset_seq_lens(self._meta_with_slots(
            torch.as_tensor(slot_ids).to(dev)))
        guard = self._guard_for_rows(rows + [None] * (B - len(rows)))
        has_check = any(
            self.manager.policy_of(r.tenant) is FencePolicy.CHECK
            for r in rows)
        return _RunState(rows=rows, slot_ids=slot_ids, meta=meta,
                         guard=guard,
                         batch={"tokens": torch.as_tensor(toks).to(dev)},
                         remaining=max_new_tokens, has_check=has_check)

    def _enqueue_step(self, st: _RunState):
        """Attribute CHECK rows, then enqueue this engine's next step as a
        LaunchRequest (the request doubles as the result handle).  The
        manager drain — shared with every co-hosted engine — happens in
        :func:`serve_engines`."""
        if st.has_check:
            self._attribute(st.rows, st.slot_ids)
        tel = self.manager.telemetry
        if tel.enabled:
            name = "prefill" if st.batch is not None else "decode"
            for r in st.rows:
                tel.spans.phase(self._spans.get(r.rid), name)
        if st.batch is not None:       # prefill
            return self._client.launch_kernel(
                self._steps.prefill_name,
                args=(self.params, st.meta, st.batch, st.guard))
        st.trail.append(st.nxt)        # stays on the device until _finalize
        req = self._client.launch_kernel(
            self._steps.decode_name,
            args=(self.params, st.meta, st.nxt, st.guard))
        if st.decode_sig is None:
            st.decode_sig = req.signature
        else:
            req._sig = st.decode_sig
        return req

    def _finish_step(self, st: _RunState, req) -> bool:
        """Consume the drained step's result; True while decodes remain.
        The step took its argmax on the device: no logits, no host sync
        here (the pool was written in place on the manager)."""
        st.meta, st.nxt = req.result
        if st.batch is not None:
            st.batch = None            # prefilled; decodes follow
            return st.remaining > 0
        self.decode_steps += 1
        st.remaining -= 1
        return st.remaining > 0

    def _finalize(self, st: _RunState) -> Dict[int, List[int]]:
        self._meta = st.meta           # the pool already lives on the manager
        # one transfer materialises every step's tokens
        if st.trail:
            toks = torch.stack(st.trail).cpu().numpy()     # (steps, B)
            for i, r in enumerate(st.rows):
                r.generated.extend(int(t) for t in toks[:, i])
        # a mid-run eviction was deferred to here
        self._apply_pending_scrubs()
        # rows whose tenant was quarantined/evicted mid-run were already
        # dropped and recorded in self.rejected: not reported as served
        out: Dict[int, List[int]] = {}
        tel = self.manager.telemetry
        for r in st.rows:
            state = self.manager.quarantine.state_of(r.tenant)
            if state is None or state.admissible:
                r.done = True
                out[r.rid] = r.generated
                tel.spans.close(self._spans.pop(r.rid, None), "complete")
        if tel.enabled:
            # survivors the wave held now re-queue for the next run
            for r in self._requests:
                if not r.done:
                    tel.spans.phase(self._spans.get(r.rid), "queue")
        return out

    def _meta_with_slots(self, slot_ids: torch.Tensor):
        """The engine's meta with every half's slot ids set to
        ``slot_ids`` (a hybrid meta carries them in its KV and its state
        half)."""
        return KV.with_slot_ids(self._meta, slot_ids)

    def _scrub(self, item: tuple) -> None:
        """Zero the pool behind an evicted tenant: ``("phys", pages)`` of
        the global pool or ``("slots", base, size)`` of the slab pool."""
        if item[0] == "phys":
            _scrub_phys_pages(self.cache, item[1])
        else:
            _scrub_slots(self.cache, item[1], item[2])

    def _apply_pending_scrubs(self) -> None:
        for item in self._pending_scrubs:
            self._scrub(item)
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
            x = st.nxt
            if self._sample_key is not None:
                self._sample_key, sub = sampling.split(self._sample_key)
                x = (st.nxt, sampling.key_tensor(sub, self.device))
            dec_req = self._client.launch_kernel(
                self._steps.decode_name,
                args=(self.params, meta, x, guard))
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


def serve_engines(engines: List[ServeEngine], max_new_tokens: int = 16
                  ) -> List[Dict[int, List[int]]]:
    """Lockstep driver for slab engines sharing one GuardianManager: every
    active engine enqueues its next prefill/decode step, then ONE manager
    drain dispatches them — compatible steps (same model shape, same
    phase) fuse into a single device step, so N engines cost one dispatch
    per lockstep instead of N.  Returns one ``rid -> tokens`` dict per
    engine, in order.  A single-engine call is exactly ``engine.run()``."""
    if not engines:
        return []
    mgr = engines[0].manager
    if any(e.manager is not mgr for e in engines[1:]):
        raise ValueError("serve_engines needs engines sharing one "
                         "GuardianManager (see make_shared_manager)")
    if any(e.paged for e in engines):
        raise ValueError("paged engines batch per-request — drive them "
                         "with serve_continuous")
    # elastic resizes that move data defer for the whole run: the staged
    # guards / slot-id operands of in-flight steps must never go stale
    mgr.elastic.hold()
    states = [e._begin(max_new_tokens) for e in engines]
    try:
        active = [i for i, s in enumerate(states) if s is not None]
        while active:
            reqs = [(i, engines[i]._enqueue_step(states[i]))
                    for i in active]
            mgr.run_queued()
            active = [i for i, req in reqs
                      if engines[i]._finish_step(states[i], req)]
        return [engines[i]._finalize(s) if s is not None else {}
                for i, s in enumerate(states)]
    finally:
        mgr.elastic.release()
        for e in engines:
            e._in_run = False


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
    if not all(e.paged for e in engines):
        raise ValueError("serve_continuous drives paged engines; slab "
                         "engines lockstep through serve_engines")
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


def _reset_seq_lens(meta):
    """A lockstep wave prefills EVERY row, so each row's sequence starts
    at 0 — without this an engine reused across runs would carry the
    previous wave's seq_lens into the new prefill (stale write positions
    and attention over dead tokens).  A hybrid meta resets its KV half
    only, as the reference's does: its state half's seq lens (the decode
    positions) carry across waves."""
    if hasattr(meta, "kv"):
        return dataclasses.replace(meta, kv=_reset_seq_lens(meta.kv))
    return dataclasses.replace(meta,
                               seq_lens=torch.zeros_like(meta.seq_lens))


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


def _scrub_slots(cache, base: int, size: int):
    """Zero a slot range [base, base+size) across every pool tensor of a
    slab cache (axis 1: the slab k/v, the state pools, a hybrid's both, an
    encoder-decoder's cross-attention pools), in place — the eviction
    scrub (the sLSTM stabiliser too, as the reference's scrub zeroes
    it)."""
    if hasattr(cache, "kv"):          # hybrid / encdec: recurse
        _scrub_slots(cache.kv, base, size)
        if hasattr(cache, "state"):
            _scrub_slots(cache.state, base, size)
        if hasattr(cache, "cross_k"):
            for t in (cache.cross_k, cache.cross_v):
                t[:, base:base + size] = 0
        return cache
    for t in (cache.pools.values() if hasattr(cache, "pools")
              else (cache.k, cache.v)):
        t[:, base:base + size] = 0
    return cache


# --------------------------------------------------------------------- #
# Command line                                                          #
# --------------------------------------------------------------------- #

def parse_args(argv=None) -> argparse.Namespace:
    """The reference's flags, plus ``--device`` (the card unless the
    caller asks for the CPU)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--no-guard", action="store_true")
    ap.add_argument("--no-jit", action="store_true",
                    help="eager trusted steps (the fallback to the "
                         "compiled step path)")
    ap.add_argument("--engines", type=int, default=1,
                    help="co-hosted engines sharing one manager; >1 "
                         "exercises the multi-engine fused decode")
    ap.add_argument("--policies", default="",
                    help="comma-separated per-tenant fence policies cycled "
                         "across tenants (e.g. 'modulo,check'); empty = "
                         "engine default (bitwise) for all")
    ap.add_argument("--classes", default="",
                    help="comma-separated per-tenant SLO classes cycled "
                         "across tenants — 'latency_critical'/'lc', "
                         "'best_effort'/'be', or '-' for class-less; "
                         "empty = class-less for all")
    ap.add_argument("--bench-out", default=None,
                    help="append a `name,us_per_call,derived` bench CSV "
                         "row (per-token wall time) to this file")
    ap.add_argument("--bench-name", default="serve.smoke",
                    help="row name used with --bench-out")
    ap.add_argument("--trace-out", default=None,
                    help="write the manager's flight-recorder event trace "
                         "as Chrome/Perfetto trace_event JSON to this path")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (default) or cpu")
    return ap.parse_args(argv)


def build_engines(args: argparse.Namespace,
                  params: Optional[Dict[str, Any]] = None
                  ) -> List[ServeEngine]:
    """The slab engines :func:`main` serves: one, or ``--engines`` sharing
    one manager, each ``max_batch=8, max_len=256``.  ``params`` injects
    the weights (every engine gets the same); otherwise each engine draws
    its own from seed 0."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    kw = dict(max_batch=8, max_len=256, guard=not args.no_guard,
              params=params, device=args.device)
    if args.engines > 1:
        mgr = make_shared_manager(args.engines, max_batch=8,
                                  jit_trusted=not args.no_jit,
                                  device=args.device)
        return [ServeEngine(cfg, manager=mgr, **kw)
                for _ in range(args.engines)]
    return [ServeEngine(cfg, jit_steps=not args.no_jit, **kw)]


def serve_cli(args: argparse.Namespace,
              engines: List[ServeEngine]) -> List[Dict[int, List[int]]]:
    """Register ``--tenants`` tenants on every engine, submit
    ``--requests`` seeded 12-token prompts each, serve them in lockstep and
    print the reference's lines; returns one ``rid -> tokens`` dict per
    engine."""
    cfg = engines[0].cfg
    pols = [FencePolicy(p.strip()) for p in args.policies.split(",")
            if p.strip()]
    aliases = {"lc": "latency_critical", "be": "best_effort", "-": None}
    classes = [aliases.get(c.strip(), c.strip())
               for c in args.classes.split(",") if c.strip()]
    per = max(engines[0]._pool_slots()
              // max(args.tenants * len(engines), 1) // 2, 2)
    for e, eng in enumerate(engines):
        for t in range(args.tenants):
            pol = pols[t % len(pols)] if pols else None
            cls = classes[t % len(classes)] if classes else None
            tenant = f"tenant{t}" if len(engines) == 1 \
                else f"e{e}.tenant{t}"
            eng.register_tenant(tenant, per, policy=pol, tenant_class=cls)
            if pol is not None:
                print(f"{tenant}: policy={pol.value}")
            if cls is not None:
                print(f"{tenant}: class={cls}")
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        t = i % args.tenants
        for e, eng in enumerate(engines):
            tenant = f"tenant{t}" if len(engines) == 1 \
                else f"e{e}.tenant{t}"
            prompt = rng.integers(0, cfg.vocab, size=12).astype(np.int32)
            eng.submit(tenant, prompt)
    t0 = time.time()
    outs = serve_engines(engines, max_new_tokens=args.tokens)
    dt = time.time() - t0
    for e, out in enumerate(outs):
        for rid, toks in sorted(out.items()):
            print(f"engine{e} req {rid}: {toks[:8]}...")
    st = engines[0].manager.scheduler.stats
    n_out = sum(len(o) for o in outs)
    print(f"{n_out} requests, {args.tokens} tokens each, "
          f"{dt:.2f}s total, {sum(e.decode_steps for e in engines)} "
          f"decode steps, {int(st.total_launches)} scheduler launches, "
          f"mean step width {st.mean_batch_width:.1f}")
    if args.trace_out:
        trace = engines[0].manager.telemetry.trace
        with open(args.trace_out, "w") as fh:
            fh.write(trace.to_json())
        print(f"trace: {args.trace_out} ({len(trace)} events)")
    if args.bench_out:
        # per-token wall time, cold start included
        n_tokens = max(n_out * args.tokens, 1)
        us = dt / n_tokens * 1e6
        row = (f"{args.bench_name},{us:.2f},"
               f"requests={n_out};tokens={n_tokens};"
               f"launches={int(st.total_launches)};"
               f"mean_width={st.mean_batch_width:.1f}")
        with open(args.bench_out, "a") as fh:
            fh.write(row + "\n")
        print(f"bench row -> {args.bench_out}: {row}")
    return outs


def main(argv=None, params: Optional[Dict[str, Any]] = None):
    """``python -m repro_torch.launch.serve``: parse the flags, build the
    engines (:func:`build_engines`, ``params`` as there) and serve
    (:func:`serve_cli`).  Returns the first engine's ``rid -> tokens``."""
    args = parse_args(argv)
    return serve_cli(args, build_engines(args, params=params))[0]


if __name__ == "__main__":
    main()

"""Guardian flight recorder — unified per-tenant telemetry for the
manager plane (the operability substrate the SLO-aware scheduling
roadmap item builds on).

Guardian's runtime state used to be spread over five disconnected ad-hoc
surfaces (``LaunchStats.summary()``, ``SchedulerStats.summary()``,
``violation_report()``, ``jit_cache_stats()``, the elastic manager's
counters) with no timeline, no percentiles, and no export format.  This
module unifies them behind two host-side primitives:

* :class:`MetricsRegistry` — per-tenant counters, gauges, and
  fixed-bucket :class:`Histogram`\\ s (queue age, fused-step width,
  drain-cycle wall time, arena utilization, violation counts by kind,
  jit-cache occupancy, waitlist age, compaction slots moved).  Every
  record path is a dict write over values the host already owns; p50/p90/
  p99 are derived from the buckets host-side on demand.
* :class:`EventTrace` — a bounded ring buffer of structured lifecycle
  events (admission, resize, compaction, quarantine transitions,
  lookahead hold/flush, fence elision via proven steps, drain cycles)
  stamped with the scheduler's monotonic drain-cycle counter plus a wall
  clock, exportable as Chrome/Perfetto ``trace_event`` JSON (one track
  per tenant, one per scheduler, one per completed serve request) for
  ``ui.perfetto.dev``.  Ring overflow is counted (:attr:`EventTrace.
  dropped`) and surfaced in ``metrics_report()`` / ``repro.top``.
* :class:`RequestSpan` / :class:`SpanLedger` — request-level tracing for
  the serving plane.  Every serve request owns a span whose lifetime is
  partitioned into phases (``queue``/``hold``/``prefill``/``decode``/
  ``preempt``/``stall``) on the **drain-cycle clock**: the serving
  drivers mark phase transitions at existing drain-cycle boundaries, so
  the per-phase component cycles always sum *exactly* to the end-to-end
  latency (asserted in tests/test_spans.py and the production
  macro-bench).  Closing a span feeds the per-tenant-class SLO
  attainment ledger (attained/violated + violation-cause histogram — a
  latency-critical span violates when its *slack* cycles, the
  queue+hold+preempt+stall sum, exceed the class's ``queue_age_budget``)
  and emits per-request Perfetto tracks linked to the submit instant by
  flow events.

**Sync-freedom invariant** (the ViolationLog discipline): nothing here
ever reads device memory.  Counters and histograms are fed from host
state at the existing drain-cycle boundaries — the violation gauges, for
example, update only inside the QuarantineManager's dirty-flag-gated
poll, which was already synchronizing.  BITWISE/MODULO hot-path traffic
therefore pays a handful of dict writes when telemetry is on and a
single ``enabled`` check when it is off (``GuardianManager(telemetry=
False)`` — asserted byte-identical and sync-identical in
tests/test_telemetry.py, and ≤5% fused-drain cost by the
``telemetry.overhead`` bench row).

The :class:`Telemetry` facade owns both primitives plus the unified
report assembly: ``manager.metrics_report()`` delegates here, and the
legacy ``violation_report()`` / ``jit_cache_stats()`` surfaces are thin
views (:meth:`Telemetry.violation_view`, :meth:`Telemetry.jit_cache_view`)
kept API-compatible.  :meth:`MetricsRegistry.to_prometheus` writes the
text exposition format; ``python -m repro.top`` renders the terminal
dashboard (:mod:`repro_torch.launch.dashboard`).
"""

from __future__ import annotations

import bisect
import json
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, \
    Tuple

__all__ = [
    "Histogram",
    "MetricsRegistry",
    "TraceEvent",
    "EventTrace",
    "RequestSpan",
    "SpanLedger",
    "Telemetry",
    "QUEUE_AGE_BOUNDS",
    "WIDTH_BOUNDS",
    "WALL_US_BOUNDS",
    "SLOTS_BOUNDS",
    "E2E_CYCLE_BOUNDS",
    "SPAN_PHASES",
    "SLACK_PHASES",
]

#: global (non-tenant) series key inside the registry maps — a plain
#: string so snapshots stay JSON-serializable
GLOBAL = ""

#: drain-cycle ages (queue age, waitlist age): small ints, pow2 buckets
QUEUE_AGE_BOUNDS: Tuple[float, ...] = (0, 1, 2, 4, 8, 16, 32, 64, 128)
#: fused-step widths: max_fuse rarely exceeds 16
WIDTH_BOUNDS: Tuple[float, ...] = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
#: wall-clock microseconds (drain cycles): 1us .. ~67s, geometric x4
WALL_US_BOUNDS: Tuple[float, ...] = tuple(float(4 ** i) for i in range(14))
#: slot counts (compaction moves, partition sizes): pow4 up to 2^30
SLOTS_BOUNDS: Tuple[float, ...] = tuple(float(4 ** i) for i in range(16))
#: end-to-end request latencies in drain cycles: pow2 up to 4096
E2E_CYCLE_BOUNDS: Tuple[float, ...] = \
    (0.0,) + tuple(float(1 << i) for i in range(13))


class Histogram:
    """Fixed-bucket host-side histogram with percentile extraction.

    ``bounds`` are ascending inclusive bucket upper edges; one implicit
    overflow bucket catches everything above the last edge.  Observation
    is a bisect + two adds — no allocation, no device work — and the
    state is plain ints, so two runs observing the same sequence are
    bit-identical (the telemetry determinism tests rely on this).
    Percentiles report the *upper edge* of the bucket holding the
    requested rank (the exact max for the overflow bucket), the standard
    fixed-bucket estimate: exact for integer series whose values are
    edges (queue ages, widths), conservative otherwise.
    """

    __slots__ = ("bounds", "buckets", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: Iterable[float] = QUEUE_AGE_BOUNDS):
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        if not self.bounds:
            raise ValueError("Histogram needs at least one bucket edge")
        if any(a >= b for a, b in zip(self.bounds, self.bounds[1:])):
            raise ValueError(
                f"bucket edges must be strictly ascending: {self.bounds}")
        self.buckets: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, value: float) -> None:
        v = float(value)
        self.buckets[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        # inline comparisons, not min()/max(): this is the per-launch
        # hot path of the fused drain (telemetry.overhead bench row)
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Upper bucket edge holding rank ``ceil(q/100 * count)``; 0.0
        when empty; the exact observed max for the overflow bucket."""
        if self.count == 0:
            return 0.0
        rank = max(1, -(-int(q * self.count) // 100))   # ceil without float
        acc = 0
        for i, c in enumerate(self.buckets):
            acc += c
            if acc >= rank:
                if i < len(self.bounds):
                    return self.bounds[i]
                return float(self.vmax)
        return float(self.vmax)           # pragma: no cover (acc==count)

    def percentiles(self, qs: Tuple[int, ...] = (50, 90, 99)
                    ) -> Dict[str, float]:
        out = {f"p{q}": self.percentile(q) for q in qs}
        out["count"] = float(self.count)
        out["mean"] = self.mean
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "bounds": list(self.bounds),
            "buckets": list(self.buckets),
            "count": self.count,
            "total": self.total,
            "min": self.vmin,
            "max": self.vmax,
            **{k: v for k, v in self.percentiles().items()
               if k not in ("count",)},
        }


class MetricsRegistry:
    """Per-tenant counters, gauges, and histograms, keyed ``(name,
    tenant)`` with ``tenant=None`` for manager-global series.

    ``enabled=False`` turns every mutator into a single-branch no-op —
    the ``telemetry=off`` knob — while reads keep working (they report
    empty).  Histograms observed under a name registered in
    ``timing=True`` mode (wall-clock series) are excluded from
    ``snapshot(include_timing=False)``, which is the comparison surface
    of the determinism tests: logical metrics must be bit-identical
    across jit/eager runs, wall clocks cannot be.
    """

    #: default bucket edges per histogram name; unknown names fall back
    #: to QUEUE_AGE_BOUNDS unless ``bounds=`` is passed at first observe
    HISTOGRAM_BOUNDS: Dict[str, Tuple[float, ...]] = {
        "queue_age_cycles": QUEUE_AGE_BOUNDS,
        "waitlist_age_cycles": QUEUE_AGE_BOUNDS,
        "fused_step_width": WIDTH_BOUNDS,
        "drain_cycle_us": WALL_US_BOUNDS,
        "compaction_slots_moved": SLOTS_BOUNDS,
        "request_e2e_cycles": E2E_CYCLE_BOUNDS,
        "request_e2e_us": WALL_US_BOUNDS,
    }

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.counters: Dict[str, Dict[str, int]] = {}
        self.gauges: Dict[str, Dict[str, float]] = {}
        self.histograms: Dict[str, Dict[str, Histogram]] = {}
        self._timing_names: set = set()
        #: ``(name, tenant) -> Histogram`` shadow of ``histograms`` — the
        #: per-launch observe fast path pays one flat dict hit instead of
        #: two nested ones (telemetry.overhead bench row)
        self._flat_hists: Dict[Tuple[str, str], Histogram] = {}
        #: bumped by :meth:`forget_tenant`; holders of :meth:`hist`
        #: handles re-resolve when it changes
        self.epoch = 0

    # -- mutators (hot-ish paths: dict writes only; ``get``-then-create
    # rather than ``setdefault(name, {})``, which would allocate a
    # throwaway dict per call on the per-launch drain path) ------------- #
    def inc(self, name: str, n: int = 1,
            tenant: Optional[str] = None) -> None:
        if not self.enabled:
            return
        series = self.counters.get(name)
        if series is None:
            series = self.counters[name] = {}
        key = tenant if tenant is not None else GLOBAL
        series[key] = series.get(key, 0) + n

    def set_gauge(self, name: str, value: float,
                  tenant: Optional[str] = None) -> None:
        if not self.enabled:
            return
        series = self.gauges.get(name)
        if series is None:
            series = self.gauges[name] = {}
        series[tenant if tenant is not None else GLOBAL] = float(value)

    def observe(self, name: str, value: float,
                tenant: Optional[str] = None,
                bounds: Optional[Iterable[float]] = None,
                timing: bool = False) -> None:
        if not self.enabled:
            return
        key = tenant if tenant is not None else GLOBAL
        hist = self._flat_hists.get((name, key))
        if hist is None:
            # first observe of a series: ``timing`` and ``bounds``
            # register there, so they are first-call attributes (every
            # call site passes them constantly anyway)
            hist = self.hist(name, tenant, bounds=bounds, timing=timing)
        hist.observe(value)

    def forget_tenant(self, tenant_id: str) -> None:
        """Drop a departed tenant's series (lifetime counters of evicted
        tenants survive in the quarantine records, not here)."""
        for table in (self.counters, self.gauges, self.histograms):
            for series in table.values():
                series.pop(tenant_id, None)
        for key in [k for k in self._flat_hists if k[1] == tenant_id]:
            del self._flat_hists[key]
        self.epoch += 1

    def hist(self, name: str, tenant: Optional[str] = None,
             bounds: Optional[Iterable[float]] = None,
             timing: bool = False) -> Optional[Histogram]:
        """Live :class:`Histogram` handle for a series (created empty on
        first request), or None when disabled — the per-launch hot paths
        observe through a cached handle instead of paying the registry
        lookup per sample.  Handles die with :meth:`forget_tenant`:
        cache them no longer than :attr:`epoch` stays unchanged."""
        if not self.enabled:
            return None
        key = tenant if tenant is not None else GLOBAL
        hist = self._flat_hists.get((name, key))
        if hist is None:
            if timing:
                self._timing_names.add(name)
            series = self.histograms.get(name)
            if series is None:
                series = self.histograms[name] = {}
            hist = series[key] = Histogram(
                bounds if bounds is not None
                else self.HISTOGRAM_BOUNDS.get(name, QUEUE_AGE_BOUNDS))
            self._flat_hists[(name, key)] = hist
        return hist

    # -- reads ---------------------------------------------------------- #
    def counter(self, name: str, tenant: Optional[str] = None) -> int:
        return self.counters.get(name, {}).get(
            tenant if tenant is not None else GLOBAL, 0)

    def gauge(self, name: str, tenant: Optional[str] = None
              ) -> Optional[float]:
        return self.gauges.get(name, {}).get(
            tenant if tenant is not None else GLOBAL)

    def histogram(self, name: str, tenant: Optional[str] = None
                  ) -> Optional[Histogram]:
        return self.histograms.get(name, {}).get(
            tenant if tenant is not None else GLOBAL)

    def percentiles(self, name: str, tenant: Optional[str] = None,
                    qs: Tuple[int, ...] = (50, 90, 99)
                    ) -> Dict[str, float]:
        """Percentile summary of one histogram series (zeros when the
        series was never observed — report shapes stay stable)."""
        hist = self.histogram(name, tenant)
        if hist is None:
            return {**{f"p{q}": 0.0 for q in qs},
                    "count": 0.0, "mean": 0.0}
        return hist.percentiles(qs)

    def snapshot(self, include_timing: bool = True) -> Dict[str, Any]:
        """Nested plain-dict dump — the determinism-test comparison
        surface (``include_timing=False`` drops wall-clock histograms)
        and the JSON export body."""
        hists = {
            name: {t: h.to_dict() for t, h in sorted(series.items())}
            for name, series in sorted(self.histograms.items())
            if include_timing or name not in self._timing_names
        }
        return {
            "counters": {n: dict(sorted(s.items()))
                         for n, s in sorted(self.counters.items())},
            "gauges": {n: dict(sorted(s.items()))
                       for n, s in sorted(self.gauges.items())},
            "histograms": hists,
        }

    def to_prometheus(self, prefix: str = "guardian") -> str:
        """Prometheus text exposition of every series.  Counters become
        ``_total``, histograms the standard ``_bucket{le=}`` /``_sum`` /
        ``_count`` triple with cumulative buckets."""

        def label(tenant: str) -> str:
            return "" if tenant == GLOBAL else \
                '{tenant="%s"}' % tenant
        def label_le(tenant: str, le: str) -> str:
            if tenant == GLOBAL:
                return '{le="%s"}' % le
            return '{tenant="%s",le="%s"}' % (tenant, le)

        lines: List[str] = []
        for name, series in sorted(self.counters.items()):
            metric = f"{prefix}_{name}_total"
            lines.append(f"# TYPE {metric} counter")
            for tenant, v in sorted(series.items()):
                lines.append(f"{metric}{label(tenant)} {v}")
        for name, series in sorted(self.gauges.items()):
            metric = f"{prefix}_{name}"
            lines.append(f"# TYPE {metric} gauge")
            for tenant, v in sorted(series.items()):
                lines.append(f"{metric}{label(tenant)} {v:g}")
        for name, series in sorted(self.histograms.items()):
            metric = f"{prefix}_{name}"
            lines.append(f"# TYPE {metric} histogram")
            for tenant, h in sorted(series.items()):
                acc = 0
                for edge, c in zip(h.bounds, h.buckets):
                    acc += c
                    lines.append(
                        f"{metric}_bucket{label_le(tenant, '%g' % edge)}"
                        f" {acc}")
                lines.append(
                    f"{metric}_bucket{label_le(tenant, '+Inf')} {h.count}")
                lines.append(f"{metric}_sum{label(tenant)} {h.total:g}")
                lines.append(f"{metric}_count{label(tenant)} {h.count}")
        return "\n".join(lines) + "\n"


class TraceEvent:
    """One flight-recorder entry: ``track`` is the Perfetto thread the
    event renders on (a tenant id, the scheduler/drain tracks, or a
    per-request ``tenant:rN`` track), ``cycle`` the scheduler's
    drain-cycle stamp, ``ts_us`` wall microseconds from trace start,
    ``dur_us`` present for duration events (drain cycles, span phases).
    ``flow`` optionally attaches a Chrome flow-event record
    (``("s"|"t"|"f", flow_id)``) so e.g. a request's submit instant links
    to its span slices across tracks with a Perfetto arrow."""

    __slots__ = ("name", "track", "cycle", "ts_us", "dur_us", "args",
                 "flow")

    def __init__(self, name: str, track: str, cycle: int, ts_us: float,
                 dur_us: Optional[float] = None,
                 args: Optional[Dict[str, Any]] = None,
                 flow: Optional[Tuple[str, int]] = None):
        self.name = name
        self.track = track
        self.cycle = cycle
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.args = args or {}
        self.flow = flow

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "track": self.track,
                "cycle": self.cycle, "ts_us": self.ts_us,
                "dur_us": self.dur_us, "args": dict(self.args)}


#: Perfetto track names of the manager-plane (non-tenant) timelines
SCHEDULER_TRACK = "scheduler"
DRAIN_TRACK = "drain-cycles"


class EventTrace:
    """Bounded ring buffer of :class:`TraceEvent`\\ s.

    Append is O(1) host work (the deque drops the oldest entry at
    capacity — a flight recorder, not an archive).  Timestamps come from
    ``time.perf_counter_ns`` relative to trace start, so they are
    monotonic per track by construction: every track's events are
    emitted in wall order (drain duration events live on their own
    :data:`DRAIN_TRACK` — their *start* stamps are monotonic because
    drain cycles never overlap).
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        if capacity < 1:
            raise ValueError("EventTrace capacity must be >= 1")
        self.enabled = enabled
        self.capacity = capacity
        self._events: Deque[TraceEvent] = deque(maxlen=capacity)
        self._t0 = time.perf_counter_ns()
        #: lifetime append count (ring drops are visible as
        #: ``emitted - len(events())``)
        self.emitted = 0
        #: lifetime count of events the ring silently evicted at
        #: capacity — surfaced in ``metrics_report()["trace"]`` and as a
        #: ``repro.top`` warning so an undersized ring is never mistaken
        #: for a complete trace
        self.dropped = 0

    def emit(self, name: str, track: str, cycle: int,
             dur_us: Optional[float] = None,
             ts_us: Optional[float] = None,
             flow: Optional[Tuple[str, int]] = None,
             **args: Any) -> None:
        if not self.enabled:
            return
        if ts_us is None:
            ts_us = (time.perf_counter_ns() - self._t0) / 1000.0
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(TraceEvent(name, track, cycle, ts_us,
                                       dur_us=dur_us, args=args,
                                       flow=flow))
        self.emitted += 1

    def now_us(self) -> float:
        """Wall microseconds since trace start (for callers stamping a
        duration event's start explicitly)."""
        return (time.perf_counter_ns() - self._t0) / 1000.0

    def events(self) -> List[TraceEvent]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- Chrome/Perfetto export ----------------------------------------- #
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON object (the dict form — dump with
        :meth:`to_json`).  One pid ("guardian"), one tid per track in
        first-seen order, thread_name metadata rows, instant events
        (``ph: "i"``) for lifecycle transitions and complete events
        (``ph: "X"``) for drain cycles.  Loadable in ``ui.perfetto.dev``
        or ``chrome://tracing``."""
        pid = 1
        tids: Dict[str, int] = {}
        out: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "guardian"},
        }]
        body: List[Dict[str, Any]] = []
        for ev in self._events:
            tid = tids.get(ev.track)
            if tid is None:
                tid = tids[ev.track] = len(tids) + 1
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": ev.track}})
            rec: Dict[str, Any] = {
                "name": ev.name, "pid": pid, "tid": tid,
                "cat": "guardian",
                "args": {"cycle": ev.cycle, **ev.args},
            }
            if ev.dur_us is not None:
                rec["ph"] = "X"
                rec["ts"] = ev.ts_us
                rec["dur"] = ev.dur_us
            else:
                rec["ph"] = "i"
                rec["ts"] = ev.ts_us
                rec["s"] = "t"
            body.append(rec)
            if ev.flow is not None:
                letter, fid = ev.flow
                frec: Dict[str, Any] = {
                    "name": "request", "cat": "guardian.flow",
                    "ph": letter, "id": fid, "pid": pid, "tid": tid,
                    "ts": ev.ts_us,
                }
                if letter == "f":
                    frec["bp"] = "e"
                body.append(frec)
        return {"traceEvents": out + body, "displayTimeUnit": "ms"}

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_chrome(), **kw)


#: the exhaustive partition of a serve request's lifetime (drain-cycle
#: clock).  ``queue``: submitted but not yet picked; ``hold``: picked
#: into a run but parked this cycle (inflight cap / no idle row);
#: ``prefill``/``decode``: on-device compute cycles; ``preempt``:
#: bypassed by a latency-critical joiner; ``stall``: blocked on the
#: paged-KV pool (page-full / compaction stall).
SPAN_PHASES: Tuple[str, ...] = (
    "queue", "hold", "prefill", "decode", "preempt", "stall")

#: the non-compute phases — their sum is a request's *slack*, the
#: quantity an SLO class budgets (``TenantClassPolicy.queue_age_budget``)
SLACK_PHASES: Tuple[str, ...] = ("queue", "hold", "preempt", "stall")


class RequestSpan:
    """One serve request's lifetime, partitioned into phases on the
    drain-cycle clock.

    The span is a sequence of half-open phase segments
    ``(phase, cycle0, cycle1, us0, us1)`` with ``cycle1`` of each equal
    to ``cycle0`` of the next, so the per-phase cycle components sum
    *exactly* to the end-to-end latency by construction — the
    reconciliation invariant tests and the macro-bench assert.  Phase
    transitions are recorded at drain-cycle boundaries by the serve
    drivers; a transition within one cycle renames the pending phase
    rather than emitting a zero-length segment.

    Pure host bookkeeping: never reads device memory, never syncs.
    Spans are created by :class:`SpanLedger` (None when telemetry is
    off — every call site guards, so off-mode is byte-identical).
    """

    __slots__ = ("tenant", "rid", "sid", "cls", "budget", "started",
                 "segments", "start_cycle", "start_us", "end_cycle",
                 "end_us", "outcome", "_phase", "_pc", "_pus")

    def __init__(self, tenant: str, rid: int, sid: int,
                 cls: Optional[str] = None,
                 budget: Optional[int] = None):
        self.tenant = tenant
        self.rid = rid
        #: ledger-unique span id — doubles as the Perfetto flow id
        self.sid = sid
        #: SLO class name ("latency_critical"/"best_effort"/None)
        self.cls = cls
        #: slack budget in drain cycles (None = unbudgeted: always
        #: attained on completion)
        self.budget = budget
        self.started = False
        self.segments: List[Tuple[str, int, int, float, float]] = []
        self.start_cycle = 0
        self.start_us = 0.0
        self.end_cycle = 0
        self.end_us = 0.0
        #: terminal state: "complete" | "evicted" | "withdrawn"
        self.outcome: Optional[str] = None
        self._phase: Optional[str] = None
        self._pc = 0
        self._pus = 0.0

    def begin(self, cycle: int, us: float) -> None:
        """Start the clock (phase ``queue``).  Paged requests with a
        future ``arrive`` stamp begin when they become visible to
        admission, not at submit — queueing they asked for is not
        queueing the system imposed."""
        self.started = True
        self.start_cycle = cycle
        self.start_us = us
        self._phase = "queue"
        self._pc = cycle
        self._pus = us

    def phase(self, name: str, cycle: int, us: float) -> None:
        """Transition to ``name`` at drain-cycle ``cycle``.  No-op when
        unstarted, finished, or already in that phase."""
        if (not self.started or self.outcome is not None
                or name == self._phase):
            return
        if cycle > self._pc:
            self.segments.append(
                (self._phase, self._pc, cycle, self._pus, us))
            self._pc = cycle
            self._pus = us
        self._phase = name

    def finish(self, outcome: str, cycle: int, us: float) -> None:
        """Stamp the terminal state and close the pending segment.  An
        unstarted span (deferred, then withdrawn/evicted before its
        clock began) closes zero-length."""
        if self.outcome is not None:
            return
        if not self.started:
            self.begin(cycle, us)
        if cycle > self._pc:
            self.segments.append(
                (self._phase, self._pc, cycle, self._pus, us))
        self.end_cycle = cycle
        self.end_us = us
        self.outcome = outcome
        self._phase = None

    @property
    def e2e_cycles(self) -> int:
        return self.end_cycle - self.start_cycle

    @property
    def e2e_us(self) -> float:
        return self.end_us - self.start_us

    def components(self) -> Dict[str, int]:
        """Per-phase drain-cycle totals.  For every finished span,
        ``sum(components().values()) == e2e_cycles`` exactly."""
        comps = {p: 0 for p in SPAN_PHASES}
        for phase, c0, c1, _us0, _us1 in self.segments:
            comps[phase] += c1 - c0
        return comps

    def slack_cycles(self) -> int:
        comps = self.components()
        return sum(comps[p] for p in SLACK_PHASES)

    def to_dict(self) -> Dict[str, Any]:
        return {"tenant": self.tenant, "rid": self.rid,
                "class": self.cls, "outcome": self.outcome,
                "e2e_cycles": self.e2e_cycles,
                "components": self.components()}


class SpanLedger:
    """Owns every :class:`RequestSpan` and folds closed spans into the
    per-tenant-class SLO attainment ledger.

    A latency-critical span *attains* its SLO when it completes with
    slack (queue+hold+preempt+stall cycles) within the class's
    ``queue_age_budget``; everything else — over-budget completions,
    evictions, withdrawals — is a violation with a cause (the dominant
    slack phase, or the terminal outcome).  Closing a span also emits
    its per-request Perfetto track (one ``X`` slice per phase segment,
    flow-linked back to the submit instant) and feeds the
    ``request_e2e_cycles`` / ``request_e2e_us`` histograms.

    All methods are None-tolerant and off-mode no-ops: with telemetry
    disabled :meth:`open` returns None and every other method returns
    immediately, so the serve hot paths stay byte-identical.
    """

    #: closed spans retained for audit (tests, macro-bench reconciliation)
    CLOSED_KEEP = 4096

    def __init__(self, tel: "Telemetry"):
        self.tel = tel
        self._open: Dict[int, RequestSpan] = {}
        self._next_id = 1
        self.closed: Deque[RequestSpan] = deque(maxlen=self.CLOSED_KEEP)
        #: class name -> {"attained", "violated", "causes": {cause: n}}
        self.classes: Dict[str, Dict[str, Any]] = {}
        #: tenant -> {"attained", "violated"} (dropped on forget_tenant)
        self.by_tenant: Dict[str, Dict[str, int]] = {}
        #: lifetime terminal-outcome totals
        self.totals: Dict[str, int] = {}

    def open_count(self) -> int:
        return len(self._open)

    def open(self, tenant: str, rid: int, cls: Optional[str] = None,
             budget: Optional[int] = None,
             defer: bool = False) -> Optional[RequestSpan]:
        """New span for request ``rid`` (None when telemetry is off).
        ``defer=True`` registers the span without starting its clock —
        :meth:`begin` starts it when the request becomes admissible."""
        if not self.tel.enabled:
            return None
        sp = RequestSpan(tenant, rid, self._next_id, cls=cls,
                         budget=budget)
        self._next_id += 1
        self._open[sp.sid] = sp
        if not defer:
            self.begin(sp)
        return sp

    def begin(self, sp: Optional[RequestSpan]) -> None:
        if sp is None or sp.started:
            return
        trace = self.tel.trace
        sp.begin(self.tel.cycle, trace.now_us())
        trace.emit("req_submit", sp.tenant, sp.start_cycle,
                   ts_us=sp.start_us, flow=("s", sp.sid), rid=sp.rid)

    def phase(self, sp: Optional[RequestSpan], name: str) -> None:
        """Transition ``sp`` at the current drain cycle (cheap no-op on
        None / unstarted / same-phase — callers don't guard)."""
        if sp is None or not sp.started or name == sp._phase:
            return
        sp.phase(name, self.tel.cycle, self.tel.trace.now_us())

    def close(self, sp: Optional[RequestSpan], outcome: str) -> None:
        """Terminal transition: fold the span into the ledger, feed the
        latency histograms, emit its Perfetto track."""
        if sp is None or sp.outcome is not None:
            return
        cycle = self.tel.cycle
        trace = self.tel.trace
        sp.finish(outcome, cycle, trace.now_us())
        self._open.pop(sp.sid, None)
        self.closed.append(sp)
        self.totals[outcome] = self.totals.get(outcome, 0) + 1

        reg = self.tel.registry
        reg.inc(f"requests_{outcome}", tenant=sp.tenant)
        reg.observe("request_e2e_cycles", float(sp.e2e_cycles),
                    tenant=sp.tenant)
        reg.observe("request_e2e_us", sp.e2e_us, tenant=sp.tenant,
                    timing=True)

        comps = sp.components()
        slack = sum(comps[p] for p in SLACK_PHASES)
        attained = (outcome == "complete"
                    and (sp.budget is None or slack <= sp.budget))
        row = self.by_tenant.get(sp.tenant)
        if row is None:
            row = self.by_tenant[sp.tenant] = {"attained": 0,
                                               "violated": 0}
        cls = sp.cls if sp.cls is not None else "unclassified"
        crow = self.classes.get(cls)
        if crow is None:
            crow = self.classes[cls] = {"attained": 0, "violated": 0,
                                        "causes": {}}
        if attained:
            reg.inc("slo_attained", tenant=sp.tenant)
            row["attained"] += 1
            crow["attained"] += 1
        else:
            reg.inc("slo_violated", tenant=sp.tenant)
            row["violated"] += 1
            crow["violated"] += 1
            cause = outcome if outcome != "complete" else \
                max(SLACK_PHASES, key=lambda p: comps[p])
            crow["causes"][cause] = crow["causes"].get(cause, 0) + 1

        track = f"{sp.tenant}:r{sp.rid}"
        first = True
        for name, c0, c1, us0, us1 in sp.segments:
            trace.emit(name, track, c0, dur_us=max(us1 - us0, 0.0),
                       ts_us=us0, cycles=c1 - c0,
                       flow=("f", sp.sid) if first else None)
            first = False
        trace.emit(f"req_{outcome}", track, cycle, rid=sp.rid,
                   e2e_cycles=sp.e2e_cycles, slack=slack,
                   flow=("f", sp.sid) if first else None)

    def forget_tenant(self, tenant_id: str) -> None:
        """Eviction path: close the departed tenant's open spans (each
        counts as a violated request with cause ``evicted``) before the
        registry drops its series, then drop the per-tenant ledger row.
        Class-level aggregates survive — fleet history, not tenant
        state."""
        for sid in [s for s, sp in self._open.items()
                    if sp.tenant == tenant_id]:
            self.close(self._open[sid], "evicted")
        self.by_tenant.pop(tenant_id, None)

    def to_dict(self) -> Dict[str, Any]:
        classes: Dict[str, Any] = {}
        for cls, row in sorted(self.classes.items()):
            total = row["attained"] + row["violated"]
            classes[cls] = {
                "attained": row["attained"],
                "violated": row["violated"],
                "attainment": row["attained"] / total if total else 1.0,
                "causes": dict(sorted(row["causes"].items())),
            }
        return {
            "classes": classes,
            "tenants": {t: dict(r)
                        for t, r in sorted(self.by_tenant.items())},
            "open_spans": len(self._open),
            "completed": self.totals.get("complete", 0),
            "evicted": self.totals.get("evicted", 0),
            "withdrawn": self.totals.get("withdrawn", 0),
        }


class Telemetry:
    """The flight-recorder facade a :class:`GuardianManager` owns.

    Bundles the :class:`MetricsRegistry` and :class:`EventTrace` behind
    one ``enabled`` switch and assembles the unified operator report.
    The manager back-reference exists only for *report-time* reads (it
    is never touched on a record path), plus the drain-cycle clock.
    """

    def __init__(self, manager: Any = None, enabled: bool = True,
                 trace_capacity: int = 65536):
        self.manager = manager
        self.enabled = enabled
        self.registry = MetricsRegistry(enabled=enabled)
        self.trace = EventTrace(capacity=trace_capacity, enabled=enabled)
        self.spans = SpanLedger(self)

    @property
    def cycle(self) -> int:
        """The scheduler's current drain-cycle counter — the logical
        clock every event is stamped with."""
        if self.manager is None:
            return 0
        return self.manager.scheduler._cycle

    def event(self, name: str, track: str,
              dur_us: Optional[float] = None,
              ts_us: Optional[float] = None, **args: Any) -> None:
        """Emit a lifecycle event stamped with the current drain cycle."""
        if not self.enabled:
            return
        self.trace.emit(name, track, self.cycle, dur_us=dur_us,
                        ts_us=ts_us, **args)

    def forget_tenant(self, tenant_id: str) -> None:
        # spans first: closing an evicted tenant's open spans writes its
        # counters, which the registry purge below then drops
        self.spans.forget_tenant(tenant_id)
        self.registry.forget_tenant(tenant_id)

    # ------------------------------------------------------------------ #
    # Legacy views (API-compatible with the pre-registry surfaces)       #
    # ------------------------------------------------------------------ #
    def violation_view(self) -> Dict[str, Any]:
        """The ``violation_report()`` body: per-tenant per-kind OOB
        counts (synchronizing — one ViolationLog snapshot), lifecycle
        states, transfer violations, quarantine events."""
        from repro_torch.core.quarantine import TenantState
        from repro_torch.core.violations import KIND_NAMES

        mgr = self.manager
        snap = mgr.violog.snapshot()
        tenants: Dict[str, Dict[str, Any]] = {}
        for t in mgr.violog.tenants():
            counts = mgr.violog.counts(t, snap=snap)
            state = mgr.quarantine.state_of(t)
            tenants[t] = {
                **counts,
                "total": sum(counts.values()),
                "state": state.value if state
                else TenantState.ACTIVE.value,
            }
        for rec in mgr.quarantine.machine.records():
            if rec.tenant_id in tenants:
                continue
            counts = {k: rec.final_counts.get(k, 0) for k in KIND_NAMES}
            tenants[rec.tenant_id] = {
                **counts,
                "total": sum(counts.values()),
                "state": rec.state.value,
            }
        return {
            "tenants": tenants,
            "transfer_violations": list(mgr.violations),
            "events": list(mgr.quarantine.events),
        }

    def jit_cache_view(self) -> Dict[str, Any]:
        """The ``jit_cache_stats()`` body: occupancy + evictions of every
        LRU-bounded compiled cache (host dict sizes — never a sync)."""
        from repro_torch.core.scheduler import LRUCache

        mgr = self.manager
        per_kernel = {name: len(e.jit_cache)
                      for name, e in mgr.pointer_to_symbol.items()}
        return {
            "capacity": mgr.jit_cache_capacity,
            "entries": sum(per_kernel.values()),
            "per_kernel": per_kernel,
            "evictions": sum(e.jit_cache.evictions
                             for e in mgr.pointer_to_symbol.values()
                             if isinstance(e.jit_cache, LRUCache)),
            "fused_capacity": mgr.scheduler._fused_cache.capacity,
            "fused_entries": len(mgr.scheduler._fused_cache),
            "fused_evictions": mgr.scheduler._fused_cache.evictions,
        }

    # ------------------------------------------------------------------ #
    # The unified report                                                 #
    # ------------------------------------------------------------------ #
    def report(self) -> Dict[str, Any]:
        """One dict unifying the five legacy surfaces plus the registry:
        per-tenant rows (state, policy, SLO class, weight, extent,
        utilization, queue-age p50/p90/p99, violation counts), the
        scheduler/launch
        summaries, the drain-cycle wall-time histogram, jit-cache and
        elastic stats.  Synchronizing (the violation view snapshots the
        device log) — an operator surface, never a hot-path call."""
        mgr = self.manager
        vio = self.violation_view()
        stats = mgr.scheduler.stats
        tenants: Dict[str, Dict[str, Any]] = {}
        for t in sorted(mgr.bounds.tenants()):
            part = mgr.bounds.lookup(t)
            sub = mgr._suballoc.get(t)
            state = mgr.quarantine.state_of(t)
            util = self.registry.gauge("arena_utilization", tenant=t)
            cp = mgr.class_policy_of(t)
            tenants[t] = {
                "state": state.value if state else "active",
                "policy": mgr.policy_of(t).value,
                "class": cp.tenant_class.value if cp is not None else None,
                "weight": mgr.weight_of(t),
                "partition": {"base": part.base, "size": part.size},
                "live_slots": sub.live_bytes() if sub is not None
                else None,
                "utilization": util,
                # serving-plane gauges (continuous driver): batch rows
                # currently held and fraction of the page extent in use
                "inflight": self.registry.gauge("serve_inflight",
                                                tenant=t),
                "page_occupancy": self.registry.gauge("page_occupancy",
                                                      tenant=t),
                "queue_age": self.registry.percentiles(
                    "queue_age_cycles", tenant=t),
                # request-span ledger: end-to-end latency percentiles
                # (wall us) and SLO attainment counts for the serving
                # plane (zeros/absent for non-serving tenants)
                "latency": self.registry.percentiles(
                    "request_e2e_us", tenant=t),
                "slo": self.spans.by_tenant.get(
                    t, {"attained": 0, "violated": 0}),
                "violations": vio["tenants"].get(t, {}),
            }
        return {
            "tenants": tenants,
            "scheduler": {
                **stats.summary(),
                "queue_age": stats.queue_age_percentiles(),
                "queue_age_by_class":
                    stats.queue_age_percentiles_by_class(),
                "fused_width": self.registry.percentiles(
                    "fused_step_width"),
            },
            "drain": self.registry.percentiles("drain_cycle_us"),
            "drain_cycles": self.registry.counter("drain_cycles"),
            "launch": mgr.launch_stats.summary(),
            "jit_cache": self.jit_cache_view(),
            "elastic": {
                **mgr.elastic.stats,
                "waitlist": len(mgr.elastic.waitlist),
                "waitlist_age": self.registry.percentiles(
                    "waitlist_age_cycles"),
            },
            "memory": mgr.memory_usage(),
            "violations": vio,
            "counters": {n: dict(sorted(s.items()))
                         for n, s in sorted(
                             self.registry.counters.items())},
            "gauges": {n: dict(sorted(s.items()))
                       for n, s in sorted(self.registry.gauges.items())},
            "slo": self.spans.to_dict(),
            "trace": {"events": len(self.trace),
                      "emitted": self.trace.emitted,
                      "dropped": self.trace.dropped,
                      "capacity": self.trace.capacity},
        }

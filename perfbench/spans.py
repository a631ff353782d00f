"""The program's host spans beside the card's trace: what a traced run
keeps of them, the span tree of a serve cycle, each layer's host time,
and the split of the device's idle time over the span open on the host.

The program records the spans itself (``repro_torch``'s
``EventTrace.spans``, off by default): per serve cycle a ``serve.cycle``
holding ``serve.leave``, ``serve.join``, ``serve.dispatch`` (with its
``serve.stage``), the manager's ``manager.drain`` and ``serve.finish``;
inside the drain ``sched.flush`` > ``sched.execute`` > ``step.run`` >
``step.stage`` / ``step.replay`` / ``step.capture``, and
``manager.poll``; ``host.gc`` wherever the garbage collector ran.  A
:class:`Collector` turns them on for a window, takes them after each
chunk mapped onto the profiler's clock (the host's wall clock,
``time.time_ns``) and keeps the ``serve_requests_scanned`` counter; a
:class:`SpanRecord` is what the metric readers get, as ``rec.spans``.

Layers, by the innermost span open (``host.gc`` counts to the span it
interrupted): ``step.*`` the compiled steps, ``manager.*`` and
``sched.*`` the control plane, ``serve.*`` the serve driver.  The
harness adds one span of its own to the tree, ``bench.profiler``, around
the profiler's start and stop (which run inside a serve cycle and which
the window leaves out); it belongs to no layer.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from perfbench.trace import _kind

#: metric layers, by span name prefix
LAYERS = (("step.", "step"), ("manager.", "control"), ("sched.", "control"),
          ("serve.", "driver"))
GC = "host.gc"
PROFILER = "bench.profiler"


class Span(NamedTuple):
    name: str
    sid: int
    parent: int                 # 0: a root
    start: int                  # ns, the profiler's clock
    end: int
    args: dict


@dataclasses.dataclass
class SpanRecord:
    """A window's host spans, for the metric readers."""
    spans: List[Span]
    #: every span of the window reached here (the ring dropped none)
    complete: bool = True
    #: ``serve_requests_scanned`` over the window
    scanned: int = 0
    #: the profiled span, on the profiler's clock (None: not traced)
    bounds: Optional[Tuple[int, int]] = None
    #: the graph-launch runtime calls in the profiled span
    launches: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


def of(rec) -> Optional[SpanRecord]:
    """The run's spans, or None where it kept none or lost some."""
    sr = getattr(rec, "spans", None)
    return sr if sr is not None and sr.complete and sr.spans else None


def layer_of(name: str) -> Optional[str]:
    for prefix, layer in LAYERS:
        if name.startswith(prefix):
            return layer
    return None


# --------------------------------------------------------------------- #
# Collection                                                            #
# --------------------------------------------------------------------- #

class Collector:
    """The spans of one window from a manager's telemetry: ``start``
    turns the switch on (unless ``on`` is False: the same run without
    spans), ``take`` after each chunk keeps what closed since, mapped
    onto the wall clock, ``stop`` turns the switch off."""

    COUNTER = "serve_requests_scanned"

    def __init__(self, telemetry, on: bool = True):
        self.trace = telemetry.trace
        self.registry = telemetry.registry
        self.on = on
        self.spans: List[Span] = []
        self.complete = True
        self._mark = 0
        self._scanned0 = 0
        self.scanned = 0

    def start(self) -> None:
        self._mark = self.trace.emitted
        self._scanned0 = self.registry.counter(self.COUNTER)
        self.trace.spans = self.on

    def take(self) -> None:
        tr = self.trace
        try:
            evs = tr.since(self._mark)
        except LookupError:
            self.complete = False
            evs = []
        self._mark = tr.emitted
        for ev in evs:
            if ev.sid is not None:
                self.spans.append(Span(
                    ev.name, ev.sid, ev.parent, tr.wall_ns(ev.ts_us),
                    tr.wall_ns(ev.ts_us + ev.dur_us), dict(ev.args)))
        self.scanned = self.registry.counter(self.COUNTER) - self._scanned0

    def stop(self) -> None:
        self.take()
        self.trace.spans = False

    def record(self, bounds=None, launches=()) -> SpanRecord:
        return SpanRecord(spans=self.spans, complete=self.complete,
                          scanned=self.scanned, bounds=bounds,
                          launches=list(launches))


def graph_launches(events, w0: int, w1: int) -> List[Tuple[int, int]]:
    """The ``cudaGraphLaunch`` runtime calls among the profiler's events
    that began inside ``[w0, w1)``."""
    return sorted((ev.start_ns(), ev.end_ns()) for ev in events
                  if _kind(ev) == "runtime"
                  and ev.name().startswith("cudaGraphLaunch")
                  and w0 <= ev.start_ns() < w1)


# --------------------------------------------------------------------- #
# The span tree                                                         #
# --------------------------------------------------------------------- #

def named(spans: Iterable[Span], name: str) -> List[Span]:
    return [s for s in spans if s.name == name]


def children(spans: Iterable[Span]) -> Dict[int, List[Span]]:
    out: Dict[int, List[Span]] = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def descendants(kids: Dict[int, List[Span]], s: Span,
                names: Tuple[str, ...]) -> List[Span]:
    """The spans below ``s`` called one of ``names``, not below one
    another."""
    out, todo = [], list(kids.get(s.sid, ()))
    while todo:
        c = todo.pop()
        if c.name in names:
            out.append(c)
        else:
            todo.extend(kids.get(c.sid, ()))
    return out


def self_ms(spans: List[Span], outer: str, *inner: str) -> Optional[float]:
    """Mean over the ``outer`` spans of their time less that of the
    spans below them called one of ``inner`` or ``bench.profiler``, in
    ms."""
    outs = named(spans, outer)
    if not outs:
        return None
    kids = children(spans)
    names = (*inner, PROFILER)
    tot = sum((s.end - s.start)
              - sum(c.end - c.start for c in descendants(kids, s, names))
              for s in outs)
    return 1e-6 * tot / len(outs)


def depths(spans: List[Span]) -> Dict[int, int]:
    by = {s.sid: s for s in spans}
    out: Dict[int, int] = {}
    for s in spans:
        chain, p = [], s
        while p is not None and p.sid not in out:
            chain.append(p)
            p = by.get(p.parent)
        d = out[p.sid] if p is not None else -1
        for q in reversed(chain):
            d += 1
            out[q.sid] = d
    return out


# --------------------------------------------------------------------- #
# The idle split                                                        #
# --------------------------------------------------------------------- #

def idle_intervals(busy: List[Tuple[int, int]], w0: int, w1: int
                   ) -> List[Tuple[int, int]]:
    """``[w0, w1)`` less the union of ``busy``."""
    out, t = [], w0
    for s, e in sorted(busy):
        s, e = max(s, w0), min(e, w1)
        if e <= t:
            continue
        if s > t:
            out.append((t, s))
        t = e
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return out


def innermost(spans: List[Span], w0: int, w1: int
              ) -> List[Tuple[int, int, Optional[str], bool]]:
    """``[w0, w1)`` cut where the innermost open span changes: ``(start,
    end, name, gc)`` with the innermost span's name (``host.gc`` passed
    over for the span it interrupted; None: no span open) and whether a
    collection ran.  One sweep over the spans' sorted edges."""
    depth = depths(spans)
    edges = []
    for s in spans:
        d = depth[s.sid]
        edges.append((s.start, 1, d, s))
        edges.append((s.end, 0, -d, s))
    edges.sort(key=lambda x: x[:3])
    stack: List[Span] = []
    out: List[Tuple[int, int, Optional[str], bool]] = []
    t = w0

    def state():
        gc = False
        for s in reversed(stack):
            if s.name == GC:
                gc = True
                continue
            return s.name, gc
        return None, gc

    for te, kind, _, s in edges:
        if te > t and t < w1:
            name, gc = state()
            out.append((t, min(te, w1), name, gc))
            t = min(te, w1)
        if kind:
            stack.append(s)
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is s:
                    del stack[i]
                    break
    if t < w1:
        name, gc = state()
        out.append((t, w1, name, gc))
    return out


@dataclasses.dataclass
class Split:
    """The profiled span's idle device time by the host's innermost
    span, in seconds."""
    window_s: float
    idle_s: float
    by_name: Dict[Optional[str], float]
    gc_s: float                 # of it, while a collection ran

    def layer_s(self, layer: str) -> float:
        return sum(v for k, v in self.by_name.items()
                   if k is not None and layer_of(k) == layer)

    def share(self, layer: str) -> Optional[float]:
        if self.window_s <= 0:
            return None
        return 100.0 * self.layer_s(layer) / self.window_s


def split_idle(busy: List[Tuple[int, int]], w0: int, w1: int,
               spans: List[Span]) -> Split:
    """Each idle interval of the device in ``[w0, w1)`` split over the
    innermost span open on the host at each instant."""
    idle = idle_intervals(busy, w0, w1)
    segs = innermost(spans, w0, w1)
    by: Dict[Optional[str], float] = {}
    gc_s = 0.0
    starts = [s for s, _, _, _ in segs]
    for a, b in idle:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s, e, name, gc = segs[i]
            lo, hi = max(s, a), min(e, b)
            if hi > lo:
                by[name] = by.get(name, 0.0) + (hi - lo) * 1e-9
                if gc:
                    gc_s += (hi - lo) * 1e-9
            i += 1
    return Split(window_s=(w1 - w0) * 1e-9,
                 idle_s=sum(b - a for a, b in idle) * 1e-9, by_name=by,
                 gc_s=gc_s)


def longest_gaps(busy: List[Tuple[int, int]], w0: int, w1: int,
                 spans: List[Span], n: int = 10
                 ) -> List[Tuple[float, List[Tuple[Optional[str], float]]]]:
    """The ``n`` longest idle intervals of the device in ``[w0, w1)``,
    longest first: seconds, and the seconds of each innermost span over
    it, most first (``host.gc`` as itself here)."""
    idle = sorted(idle_intervals(busy, w0, w1), key=lambda g: g[0] - g[1])
    out = []
    for a, b in idle[:n]:
        by: Dict[Optional[str], float] = {}
        for s, e, name, gc in innermost(
                [x for x in spans if x.end > a and x.start < b], a, b):
            key = GC if gc else name
            by[key] = by.get(key, 0.0) + (e - s) * 1e-9
        out.append(((b - a) * 1e-9, sorted(by.items(),
                                           key=lambda kv: -kv[1])))
    return out


def split_of(rec) -> Optional[Split]:
    """The split of a traced run with spans, or None."""
    sr = of(rec)
    if sr is None or sr.bounds is None or rec.trace is None:
        return None
    w0, w1 = sr.bounds
    return split_idle([(op.start, op.end) for op in rec.trace.ops], w0, w1,
                      sr.spans)


def launch_coverage(spans: List[Span], launches: List[Tuple[int, int]]
                    ) -> Tuple[int, int]:
    """(how many of ``launches`` lie inside a ``step.replay`` span, how
    many there are)."""
    replays = sorted((s.start, s.end) for s in named(spans, "step.replay"))
    starts = [s for s, _ in replays]
    inside = 0
    for a, b in launches:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and replays[i][1] >= b:
            inside += 1
    return inside, len(launches)

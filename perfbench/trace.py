"""The device trace of a traced chunk, reduced: device busy time, the
share of it each drain holds, each kernel's calls by drain, and the idle
gaps named by what the host was doing.

The profiler records the card only (``ProfilerActivity.CUDA``: its
operations and the runtime calls that launched them), so the host pays
for no record of its own operations.  The harness stamps its own host
ranges on the profiler's clock (the wall clock, ``time.time_ns``): the
traced span (``driver``) and each drain in it (``dispatch``, the
manager's ``run_queued``).  A device operation belongs to the last drain
whose range began before the runtime call that launched it (the profiler
links the two by ``correlation``), or, where no link is found, before the
operation began: the serve driver's own copies and merge between two
drains go to the earlier one.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Tuple



@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int                  # ns, the profiler's clock
    end: int
    drain: int = -1             # index of the traced drain, -1: none


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    drains: int
    ops: List[DeviceOp]
    drain_busy_s: List[float]
    gaps: List[Tuple[str, float]]     # (host range, seconds), longest first

    def calls(self, needle: str) -> Dict[int, List[float]]:
        """Seconds of every operation whose name holds ``needle``, by
        drain."""
        out: Dict[int, List[float]] = {}
        for op in self.ops:
            if needle in op.name and op.drain >= 0:
                out.setdefault(op.drain, []).append((op.end - op.start)
                                                    * 1e-9)
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for op in self.ops:
            tot[op.name] = tot.get(op.name, 0.0) + (op.end - op.start) * 1e-9
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _kind(ev) -> str:
    """The event's kind: ``runtime`` (a CUDA runtime or driver call),
    ``device`` (an operation on the card) or ``other``.  Read from the
    event's device and name, which every torch release since 2.0 gives
    (``activity_type`` is newer)."""
    if str(ev.device_type()).endswith("CUDA"):
        return "device"
    name = ev.name()
    if name.startswith("cu") and not name.startswith("cudnn"):
        return "runtime"
    return "other"


def reduce_events(events, host: Dict[str, List[Tuple[int, int]]]
                  ) -> Optional[Reduced]:
    """Reduce the profiler's events (``kineto_results.events()``) of one
    traced span, given the host ranges ``{"driver": [(start, end)],
    "dispatch": [(start, end), ...]}`` on the profiler's clock.  None when
    the trace holds no device operation."""
    runtime: Dict[int, int] = {}
    device: List[Tuple[str, int, int, int, int]] = []
    for ev in events:
        kind = _kind(ev)
        if kind == "runtime":
            runtime[ev.correlation_id()] = ev.start_ns()
        elif kind == "device":
            device.append((ev.name(), ev.start_ns(), ev.end_ns(),
                           ev.correlation_id(), ev.linked_correlation_id()))
    if not device or not host.get("driver"):
        return None
    w0 = min(s for s, _ in host["driver"])
    w1 = max(e for _, e in host["driver"])
    drains = sorted(host["dispatch"])
    starts = [s for s, _ in drains]

    def drain_at(t: int) -> int:
        i = bisect.bisect_right(starts, t) - 1
        return i

    ops: List[DeviceOp] = []
    for name, s, e, corr, linked in device:
        if e <= w0 or s >= w1:
            continue
        launched = runtime.get(corr, runtime.get(linked))
        d = drain_at(launched if launched is not None else s)
        ops.append(DeviceOp(name, max(s, w0), min(e, w1), d))
    busy = _union([(op.start, op.end) for op in ops])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    per: Dict[int, List[Tuple[int, int]]] = {}
    for op in ops:
        if op.drain >= 0:
            per.setdefault(op.drain, []).append((op.start, op.end))
    drain_busy = [sum(e - s for s, e in _union(per.get(i, []))) * 1e-9
                  for i in range(len(drains))]
    # idle gaps, named by the innermost host range open when they began
    ranges = sorted(((s, e, name) for name, rs in host.items()
                     for s, e in rs), key=lambda r: r[1] - r[0])
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = []
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e <= s:
            continue
        label = next((n for r0, r1, n in ranges if r0 <= s < r1), "none")
        gaps.append((label, (e - s) * 1e-9))
    gaps.sort(key=lambda g: -g[1])
    return Reduced(window_s=(w1 - w0) * 1e-9, busy_s=busy_s,
                   drains=len(drains), ops=ops, drain_busy_s=drain_busy,
                   gaps=gaps)


class Tracer:
    """``torch.profiler`` over one traced span of the card, started and
    stopped by the driver's drain clock, which stamps the span's drains
    into ``drains``.  ``overhead_s``: the host seconds its start and stop
    took, which the window leaves out."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.running = False
        self.drains: List[Tuple[int, int]] = []
        self.overhead_s = 0.0
        self._span: List[int] = []

    def start(self) -> None:
        t = time.perf_counter()
        self._prof.start()
        self._span = [time.time_ns()]
        self.running = True
        self.overhead_s += time.perf_counter() - t

    def stop(self) -> None:
        self._span.append(time.time_ns())
        t = time.perf_counter()
        self._prof.stop()
        self.running = False
        self.overhead_s += time.perf_counter() - t

    def reduce(self) -> Optional[Reduced]:
        if len(self._span) != 2:
            return None
        return reduce_events(self._prof.profiler.kineto_results.events(),
                             {"driver": [tuple(self._span)],
                              "dispatch": self.drains})

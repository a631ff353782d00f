"""Terminal rendering of the Guardian flight recorder — the formatting
half of ``python -m repro_torch.top``.

Pure string assembly over the :meth:`GuardianManager.metrics_report`
dict (plus, optionally, the live :class:`MetricsRegistry` for bucket
sparklines).  No torch, no curses, no device access: the same text as
the reference's renderer for the same report (tests/test_torch_cli.py).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

#: eight-level unicode bars, lowest to highest
SPARK_CHARS = "▁▂▃▄▅▆▇█"

WIDTH = 72


def sparkline(values: Iterable[float]) -> str:
    """One character per value, scaled to the series max (all-zero and
    empty series render flat)."""
    vals = [max(float(v), 0.0) for v in values]
    if not vals:
        return ""
    top = max(vals)
    if top <= 0:
        return SPARK_CHARS[0] * len(vals)
    n = len(SPARK_CHARS)
    return "".join(
        SPARK_CHARS[min(int(v / top * (n - 1) + 0.5), n - 1)]
        for v in vals)


def _us(v: float) -> str:
    """Humanized microseconds."""
    if v < 1000:
        return f"{v:.0f}us"
    if v < 1e6:
        return f"{v / 1e3:.1f}ms"
    return f"{v / 1e6:.2f}s"


def _bytes(v: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if v < 1024 or unit == "GB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024
    return f"{v:.1f}GB"      # pragma: no cover


def _rule(title: str) -> str:
    pad = WIDTH - len(title) - 4
    return f"── {title} {'─' * max(pad, 2)}"


def _pcts(d: Dict[str, float], unit: str = "") -> str:
    fmt = _us if unit == "us" else (lambda x: f"{x:g}")
    return (f"p50 {fmt(d.get('p50', 0.0))}  p90 {fmt(d.get('p90', 0.0))}"
            f"  p99 {fmt(d.get('p99', 0.0))}"
            f"  (n={int(d.get('count', 0))})")


def format_tenants(report: Dict[str, Any]) -> List[str]:
    lines = [f"{'tenant':<18}{'state':<12}{'policy':<9}{'cls':>4}{'wt':>3}"
             f"{'extent':>15}{'util':>6}{'infl':>5}{'pg%':>5}"
             f"{'q50':>5}{'q99':>5}"
             f"{'e2e50':>8}{'e2e99':>8}{'slo%':>6}{'viol':>6}"]
    short_cls = {"latency_critical": "lc", "best_effort": "be"}
    for name, row in sorted(report.get("tenants", {}).items()):
        part = row.get("partition", {})
        extent = f"[{part.get('base', 0)},{part.get('base', 0) + part.get('size', 0)})"
        util = row.get("utilization")
        infl = row.get("inflight")
        pg = row.get("page_occupancy")
        age = row.get("queue_age", {})
        cls = short_cls.get(row.get("class"), "-")
        # request-span ledger columns: end-to-end latency percentiles
        # and SLO attainment (dashes for tenants that never served)
        lat = row.get("latency", {})
        slo = row.get("slo", {})
        served = slo.get("attained", 0) + slo.get("violated", 0)
        e50 = _us(lat["p50"]) if lat.get("count") else "-"
        e99 = _us(lat["p99"]) if lat.get("count") else "-"
        att = f"{slo.get('attained', 0) / served:.0%}" if served else "-"
        lines.append(
            f"{name:<18}{row.get('state', '?'):<12}"
            f"{row.get('policy', '?'):<9}{cls:>4}{row.get('weight', 1):>3}"
            f"{extent:>15}"
            f"{('-' if util is None else f'{util:.2f}'):>6}"
            f"{('-' if infl is None else f'{int(infl)}'):>5}"
            f"{('-' if pg is None else f'{pg:.0%}'):>5}"
            f"{age.get('p50', 0.0):>5g}{age.get('p99', 0.0):>5g}"
            f"{e50:>8}{e99:>8}{att:>6}"
            f"{row.get('violations', {}).get('total', 0):>6}")
    return lines


def format_report(report: Dict[str, Any],
                  registry: Any = None) -> str:
    """Render one metrics_report() snapshot as a terminal dashboard.

    ``registry`` (the live :class:`MetricsRegistry`, optional) adds
    bucket sparklines for the drain-cycle and fused-width histograms —
    the report dict alone carries only their percentiles.
    """
    sched = report.get("scheduler", {})
    drain = report.get("drain", {})
    jc = report.get("jit_cache", {})
    el = report.get("elastic", {})
    mem = report.get("memory", {})
    launch = report.get("launch", {})
    trace = report.get("trace", {})
    vio = report.get("violations", {})
    slo = report.get("slo", {})

    lines: List[str] = [
        f"guardian flight recorder — {len(report.get('tenants', {}))} "
        f"tenant(s), {report.get('drain_cycles', 0)} drain cycle(s)",
        _rule("tenants"),
        *format_tenants(report),
        _rule("scheduler"),
        (f"launches {int(sched.get('total_launches', 0))}"
         f"  device steps {int(sched.get('device_steps', 0))}"
         f" (fused {int(sched.get('fused_steps', 0))},"
         f" check {int(sched.get('check_steps', 0))},"
         f" proven {int(sched.get('proven_steps', 0))})"
         f"  mean width {sched.get('mean_batch_width', 0.0):.1f}"
         f"  max {int(sched.get('max_batch_width', 0))}"),
        (f"queue age   {_pcts(sched.get('queue_age', {}))} cycles"
         f"   lookahead fused {int(sched.get('lookahead_fused', 0))},"
         f" budget {int(sched.get('lookahead_budget', 0))}"
         f"   be preempts {int(sched.get('be_preemptions', 0))}"),
        *(f"  {cls:<18}{_pcts(p)} cycles"
          for cls, p in sorted(
              sched.get("queue_age_by_class", {}).items())),
        f"fused width {_pcts(sched.get('fused_width', {}))}",
        _rule("drain cycles"),
        f"wall time   {_pcts(drain, unit='us')}",
    ]
    if registry is not None:
        h = registry.histogram("drain_cycle_us")
        if h is not None:
            lines.append(f"buckets     {sparkline(h.buckets)}  "
                         f"({_us(h.bounds[0])}..{_us(h.bounds[-1])}+)")
        w = registry.histogram("fused_step_width")
        if w is not None:
            lines.append(f"widths      {sparkline(w.buckets)}  "
                         f"({w.bounds[0]:g}..{w.bounds[-1]:g}+)")
    lines += [
        _rule("jit cache"),
        (f"kernel entries {jc.get('entries', 0)}/{jc.get('capacity', 0)}"
         f" (evictions {jc.get('evictions', 0)})"
         f"   fused {jc.get('fused_entries', 0)}/"
         f"{jc.get('fused_capacity', 0)}"
         f" (evictions {jc.get('fused_evictions', 0)})"),
        _rule("elastic"),
        (f"admitted {el.get('admitted', 0)}"
         f"  waitlisted {el.get('waitlisted', 0)}"
         f" ({el.get('waitlist', 0)} waiting)"
         f"  grows {el.get('grows', 0)}  shrinks {el.get('shrinks', 0)}"
         f"  relocations {el.get('relocations', 0)}"
         f"  compactions {el.get('compactions', 0)}"),
        f"waitlist age {_pcts(el.get('waitlist_age', {}))} cycles",
        _rule("memory"),
        (f"arena {_bytes(mem.get('arena_bytes', 0))}"
         f"  free slots {mem.get('free_slots', 0)}"
         f"  live: " + (", ".join(
             f"{t}={n}" for t, n in sorted(
                 mem.get("tenant_live_slots", {}).items())) or "-")),
        _rule("launch path"),
        (f"lookup {launch.get('lookup_ns', 0.0):.0f}ns"
         f"  augment {launch.get('augment_ns', 0.0):.0f}ns"
         f"  dispatch {launch.get('dispatch_ns', 0.0):.0f}ns"),
        _rule("violations"),
        (f"transfer {len(vio.get('transfer_violations', []))}"
         f"  quarantine events {len(vio.get('events', []))}"),
        _rule("slo ledger"),
        (f"requests: {slo.get('completed', 0)} completed"
         f"  {slo.get('evicted', 0)} evicted"
         f"  {slo.get('withdrawn', 0)} withdrawn"
         f"  ({slo.get('open_spans', 0)} spans open)"),
        *(f"  {cls:<18}attained {row.get('attained', 0)}"
          f"  violated {row.get('violated', 0)}"
          f"  ({row.get('attainment', 1.0):.1%})"
          + ("  causes: " + ",".join(
              f"{c}={n}" for c, n in sorted(
                  row.get("causes", {}).items()))
             if row.get("causes") else "")
          for cls, row in sorted(slo.get("classes", {}).items())),
        _rule("trace"),
        (f"{trace.get('events', 0)} event(s) buffered"
         f" ({trace.get('emitted', 0)} emitted,"
         f" capacity {trace.get('capacity', 0)})"
         + (f"  ! {trace.get('dropped', 0)} dropped (ring overflow — "
            f"raise trace_capacity)"
            if trace.get("dropped", 0) else "")),
    ]
    return "\n".join(lines)

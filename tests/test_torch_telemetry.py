"""The port's flight recorder and dashboard against the reference's: the
mirrors of tests/test_telemetry.py.  The unit cases feed the same values
(and the same Hypothesis draws) to both recorders and compare what they
return; the manager-plane cases run one scenario on the reference and on
the port (the CPU, launches compiled and eager) with the tenant kernel in
jnp and in torch, and hold the registry's logical snapshot, the
Prometheus text without its wall-clock series, the trace's events (name,
track, cycle, flow id), the metrics report's logical fields and the arena
bytes equal field by field, besides the reference test's own assertions
on the port's run.  The serving cases run the port's engines on the
reference's weights.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from _plane_parity import CFG_J, JAX, SERVE_REF, SERVE_SIDES, SIDES, \
    arena_bytes, logical_report, module, on_both, \
    telemetry_view  # noqa: E402
from _tenant_parity import assert_same_tree  # noqa: E402
from repro.launch import dashboard as DJ  # noqa: E402
from repro_torch.launch import dashboard as DT  # noqa: E402

TOTAL = 512
PORT = SIDES["compiled"]
SIDE = pytest.mark.parametrize("side", sorted(SIDES))


def _units(fn):
    """``fn(telemetry module)`` on both recorders."""
    return fn(module(JAX, "telemetry")), fn(module(PORT, "telemetry"))


def make_mgr(fw, n_tenants=3, **kw):
    kw.setdefault("total_slots", TOTAL)
    kw.setdefault("standalone_fast_path", False)
    mgr = fw.manager(**kw)
    clients, ptrs = [], []
    for i in range(n_tenants):
        c = mgr.register_tenant(f"t{i}", TOTAL // (2 * n_tenants))
        c.module_load("bump", fw.kernel("bump"))
        p = c.malloc(8)
        c.memcpy_h2d(p, np.zeros(8, np.float32))
        clients.append(c)
        ptrs.append(p)
    mgr.synchronize()
    return mgr, clients, ptrs


def drive(mgr, clients, ptrs, rounds=3):
    for _ in range(rounds):
        for c, p in zip(clients, ptrs):
            c.launch_kernel("bump", ptrs=[p], args=(8,))
        mgr.run_queued()


def _plane(mgr) -> dict:
    """What a manager-plane run is compared on."""
    report = logical_report(mgr.metrics_report())
    for k in ("jit_cache", "memory"):
        report.pop(k, None)
    return {"telemetry": telemetry_view(mgr.telemetry), "report": report,
            "arena": arena_bytes(mgr)}


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------

def _edge_ints(T):
    h = T.Histogram(T.QUEUE_AGE_BOUNDS)
    for v in (0, 1, 1, 2, 4):
        h.observe(v)
    return [h.count, h.mean, h.percentile(50), h.percentile(90),
            h.percentile(99), h.percentiles(), h.to_dict()]


def _empty_overflow(T):
    h = T.Histogram((0, 1, 2))
    out = [h.percentile(99), h.mean]
    h.observe(10_000)
    out += [h.percentile(50), h.to_dict()]
    for bad in ((), (2, 1)):
        with pytest.raises(ValueError):
            T.Histogram(bad)
    return out


@pytest.mark.parametrize("case", ["exact_on_edge_valued_ints",
                                  "empty_and_overflow"])
def test_histogram_units(case):
    """Mirrors test_histogram_exact_on_edge_valued_ints (percentiles exact
    on bucket-edge integers) and test_histogram_empty_and_overflow (an
    empty histogram reads 0, the overflow bucket reports the observed
    max, bad bounds raise): the port's histogram returns the
    reference's values."""
    ref, got = _units(_edge_ints if case.startswith("exact")
                      else _empty_overflow)
    if case.startswith("exact"):
        assert got[:5] == [5, pytest.approx(1.6), 1.0, 4.0, 4.0]
        assert got[5] == {"p50": 1.0, "p90": 4.0, "p99": 4.0,
                          "count": 5.0, "mean": pytest.approx(1.6)}
    else:
        assert got == [0.0, 0.0, 10_000.0, got[3]]
        assert got[3]["max"] == 10_000.0
    assert_same_tree(ref, got)


def _monotonic(T, vals, qs):
    h = T.Histogram(T.QUEUE_AGE_BOUNDS)
    for v in vals:
        h.observe(int(v))
    return [h.percentile(q) for q in qs], h.count, h.to_dict()


def test_histogram_percentiles_monotonic_sweep():
    """Mirrors test_histogram_percentiles_monotonic_sweep: ten seeded
    samples; monotonic percentiles, equal on both."""
    rng = np.random.default_rng(0)
    qs = (1, 25, 50, 75, 90, 99, 100)
    for _ in range(10):
        vals = rng.integers(0, 200, size=rng.integers(1, 40))
        ref, got = _units(lambda T: _monotonic(T, vals, qs))
        assert got[0] == sorted(got[0]) and got[1] == len(vals)
        assert got[0][-1] >= vals.max() or got[0][-1] == float(vals.max())
        assert_same_tree(ref, got)


@given(st.lists(st.integers(min_value=0, max_value=300), min_size=1,
                max_size=40))
@settings(max_examples=30, deadline=None)
def test_histogram_percentiles_monotonic_property(vals):
    """Mirrors test_histogram_percentiles_monotonic_property: the same
    drawn values into both histograms."""
    ref, got = _units(lambda T: _monotonic(T, vals, (1, 50, 90, 99, 100)))
    assert got[0] == sorted(got[0]) and got[1] == len(vals)
    assert got[0][0] >= 0
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------

def _disabled(T):
    reg = T.MetricsRegistry(enabled=False)
    reg.inc("x")
    reg.set_gauge("g", 1.0, tenant="a")
    reg.observe("h", 3.0)
    return [reg.snapshot(), reg.counter("x"), reg.gauge("g", tenant="a"),
            reg.percentiles("h")]


def _per_tenant(T):
    reg = T.MetricsRegistry()
    reg.inc("req", tenant="a")
    reg.inc("req", n=2, tenant="b")
    reg.inc("req")
    reg.observe("queue_age_cycles", 3, tenant="a")
    reg.set_gauge("util", 0.5, tenant="a")
    out = [reg.counter("req", tenant="a"), reg.counter("req", tenant="b"),
           reg.counter("req"), reg.snapshot(), reg.to_prometheus()]
    reg.forget_tenant("a")
    out += [reg.counter("req", tenant="a"), reg.counter("req", tenant="b"),
            reg.gauge("util", tenant="a"),
            reg.histogram("queue_age_cycles", tenant="a"), reg.snapshot()]
    return out


def _timing(T):
    reg = T.MetricsRegistry()
    reg.observe("drain_cycle_us", 123.0, timing=True)
    reg.observe("queue_age_cycles", 1)
    return [sorted(reg.snapshot(include_timing=True)["histograms"]),
            reg.snapshot(include_timing=False)]


def _prometheus(T):
    reg = T.MetricsRegistry()
    reg.inc("requests", n=3, tenant="a")
    reg.observe("queue_age_cycles", 1, tenant="a")
    reg.observe("queue_age_cycles", 500, tenant="a")
    reg.set_gauge("util", 0.25)
    return reg.to_prometheus()


REGISTRY_CASES = {"disabled_is_a_noop": _disabled,
                  "per_tenant_series_and_forget": _per_tenant,
                  "timing_series_excluded_from_logical_snapshot": _timing,
                  "prometheus_exposition_shape": _prometheus}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_units(case):
    """Mirrors test_registry_disabled_is_a_noop,
    test_registry_per_tenant_series_and_forget,
    test_registry_timing_series_excluded_from_logical_snapshot and
    test_prometheus_exposition_shape: the port's registry returns the
    reference's values and exposition text, and the reference test's own
    assertions hold on it."""
    ref, got = _units(REGISTRY_CASES[case])
    if case == "disabled_is_a_noop":
        assert got[0] == {"counters": {}, "gauges": {}, "histograms": {}}
        assert got[1] == 0 and got[2] is None and got[3]["count"] == 0.0
    elif case == "per_tenant_series_and_forget":
        assert got[:3] == [1, 2, 1] and got[5:9] == [0, 2, None, None]
    elif case.startswith("timing"):
        assert "drain_cycle_us" in got[0]
        assert list(got[1]["histograms"]) == ["queue_age_cycles"]
    else:
        lines = got.splitlines()
        assert got.endswith("\n")
        assert '# TYPE guardian_requests_total counter' in lines
        assert 'guardian_requests_total{tenant="a"} 3' in lines
        assert "guardian_util 0.25" in lines
        assert [ln for ln in lines if "+Inf" in ln] == [
            'guardian_queue_age_cycles_bucket{tenant="a",le="+Inf"} 2']
        assert 'guardian_queue_age_cycles_sum{tenant="a"} 501' in lines
        buckets = [int(ln.rsplit(" ", 1)[1]) for ln in lines
                   if "queue_age_cycles_bucket" in ln]
        assert buckets == sorted(buckets)
    assert_same_tree(ref, got)


def _feed(reg, ops):
    for kind, name, val, tenant in ops:
        if kind == 0:
            reg.inc(name, n=val, tenant=tenant)
        elif kind == 1:
            reg.set_gauge(name, float(val), tenant=tenant)
        else:
            reg.observe(name, float(val), tenant=tenant)


def _fed(T, ops):
    reg = T.MetricsRegistry()
    _feed(reg, ops)
    return reg.snapshot(), reg.to_prometheus()


def test_registry_determinism_sweep():
    """Mirrors test_registry_determinism_sweep: 200 seeded operations fed
    to a reference and a port registry give one snapshot and one
    exposition text."""
    rng = np.random.default_rng(1)
    ops = [(int(rng.integers(0, 3)), f"m{rng.integers(3)}",
            int(rng.integers(1, 9)),
            [None, "a", "b"][rng.integers(3)]) for _ in range(200)]
    ref, got = _units(lambda T: _fed(T, ops))
    assert got == _fed(module(PORT, "telemetry"), ops)
    assert_same_tree(ref, got)


@given(st.lists(st.tuples(st.integers(0, 2), st.sampled_from("xyz"),
                          st.integers(1, 9),
                          st.sampled_from([None, "a", "b"])),
                max_size=60))
@settings(max_examples=25, deadline=None)
def test_registry_determinism_property(ops):
    """Mirrors test_registry_determinism_property: the same drawn
    operations into both registries."""
    ref, got = _units(lambda T: _fed(T, ops))
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# EventTrace + Perfetto export
# ---------------------------------------------------------------------------

def _ring(T):
    tr = T.EventTrace(capacity=4)
    for i in range(6):
        tr.emit(f"e{i}", "trk", cycle=i)
    out = [len(tr), tr.emitted, [e.name for e in tr.events()]]
    tr.clear()
    return out + [len(tr), tr.emitted]


def _off(T):
    tr = T.EventTrace(enabled=False)
    tr.emit("e", "trk", cycle=0)
    return [len(tr), tr.emitted]


def _chrome(T):
    tr = T.EventTrace()
    tr.emit("a", "t0", cycle=0, slots=4)
    tr.emit("b", "t1", cycle=0)
    tr.emit("c", "t0", cycle=1)
    tr.emit("drain", T.DRAIN_TRACK, cycle=1, dur_us=5.0, ts_us=tr.now_us())
    doc = json.loads(tr.to_json())
    for e in doc["traceEvents"]:
        e.pop("ts", None)
    return doc


TRACE_CASES = {"trace_ring_buffer_drops_oldest": _ring,
               "trace_disabled_emits_nothing": _off,
               "chrome_export_roundtrips_with_monotonic_tracks": _chrome}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_units(case):
    """Mirrors test_trace_ring_buffer_drops_oldest,
    test_trace_disabled_emits_nothing and
    test_chrome_export_roundtrips_with_monotonic_tracks: the port's trace
    keeps, drops and exports (through ``json.loads``, timestamps left
    out) what the reference's does."""
    ref, got = _units(TRACE_CASES[case])
    if case.startswith("trace_ring"):
        assert got == [4, 6, ["e2", "e3", "e4", "e5"], 0, 6]
    elif case.startswith("trace_disabled"):
        assert got == [0, 0]
    else:
        evs = got["traceEvents"]
        names = {e["args"]["name"] for e in evs if e["ph"] == "M"}
        drain = module(PORT, "telemetry").DRAIN_TRACK
        assert {"guardian", "t0", "t1", drain} <= names
        body = [e for e in evs if e["ph"] in ("i", "X")]
        assert all(e["cat"] == "guardian" and "cycle" in e["args"]
                   for e in body)
        x = [e for e in body if e["ph"] == "X"]
        assert len(x) == 1 and x[0]["dur"] == 5.0
    assert_same_tree(ref, got)


def test_chrome_export_tracks_are_monotonic_on_the_port():
    """The rest of test_chrome_export_roundtrips_with_monotonic_tracks on
    the port's own export, timestamps kept: per-track monotonic."""
    T = module(PORT, "telemetry")
    tr = T.EventTrace()
    for i, trk in enumerate(("t0", "t1", "t0", "t1", "t0")):
        tr.emit(f"e{i}", trk, cycle=i)
    by_tid = {}
    for e in json.loads(tr.to_json())["traceEvents"]:
        if e["ph"] in ("i", "X"):
            by_tid.setdefault(e["tid"], []).append(e["ts"])
    assert by_tid and all(ts == sorted(ts) for ts in by_tid.values())


# ---------------------------------------------------------------------------
# Manager-plane instrumentation
# ---------------------------------------------------------------------------

@SIDE
def test_drain_instrumentation_and_report_shape(side):
    """Mirrors test_drain_instrumentation_and_report_shape: three tenants,
    three rounds; counters, per-tenant queue ages and the report's shape
    — and the whole logical recorder equal to the reference's."""
    def run(fw):
        mgr, clients, ptrs = make_mgr(fw, 3)
        drive(mgr, clients, ptrs, rounds=3)
        drains = [e for e in mgr.telemetry.trace.events()
                  if e.track == module(fw, "telemetry").DRAIN_TRACK]
        return {**_plane(mgr), "keys": sorted(mgr.metrics_report()),
                "drain_durations": all(e.dur_us is not None
                                       for e in drains),
                "drain_starts": [e.ts_us for e in drains]}
    ref, got = on_both(side, run)
    snap = got["telemetry"]["snapshot"]
    assert snap["counters"]["drain_cycles"][""] > 0
    assert snap["counters"]["tenants_registered"][""] == 3
    for t in ("t0", "t1", "t2"):
        assert snap["histograms"]["queue_age_cycles"][t]["count"] == 3
    assert {"tenants", "scheduler", "drain", "drain_cycles", "launch",
            "jit_cache", "elastic", "memory", "violations", "counters",
            "gauges", "trace"} <= set(got["keys"])
    rep = got["report"]
    assert rep["tenants"]["t1"]["state"] == "active"
    assert rep["scheduler"]["queue_age"]["count"] == 9.0
    assert rep["drain"]["count"] == float(rep["drain_cycles"])
    assert got["drain_durations"] and got["drain_starts"] == sorted(
        got["drain_starts"])
    ref, got = ({k: v for k, v in r.items() if k != "drain_starts"}
                for r in (ref, got))
    assert_same_tree(ref, got)


@SIDE
def test_legacy_reports_are_views_of_the_recorder(side):
    """Mirrors test_legacy_reports_are_views_of_the_recorder: the
    violation report and the jit cache stats are the recorder's views,
    with the reference's keys and values (the port's jit cache view adds
    its step graphs' counts)."""
    def run(fw):
        mgr, clients, ptrs = make_mgr(fw, 2)
        drive(mgr, clients, ptrs, rounds=1)
        vio, jc = mgr.violation_report(), mgr.jit_cache_stats()
        return {"vio": vio, "vio_is_view":
                vio == mgr.telemetry.violation_view(),
                "jc_is_view": jc == mgr.telemetry.jit_cache_view(),
                "jc": {k: jc[k] for k in (
                    "capacity", "fused_capacity", "evictions",
                    "fused_evictions")}}
    ref, got = on_both(side, run)
    assert got["vio_is_view"] and got["jc_is_view"]
    assert {"tenants", "transfer_violations", "events"} <= set(got["vio"])
    assert_same_tree(ref, got)


@SIDE
def test_queue_age_percentiles_under_lookahead(side):
    """Mirrors test_queue_age_percentiles_under_lookahead: two tenants x
    two ops under lookahead 1 dispatch as one width-4 step, ages
    (1, 1, 0, 0) exactly; a hold and a lookahead flush recorded."""
    def run(fw):
        mgr, clients, ptrs = make_mgr(fw, 2, lookahead_cycles=1)
        for _ in range(2):
            for c, p in zip(clients, ptrs):
                c.launch_kernel("bump", ptrs=[p], args=(8,))
        mgr.synchronize()
        return {**_plane(mgr),
                "ages": mgr.scheduler.stats.queue_age_percentiles()}
    ref, got = on_both(side, run)
    assert got["ages"] == {"p50": 0.0, "p90": 1.0, "p99": 1.0,
                           "count": 4.0, "mean": 0.5}
    assert got["telemetry"]["snapshot"]["counters"]["lookahead_holds"][
        ""] >= 1
    assert any(e[1] == "lookahead_flush" for e in got["telemetry"]["trace"])
    assert_same_tree(ref, got)


@SIDE
def test_telemetry_off_is_byte_identical_and_empty(side):
    """Mirrors test_telemetry_off_is_byte_identical_and_empty: telemetry
    off leaves the arena as telemetry on does and the registry and
    trace empty."""
    def run(fw):
        out = []
        for enabled in (True, False):
            mgr, clients, ptrs = make_mgr(fw, 2, telemetry=enabled)
            drive(mgr, clients, ptrs, rounds=2)
            mgr.synchronize()
            out.append({"arena": arena_bytes(mgr),
                        "snapshot": mgr.telemetry.registry.snapshot(
                            include_timing=False),
                        "trace": len(mgr.telemetry.trace)})
        return out
    ref, got = on_both(side, run)
    np.testing.assert_array_equal(got[0]["arena"], got[1]["arena"])
    assert got[1]["snapshot"] == {"counters": {}, "gauges": {},
                                  "histograms": {}}
    assert got[1]["trace"] == 0
    assert_same_tree(ref, got)


@SIDE
def test_zero_added_syncs_on_fenced_traffic(side):
    """Mirrors test_zero_added_syncs_on_fenced_traffic: BITWISE drains
    with telemetry on never snapshot the violation log."""
    def run(fw):
        mgr, clients, ptrs = make_mgr(fw, 2,
                                      policy=fw.core.FencePolicy.BITWISE)
        calls = []
        orig = mgr.violog.snapshot
        mgr.violog.snapshot = lambda: (calls.append(1), orig())[1]
        drive(mgr, clients, ptrs, rounds=3)
        out = {"calls": len(calls), "dirty": mgr.violog.dirty,
               "drains": mgr.telemetry.registry.counter("drain_cycles")}
        mgr.violog.snapshot = orig
        return {**out, **_plane(mgr)}
    ref, got = on_both(side, run)
    assert got["drains"] > 0 and got["calls"] == 0 and not got["dirty"]
    assert_same_tree(ref, got)


@SIDE
def test_quarantine_gauges_counters_and_events(side):
    """Mirrors test_quarantine_gauges_counters_and_events: a CHECK launch
    out of bounds quarantines "a" at the next poll; the counter, the
    gauge, the trace event and the report's state follow."""
    def run(fw):
        mgr = fw.manager(total_slots=TOTAL, policy=fw.core.FencePolicy.CHECK,
                         standalone_fast_path=False,
                         quarantine_policy=fw.core.ThresholdPolicy(
                             quarantine_after=1))
        a = mgr.register_tenant("a", 128)
        mgr.register_tenant("b", 128)
        a.module_load("bump", fw.kernel("bump"))
        part = mgr.bounds.lookup("a")
        a.launch_kernel("bump", args=(fw.i32(part.end + 50), 4))
        mgr.run_queued()
        return {**_plane(mgr),
                "admissible": mgr.quarantine.state_of("a").admissible}
    ref, got = on_both(side, run)
    snap = got["telemetry"]["snapshot"]
    assert not got["admissible"]
    assert snap["counters"]["quarantines"]["a"] == 1
    assert snap["gauges"]["violations_gather"]["a"] >= 1
    assert ("quarantine", "a") in {(e[1], e[2])
                                   for e in got["telemetry"]["trace"]}
    assert got["report"]["tenants"]["a"]["state"] != "active"
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# Serving plane: jit/eager bit-identity + request counters
# ---------------------------------------------------------------------------

def _serve_run(serve, jit_steps=True):
    eng = serve.engine(max_batch=4, max_len=16, jit_steps=jit_steps)
    eng.register_tenant("t0", 2)
    eng.register_tenant("t1", 2)
    rng = np.random.default_rng(0)
    for t in ("t0", "t1"):
        eng.submit(t, rng.integers(0, CFG_J.vocab, 8).astype(np.int32))
    outs = eng.run(max_new_tokens=3)
    return {"outs": outs, "telemetry": telemetry_view(eng.manager.telemetry)}


def test_serve_metrics_bit_identical_jit_vs_eager():
    """Mirrors test_serve_metrics_bit_identical_jit_vs_eager: the port's
    compiled and eager serve runs agree on the tokens and on every
    logical metric, with each other and with the reference's compiled
    run (the reference test holds its own eager run to it)."""
    ref = _serve_run(SERVE_REF)
    runs = [_serve_run(SERVE_SIDES[s], jit_steps=(s == "compiled"))
            for s in ("compiled", "eager")]
    assert runs[0]["outs"] == runs[1]["outs"]
    assert runs[0]["telemetry"]["snapshot"] == \
        runs[1]["telemetry"]["snapshot"]
    counters = runs[0]["telemetry"]["snapshot"]["counters"]["requests"]
    assert counters["t0"] == 1 and counters["t1"] == 1
    for got in runs:
        assert_same_tree(ref, got)


@pytest.mark.parametrize("fw", ["reference", "port"])
def test_shared_manager_refuses_per_engine_telemetry_override(fw):
    """Mirrors test_shared_manager_refuses_per_engine_telemetry_override
    on both packages: a co-hosted engine refuses its own telemetry
    setting with the same error."""
    serve = SERVE_REF if fw == "reference" else SERVE_SIDES["compiled"]
    mgr = serve.manager(2, max_batch=2)
    with pytest.raises(ValueError, match="telemetry"):
        serve.engine(max_batch=2, manager=mgr, telemetry=False)


# ---------------------------------------------------------------------------
# Dashboard rendering
# ---------------------------------------------------------------------------

def test_sparkline():
    """Mirrors test_sparkline: the port's sparklines are the
    reference's."""
    for vals in ([], [0, 0, 0], [0, 1, 2, 4], [5], [3, 9, 1, 0, 7]):
        assert DT.sparkline(vals) == DJ.sparkline(vals)
    s = DT.sparkline([0, 1, 2, 4])
    assert DT.sparkline([]) == "" and DT.sparkline([0, 0, 0]) == "▁▁▁"
    assert len(s) == 4 and s[-1] == "█" and s[0] == "▁"
    assert DT.sparkline([5]) == "█"


@SIDE
def test_format_report_renders_live_manager(side):
    """Mirrors test_format_report_renders_live_manager: the port's
    dashboard of a live manager, its wall-clock figures zeroed, is the
    reference's text (the jit cache's counts compared for compiled
    launches, whose entries the reference's are)."""
    def run(fw):
        mgr, clients, ptrs = make_mgr(fw, 2)
        drive(mgr, clients, ptrs, rounds=2)
        render = (DJ if fw is JAX else DT).format_report
        report = logical_report(mgr.metrics_report())
        for key in ("entries", "fused_entries"):
            report["jit_cache"][key] = 0
        return {"text": render(report), "live": render(
            mgr.metrics_report(), registry=mgr.telemetry.registry)}
    ref, got = on_both(side, run)
    text = got["live"]
    assert "guardian flight recorder" in text
    for section in ("tenants", "scheduler", "drain cycles", "jit cache",
                    "elastic", "memory", "launch path", "slo ledger",
                    "trace"):
        assert section in text
    assert "t0" in text and "t1" in text
    assert "▁" in text or "█" in text
    assert_same_tree(ref["text"], got["text"])


def test_format_report_tolerates_empty_report():
    """Mirrors test_format_report_tolerates_empty_report."""
    text = DT.format_report({})
    assert text == DJ.format_report({})
    assert "guardian flight recorder" in text and "0 tenant(s)" in text


# ---------------------------------------------------------------------------
# The port's own: host spans, the wall clock, the launch stats
# ---------------------------------------------------------------------------

def test_wall_clock_is_linear_between_anchors():
    """``wall_ns`` maps a stamp linearly between the two anchors around
    it (the clocks' drift between them shared out), and outside them by
    the nearest anchor's offset."""
    T = module(PORT, "telemetry")
    tr = T.EventTrace()
    tr._t0 = 1_000
    tr.anchors = [(1_000, 5_000_000), (11_000, 5_010_010),
                  (21_000, 5_020_000)]
    assert tr.wall_ns(0.0) == 5_000_000
    assert tr.wall_ns(5.0) == 5_005_005          # midway, drift halved
    assert tr.wall_ns(10.0) == 5_010_010
    assert tr.wall_ns(15.0) == 5_015_005
    assert tr.wall_ns(-0.5) == 4_999_500         # before: first offset
    assert tr.wall_ns(30.0) == 5_030_000         # after: last offset
    stamps = [tr.wall_ns(x / 10) for x in range(-20, 400)]
    assert stamps == sorted(stamps)


def test_anchor_reads_both_clocks_together():
    import time
    T = module(PORT, "telemetry")
    tr = T.EventTrace()
    assert len(tr.anchors) == 1                  # one at creation
    w0 = time.time_ns()
    p, w = tr.anchor()
    w1 = time.time_ns()
    assert w0 <= w <= w1 and len(tr.anchors) == 2
    assert w0 - 1_000_000 <= tr.wall_ns(tr.now_us()) <= time.time_ns() \
        + 1_000_000


def test_open_close_nest_and_unwind():
    """Spans nest on a stack (ids, parent ids, the parent's cycle), land
    in the ring as they close, and closing an outer span drops what was
    left open inside it."""
    T = module(PORT, "telemetry")
    tr = T.EventTrace()
    tr.spans = True
    try:
        a = tr.open("a", 7, k=1)
        b = tr.open("b")
        assert tr._open == [a, b]
        tr.close(b, n=2)
        c = tr.open("c")
        tr.open("left-open")
        tr.close(c)
        tr.close(a)
        assert tr._open == []
        got = [(e.name, e.sid, e.parent, e.cycle, e.track, e.args)
               for e in tr.events()]
        assert got == [("b", b.sid, a.sid, 7, T.SPAN_TRACK, {"n": 2}),
                       ("c", c.sid, a.sid, 7, T.SPAN_TRACK, {}),
                       ("a", a.sid, 0, 7, T.SPAN_TRACK, {"k": 1})]
        assert all(e.dur_us >= 0 for e in tr.events())
        assert a.ts_us <= b.ts_us and b.ts_us + b.dur_us <= \
            a.ts_us + a.dur_us
        assert tr.events()[0].to_dict()["parent"] == a.sid
    finally:
        tr.spans = False


def test_spans_switch_owns_the_gc_callback():
    import gc as _gc
    T = module(PORT, "telemetry")
    tr = T.EventTrace()
    assert not tr.spans and tr._on_gc not in _gc.callbacks
    tr.spans = True
    assert tr._on_gc in _gc.callbacks
    outer = tr.open("outer")
    _gc.collect()
    tr.close(outer)
    tr.spans = False
    assert tr._on_gc not in _gc.callbacks
    gcs = [e for e in tr.events() if e.name == "host.gc"]
    assert gcs and gcs[-1].parent == outer.sid
    assert gcs[-1].args["generation"] == 2
    n = len(tr)
    _gc.collect()                               # off: nothing recorded
    assert len(tr) == n
    with pytest.raises(ValueError):
        T.EventTrace(enabled=False).spans = True


def test_since_takes_what_followed_a_mark_or_raises():
    T = module(PORT, "telemetry")
    tr = T.EventTrace(capacity=4)
    tr.emit("a", "t", 0)
    mark = tr.emitted
    for n in "bcd":
        tr.emit(n, "t", 0)
    assert [e.name for e in tr.since(mark)] == ["b", "c", "d"]
    assert tr.since(tr.emitted) == []
    tr.emit("e", "t", 0)
    tr.emit("f", "t", 0)                        # "b" dropped
    with pytest.raises(LookupError):
        tr.since(mark)
    assert [e.name for e in tr.since(mark + 2)] == ["d", "e", "f"]


@pytest.mark.parametrize("jit", [True, False])
def test_launch_stats_means_match_the_series(jit, monkeypatch):
    """``LaunchStats`` keeps a count and a sum a field, no list; its
    ``summary()`` (what ``repro_torch.top`` reads) equals the mean of
    every sample a serve fed it."""
    from repro_torch.core import manager as M
    seen = {}
    real = M.RunningMean.add

    def add(self, value):
        seen.setdefault(id(self), []).append(value)
        real(self, value)

    monkeypatch.setattr(M.RunningMean, "add", add)
    serve = SERVE_SIDES["compiled" if jit else "eager"]
    mgr = serve.manager(1, max_batch=2, paged=True, max_len=64)
    eng = serve.engine(max_batch=2, max_len=64, seed=0, manager=mgr,
                       paged=True)
    eng.register_tenant("t", 2)
    for i in range(3):
        eng.submit("t", [1 + i, 2, 3], max_new=2)
    serve.continuous([eng], max_new_tokens=2)
    stats = mgr.launch_stats
    got = stats.summary()
    assert set(got) == {"lookup_ns", "augment_ns", "dispatch_ns"}
    for field in got:
        series = seen.get(id(getattr(stats, field)), [])
        want = float(np.mean(series)) if series else 0.0
        assert got[field] == want
        assert getattr(stats, field).count == len(series)
        assert not isinstance(getattr(stats, field), list)
    assert seen.get(id(stats.dispatch_ns))

"""The port's request spans and SLO ledger against the reference's: the
mirrors of tests/test_spans.py.  Every serving scenario runs on the
reference and on the port's engines on the reference's weights (the CPU,
compiled and eager) and holds the generated tokens, every closed span's
``to_dict()``, the ledger's ``to_dict()``, the registry's logical
snapshot, the Prometheus text without its wall-clock series and the
trace's events (name, track, cycle, flow id) equal field by field,
besides the reference test's own assertions on the port's run: every
span terminal, its phase components summing to its end-to-end cycles.
"""

import pytest

torch = pytest.importorskip("torch")

from _plane_parity import JAX, SERVE_REF, SERVE_SIDES, SIDES, \
    logical_report, module, spans_view, telemetry_view  # noqa: E402
from _tenant_parity import assert_same_tree  # noqa: E402
from repro.launch import dashboard as DJ  # noqa: E402
from repro_torch.launch import dashboard as DT  # noqa: E402

SIDE = pytest.mark.parametrize("side", sorted(SERVE_SIDES))
_REF = {}


def _serve_both(side, scenario):
    """``scenario(serve)`` on the reference (run once per scenario) and
    on the port's ``side``."""
    key = scenario.__name__
    if key not in _REF:
        _REF[key] = scenario(SERVE_REF)
    return _REF[key], scenario(SERVE_SIDES[side])


def _prompts(n, plen=6, salt=0):
    return [[(7 * i + 3 * j + salt) % 211 + 1 for j in range(plen)]
            for i in range(n)]


def _assert_reconciled(tel):
    """Every closed span is terminal and its components sum to e2e."""
    phases = module(SIDES["compiled"], "telemetry").SPAN_PHASES
    assert tel.spans.open_count() == 0
    assert len(tel.spans.closed) > 0
    for sp in tel.spans.closed:
        assert sp.outcome in ("complete", "evicted", "withdrawn")
        comps = sp.components()
        assert set(comps) == set(phases)
        assert sum(comps.values()) == sp.e2e_cycles, sp.to_dict()


def _paged(serve, n_engines=1, max_batch=2):
    mgr = serve.manager(n_engines, max_batch=max_batch, paged=True,
                        max_len=64)
    eng = serve.engine(max_batch=max_batch, max_len=64, seed=0,
                       manager=mgr, paged=True)
    return mgr, eng


def _lc(serve, budget):
    core = (JAX if serve.ref else SIDES["compiled"]).core
    return core.TenantClassPolicy.latency_critical(queue_age_budget=budget)


def _result(recorder, out, rids, **extra):
    return {"tokens": [out.get(r) for r in rids], "rids": rids,
            "telemetry": telemetry_view(recorder), **extra}


# --------------------------------------------------------------------- #
# Reconciliation on the real drivers                                    #
# --------------------------------------------------------------------- #

def continuous(serve):
    mgr, eng = _paged(serve)
    eng.register_tenant("t", 2)
    rids = [eng.submit("t", p, max_new=1 + i % 3, arrive=i // 2)
            for i, p in enumerate(_prompts(6))]
    out = serve.continuous([eng], max_new_tokens=8)[0]
    return _result(mgr.telemetry, out, rids, keys=sorted(out),
                   tel=mgr.telemetry)


@SIDE
def test_continuous_spans_reconcile_and_complete(side):
    """Mirrors test_continuous_spans_reconcile_and_complete: a staggered
    continuous workload, one complete span per request."""
    ref, got = _serve_both(side, continuous)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    assert got["keys"] == sorted(got["rids"])
    _assert_reconciled(tel)
    assert tel.spans.totals == {"complete": 6}
    assert all(sp.started and sp.e2e_cycles >= 1 for sp in tel.spans.closed)
    assert_same_tree(ref, got)


def lockstep(serve):
    mgr = serve.manager(2, max_batch=2)
    eng = serve.engine(max_batch=2, max_len=16, seed=0, manager=mgr)
    eng.register_tenant("t", 4)
    rids = [eng.submit("t", p) for p in _prompts(3)]
    out: dict = {}
    for _ in range(3):
        out.update(serve.lockstep([eng], max_new_tokens=3)[0])
        if len(out) == len(rids):
            break
    return _result(eng.manager.telemetry, out, rids, tel=mgr.telemetry)


@SIDE
def test_lockstep_spans_reconcile_and_complete(side):
    """Mirrors test_lockstep_spans_reconcile_and_complete: the slab
    lockstep driver's overflow request rides hold / queue across waves
    and every span reconciles."""
    ref, got = _serve_both(side, lockstep)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    _assert_reconciled(tel)
    assert tel.spans.totals == {"complete": 3}
    assert any(sp.slack_cycles() > 0 for sp in tel.spans.closed)
    assert_same_tree(ref, got)


# --------------------------------------------------------------------- #
# Wait attribution                                                      #
# --------------------------------------------------------------------- #

def preempt(serve):
    mgr, eng = _paged(serve, 2, max_batch=1)
    eng.register_tenant("be", 1)
    eng.register_tenant("lc", 1, tenant_class=_lc(serve, 16))
    p = _prompts(2)
    rids = [eng.submit("be", p[0], max_new=2),
            eng.submit("lc", p[1], max_new=2)]
    out = serve.continuous([eng], max_new_tokens=4)[0]
    return _result(mgr.telemetry, out, rids, tel=mgr.telemetry,
                   attained=mgr.telemetry.registry.counter(
                       "slo_attained", tenant="lc"))


@SIDE
def test_preempt_phase_when_bypassed_by_latency_critical(side):
    """Mirrors test_preempt_phase_when_bypassed_by_latency_critical: the
    bypassed best-effort request's wait is ``preempt``; the LC
    completion is booked against its class."""
    ref, got = _serve_both(side, preempt)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    rid_be, rid_lc = got["rids"]
    assert [len(t) for t in got["tokens"]] == [2, 2]
    _assert_reconciled(tel)
    by_rid = {sp.rid: sp for sp in tel.spans.closed}
    assert by_rid[rid_lc].components()["preempt"] == 0
    assert by_rid[rid_be].components()["preempt"] > 0
    assert tel.spans.to_dict()["classes"]["latency_critical"][
        "attained"] == 1
    assert got["attained"] == 1
    assert_same_tree(ref, got)


def stall(serve):
    mgr, eng = _paged(serve)
    eng.register_tenant("t", 1)
    eng.register_tenant("f", 1)
    p = _prompts(2)
    rids = [eng.submit("t", p[0], max_new=3), eng.submit("t", p[1],
                                                         max_new=1)]
    out = serve.continuous([eng], max_new_tokens=4)[0]
    return _result(mgr.telemetry, out, rids, tel=mgr.telemetry,
                   elastic=list(mgr.elastic.events))


@SIDE
def test_stall_phase_when_page_pool_full(side):
    """Mirrors test_stall_phase_when_page_pool_full: the request blocked
    on its tenant's one-page extent charges ``stall``."""
    ref, got = _serve_both(side, stall)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    _assert_reconciled(tel)
    by_rid = {sp.rid: sp for sp in tel.spans.closed}
    assert by_rid[got["rids"][1]].components()["stall"] > 0
    assert_same_tree(ref, got)


def hold(serve):
    mgr, eng = _paged(serve, 2, max_batch=1)
    eng.register_tenant("lc", 2, tenant_class=_lc(serve, 0))
    p = _prompts(2)
    rids = [eng.submit("lc", p[0], max_new=3),
            eng.submit("lc", p[1], max_new=1)]
    out = serve.continuous([eng], max_new_tokens=4)[0]
    return _result(mgr.telemetry, out, rids, tel=mgr.telemetry)


@SIDE
def test_hold_phase_and_violation_cause(side):
    """Mirrors test_hold_phase_and_violation_cause: a batch-capacity wait
    is ``hold``; the LC span over its zero budget is a violation caused
    by ``hold``."""
    ref, got = _serve_both(side, hold)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    _assert_reconciled(tel)
    by_rid = {sp.rid: sp for sp in tel.spans.closed}
    assert by_rid[got["rids"][1]].components()["hold"] > 0
    assert tel.spans.to_dict()["classes"]["latency_critical"] == {
        "attained": 1, "violated": 1, "attainment": 0.5,
        "causes": {"hold": 1}}
    assert_same_tree(ref, got)


# --------------------------------------------------------------------- #
# Terminal-state edge cases                                             #
# --------------------------------------------------------------------- #

def withdrawn(serve):
    mgr, eng = _paged(serve)
    eng.register_tenant("t", 2)
    p = _prompts(2)
    rid0 = eng.submit("t", p[0], max_new=2)
    rid1 = eng.submit("t", p[1], max_new=2, arrive=50)
    answers = [eng.withdraw(rid1), eng.withdraw(rid1)]
    out = serve.continuous([eng], max_new_tokens=4)[0]
    answers.append(eng.withdraw(rid0))
    return _result(mgr.telemetry, out, [rid0, rid1], tel=mgr.telemetry,
                   answers=answers, keys=sorted(out))


@SIDE
def test_withdrawn_request_closes_span(side):
    """Mirrors test_withdrawn_request_closes_span: a queued request
    withdrawn before it ran closes zero-length ``withdrawn``; a second
    withdrawal and one of a finished request are refused."""
    ref, got = _serve_both(side, withdrawn)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    rid0, rid1 = got["rids"]
    assert got["answers"] == [True, False, False]
    assert got["keys"] == [rid0]
    _assert_reconciled(tel)
    assert tel.spans.totals == {"complete": 1, "withdrawn": 1}
    wd = next(sp for sp in tel.spans.closed if sp.rid == rid1)
    assert wd.outcome == "withdrawn" and wd.e2e_cycles == 0
    assert_same_tree(ref, got)


def quarantined(serve, at_drain=2):
    mgr, eng = _paged(serve)
    eng.register_tenant("good", 1)
    eng.register_tenant("rogue", 1)
    p = _prompts(4)
    good = [eng.submit("good", p[0], max_new=6),
            eng.submit("good", p[1], max_new=1, arrive=4)]
    rogue = [eng.submit("rogue", p[2], max_new=6),
             eng.submit("rogue", p[3], max_new=6, arrive=3)]
    drains = {"n": 0}
    orig = mgr.run_queued

    def wrapped(*a, **k):
        res = orig(*a, **k)
        drains["n"] += 1
        if drains["n"] == at_drain:
            eng.quarantine_tenant("rogue", reason="test")
        return res

    mgr.run_queued = wrapped
    try:
        out = serve.continuous([eng], max_new_tokens=8)[0]
    finally:
        mgr.run_queued = orig
    tel = mgr.telemetry
    before = {"view": telemetry_view(tel),
              "by_tenant": sorted(tel.spans.by_tenant)}
    eng.evict_tenant("rogue")
    return {"tokens": [out.get(r) for r in good + rogue],
            "keys": sorted(out), "rids": (good, rogue), "before": before,
            "after": {"spans": spans_view(tel),
                      "by_tenant": sorted(tel.spans.by_tenant)},
            "tel": tel}


@SIDE
def test_quarantine_mid_run_closes_spans_evicted(side):
    """Mirrors test_quarantine_mid_run_closes_spans_evicted: quarantining
    a tenant at the second drain closes its queued and in-flight spans
    ``evicted``; the co-tenant's complete; eviction drops the tenant's
    ledger row and keeps the class history."""
    ref, got = _serve_both(side, quarantined)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    good, rogue = got["rids"]
    assert set(good) <= set(got["keys"])
    assert not set(rogue) & set(got["keys"])
    _assert_reconciled(tel)
    totals = got["before"]["view"]["spans"]["totals"]
    assert totals["complete"] == 2 and totals["evicted"] == 2
    for sp in tel.spans.closed:
        assert sp.outcome == ("evicted" if sp.tenant == "rogue"
                              else "complete")
    assert got["before"]["view"]["spans"]["ledger"]["classes"][
        "unclassified"]["causes"] == {"evicted": 2}
    assert "rogue" in got["before"]["by_tenant"]
    assert "rogue" not in got["after"]["by_tenant"]
    assert got["after"]["spans"]["totals"]["evicted"] == 2
    assert_same_tree(ref, got)


def quarantined_after_prefill(serve):
    return quarantined(serve, at_drain=1)


@SIDE
def test_quarantine_between_prefill_and_first_decode_closes_spans(side):
    """The quarantine of test_quarantine_mid_run_closes_spans_evicted one
    drain earlier: right after the rogue tenant's prefill, before its
    first decode step.  Its in-flight span (prefilled, no token decoded
    yet) and its queued one close ``evicted``, every span reconciles, and
    the port's spans, ledger, recorder and tokens are the reference's."""
    ref, got = _serve_both(side, quarantined_after_prefill)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    good, rogue = got["rids"]
    assert set(good) <= set(got["keys"])
    assert not set(rogue) & set(got["keys"])
    _assert_reconciled(tel)
    spans = got["before"]["view"]["spans"]
    assert spans["totals"] == {"complete": 2, "evicted": 2}
    evicted = [sp for sp in spans["closed"] if sp["outcome"] == "evicted"]
    assert any(sp["components"]["prefill"] > 0
               and sp["components"]["decode"] == 0 for sp in evicted)
    assert_same_tree(ref, got)


def control_plane(serve):
    """chip_smoke phase 3's ``control plane`` scenario at the reduced
    size: a latency-critical tenant behind a best-effort flood, a
    one-page tenant whose later requests stall, a withdrawal, two CHECK
    probes whose fused launch is keyed while the violation log is full,
    three tenants growing the log from 4 rows to 8, the probes' launch
    again, and a forged launch of a best-effort tenant in a new row that
    its class's threshold quarantines mid-run."""
    fw = JAX if serve.ref else serve.fw
    core = fw.core
    mgr = serve.manager(2, max_batch=2, max_len=256, paged=True,
                        max_tenants=4, quarantine_policy=core
                        .ThresholdPolicy(quarantine_after=1 << 30))
    eng = serve.engine(max_batch=2, max_len=256, manager=mgr, paged=True,
                       seed=0)
    eng.register_tenant("lc", 4, tenant_class=core.TenantClassPolicy
                        .latency_critical(queue_age_budget=2))
    for t in ("p0", "p1"):
        mgr.register_tenant(t, 2, policy=core.FencePolicy.CHECK)
        mgr._clients[t].module_load("evil", fw.kernel("evil"))

    def probe_launch(pairs):
        for t, target in pairs:
            mgr._clients[t].launch_kernel("evil", args=(fw.i32(target), 2))

    lc_base = mgr.bounds.lookup("lc").base
    p0 = mgr.bounds.lookup("p0").base
    probe_launch([("p0", p0), ("p1", lc_base)])
    mgr.run_queued()
    eng.register_tenant("be0", 1)
    eng.register_tenant("be1", 2)
    eng.register_tenant("rogue", 2, policy=core.FencePolicy.CHECK,
                        tenant_class=core.TenantClassPolicy.best_effort(
                            quarantine_after=1))
    mgr._clients["rogue"].module_load("evil", fw.kernel("evil"))
    p = _prompts(9, plen=5)
    rids = [eng.submit("be0", p[i], max_new=3) for i in range(3)]
    rids += [eng.submit("be1", p[3 + i], max_new=4) for i in range(2)]
    rids += [eng.submit("rogue", p[5], max_new=5),
             eng.submit("rogue", p[6], max_new=5, arrive=2),
             eng.submit("lc", p[7], max_new=2, arrive=1),
             eng.submit("lc", p[8], max_new=2, arrive=3)]
    late = eng.submit("be1", p[0], max_new=2, arrive=50)
    withdrawn = [eng.withdraw(late), eng.withdraw(late)]
    drains = {"n": 0}
    orig = mgr.run_queued

    def wrapped(*a, **k):
        res = orig(*a, **k)
        drains["n"] += 1
        if drains["n"] == 2:
            probe_launch([("p0", p0), ("p1", lc_base)])
        elif drains["n"] == 3:
            probe_launch([("p0", p0), ("rogue", lc_base)])
        return res

    mgr.run_queued = wrapped
    try:
        out = serve.continuous([eng], max_new_tokens=8)[0]
    finally:
        mgr.run_queued = orig
    log = mgr.violog
    return {**_result(mgr.telemetry, out, rids, tel=mgr.telemetry),
            "drains": drains["n"], "withdrawn": withdrawn,
            "violations": {t: log.counts(t) for t in sorted(log.tenants())},
            "rows": {t: log.row_of(t) for t in sorted(log.tenants())},
            "capacity": log.capacity,
            "states": {t: mgr.quarantine.state_of(t).name
                       for t in ("lc", "be0", "be1", "rogue", "p0", "p1")},
            "elastic": (list(mgr.elastic.events), dict(mgr.elastic.stats))}


@SIDE
def test_control_plane_scenario_matches_reference(side):
    """chip_smoke phase 3's control-plane scenario (which holds the card
    against the CPU) on the port against the reference: every phase
    shows — preempt, hold and stall waits, a withdrawn span, the rogue's
    two spans evicted after its forged CHECK launch, counted in a row
    past the log's first capacity — and tokens, drains, spans, ledger,
    recorder, violation counts, quarantine states and elastic events
    equal the reference's."""
    ref, got = _serve_both(side, control_plane)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    _assert_reconciled(tel)
    comps = {}
    for sp in tel.spans.closed:
        for k, v in sp.components().items():
            comps[k] = comps.get(k, 0) + v
    assert comps["preempt"] > 0 and comps["hold"] > 0 and comps["stall"] > 0
    assert got["withdrawn"] == [True, False]
    assert tel.spans.totals == {"complete": 7, "evicted": 2, "withdrawn": 1}
    assert got["states"]["rogue"] == "QUARANTINED"
    assert got["capacity"] == 8 and got["rows"]["rogue"] >= 4
    assert got["violations"]["p1"]["scatter"] == 4
    assert got["violations"]["rogue"]["scatter"] == 2
    assert_same_tree(ref, got)


# --------------------------------------------------------------------- #
# Off-mode byte-identity                                                #
# --------------------------------------------------------------------- #

def telemetry_off(serve):
    runs = {}
    for on in (True, False):
        eng = serve.engine(max_batch=2, max_len=64, seed=0, paged=True,
                           telemetry=on)
        eng.register_tenant("t", 2)
        rids = [eng.submit("t", p, max_new=2 + i % 2, arrive=i // 2)
                for i, p in enumerate(_prompts(4))]
        out = serve.continuous([eng], max_new_tokens=4)[0]
        tel = eng.manager.telemetry
        runs[on] = {"tokens": [out[r] for r in rids],
                    "enabled": tel.enabled, "engine_spans": len(eng._spans),
                    "telemetry": telemetry_view(tel),
                    "trace_len": len(tel.trace)}
    return runs


@SIDE
def test_telemetry_off_records_nothing_and_tokens_identical(side):
    """Mirrors test_telemetry_off_records_nothing_and_tokens_identical:
    with telemetry off no span, ledger state or event is recorded and
    the tokens equal the telemetry-on run's."""
    ref, got = _serve_both(side, telemetry_off)
    on, off = got[True], got[False]
    assert on["tokens"] == off["tokens"]
    assert not off["enabled"] and off["engine_spans"] == 0
    spans = off["telemetry"]["spans"]
    assert spans["open"] == 0 and spans["closed"] == []
    assert spans["totals"] == {} and off["trace_len"] == 0
    assert on["telemetry"]["spans"]["totals"] == {"complete": 4}
    assert_same_tree(ref, got)


def _ledger_calls(fw):
    tel_mod = module(fw, "telemetry")
    tel = tel_mod.Telemetry(enabled=False)
    led = tel.spans
    out = [led.open("t", 0)]
    led.begin(None)
    led.phase(None, "decode")
    led.close(None, "complete")
    led.forget_tenant("t")
    out += [led.open_count(), dict(led.totals), led.to_dict()]
    tel_on = tel_mod.Telemetry(enabled=True)
    sp = tel_on.spans.open("t", 0)
    tel_on.spans.close(sp, "evicted")
    tel_on.spans.close(sp, "complete")
    out += [dict(tel_on.spans.totals), tel_on.spans.to_dict(),
            sp.to_dict()]
    return out


def test_ledger_methods_none_tolerant():
    """Mirrors test_ledger_methods_none_tolerant: every ledger entry
    point is a no-op on None or disabled, and a double close counts
    once — the port's ledger returns the reference's values."""
    ref, got = _ledger_calls(JAX), _ledger_calls(SIDES["compiled"])
    assert got[0] is None and got[1] == 0 and got[2] == {}
    assert got[3]["completed"] == 0
    assert got[4] == {"evicted": 1}
    assert_same_tree(ref, got)


# --------------------------------------------------------------------- #
# Export: Perfetto tracks + ring-overflow accounting                    #
# --------------------------------------------------------------------- #

def perfetto(serve):
    mgr, eng = _paged(serve)
    eng.register_tenant("t", 2)
    rid = eng.submit("t", _prompts(1)[0], max_new=3)
    out = serve.continuous([eng], max_new_tokens=3)[0]
    return _result(mgr.telemetry, out, [rid], tel=mgr.telemetry)


@SIDE
def test_perfetto_per_request_tracks_and_flow_events(side):
    """Mirrors test_perfetto_per_request_tracks_and_flow_events: the
    request's own track, its submit-to-track flow pair, and phase slices
    summing to its e2e cycles; the port's events are the reference's."""
    ref, got = _serve_both(side, perfetto)
    tel = got.pop("tel")
    ref = {k: v for k, v in ref.items() if k != "tel"}
    phases = module(SIDES["compiled"], "telemetry").SPAN_PHASES
    (rid,) = got["rids"]
    evs = tel.trace.to_chrome()["traceEvents"]
    tracks = {e["args"]["name"] for e in evs if e.get("ph") == "M"
              and e["name"] == "thread_name"}
    assert f"t:r{rid}" in tracks
    sp = tel.spans.closed[-1]
    flows = [e for e in evs if e.get("cat") == "guardian.flow"
             and e["id"] == sp.sid]
    assert [e["ph"] for e in flows] == ["s", "f"] and flows[1]["bp"] == "e"
    rtid = next(e["tid"] for e in evs if e.get("ph") == "M"
                and e["name"] == "thread_name"
                and e["args"]["name"] == f"t:r{rid}")
    slices = [e for e in evs if e.get("tid") == rtid and e.get("ph") == "X"]
    assert {e["name"] for e in slices} <= set(phases)
    assert sum(e["args"]["cycles"] for e in slices) == sp.e2e_cycles
    assert_same_tree(ref, got)


def _ring(fw):
    tel_mod = module(fw, "telemetry")
    tr = tel_mod.EventTrace(capacity=2)
    for i in range(5):
        tr.emit(f"e{i}", "t", i)
    tr2 = tel_mod.EventTrace(capacity=8)
    tr2.emit("only", "t", 0)
    return [len(tr), tr.emitted, tr.dropped, tr2.dropped,
            [e.name for e in tr.events()]]


def test_event_trace_counts_ring_drops():
    """Mirrors test_event_trace_counts_ring_drops: a ring of two keeps
    the last two of five events and counts three dropped."""
    ref, got = _ring(JAX), _ring(SIDES["compiled"])
    assert got[:4] == [2, 5, 3, 0]
    assert_same_tree(ref, got)


def dashboard(serve):
    mgr, eng = _paged(serve, 2, max_batch=1)
    eng.register_tenant("lc", 1, tenant_class=_lc(serve, 16))
    eng.submit("lc", _prompts(1)[0], max_new=2)
    serve.continuous([eng], max_new_tokens=2)
    render = (DJ if serve.ref else DT).format_report
    report = mgr.metrics_report()
    text = render(logical_report(report))
    mgr.telemetry.trace.dropped = 7
    overflow = render(logical_report(mgr.metrics_report()))
    jit = {k: report["jit_cache"][k] for k in (
        "capacity", "entries", "evictions", "fused_capacity",
        "fused_entries", "fused_evictions")}
    return {"slo": report["slo"], "trace": report["trace"], "jit": jit,
            "row": {k: report["tenants"]["lc"][k]
                    for k in ("slo", "class", "state")},
            "latency_count": report["tenants"]["lc"]["latency"]["count"],
            "text": text, "overflow": overflow}


@SIDE
def test_dashboard_renders_spans_ledger_and_overflow_warning(side):
    """Mirrors test_dashboard_renders_spans_ledger_and_overflow_warning:
    the report carries the ledger and the dropped counter, and the
    port's dashboard text — wall-clock figures zeroed on both sides —
    is the reference's, overflow warning included.  The reference's
    engine compiles its steps, so the jit cache's counts (its entries
    the compiled steps) are compared with the compiled port's; the eager
    port caches none, its text otherwise the same."""
    ref, got = _serve_both(side, dashboard)
    if side == "eager":
        assert got["jit"]["entries"] == 0
        ref = {**ref, "jit": got["jit"],
               **{k: ref[k].replace(
                   "kernel entries {entries}/".format(**ref["jit"]),
                   "kernel entries 0/") for k in ("text", "overflow")}}
    assert got["slo"]["completed"] == 1
    assert got["slo"]["classes"]["latency_critical"]["attained"] == 1
    assert got["trace"]["dropped"] == 0
    assert got["row"]["slo"]["attained"] == 1 and got["latency_count"] == 1
    text = got["text"]
    assert "slo ledger" in text and "e2e50" in text and "slo%" in text
    assert "latency_critical" in text and "100.0%" in text
    assert "dropped" not in text
    assert "7 dropped (ring overflow" in got["overflow"]
    assert_same_tree(ref, got)


# --------------------------------------------------------------------- #
# Host spans (the port's own: EventTrace.spans)                         #
# --------------------------------------------------------------------- #

def _serve_with_spans(side, n=6, on=True, hook=None):
    """The staggered continuous workload on the port's ``side`` with the
    host spans on (``on``) from the serve's start; ``hook(eng)`` runs
    before it.  Returns the manager, the events the serve appended, the
    wall clock read before and after, and the drains run."""
    import time
    serve = SERVE_SIDES[side]
    mgr, eng = _paged(serve)
    eng.register_tenant("t", 2)
    for i, p in enumerate(_prompts(n)):
        eng.submit("t", p, max_new=1 + i % 3, arrive=i // 2)
    if hook is not None:
        hook(eng)
    drains = []
    real = mgr.run_queued

    def counted():
        drains.append(1)
        real()

    mgr.run_queued = counted
    trace = mgr.telemetry.trace
    mark = trace.emitted
    trace.anchor()
    w0 = time.time_ns()
    trace.spans = on
    serve.continuous([eng], max_new_tokens=8)
    trace.spans = False
    w1 = time.time_ns()
    return mgr, trace.since(mark), (w0, w1), len(drains)


def _logical(ev):
    d = ev.to_dict()
    for k in ("ts_us", "dur_us", "parent"):
        d.pop(k, None)
    return d, ev.flow


@SIDE
def test_spans_off_ring_holds_todays_events(side):
    """With the switch off the ring of a continuous serve holds no span
    and no parent link, the same events as the reference's (the mirror
    above); with it on, the same events again beside the spans, the
    drain cycles now children of their drain."""
    _, off, _, _ = _serve_with_spans(side, on=False)
    assert all(ev.sid is None and ev.parent is None for ev in off)
    _, on, _, _ = _serve_with_spans(side)
    kept = [ev for ev in on if ev.sid is None]
    assert [_logical(ev) for ev in kept] == [_logical(ev) for ev in off]
    assert all(ev.parent is not None for ev in kept
               if ev.name == "drain_cycle")
    assert len(on) > len(off)


@SIDE
def test_spans_form_a_tree_per_cycle(side):
    """Each span lies inside its parent, every serve cycle holds at most
    one ``manager.drain`` and every drain lies in a serve cycle, one per
    ``run_queued`` call; the layers nest as documented."""
    _, evs, _, drains = _serve_with_spans(side)
    spans = [ev for ev in evs if ev.sid is not None]
    by = {ev.sid: ev for ev in spans}
    for ev in spans:
        assert ev.dur_us >= 0
        if ev.parent:
            p = by[ev.parent]
            assert p.ts_us <= ev.ts_us
            assert ev.ts_us + ev.dur_us <= p.ts_us + p.dur_us
    names = lambda sid: [e.name for e in spans if e.parent == sid
                         and e.name != "host.gc"]
    cycles = [ev for ev in spans if ev.name == "serve.cycle"]
    assert all(ev.parent == 0 for ev in cycles)
    per = [names(c.sid).count("manager.drain") for c in cycles]
    assert set(per) <= {0, 1} and sum(per) == drains > 0
    assert per[-1] == 0                 # the last cycle finds no work
    for c in cycles[:-1]:
        kids = names(c.sid)
        assert kids[:3] == ["serve.leave", "serve.join", "serve.dispatch"]
        assert kids[-2:] == ["manager.drain", "serve.finish"]
    parents = {ev.name: by[ev.parent].name for ev in spans if ev.parent
               and ev.name != "host.gc"}
    assert parents["serve.stage"] == "serve.dispatch"
    assert parents["sched.flush"] == "manager.drain"
    assert parents["manager.poll"] == "manager.drain"
    assert parents["sched.execute"] == "sched.flush"
    if side == "compiled":
        assert parents["step.run"] == "sched.execute"
        for child in ("step.stage", "step.replay", "step.capture"):
            assert parents[child] == "step.run"
    else:
        assert not any(ev.name.startswith("step.") for ev in spans)
    assert [ev.name for ev in spans if ev.parent == 0][-1] == \
        "serve.finalize"


@SIDE
def test_spans_map_onto_the_wall_clock(side):
    """Every span's bounds, mapped onto ``time.time_ns``, lie between the
    wall clock read before and after the serve; so does every event the
    Chrome export gives, and the spans carry their ids there."""
    mgr, evs, (w0, w1), _ = _serve_with_spans(side)
    trace = mgr.telemetry.trace
    spans = [ev for ev in evs if ev.sid is not None]
    assert spans
    for ev in spans:
        a, b = trace.wall_ns(ev.ts_us), trace.wall_ns(ev.ts_us + ev.dur_us)
        assert w0 <= a <= b <= w1
    x = [e for e in trace.to_chrome()["traceEvents"]
         if e.get("ph") == "X" and "id" in e.get("args", {})]
    assert len(x) == len(spans)
    assert all(w0 / 1e3 - 1 <= e["ts"] <= w1 / 1e3 + 1 for e in x)


@pytest.mark.parametrize("n,count", [(2, 16), (3, 36)])
def test_requests_scanned_counts_by_hand(n, count):
    """``serve_requests_scanned`` against a hand count.  Two rows, one
    tenant of two pages, ``n`` requests of one token at cycle 0.  n = 2:
    cycle 0 the join's list (2), two page scans (2 + 2), the arrived
    check (2), the gauges' page scan (2); cycle 1 the list, the waiting
    check and the arrived check (2 each): 16.  n = 3 (the third waits a
    cycle): 15 + 12 + 9 = 36."""
    serve = SERVE_SIDES["compiled"]
    mgr, eng = _paged(serve)
    eng.register_tenant("t", 2)
    for p in _prompts(n):
        eng.submit("t", p, max_new=1)
    trace = mgr.telemetry.trace
    trace.spans = True
    serve.continuous([eng], max_new_tokens=4)
    trace.spans = False
    assert mgr.telemetry.registry.counter("serve_requests_scanned") == count
    # off: counted nowhere
    mgr2, eng2 = _paged(serve)
    eng2.register_tenant("t", 2)
    for p in _prompts(n):
        eng2.submit("t", p, max_new=1)
    serve.continuous([eng2], max_new_tokens=4)
    assert "serve_requests_scanned" not in mgr2.telemetry.registry.counters


@SIDE
def test_forced_collection_is_a_host_gc_span(side):
    """A ``gc.collect()`` inside a cycle (in the gauges, under
    ``serve.finish``) shows as a ``host.gc`` span of generation 2 there;
    the switch's callback is gone once it is off."""
    import gc as _gc
    calls = []

    def hook(eng):
        real = eng._cont_gauges

        def gauges(st):
            calls.append(_gc.collect())
            real(st)

        eng._cont_gauges = gauges

    mgr, evs, _, _ = _serve_with_spans(side, hook=hook)
    by = {ev.sid: ev for ev in evs if ev.sid is not None}
    forced = [ev for ev in by.values() if ev.name == "host.gc"
              and ev.args["generation"] == 2
              and by[ev.parent].name == "serve.finish"]
    assert calls and len(forced) >= len(calls)
    assert all("collected" in ev.args for ev in forced)
    assert mgr.telemetry.trace._on_gc not in _gc.callbacks

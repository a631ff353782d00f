"""The port's tenant classes against the reference's: the mirrors of
tests/test_tenantclass.py.  Every scenario runs on the reference and on
the port (the CPU, launches compiled and eager) with the tenant kernels
written in jnp and in torch, and holds the scheduler's dispatch log,
queue ages, per-class percentiles, best-effort preemptions, the elastic
manager's events and stats, quarantine states, the metrics report's class
rows and the arena bytes equal field by field, besides the reference
test's own assertions on the port's run.  The serving case runs the
port's engines on the reference's weights, compiled and eager.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from _plane_parity import CFG_J, JAX, SERVE_REF, SERVE_SIDES, SIDES, \
    arena_bytes, elastic_view, module, on_both  # noqa: E402
from _tenant_parity import assert_same_tree  # noqa: E402

SIDE = pytest.mark.parametrize("side", sorted(SIDES))



def _lc_be_workload(fw, lookahead, lc_class=None, be_class=None, n_ops=8,
                    be_weight=4, **mgr_kw):
    """One LC-shaped tenant (1 op a cycle, its own kernel) and one
    flooding tenant (``be_weight`` ops a cycle, an incompatible kernel),
    as the reference's helper of the same name builds them."""
    mgr = fw.manager(total_slots=512, lookahead_cycles=lookahead,
                     max_fuse=16, **mgr_kw)
    lc = mgr.register_tenant("lc", 64, tenant_class=lc_class)
    be = mgr.register_tenant("be", 64, weight=be_weight,
                             tenant_class=be_class)
    lc.module_load("bump", fw.kernel("bump"))
    be.module_load("bump2", fw.kernel("bump2"))
    lp, bp = lc.malloc(8), be.malloc(8)
    for _ in range(n_ops):
        lc.launch_kernel("bump", ptrs=[lp], args=(8,))
    for _ in range(be_weight * n_ops):
        be.launch_kernel("bump2", ptrs=[bp], args=(8,))
    mgr.run_queued()
    return mgr


def _view(mgr) -> dict:
    """What a workload run is compared on."""
    st_ = mgr.scheduler.stats
    rep = mgr.metrics_report()
    return {"dispatch": list(mgr.scheduler.dispatch_log),
            "ages": list(st_.queue_ages),
            "by_class": st_.queue_age_percentiles_by_class(),
            "preemptions": st_.be_preemptions,
            "report_scheduler": {k: rep["scheduler"][k] for k in (
                "be_preemptions", "queue_age_by_class")},
            "report_classes": {t: r["class"]
                               for t, r in rep["tenants"].items()},
            "counters": rep["counters"].get("be_preemptions"),
            "arena": arena_bytes(mgr)}


def _lc(fw, **kw):
    return fw.core.TenantClassPolicy.latency_critical(**kw)


def _be(fw, **kw):
    return fw.core.TenantClassPolicy.best_effort(**kw)


@SIDE
def test_classless_and_all_best_effort_defaults_bit_identical(side):
    """Mirrors test_classless_and_all_best_effort_defaults_bit_identical:
    every tenant best-effort reproduces the class-less run decision for
    decision, age for age, byte for byte — on the port as on the
    reference, and equal to the reference's runs."""
    def run(fw):
        runs = []
        for classed in (False, True):
            be = _be(fw) if classed else None
            mgr = _lc_be_workload(fw, lookahead=3, lc_class=be,
                                  be_class=be, be_weight=2)
            v = _view(mgr)
            runs.append((v["dispatch"], v["ages"], v["arena"]))
        return runs
    ref, got = on_both(side, run)
    assert got[0][0] == got[1][0] and got[0][1] == got[1][1]
    np.testing.assert_array_equal(got[0][2], got[1][2])
    assert_same_tree(ref, got)


@SIDE
def test_classless_manager_leaves_class_machinery_cold(side):
    """Mirrors test_classless_manager_leaves_class_machinery_cold: no
    class registered, no arrival tracking, EWMAs, histograms or
    preemptions."""
    def run(fw):
        mgr = _lc_be_workload(fw, lookahead=2)
        sch = mgr.scheduler
        rep = mgr.metrics_report()
        return {"has": mgr.has_class_tenants,
                "ewmas": (dict(sch._arrival_ewma), dict(sch._qage_ewma)),
                "preemptions": sch.stats.be_preemptions,
                "class_ages": dict(sch.stats.class_queue_age),
                "report": rep["scheduler"]["queue_age_by_class"],
                "classes": [r["class"] for r in rep["tenants"].values()],
                **_view(mgr)}
    ref, got = on_both(side, run)
    assert not got["has"] and got["ewmas"] == ({}, {})
    assert got["preemptions"] == 0 and got["class_ages"] == {}
    assert got["report"] == {} and set(got["classes"]) == {None}
    assert_same_tree(ref, got)


@SIDE
def test_lc_hold_budget_sweep(side):
    """Mirrors test_lc_hold_budget_sweep over lookaheads 1-4: class-less
    the LC tenant's max age is the lookahead, latency-critical with
    class lookahead 0 it is 0, inheriting it is min(lookahead, budget);
    arena bytes equal in every run."""
    def run(fw):
        out = []
        for look in (1, 2, 3, 4):
            classless = _lc_be_workload(fw, look)
            immediate = _lc_be_workload(
                fw, look, lc_class=_lc(fw, queue_age_budget=2,
                                       lookahead_cycles=0),
                be_class=_be(fw))
            capped = _lc_be_workload(
                fw, look, lc_class=_lc(fw, queue_age_budget=2,
                                       lookahead_cycles=None))
            out.append([_view(m) for m in (classless, immediate, capped)])
        return out
    ref, got = on_both(side, run)
    for look, (classless, immediate, capped) in zip((1, 2, 3, 4), got):
        assert max(classless["ages"]) == look
        assert max(immediate["ages"]) == 0
        lc = immediate["by_class"]["latency_critical"]
        assert lc["p99"] == 0 and lc["count"] == 8
        assert max(capped["ages"]) == min(look, 2)
        for v in (immediate, capped):
            np.testing.assert_array_equal(classless["arena"], v["arena"])
    assert_same_tree(ref, got)


@settings(max_examples=5, deadline=None)
@given(look=st.integers(min_value=1, max_value=4),
       budget=st.integers(min_value=0, max_value=4))
def test_lc_hold_budget_property(look, budget):
    """Mirrors test_lc_hold_budget_property: the same drawn (lookahead,
    budget) on both, compiled on the port; the max age is exactly
    min(lookahead, budget) and the runs are equal."""
    def run(fw):
        return _view(_lc_be_workload(
            fw, look, lc_class=_lc(fw, queue_age_budget=budget,
                                   lookahead_cycles=None), n_ops=6))
    ref, got = on_both("compiled", run, cache=False)
    assert max(got["ages"]) == min(look, budget)
    assert_same_tree(ref, got)


@SIDE
def test_budget_breach_defers_best_effort_batches(side):
    """Mirrors test_budget_breach_defers_best_effort_batches: an
    unsmoothed EWMA registers the breach and best-effort batches defer;
    every deferred op still lands, and the recorder counts the
    deferrals."""
    def run(fw):
        classless = _lc_be_workload(fw, 4, be_weight=2, n_ops=12)
        preempt = _lc_be_workload(
            fw, 4, lc_class=_lc(fw, queue_age_budget=2, lookahead_cycles=2,
                                ewma_alpha=1.0),
            be_class=_be(fw), be_weight=2, n_ops=12)
        return _view(classless), _view(preempt)
    ref, got = on_both(side, run)
    classless, preempt = got
    assert preempt["preemptions"] > 0
    assert preempt["by_class"]["latency_critical"]["p99"] <= 2
    np.testing.assert_array_equal(classless["arena"], preempt["arena"])
    assert preempt["report_scheduler"]["be_preemptions"] \
        == preempt["preemptions"] == preempt["counters"][""]
    assert_same_tree(ref, got)


@SIDE
def test_no_preemption_without_breach(side):
    """Mirrors test_no_preemption_without_breach: class lookahead 0 never
    breaches, so nothing is deferred."""
    def run(fw):
        return _view(_lc_be_workload(
            fw, 4, lc_class=_lc(fw, queue_age_budget=2, lookahead_cycles=0),
            be_class=_be(fw), be_weight=2))
    ref, got = on_both(side, run)
    assert got["preemptions"] == 0
    assert_same_tree(ref, got)


@SIDE
def test_compute_aware_admission_defers_then_admits(side):
    """Mirrors test_compute_aware_admission_defers_then_admits: a
    best-effort admission waitlists while the arrival-rate EWMA is at
    or above the watermark and admits itself once it decays; a
    class-less admission is never compute-deferred."""
    def run(fw):
        mgr = fw.manager(total_slots=512, elastic_policy=fw.core
                         .ElasticPolicy(compute_watermark=1.5))
        lc = mgr.register_tenant("lc", 64, weight=2,
                                 tenant_class="latency_critical")
        lc.module_load("bump", fw.kernel("bump"))
        p = lc.malloc(8)
        for _ in range(16):
            lc.launch_kernel("bump", ptrs=[p], args=(8,))
        mgr.run_queued()
        trail = [mgr.scheduler.arrival_rate_total()]
        adm = mgr.elastic.admit("be", 64, tenant_class="best_effort")
        trail.append(adm.status.name)
        plain = mgr.elastic.admit("plain", 64)
        trail.append(plain.status.name)
        for _ in range(2):
            lc.launch_kernel("bump", ptrs=[p], args=(8,))
            mgr.run_queued()
            trail += [adm.status.name, mgr.scheduler.arrival_rate_total()]
        trail.append(adm.client is not None)
        return {"trail": trail, "elastic": elastic_view(mgr),
                "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    assert got["trail"][0] == pytest.approx(2.0)
    assert got["trail"][1:3] == ["WAITLISTED", "ADMITTED"]
    assert got["trail"][3] == "WAITLISTED" and got["trail"][5] == "ADMITTED"
    assert got["trail"][-1] is True
    assert got["elastic"]["stats"]["compute_deferred"] >= 1
    assert_same_tree(ref, got)


@SIDE
def test_no_compute_deferral_without_watermark(side):
    """Mirrors test_no_compute_deferral_without_watermark: without a
    watermark a best-effort admission sees memory only."""
    def run(fw):
        mgr = fw.manager(total_slots=512)
        lc = mgr.register_tenant("lc", 64, weight=2,
                                 tenant_class="latency_critical")
        lc.module_load("bump", fw.kernel("bump"))
        p = lc.malloc(8)
        for _ in range(16):
            lc.launch_kernel("bump", ptrs=[p], args=(8,))
        mgr.run_queued()
        adm = mgr.elastic.admit("be", 64, tenant_class="best_effort")
        return {"status": adm.status.name, "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["status"] == "ADMITTED"
    assert got["elastic"]["stats"]["compute_deferred"] == 0
    assert_same_tree(ref, got)


def test_weighted_rate_policy_unit():
    """Mirrors test_weighted_rate_policy_unit: the weighted total, the
    rate threshold clamped to ``min_cycles`` and the eviction threshold
    decide as the reference's."""
    def run(fw):
        q = module(fw, "quarantine")
        rec = q.TenantRecord(tenant_id="t")
        pol = fw.core.WeightedRatePolicy(quarantine_after=8,
                                         weights={"scatter_oob": 4.0})
        out = [pol.weighted_total({"scatter_oob": 2}),
               pol.should_quarantine("t", {"scatter_oob": 2}, rec),
               pol.should_quarantine("t", {"gather_oob": 7}, rec)]
        rate = fw.core.WeightedRatePolicy(quarantine_after=None,
                                          quarantine_rate=1.0, min_cycles=4)
        rec.cycles_observed = 2
        out.append(rate.should_quarantine("t", {"gather_oob": 4}, rec))
        rec.cycles_observed = 8
        out.append(rate.should_quarantine("t", {"gather_oob": 4}, rec))
        ev = fw.core.WeightedRatePolicy(quarantine_after=2, evict_after=16)
        out += [ev.should_quarantine("t", {"gather_oob": 2}, rec),
                ev.should_evict("t", {"gather_oob": 8}, rec),
                ev.should_evict("t", {"gather_oob": 16}, rec)]
        return out
    ref, got = run(JAX), run(SIDES["compiled"])
    assert got == [8.0, True, False, True, False, True, False, True]
    assert_same_tree(ref, got)


@SIDE
def test_class_quarantine_threshold_overrides_global(side):
    """Mirrors test_class_quarantine_threshold_overrides_global: the
    classed offender quarantines at its class's threshold, the
    class-less one stays active under the loose global policy."""
    def run(fw):
        mgr = fw.manager(total_slots=512, policy=fw.core.FencePolicy.CHECK,
                         quarantine_policy=fw.core.ThresholdPolicy(
                             quarantine_after=100))
        mgr.register_tenant("victim", 64)
        strict = mgr.register_tenant(
            "strict", 64, tenant_class=_be(fw, quarantine_after=2))
        loose = mgr.register_tenant("loose", 64)
        vpart = mgr.bounds.lookup("victim")
        for c in (strict, loose):
            c.module_load("evil", fw.kernel("evil"))
            c.launch_kernel("evil", args=(fw.i32(vpart.base), 8))
        mgr.run_queued()
        return {"states": {t: mgr.quarantine.state_of(t).name
                           for t in ("victim", "strict", "loose")},
                "violations": {t: mgr.violog.counts(t)
                               for t in ("strict", "loose")},
                "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    assert got["states"]["strict"] == "QUARANTINED"
    assert got["states"]["loose"] == "ACTIVE"
    assert_same_tree(ref, got)


def test_register_tenant_class_specs():
    """Mirrors test_register_tenant_class_specs: names, enum members and
    policies normalise as on the reference; bad specs raise; the report
    carries the classes; departures clear the registry."""
    def run(fw):
        mgr = fw.manager(total_slots=512)
        mgr.register_tenant("s", 32, tenant_class="latency_critical")
        mgr.register_tenant("e", 32,
                            tenant_class=fw.core.TenantClass.BEST_EFFORT)
        pol = _lc(fw, queue_age_budget=5)
        mgr.register_tenant("p", 32, tenant_class=pol)
        mgr.register_tenant("none", 32)
        cp = mgr.class_policy_of("s")
        out = {"s": (cp.is_latency_critical, cp.queue_age_budget,
                     cp.lookahead_cycles),
               "e": mgr.class_policy_of("e").is_best_effort,
               "p": mgr.class_policy_of("p") is pol,
               "none": mgr.class_policy_of("none"),
               "has": [mgr.has_class_tenants]}
        with pytest.raises(ValueError):
            mgr.register_tenant("bad", 32, tenant_class="gold_tier")
        with pytest.raises(ValueError):
            _lc(fw, queue_age_budget=-1)
        out["as_none"] = fw.core.as_class_policy(None)
        rep = mgr.metrics_report()
        out["classes"] = {t: r["class"] for t, r in rep["tenants"].items()}
        for t in ("s", "e", "p"):
            mgr.remove_tenant(t)
        out["has"].append(mgr.has_class_tenants)
        return out
    ref, got = run(JAX), run(SIDES["compiled"])
    assert got["s"] == (True, 2, 0) and got["e"] and got["p"]
    assert got["none"] is None and got["as_none"] is None
    assert got["classes"]["s"] == "latency_critical"
    assert got["classes"]["none"] is None
    assert got["has"] == [True, False]
    assert_same_tree(ref, got)


_FLOOD = {}


def _flood_run(serve):
    """The LC tenant's solo generations and its generations beside two
    best-effort tenants' flood (tests/test_tenantclass.py's serving
    case), with the flood run's class rows and recorder."""
    rng = np.random.default_rng(7)
    vocab = CFG_J.vocab
    prompt = rng.integers(0, vocab, size=10).astype(np.int32)
    floods = [rng.integers(0, vocab, size=10).astype(np.int32)
              for _ in range(4)]
    solo = serve.engine(max_batch=8, max_len=64)
    solo.register_tenant("lc", 2, tenant_class="latency_critical")
    rid = solo.submit("lc", prompt)
    want = solo.run(max_new_tokens=6)[rid]
    eng = serve.engine(max_batch=8, max_len=64)
    eng.register_tenant("lc", 2, tenant_class="latency_critical")
    eng.register_tenant("be0", 2, tenant_class="best_effort")
    eng.register_tenant("be1", 2, tenant_class="best_effort")
    rid2 = eng.submit("lc", prompt)
    rids = [eng.submit(f"be{i % 2}", fp) for i, fp in enumerate(floods)]
    out = eng.run(max_new_tokens=6)
    rep = eng.manager.metrics_report()
    return {"solo": want, "lc": out[rid2], "flood": [out[r] for r in rids],
            "classes": {t: r["class"] for t, r in rep["tenants"].items()},
            "scheduler": {k: rep["scheduler"][k] for k in (
                "be_preemptions", "queue_age_by_class")},
            "snapshot": eng.manager.telemetry.registry.snapshot(
                include_timing=False)}


@pytest.mark.parametrize("side", sorted(SERVE_SIDES))
def test_serve_lc_generations_identical_under_be_flood(side):
    """Mirrors test_serve_lc_generations_identical_under_be_flood on the
    reference's weights: the LC tenant's generations beside the
    best-effort flood equal its solo run, and the port's tokens, class
    rows and logical registry equal the reference's."""
    if "ref" not in _FLOOD:
        _FLOOD["ref"] = _flood_run(SERVE_REF)
    ref, got = _FLOOD["ref"], _flood_run(SERVE_SIDES[side])
    assert got["lc"] == got["solo"]
    assert got["classes"]["lc"] == "latency_critical"
    assert got["classes"]["be0"] == "best_effort"
    assert_same_tree(ref, got)

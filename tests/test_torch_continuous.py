"""Mirrors of the reference's continuous-batching proofs on the port
(``tests/test_continuous.py`` and the continuous leg of
``benchmarks/serve_continuous.py``): the quick mixed-budget trace takes
the reference's drain cycles with zero relocation steps, churn with an
elastic grow stays identical to solo runs, join/leave churn never aliases
a live page, and background compaction is a page-map rewrite."""

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import params_np  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.elastic import ElasticPolicy  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

CFG_J = get_config("stablelm-3b").reduced()
CFG_T = get_config_t("stablelm-3b").reduced()


def _prompts(n, plen=6, salt=0):
    return [[(7 * i + 3 * j + salt) % 211 + 1 for j in range(plen)]
            for i in range(n)]


@pytest.fixture(scope="module")
def params():
    """Reference weights (seed 0, as every engine below would draw), as
    port params on the CPU."""
    eng = SJ.ServeEngine(CFG_J, max_batch=2, max_len=64, seed=0)
    return params_from_jax(params_np(eng.params), device="cpu")


def _engine(params, B, **mgr_kw):
    mgr = ST.make_shared_manager(1, max_batch=B, paged=True, max_len=64,
                                 device="cpu", **mgr_kw)
    eng = ST.ServeEngine(CFG_T, max_batch=B, max_len=64, manager=mgr,
                         paged=True, params=params, device="cpu")
    return mgr, eng


def _solo(params, prompts, budgets):
    outs = []
    for p, b in zip(prompts, budgets):
        _, eng = _engine(params, 2)
        eng.register_tenant("solo", 2)
        rid = eng.submit("solo", p)
        outs.append(eng.run(max_new_tokens=b)[rid])
    return outs


def _count_drains(mgr):
    """Count manager drains, as the reference benchmark does."""
    count = [0]
    orig = mgr.run_queued

    def counted(*a, **kw):
        count[0] += 1
        return orig(*a, **kw)

    mgr.run_queued = counted
    return count


def test_quick_trace_cycles_match_reference(params):
    """The quick trace of the reference's continuous benchmark (4 rows,
    6 short + 2 long budgets): the same generations, drains and drain
    cycles as the reference's continuous driver — 13 drains, as
    ``results/bench.csv`` records — with no relocation step."""
    budgets = [10, 3, 3, 3, 10, 3, 3, 3]
    prompts = _prompts(len(budgets))
    runs = []
    sides = ((SJ, CFG_J, {}, {}),
             (ST, CFG_T, {"device": "cpu"}, {"device": "cpu",
                                             "params": params}))
    for SV, cfg, mgr_kw, eng_kw in sides:
        mgr = SV.make_shared_manager(1, max_batch=4, paged=True,
                                     max_len=64, **mgr_kw)
        eng = SV.ServeEngine(cfg, max_batch=4, max_len=64, seed=0,
                             manager=mgr, paged=True, **eng_kw)
        eng.register_tenant("t", 4)
        drains = _count_drains(mgr)
        rids = [eng.submit("t", p, max_new=b)
                for p, b in zip(prompts, budgets)]
        out = SV.serve_continuous([eng], max_new_tokens=max(budgets))[0]
        runs.append(([out[r] for r in rids], drains[0],
                     mgr.telemetry.registry.counter("drain_cycles"),
                     mgr.elastic.stats["reloc_steps"]))
    assert runs[1] == runs[0]
    assert runs[1][1] == 13 and runs[1][3] == 0


def test_churn_with_elastic_grow_matches_solo_runs(params):
    """Staggered arrivals, mixed budgets, one tenant sized to force an
    elastic grow mid-run: every generation equals its solo run, and the
    grow is a page-map rewrite (zero relocation steps)."""
    n = 8
    prompts = _prompts(n)
    budgets = [3 if i % 2 else 6 for i in range(n)]
    refs = _solo(params, prompts, budgets)
    mgr, eng = _engine(params, 4)
    eng.max_inflight = 4
    eng.register_tenant("a", 4)
    eng.register_tenant("b", 1)      # 1-page extent: churn forces a grow
    rids = [eng.submit("b" if i % 3 == 0 else "a", prompts[i],
                       max_new=budgets[i], arrive=i // 2)
            for i in range(n)]
    out = ST.serve_continuous([eng], max_new_tokens=16)[0]
    for i, rid in enumerate(rids):
        assert out[rid] == refs[i], f"request {i} diverged"
    assert mgr.bounds.lookup("b").size > 1
    assert mgr.elastic.stats["reloc_steps"] == 0


def test_join_leave_never_aliases_freed_page(params):
    """Heavy churn on 2 pages for 4 rows: the join-time allocator
    invariant (disjoint pages inside the owner's extent, asserted in
    ``_cont_join``) holds and every request completes its budget."""
    prompts = _prompts(10, salt=3)
    _, eng = _engine(params, 4)
    eng.register_tenant("t", 2)
    rids = [eng.submit("t", p, max_new=1 + i % 3, arrive=i // 3)
            for i, p in enumerate(prompts)]
    out = ST.serve_continuous([eng], max_new_tokens=8)[0]
    assert sorted(out) == sorted(rids)
    assert [len(out[r]) for r in rids] == [1 + i % 3 for i in range(10)]


def test_background_compaction_is_zero_copy(params):
    """Evicting a middle tenant fragments the virtual page space; idle
    drain cycles drive the background compactor, which rebases the
    survivor's extent through the page map — zero relocation steps, the
    KV bytes stay in their physical pages — and later generations still
    equal solo runs."""
    prompts = _prompts(2)
    refs = _solo(params, prompts, [4, 4])
    mgr = ST.make_shared_manager(
        2, max_batch=4, paged=True, max_len=64, device="cpu",
        elastic_policy=ElasticPolicy(background_compact=True,
                                     compact_interval=2))
    eng = ST.ServeEngine(CFG_T, max_batch=4, max_len=64, manager=mgr,
                         paged=True, params=params, device="cpu")
    for t in ("a", "b", "c"):
        eng.register_tenant(t, 4)
    rid0 = eng.submit("c", prompts[0], max_new=4)
    assert ST.serve_continuous([eng], max_new_tokens=4)[0][rid0] == refs[0]
    def phys_of(tenant):
        part = mgr.bounds.lookup(tenant)
        return sorted(int(eng._pool.pages.page_map[v])
                      for v in range(part.base, part.end))

    pool = eng._pool.buf["k"].clone()
    phys_c = phys_of("c")
    eng.quarantine_tenant("b")
    eng.evict_tenant("b")            # a hole below c
    base_before = mgr.bounds.lookup("c").base
    for _ in range(4):               # idle cycles drive the compactor
        mgr.run_queued()
    assert mgr.elastic.stats["compactions"] >= 1
    assert mgr.bounds.lookup("c").base < base_before
    assert mgr.elastic.stats["reloc_steps"] == 0
    # c's bytes never moved: its new extent maps to the same physical
    # pages, which hold what they held
    assert phys_of("c") == phys_c
    assert torch.equal(eng._pool.buf["k"][:, phys_c], pool[:, phys_c])
    rid1 = eng.submit("c", prompts[1], max_new=4)
    assert ST.serve_continuous([eng], max_new_tokens=4)[0][rid1] == refs[1]

"""The port's continuous paged serving path against the JAX reference: the
README's "Continuous serving over paged KV" snippet and a churny
multi-tenant trace on identical weights (same request -> tokens dicts,
same drain-cycle, prefill and decode counts), plus mirrors of the
reference's containment and row-refill tests.  The engine-driven tests
run with compiled steps (``jit_trusted``, the default) and with the eager
fallback."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_same, np_of, params_np, t_of  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.fence import FencePolicy as PJ  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.fence import FenceParams, FencePolicy  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.models import kvcache as KV  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.guard import GuardSpec  # noqa: E402

CFG_J = get_config("stablelm-3b").reduced()
CFG_T = get_config_t("stablelm-3b").reduced()


def _counts(mgr, eng):
    stats = mgr.scheduler.stats.summary()
    return {"cycles": mgr.telemetry.registry.counter("drain_cycles"),
            "decodes": eng.decode_steps,
            "prefills": int(stats["total_launches"]) - eng.decode_steps,
            "scheduler": stats}


def _shape(d):
    if isinstance(d, dict):
        return {k: _shape(v) for k, v in d.items()}
    return type(d).__name__


#: the port's jit-cache keys for its CUDA graphs (the reference compiles
#: through jax.jit and has no such counters)
GRAPH_KEYS = {"graphs": "int", "graph_evictions": "int",
              "graph_pool_bytes": "int", "graph_capture_s": "float"}

JIT = pytest.mark.parametrize("jit", [True, False],
                              ids=["compiled", "eager"])


def _readme_trace(e, run):
    e.register_tenant("api", 4)
    for i in range(3):
        e.submit("api", [1 + i, 2 + i, 3 + i], max_new=2 + i, arrive=i)
    return run([e], max_new_tokens=4)


@pytest.fixture(scope="module")
def readme_ref():
    """The reference's run of the README snippet: its engine's weights,
    generations, counts and report shape."""
    smgr = SJ.make_shared_manager(1, max_batch=4, max_len=64, paged=True)
    eng = SJ.ServeEngine(CFG_J, max_batch=4, max_len=64, manager=smgr,
                         paged=True)
    outs = _readme_trace(eng, SJ.serve_continuous)
    return (params_np(eng.params), outs, _counts(smgr, eng),
            _shape(smgr.metrics_report()))


@JIT
def test_readme_snippet_matches_reference(readme_ref, jit):
    """README.md's continuous paged-serving snippet, in both packages on
    the same weights; the port's report has the reference's shape plus
    its graph counters."""
    params, ref_outs, ref_counts, ref_shape = readme_ref
    tmgr = ST.make_shared_manager(1, max_batch=4, max_len=64, paged=True,
                                  device="cpu", jit_trusted=jit)
    teng = ST.ServeEngine(CFG_T, max_batch=4, max_len=64, manager=tmgr,
                          paged=True, device="cpu",
                          params=params_from_jax(params, device="cpu"))
    outs = _readme_trace(teng, ST.serve_continuous)
    assert len(outs[0]) == 3
    assert outs == ref_outs
    assert _counts(tmgr, teng) == ref_counts
    shape = _shape(tmgr.metrics_report())
    assert {k: shape["jit_cache"].pop(k) for k in GRAPH_KEYS} == GRAPH_KEYS
    assert shape == ref_shape


def _churn_trace(SV, eng, policy_of):
    prompts = [[(7 * i + 3 * j) % 211 + 1 for j in range(4 + i % 3)]
               for i in range(7)]
    for t, pol in enumerate([None, "modulo", "check"]):
        eng.register_tenant(f"t{t}", 2,
                            policy=None if pol is None else policy_of(pol))
    for i, p in enumerate(prompts):
        eng.submit(f"t{i % 3}", p, max_new=1 + i % 4, arrive=i // 2)
    return SV.serve_continuous([eng], max_new_tokens=8)


@pytest.fixture(scope="module")
def churn_ref():
    """The reference's run of the mixed-policy churn trace."""
    mgr = SJ.make_shared_manager(1, max_batch=4, max_len=64, paged=True)
    eng = SJ.ServeEngine(CFG_J, max_batch=4, max_len=64, manager=mgr,
                         paged=True, max_inflight=2)
    outs = _churn_trace(SJ, eng, PJ)
    return params_np(eng.params), outs, _counts(mgr, eng)


@JIT
def test_churn_with_mixed_policies_matches_reference(churn_ref, jit):
    """Three tenants (BITWISE, MODULO, CHECK) with staggered arrivals and
    per-request budgets, two rows in flight: rows leave and refill every few
    cycles, row-mixed fences run, and every generation and count equals
    the reference's."""
    params, ref_outs, ref_counts = churn_ref
    mgr = ST.make_shared_manager(1, max_batch=4, max_len=64, paged=True,
                                 device="cpu", jit_trusted=jit)
    eng = ST.ServeEngine(CFG_T, max_batch=4, max_len=64, manager=mgr,
                         paged=True, max_inflight=2, device="cpu",
                         params=params_from_jax(params, device="cpu"))
    outs = _churn_trace(ST, eng, FencePolicy)
    assert outs == ref_outs
    assert _counts(mgr, eng) == ref_counts


def test_forged_virtual_page_table_stays_fenced():
    """Mirror of the reference's serve-path containment test: a page
    table forged with another tenant's virtual ids wraps into the forger's
    own extent before the page_map translation — the victim's physical
    pages are never written, by the decode append or by the prefill page
    write, and never read by decode attention."""
    cache = KV.init_global_kv_cache(CFG_T, 2, 128, 16, device="cpu")
    assert cache.page_table.shape[1] == 2
    # attacker owns virtual [0, 2) -> phys [1, 2]; victim [4, 6) -> [3, 4]
    page_map = torch.zeros(8, dtype=torch.int32)
    page_map[0:2] = torch.tensor([1, 2])
    page_map[4:6] = torch.tensor([3, 4])
    guard = GuardSpec(
        policy=FencePolicy.BITWISE,
        kv=FenceParams(base=torch.tensor([0, 4], dtype=torch.int32),
                       size=torch.tensor([2, 2], dtype=torch.int32)),
        page=FenceParams(base=0, size=16), page_map=page_map)
    rng = np.random.default_rng(0)
    shape = (2, 1, CFG_T.n_kv_heads, CFG_T.head_dim)
    k_new = t_of(rng.normal(size=shape), torch.float32)
    honest = dataclasses.replace(
        cache, page_table=torch.tensor([[0, 1], [4, 5]], dtype=torch.int32),
        seq_lens=torch.tensor([3, 3], dtype=torch.int32))
    forged_table = torch.tensor([[4, 5], [4, 5]], dtype=torch.int32)

    def fresh(table):
        return dataclasses.replace(honest, k=cache.k.clone(),
                                   v=cache.v.clone(), page_table=table)

    c_h = KV.append_token_kv(fresh(honest.page_table), 0, k_new, k_new,
                             guard)
    c_f = KV.append_token_kv(fresh(forged_table), 0, k_new, k_new, guard)
    assert_same(c_h.k[:, 3:5], c_f.k[:, 3:5])
    assert (np_of(c_f.k[:, 1:3]) != 0).any()
    # the prefill page write (K2's plain version) under the same forgery
    src = t_of(rng.normal(size=(2, 70, *shape[2:])), torch.float32)
    p_h = KV.write_prefill_kv(fresh(honest.page_table), 1, src, src, guard)
    p_f = KV.write_prefill_kv(fresh(forged_table), 1, src, src, guard)
    assert_same(p_h.k[:, 3:5], p_f.k[:, 3:5])
    # decode attention (K1's plain version): the forger reads only its
    # own pages — clobbering the victim's changes nothing for row 0
    q = t_of(rng.normal(size=(2, 1, CFG_T.n_heads, CFG_T.head_dim)),
             torch.float32)
    lens = torch.tensor([70, 70], dtype=torch.int32)
    o1 = KV.paged_decode_attention(p_f, 1, q, lens, guard)
    p_f.k[:, 3:5] = 1e4
    p_f.v[:, 3:5] = -1e4
    o2 = KV.paged_decode_attention(p_f, 1, q, lens, guard)
    assert_same(o1[0], o2[0])


@JIT
def test_short_request_row_refills_immediately(jit):
    """Mirror of the reference test: a finished short request's row
    refills from the admission queue at the next cycle boundary."""
    prompts = [[(7 * i + 3 * j) % 211 + 1 for j in range(6)]
               for i in range(6)]
    mgr = ST.make_shared_manager(1, max_batch=2, paged=True, max_len=64,
                                 device="cpu", jit_trusted=jit)
    eng = ST.ServeEngine(CFG_T, max_batch=2, max_len=64, seed=0,
                         manager=mgr, paged=True, device="cpu")
    eng.register_tenant("t", 2)
    for i, p in enumerate(prompts):
        eng.submit("t", p, max_new=2 if i else 8)
    st = eng._cont_begin(16)
    while True:
        eng._cont_leave(st)
        joiners = eng._cont_join(st)
        h = eng._cont_dispatch(st, joiners)
        if h[0] is None and h[1] is None and not eng._cont_waiting(st):
            break
        eng.manager.run_queued()
        eng._cont_finish(st, *h)
    out = eng._cont_finalize(st)
    assert len(out) == 6
    assert sorted(len(t) for t in out.values()) == [2] * 5 + [8]
    assert st.cycles <= 13


@JIT
def test_eviction_scrubs_the_tenants_physical_pages(jit):
    """Evicting a tenant zeroes the physical pages behind its virtual
    extent (the KV-leak barrier) and leaves its co-tenant's pages as they
    were."""
    mgr = ST.make_shared_manager(1, max_batch=4, paged=True, max_len=64,
                                 device="cpu", jit_trusted=jit)
    eng = ST.ServeEngine(CFG_T, max_batch=4, max_len=64, manager=mgr,
                         paged=True, device="cpu")
    for t in ("a", "b"):
        eng.register_tenant(t, 2)
        eng.submit(t, [5, 6, 7, 8], max_new=3)
    eng.run(max_new_tokens=3)
    pm = eng._pool.pages.page_map
    phys = {t: [int(pm[v]) for v in range(mgr.bounds.lookup(t).base,
                                          mgr.bounds.lookup(t).end)]
            for t in ("a", "b")}
    k = eng._pool.buf["k"]
    assert k[:, phys["a"]].abs().sum() > 0
    kept = k[:, phys["b"]].clone()
    eng.quarantine_tenant("a", reason="test")
    eng.evict_tenant("a")
    assert k[:, phys["a"]].abs().sum() == 0
    assert torch.equal(k[:, phys["b"]], kept)


def test_unported_serve_options_refuse():
    """The sampled decode waits for a later port: ``temperature > 0`` and
    ``top_k`` refuse instead of silently serving greedy, on either layout
    (the slab layout itself is served since it was ported:
    tests/test_torch_slab.py)."""
    mgr = ST.make_shared_manager(1, max_batch=2, paged=True, max_len=64,
                                 device="cpu")
    with pytest.raises(NotImplementedError):
        ST.ServeEngine(CFG_T, max_batch=2, max_len=64, manager=mgr,
                       paged=True, temperature=0.7, device="cpu")
    with pytest.raises(NotImplementedError):
        ST.ServeEngine(CFG_T, max_batch=2, max_len=64, top_k=4,
                       device="cpu")
    with pytest.raises(NotImplementedError):
        ST.ServeEngine(CFG_T, max_batch=2, max_len=64, temperature=0.7,
                       device="cpu")

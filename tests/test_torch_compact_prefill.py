"""The continuous driver's compact prefill: a paged dense engine prefills
only a drain's joiners, rounded up to a power of two, and once its
first prefill at a prompt length has run, the other row counts' graphs
at that length are made too.

One trace drives most checks: eight rows, drains whose prefills hold 1,
2, 3 and 5 joiners (operands of 1, 2, 4 and 8 rows).  The port, compiled
and eager, against the reference's continuous driver on its weights
(``params_from_jax``) and against solo runs; what each prefill launch
carried; which physical pages each drain wrote.  An MoE engine keeps the
full-width prefill (its expert capacity couples the rows of a step)."""

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import params_np  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

CFG_J = get_config("stablelm-3b").reduced()
CFG_T = get_config_t("stablelm-3b").reduced()

B = 8
#: (arrival cycle, budget) of each request: drains 0-3 take 1, 2, 3 and 5
#: joiners (each earlier wave has left by then)
TRACE = [(0, 2)] + [(1, 2)] * 2 + [(2, 2)] * 3 + [(3, 3)] * 5
JOINERS = [1, 2, 3, 5]
#: the prompt lengths: one length, or joiners of one drain that differ
#: (the shorter ones padded to the longest, pads cached and attended)
LENGTHS = {"uniform": [6] * len(TRACE),
           "mixed": [6, 4, 7, 3, 6, 5, 8, 2, 6, 4, 7]}


def _prompts(lengths):
    return [[(7 * i + 3 * j) % 211 + 1 for j in range(n)]
            for i, n in enumerate(lengths)]


@pytest.fixture(scope="module")
def params():
    """Reference weights (seed 0, as every engine below would draw), as
    port params on the CPU."""
    eng = SJ.ServeEngine(CFG_J, max_batch=2, max_len=64, seed=0)
    return params_from_jax(params_np(eng.params), device="cpu")


def _engine(params, jit, max_batch=B, cfg=CFG_T):
    mgr = ST.make_shared_manager(1, max_batch=max_batch, paged=True,
                                 max_len=64, device="cpu", jit_trusted=jit)
    eng = ST.ServeEngine(cfg, max_batch=max_batch, max_len=64, manager=mgr,
                         paged=True, params=params, device="cpu")
    return mgr, eng


def _submit(eng, prompts, trace=TRACE):
    eng.register_tenant("t", B * eng.pages_per_req)
    return [eng.submit("t", p, max_new=m, arrive=a)
            for p, (a, m) in zip(prompts, trace)]


def _reference(prompts):
    mgr = SJ.make_shared_manager(1, max_batch=B, paged=True, max_len=64)
    eng = SJ.ServeEngine(CFG_J, max_batch=B, max_len=64, seed=0,
                         manager=mgr, paged=True)
    rids = _submit(eng, prompts)
    drains = [0]
    orig = mgr.run_queued

    def counted():
        drains[0] += 1
        orig()

    mgr.run_queued = counted
    out = SJ.serve_continuous([eng], max_new_tokens=8)[0]
    return [out[r] for r in rids], drains[0]


def _phys(eng, virt):
    pm = eng._pool.pages.page_map
    return {int(pm[v]) for v in virt}


def _record(mgr, eng):
    """Record what each prefill launch carried and which physical pages
    each drain wrote (with the pages the drain's rows own)."""
    rec = {"prefills": [], "drains": []}
    launch = eng._client.launch_kernel

    def launched(name, args):
        if name == eng._steps.prefill_name:
            _, meta, batch, _ = args
            rec["prefills"].append((tuple(batch["tokens"].shape),
                                    meta.page_table.clone(),
                                    meta.seq_lens.clone()))
        return launch(name, args=args)

    orig = mgr.run_queued

    def drain():
        before = {n: eng._pool.buf[n].clone() for n in ("k", "v")}
        orig()
        changed = set()
        for n, t in before.items():
            diff = (eng._pool.buf[n] != t).flatten(2).any(-1).any(0)
            changed |= set(diff.nonzero().flatten().tolist())
        rec["drains"].append(changed)

    eng._client.launch_kernel = launched
    mgr.run_queued = drain
    return rec


@pytest.fixture(scope="module", params=[(j, n) for j in (True, False)
                                        for n in LENGTHS],
                ids=lambda p: ("compiled" if p[0] else "eager") + "-" + p[1])
def served(request, params):
    """The trace on the port (recorded), on the reference, and each
    request served solo (uniform lengths only)."""
    jit, lengths = request.param
    prompts = _prompts(LENGTHS[lengths])
    mgr, eng = _engine(params, jit)
    rids = _submit(eng, prompts)
    rec = _record(mgr, eng)
    owners, joined = [], []
    orig_dispatch = eng._cont_dispatch

    def dispatch(st, joiners):
        # the physical pages of the rows a drain's steps compute, and the
        # joiners' virtual pages in order
        rows = [r for r in st.rows if r is not None]
        owners.append(set().union(*[_phys(eng, r.pages) for r in rows]))
        if joiners:
            joined.append([list(st.rows[i].pages) for i in joiners])
        return orig_dispatch(st, joiners)

    eng._cont_dispatch = dispatch
    out = ST.serve_continuous([eng], max_new_tokens=8)[0]
    solo = None
    if lengths == "uniform":
        solo = []
        for p, (_, m) in zip(prompts, TRACE):
            _, e = _engine(params, jit, max_batch=2)
            e.register_tenant("solo", 2 * e.pages_per_req)
            rid = e.submit("solo", p, max_new=m)
            solo.append(e.run(max_new_tokens=m)[rid])
    return dict(tokens=[out[r] for r in rids], drains=len(rec["drains"]),
                ref=_reference(prompts), solo=solo, rec=rec, owners=owners,
                joined=joined, eng=eng)


def test_tokens_and_drains_equal_the_reference_and_solo_runs(served):
    """Drains of 1, 2, 3 and 5 joiners: the same tokens and drain count
    as the reference's continuous driver, whose prefill computes all
    eight rows; at one prompt length, the same tokens as each request
    served alone."""
    assert (served["tokens"], served["drains"]) == served["ref"]
    if served["solo"] is not None:
        assert served["tokens"] == served["solo"]


def test_prefill_operands_are_the_joiners_rounded_up_to_pow2(served):
    """Each prefill's operand batch has ``_pow2(k)`` rows for its k
    joiners; row j < k carries joiner j's pages from position 0, every
    pad row the engine's scratch page ids."""
    eng, rec = served["eng"], served["rec"]
    shapes = [s for s, _, _ in rec["prefills"]]
    assert [s[0] for s in shapes] == [ST._pow2(k) for k in JOINERS]
    scratch = [eng._scratch.base + j % eng._scratch.size
               for j in range(eng.pages_per_req)]
    for k, pages, (_, table, lens) in zip(JOINERS, served["joined"],
                                          rec["prefills"]):
        assert table.shape == (ST._pow2(k), eng.pages_per_req)
        assert not lens.any()
        assert table.tolist() == pages + [scratch] * (ST._pow2(k) - k)


def test_drains_write_only_their_rows_pages_and_the_garbage_page(served):
    """Every physical page a drain changed is a page of one of the rows
    its steps computed, or the garbage page (page 0, where pad rows
    write); no other tenant page changes."""
    for changed, owned in zip(served["rec"]["drains"], served["owners"]):
        assert changed <= owned | {0}
    assert any(served["rec"]["drains"])


def test_moe_prefill_keeps_every_row():
    """An MoE engine's prefill still computes all ``max_batch`` rows:
    its expert capacity counts every token of a step, parked rows' too,
    as the reference's does."""
    cfg = get_config_t("qwen3-moe-30b-a3b").reduced()
    mgr, eng = _engine(None, True, max_batch=4, cfg=cfg)
    eng.register_tenant("t", 4 * eng.pages_per_req)
    for i, p in enumerate(_prompts([5, 5, 5])):
        eng.submit("t", p, max_new=2, arrive=i)
    rec = _record(mgr, eng)
    ST.serve_continuous([eng], max_new_tokens=2)
    assert [s for s, _, _ in rec["prefills"]] == [(4, 5)] * 3
    prefill = mgr.pointer_to_symbol[eng._steps.prefill_name]
    assert len(prefill.jit_cache) == 1


def _graphs(mgr):
    return mgr.jit_cache_stats()["graphs"]


def test_first_prefill_at_a_length_captures_every_row_count(params):
    """A run whose first prefill at each prompt length has one joiner
    captures the prefill graphs of every row count (1, 2, 4 and 8) at
    both lengths; a later run with 2 to 8 joiners at those lengths
    captures nothing.  The captures run nothing: they write no page
    and record no launch."""
    mgr, eng = _engine(params, True)
    eng.register_tenant("t", B * eng.pages_per_req)
    precompile = mgr.precompile
    calls = []

    def watched(name, args):
        pool = {n: eng._pool.buf[n].clone() for n in ("k", "v")}
        steps = mgr.scheduler.stats.single_steps
        made = precompile(name, args)
        calls.append((args[2]["tokens"].shape, made))
        assert mgr.scheduler.stats.single_steps == steps
        for n, t in pool.items():
            assert torch.equal(eng._pool.buf[n], t)
        return made

    mgr.precompile = watched
    for i, n in enumerate((6, 9)):
        eng.submit("t", _prompts([n])[0], max_new=2, arrive=i)
    ST.serve_continuous([eng], max_new_tokens=2)
    assert sorted(calls) == sorted(((b, n), True) for n in (6, 9)
                                   for b in (2, 4, 8))
    prefill = mgr.pointer_to_symbol[eng._steps.prefill_name]
    assert len(prefill.jit_cache) == 8
    graphs = _graphs(mgr)
    calls.clear()
    # 2 joiners at length 6, 3 at 9, 5 at 6, 8 at 9
    trace = [(0, 2)] * 2 + [(1, 2)] * 3 + [(3, 3)] * 5 + [(6, 2)] * 8
    lengths = [6, 6, 6, 9, 9, 6, 6, 6, 6, 6] + [9] * 8
    rids = [eng.submit("t", p, max_new=m, arrive=a)
            for p, (a, m) in zip(_prompts(lengths), trace)]
    out = ST.serve_continuous([eng], max_new_tokens=3)
    assert sorted(out[0]) == rids
    assert _graphs(mgr) == graphs and not calls

    def shape(g):
        return next(tuple(t.shape) for _, t in g.staged
                    if t.dim() == 2 and t.shape[1] in (6, 9))

    # the graphs the launches ran (on the CPU a graph made ahead runs its
    # step at its first launch, and only then is ready)
    ran = sorted(shape(g) for g in prefill.jit_cache.values() if g.ready)
    assert ran == [(1, 6), (1, 9), (2, 6), (4, 9), (8, 6), (8, 9)]


def test_eager_engine_captures_nothing(params):
    """With the eager fallback no prefill runs beyond the joiners'."""
    mgr, eng = _engine(params, False)
    eng.register_tenant("t", B * eng.pages_per_req)
    rec = _record(mgr, eng)
    eng.submit("t", _prompts([6])[0], max_new=2)
    ST.serve_continuous([eng], max_new_tokens=2)
    assert [s for s, _, _ in rec["prefills"]] == [(1, 6)]
    assert _graphs(mgr) == 0


@pytest.mark.parametrize("spans", [True, False], ids=["on", "off"])
def test_prefill_row_counters(params, spans):
    """``serve_prefill_rows`` and ``serve_prefill_joiners`` over the
    trace: 1 + 2 + 4 + 8 = 15 rows for 1 + 2 + 3 + 5 = 11 joiners (the
    captures of the other row counts not among them); with host spans
    off, counted nowhere, so the telemetry snapshot stays the
    reference's."""
    mgr, eng = _engine(params, True)
    _submit(eng, _prompts(LENGTHS["uniform"]))
    mgr.telemetry.trace.spans = spans
    ST.serve_continuous([eng], max_new_tokens=8)
    mgr.telemetry.trace.spans = False
    reg = mgr.telemetry.registry
    if spans:
        assert reg.counter("serve_prefill_rows") == 15
        assert reg.counter("serve_prefill_joiners") == 11
    else:
        assert "serve_prefill_rows" not in reg.counters
        assert "serve_prefill_joiners" not in reg.counters


@pytest.mark.parametrize("max_batch,counts", [
    (2, [1, 2]), (6, [1, 2, 4, 6]), (8, [1, 2, 4, 8])])
def test_prefill_row_counts_follow_max_batch(params, max_batch, counts):
    """The row counts a compact prefill takes are the powers of two
    below ``max_batch`` and ``max_batch`` itself: k joiners take the
    least of them that holds k, the joiners first, then pad rows."""
    _, eng = _engine(params, False, max_batch=max_batch)
    assert eng._row_counts() == counts
    st = eng._cont_begin(4)
    st.rows = [object() for _ in range(max_batch)]
    for k in range(1, max_batch + 1):
        joiners = list(range(max_batch - k, max_batch))
        got = eng._prefill_rows(st, joiners)
        assert len(got) == min(c for c in counts if c >= k)
        assert got[:k] == [st.rows[i] for i in joiners]
        assert all(r is None for r in got[k:])

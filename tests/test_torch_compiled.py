"""Compiled trusted steps (``GuardianManager(jit_trusted=True)``,
``ServeEngine(jit_steps=True)``, :mod:`repro_torch.core.stepgraph`) on the
CPU, where a step graph runs its step on the same staged operands and
fills the same persistent outputs a CUDA replay would: mirrors of the
reference's compiled-step tests on the same numpy inputs, and the port's
own cases — staged operands rewritten at dispatch, resident operands keyed
by identity, by-value fences keyed by value, outputs never overwritten by
a later replay, and isolation across replays after the fence rows move."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import np_of, params_np  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.manager import GuardianManager as GMJ  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.fence import FenceParams, FencePolicy  # noqa: E402
from repro_torch.core.manager import GuardianManager  # noqa: E402
from repro_torch.core.scheduler import LRUCache  # noqa: E402
from repro_torch.core.stepgraph import Operands, StepGraph  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.guard import GuardSpec, fence  # noqa: E402

CFG_J = get_config("stablelm-3b").reduced()
CFG_T = get_config_t("stablelm-3b").reduced()

JIT = pytest.mark.parametrize("jit", [True, False],
                              ids=["compiled", "eager"])


def _mgr(jit=True, **kw):
    return GuardianManager(total_slots=64, device="cpu", jit_trusted=jit,
                           **kw)


def _double(arena, x):
    return arena, x * 2.0


def _launch_two(mgr, step, xs):
    """Register ``step`` on ``mgr``, launch it once from each of two
    tenants and drain."""
    mgr.register_trusted_kernel("step", step)
    clients = [mgr.register_tenant(t, 8) for t in ("a", "b")]
    reqs = [c.launch_kernel("step", args=(x,)) for c, x in zip(clients, xs)]
    mgr.synchronize()
    return reqs


def _graphs(cache):
    return [g for g in cache.values() if isinstance(g, StepGraph)]


# --------------------------------------------------------------------- #
# Mirrors of tests/test_scheduler.py's trusted-step tests               #
# --------------------------------------------------------------------- #

@JIT
def test_trusted_requests_fuse_only_when_compiled(jit):
    """Mirror of ``test_trusted_requests_fuse_when_jitted`` and
    ``test_trusted_requests_stay_single_when_eager``: two tenants' trusted
    steps with equal signatures fuse into one compiled step (a graph
    cached under the trusted key) only under ``jit_trusted``; eager steps
    stay single and compile nothing.  Results equal the reference's."""
    xs = (np.ones(4, np.float32), np.full(4, 3.0, np.float32))
    ref = _launch_two(GMJ(total_slots=64, jit_trusted=jit), _double,
                      [jnp.asarray(x) for x in xs])
    mgr = _mgr(jit)
    reqs = _launch_two(mgr, _double, [torch.from_numpy(x) for x in xs])
    for r, rj in zip(reqs, ref):
        np.testing.assert_array_equal(np_of(r.result), np.asarray(rj.result))
    st = mgr.scheduler.stats
    if jit:
        assert st.fused_steps == 1 and list(st.batch_widths) == [2]
    else:
        assert st.fused_steps == 0 and st.single_steps == 2
    fused = [k for k in mgr.scheduler._fused_cache if k[0] == "trusted"]
    assert len(fused) == int(jit)
    assert len(_graphs(mgr.scheduler._fused_cache)) == int(jit)
    entry = mgr.pointer_to_symbol["step"]
    assert not any(k[0] == "trusted" for k in entry.jit_cache)


def test_trusted_compiled_matches_eager_results():
    """Mirror of ``test_trusted_jit_matches_eager_results``: the compiled
    step equals the eager fallback and the reference — same outputs, same
    arena bytes — on its first call and on a replay."""
    x = np.linspace(-1, 1, 32, dtype=np.float32).reshape(4, 8)
    w = np.linspace(1, -1, 64, dtype=np.float32).reshape(8, 8)

    def step_j(arena, x, w):
        return arena, jnp.tanh(x @ w) + x

    def step_t(arena, x, w):
        return arena, torch.tanh(x @ w) + x

    mgr = GMJ(total_slots=64)
    mgr.register_trusted_kernel("step", step_j)
    req = mgr.register_tenant("svc", 16).launch_kernel(
        "step", args=(jnp.asarray(x), jnp.asarray(w)))
    mgr.synchronize()
    want = np.asarray(req.result)
    runs = []
    for jit in (True, False):
        mgr = _mgr(jit)
        mgr.register_trusted_kernel("step", step_t)
        c = mgr.register_tenant("svc", 16)
        outs = []
        for _ in range(2):
            req = c.launch_kernel("step", args=(torch.from_numpy(x),
                                                torch.from_numpy(w)))
            mgr.synchronize()
            outs.append(np_of(req.result))
        runs.append((outs, np_of(mgr.arena.buf)))
    for outs, arena in runs:
        for out in outs:
            np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(arena, np.zeros(64, np.float32))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])


def test_trusted_pytree_operands_fuse_by_structure():
    """Mirror of the reference test: trusted signatures key pytree operands
    by structure + leaf shapes, so equal-structure steps fuse (one graph)
    and a different shape stays apart."""
    mgr = _mgr()

    def step(arena, tree):
        return arena, tree["x"] + tree["y"]

    mgr.register_trusted_kernel("step", step)
    a = mgr.register_tenant("a", 8)
    b = mgr.register_tenant("b", 8)
    t1 = {"x": torch.ones(4), "y": torch.zeros(4)}
    t2 = {"x": torch.full((4,), 2.0), "y": torch.ones(4)}
    t3 = {"x": torch.ones(8), "y": torch.zeros(8)}
    ra = a.launch_kernel("step", args=(t1,))
    rb = b.launch_kernel("step", args=(t2,))
    mgr.synchronize()
    assert mgr.scheduler.stats.fused_steps == 1
    assert torch.equal(ra.result, torch.ones(4))
    assert torch.equal(rb.result, torch.full((4,), 3.0))
    ra2 = a.launch_kernel("step", args=(t1,))
    rb2 = b.launch_kernel("step", args=(t3,))
    mgr.synchronize()
    assert mgr.scheduler.stats.fused_steps == 1
    assert torch.equal(rb2.result, torch.ones(8))
    assert torch.equal(ra2.result, torch.ones(4))


def test_jit_cache_lru_bound_evicts_and_counts():
    """Mirror of the reference test: ``jit_cache_capacity`` bounds each
    trusted step's graphs — churning signatures evicts the coldest (its
    graph and pool dropped, counted), an evicted signature recaptures on
    reuse, and the scheduler's fused cache is bounded the same way."""
    mgr = _mgr(jit_cache_capacity=2)

    def step(arena, x):
        return arena, x + 1.0

    mgr.register_trusted_kernel("step", step)
    c = mgr.register_tenant("svc", 16)
    for n in (2, 4, 8, 16):
        req = c.launch_kernel("step", args=(torch.zeros(n),))
        mgr.synchronize()
        assert torch.equal(req.result, torch.ones(n))
    entry = mgr.pointer_to_symbol["step"]
    assert len(entry.jit_cache) == 2 and entry.jit_cache.evictions == 2
    stats = mgr.jit_cache_stats()
    assert stats["capacity"] == 2 and stats["evictions"] == 2
    assert stats["per_kernel"]["step"] == 2
    assert stats["graphs"] == 2 and stats["graph_evictions"] == 2
    req = c.launch_kernel("step", args=(torch.zeros(2),))
    mgr.synchronize()
    assert torch.equal(req.result, torch.ones(2))
    stats = mgr.jit_cache_stats()
    assert stats["evictions"] == 3 and stats["graph_evictions"] == 3
    assert isinstance(mgr.scheduler._fused_cache, LRUCache)
    assert stats["fused_capacity"] == mgr.scheduler._fused_cache.capacity


# --------------------------------------------------------------------- #
# The step graph's operand rules                                        #
# --------------------------------------------------------------------- #

def test_staged_operand_is_read_at_dispatch_not_enqueue():
    """A staged tensor is copied into the graph's input when the step runs:
    a caller's write between enqueue and the drain shows, as it does
    eagerly."""
    outs = []
    for jit in (True, False):
        mgr = _mgr(jit)
        mgr.register_trusted_kernel("step", _double)
        c = mgr.register_tenant("svc", 16)
        first = c.launch_kernel("step", args=(torch.ones(4),))
        mgr.synchronize()
        x = torch.ones(4)
        req = c.launch_kernel("step", args=(x,))
        x.fill_(5.0)
        mgr.synchronize()
        outs.append((first.result, req.result))
    for first, second in outs:
        assert torch.equal(first, torch.full((4,), 2.0))
        assert torch.equal(second, torch.full((4,), 10.0))


def test_outputs_are_copies_a_later_replay_cannot_overwrite():
    """Every call of a graph returns fresh outputs: a result kept from an
    earlier call keeps its values after the key replays, and an output
    that passes a staged input through is a copy too."""
    def step(arena, x, meta):
        return arena, (x + 1.0, meta)

    g = None
    kept = []
    arena = torch.zeros(8)
    for v in (1.0, 2.0, 3.0):
        x, meta = torch.full((4,), v), {"lens": torch.full((2,), v)}
        ops = Operands.of((arena, x, meta), (True, False, False))
        g = g or StepGraph("step", step, ops, torch.device("cpu"))
        new_arena, (y, m) = g.run(ops)
        assert new_arena is arena
        assert m["lens"] is not meta["lens"]
        kept.append((y, m["lens"]))
    for v, (y, lens) in zip((1.0, 2.0, 3.0), kept):
        assert torch.equal(y, torch.full((4,), v + 1.0))
        assert torch.equal(lens, torch.full((2,), v))
    assert g.replays == 2


def test_by_value_fence_is_keyed_never_frozen():
    """A fence that reaches the step by value (an int base) is part of the
    key: another base gets another graph, and each call is fenced with
    its own base."""
    mgr = _mgr()

    def step(arena, ids, guard):
        return arena, fence(guard, "vocab", ids)

    mgr.register_trusted_kernel("step", step)
    c = mgr.register_tenant("svc", 16)
    ids = torch.arange(12, dtype=torch.int32)
    for base in (0, 8, 0):
        guard = GuardSpec(policy=FencePolicy.BITWISE,
                          vocab=FenceParams(base=base, size=8))
        req = c.launch_kernel("step", args=(ids, guard))
        mgr.synchronize()
        assert torch.equal(req.result, (ids & 7) | base)
    assert mgr.jit_cache_stats()["graphs"] == 2


def test_resident_operand_keyed_by_identity():
    """A resident operand is never copied: the graph addresses the tensor
    it was given, and another tensor of the same shape gets another
    graph."""
    mgr = _mgr()

    def step(arena, w, x):
        return arena, x @ w

    mgr.register_trusted_kernel("step", step, resident_argnums=(1,))
    c = mgr.register_tenant("svc", 16)
    x = torch.ones(1, 3)
    w1, w2 = torch.eye(3), 2 * torch.eye(3)
    for w in (w1, w2, w1):
        req = c.launch_kernel("step", args=(w, x))
        mgr.synchronize()
        assert torch.equal(req.result, x @ w)
    w1.mul_(3.0)            # in place: the same storage, the same graph
    req = c.launch_kernel("step", args=(w1, x))
    mgr.synchronize()
    assert torch.equal(req.result, 3 * x)
    assert mgr.jit_cache_stats()["graphs"] == 2


def test_compiled_step_must_write_the_arena_in_place():
    """A compiled step hands back the arena it was given; one that returns
    a new arena tensor is refused with its name."""
    mgr = _mgr()
    mgr.register_trusted_kernel("fresh", lambda arena, x: (arena + x, None))
    c = mgr.register_tenant("svc", 16)
    c.launch_kernel("fresh", args=(torch.ones(64),))
    with pytest.raises(RuntimeError, match="'fresh'"):
        mgr.synchronize()


def test_relocation_steps_stay_eager_and_apply_their_own_moves():
    """Two compactions of the flat arena move one tenant twice with two
    different move sets: each relocation step is eager by declaration (no
    graph), so the second never replays the first's moves, and the
    tenant's bytes arrive intact, as with ``jit_trusted=False``."""
    seen = []
    for jit in (True, False):
        mgr = _mgr(jit)
        register = mgr.register_trusted_kernel
        declared = []

        def spy(name, fn, **kw):
            declared.append(kw.get("capture", True))
            return register(name, fn, **kw)

        mgr.register_trusted_kernel = spy
        clients = {t: mgr.elastic.admit(t, 16).client for t in "abc"}
        ptr = clients["c"].malloc(16)
        clients["c"].memcpy_h2d(ptr, np.arange(16, dtype=np.float32))
        mgr.synchronize()
        bases = [mgr.bounds.lookup("c").base]
        for gone in ("b", "a"):
            mgr.remove_tenant(gone)
            assert mgr.elastic.compact() == 1
            bases.append(mgr.bounds.lookup("c").base)
        assert bases == [32, 16, 0]
        assert mgr.elastic.stats["reloc_steps"] == 2
        assert declared == [False, False]
        assert mgr.jit_cache_stats()["graphs"] == 0
        seen.append(clients["c"].memcpy_d2h(ptr, 16))
    for got in seen:
        np.testing.assert_array_equal(got, np.arange(16, dtype=np.float32))


# --------------------------------------------------------------------- #
# The serving plane                                                     #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def params():
    """Reference weights (seed 0), as port params on the CPU."""
    eng = SJ.ServeEngine(CFG_J, max_batch=2, max_len=64, seed=0)
    return params_from_jax(params_np(eng.params), device="cpu")


@pytest.fixture(scope="module")
def params1():
    """Other weights of the same shapes (seed 1)."""
    eng = SJ.ServeEngine(CFG_J, max_batch=2, max_len=64, seed=1)
    return params_from_jax(params_np(eng.params), device="cpu")


def _engine(params, jit, n_engines=1, B=4, **kw):
    mgr = ST.make_shared_manager(n_engines, max_batch=B, max_len=64,
                                 paged=True, device="cpu", jit_trusted=jit,
                                 **kw)
    eng = ST.ServeEngine(CFG_T, max_batch=B, max_len=64, manager=mgr,
                         paged=True, params=params, device="cpu")
    return mgr, eng


def test_serve_compiled_matches_eager_and_caches_graphs_iff_compiled():
    """Mirror of ``tests/test_system.py``'s
    ``test_serve_jit_steps_bit_identical_to_eager`` (on the paged layout,
    the port's only one): compiled and eager generations are identical
    and equal the reference's, and the engine caches a decode graph if
    and only if it compiles."""
    rng = np.random.default_rng(5)
    prompts = {t: rng.integers(0, CFG_J.vocab, 10, np.int32)
               for t in ("a", "b")}
    eng = SJ.ServeEngine(CFG_J, max_batch=4, max_len=64, paged=True)
    rids = {}
    for t, p in prompts.items():
        eng.register_tenant(t, 2)
        rids[t] = eng.submit(t, p)
    out = eng.run(max_new_tokens=6)
    want = {t: out[r] for t, r in rids.items()}
    params = params_from_jax(params_np(eng.params), device="cpu")
    for jit in (True, False):
        teng = ST.ServeEngine(CFG_T, max_batch=4, max_len=64, paged=True,
                              jit_steps=jit, params=params, device="cpu")
        rids = {}
        for t, p in prompts.items():
            teng.register_tenant(t, 2)
            rids[t] = teng.submit(t, p)
        out = teng.run(max_new_tokens=6)
        assert {t: out[r] for t, r in rids.items()} == want
        entry = teng.manager.pointer_to_symbol[teng._steps.decode_name]
        assert any(k[0] == "trusted" for k in entry.jit_cache) == jit


def test_serve_metrics_identical_compiled_vs_eager():
    """Mirror of ``tests/test_telemetry.py``'s
    ``test_serve_metrics_bit_identical_jit_vs_eager``: the compiled and
    eager paths agree on every logical metric and on the tokens, which
    equal the reference's."""
    rng = np.random.default_rng(0)
    prompts = {t: rng.integers(0, CFG_J.vocab, 8).astype(np.int32)
               for t in ("t0", "t1")}

    def run(SV, cfg, **kw):
        eng = SV.ServeEngine(cfg, max_batch=4, max_len=64, paged=True, **kw)
        for t, p in prompts.items():
            eng.register_tenant(t, 2)
            eng.submit(t, p)
        return eng, eng.run(max_new_tokens=3)

    ref_eng, want = run(SJ, CFG_J)
    params = params_from_jax(params_np(ref_eng.params), device="cpu")
    snaps = []
    for jit in (True, False):
        eng, out = run(ST, CFG_T, jit_steps=jit, params=params, device="cpu")
        assert out == want
        reg = eng.manager.telemetry.registry
        assert reg.counter("requests", tenant="t0") == 1
        snaps.append(reg.snapshot(include_timing=False))
    assert snaps[0] == snaps[1]


def test_readme_trace_captures_one_graph_per_prefill_length_and_decode(
        params):
    """On the README snippet's trace every prefill shares the prompt
    length 3: the first prefill at it and the graphs made once it has
    run give one prefill graph per row count a prefill of 4 rows can
    take (1, 2 and 4), one decode graph is captured, and every later
    step replays them."""
    mgr, eng = _engine(params, True)
    eng.register_tenant("api", 4)
    for i in range(3):
        eng.submit("api", [1 + i, 2 + i, 3 + i], max_new=2 + i, arrive=i)
    ST.serve_continuous([eng], max_new_tokens=4)
    stats = mgr.jit_cache_stats()
    assert stats["graphs"] == 4 and stats["graph_evictions"] == 0
    per = {n: _graphs(mgr.pointer_to_symbol[n].jit_cache)
           for n in (eng._steps.prefill_name, eng._steps.decode_name)}
    assert [len(g) for g in per.values()] == [3, 1]
    assert sum(g.replays for g in per[eng._steps.prefill_name]) == 2
    assert per[eng._steps.decode_name][0].replays > 0


def _drive(eng, hook=None, max_new_tokens=8):
    """``serve_continuous`` for one engine, calling ``hook(cycle)`` at
    each cycle boundary."""
    st = eng._cont_begin(max_new_tokens)
    while True:
        if hook is not None:
            hook(st.cycles)
        eng._cont_leave(st)
        joiners = eng._cont_join(st)
        h = eng._cont_dispatch(st, joiners)
        if h[0] is None and h[1] is None and not eng._cont_waiting(st):
            break
        eng.manager.run_queued()
        eng._cont_finish(st, *h)
    return eng._cont_finalize(st), st.cycles


def _prompts(n, plen=6, salt=0):
    return [[(7 * i + 3 * j + salt) % 211 + 1 for j in range(plen)]
            for i in range(n)]


def _scenario(name, params, jit):
    """One serve trace whose decode replays after the fence rows moved:
    an elastic grow mid-run, a co-tenant quarantined and evicted mid-run,
    or row-mixed fence policies.  Returns the generations, the cycle count
    and the pool's bytes."""
    mgr, eng = _engine(params, jit)
    hook = None
    prompts = _prompts(8)
    if name == "grow":
        eng.register_tenant("a", 4)
        eng.register_tenant("b", 1)          # 1-page extent: must grow
        owners = ["b" if i % 3 == 0 else "a" for i in range(8)]
    elif name == "evict":
        for t in ("a", "b", "c"):
            eng.register_tenant(t, 2)
        owners = ["abc"[i % 3] for i in range(8)]

        def hook(cycle):
            if cycle == 3:
                eng.quarantine_tenant("b", reason="test")
                eng.evict_tenant("b")
    else:
        for t, pol in zip("abc", (None, FencePolicy.MODULO,
                                  FencePolicy.CHECK)):
            eng.register_tenant(t, 2, policy=pol)
        owners = ["abc"[i % 3] for i in range(8)]
    rids = [eng.submit(o, p, max_new=3 + i % 4, arrive=i // 2)
            for i, (o, p) in enumerate(zip(owners, prompts))]
    out, cycles = _drive(eng, hook)
    if name == "grow":
        assert mgr.bounds.lookup("b").size > 1
    if name == "evict":
        assert eng.rejected
    return ([out.get(r) for r in rids], cycles,
            eng._pool.buf["k"].clone(), mgr.jit_cache_stats()["graphs"])


@pytest.mark.parametrize("name", ["grow", "evict", "mixed"])
def test_decode_replayed_after_fence_rows_move_equals_eager(params, name):
    """A decode graph replayed after the tenant's extent grew, after a
    co-tenant was quarantined and evicted (the fence table's rows change),
    and under row-mixed policies stages the new fence rows: generations,
    cycles and every byte of the pool equal the eager run's."""
    comp = _scenario(name, params, True)
    eager = _scenario(name, params, False)
    assert comp[0] == eager[0] and comp[1] == eager[1]
    assert torch.equal(comp[2], eager[2])
    assert comp[3] > 0 and eager[3] == 0


def test_decode_only_trace_keeps_every_trail_entry(params):
    """One request decoding alone: every cycle's next ids are the decode
    graph's output, kept in the trail until the run ends — each must be
    its own copy, so the tokens equal the eager run's."""
    outs = []
    for jit in (True, False):
        _, eng = _engine(params, jit)
        eng.register_tenant("t", 2)
        rid = eng.submit("t", _prompts(1)[0], max_new=7)
        outs.append(eng.run(max_new_tokens=7)[rid])
    assert len(outs[0]) == 7 and outs[0] == outs[1]
    assert len(set(outs[0])) > 1


def test_engines_with_other_weights_never_share_a_graph(params, params1):
    """Two co-hosted engines serve one model shape with other weights:
    their steps share a symbol (and fuse), but the weights are resident
    operands in every graph's key — each engine's solo run gets its own
    graphs and its own tokens, as eagerly."""
    runs = []
    for jit in (True, False):
        mgr = ST.make_shared_manager(2, max_batch=2, max_len=64, paged=True,
                                     device="cpu", jit_trusted=jit)
        engines = [ST.ServeEngine(CFG_T, max_batch=2, max_len=64,
                                  manager=mgr, paged=True, params=p,
                                  device="cpu") for p in (params, params1)]
        outs = []
        for i, eng in enumerate(engines):
            eng.register_tenant(f"t{i}", 2)
            rid = eng.submit(f"t{i}", _prompts(1)[0], max_new=4)
            outs.append(ST.serve_continuous([eng], max_new_tokens=4)[0][rid])
        decode = mgr.pointer_to_symbol[engines[0]._steps.decode_name]
        runs.append((outs, len(_graphs(decode.jit_cache))))
    assert runs[0][0] == runs[1][0]
    assert runs[0][0][0] != runs[0][0][1]
    assert runs[0][1] == 2 and runs[1][1] == 0


def test_lookahead_with_cohosted_engines_equals_eager(params, params1):
    """Two co-hosted engines under ``lookahead_cycles=2``: requests wait
    in the scheduler across cycles and fuse into width-2 compiled steps
    keyed by both engines' weights; every generation equals the eager
    (unfused) run's."""
    runs = []
    for jit in (True, False):
        mgr = ST.make_shared_manager(2, max_batch=2, max_len=64, paged=True,
                                     device="cpu", jit_trusted=jit,
                                     lookahead_cycles=2)
        engines = [ST.ServeEngine(CFG_T, max_batch=2, max_len=64,
                                  manager=mgr, paged=True, params=p,
                                  device="cpu") for p in (params, params1)]
        rids = []
        for i, eng in enumerate(engines):
            eng.register_tenant(f"t{i}", 2)
            rids.append([eng.submit(f"t{i}", p, max_new=2 + j, arrive=j)
                         for j, p in enumerate(_prompts(3, salt=i))])
        outs = ST.serve_continuous(engines, max_new_tokens=4)
        st = mgr.scheduler.stats
        runs.append(([[o[r] for r in rs] for o, rs in zip(outs, rids)],
                     st.fused_steps, st.lookahead_fused))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] > 0 and runs[0][2] > 0
    assert runs[1][1] == 0


def test_forged_page_table_stays_fenced_under_replay(params):
    """A tenant's rows carry a page table forged with its co-tenant's
    virtual ids on every compiled step: the fence wraps them into the
    forger's own extent, so the victim's physical pages keep the bytes
    its own request wrote, replay after replay."""
    mgr, eng = _engine(params, True)
    eng.register_tenant("victim", 2)
    eng.register_tenant("forger", 2)
    eng.submit("victim", _prompts(1)[0], max_new=3)
    eng.run(max_new_tokens=3)
    vp = mgr.bounds.lookup("victim")
    pm = eng._pool.pages.page_map
    phys = [int(pm[v]) for v in range(vp.base, vp.end)]
    k, v = (eng._pool.buf[n][:, phys].clone() for n in ("k", "v"))
    assert k.abs().sum() > 0
    meta = eng._cont_meta

    def forged(rows, lens=None):
        m = meta(rows, lens)
        at = [i for i, r in enumerate(rows)
              if r is not None and r.tenant == "forger"]
        table = m.page_table.clone()
        table[at] = torch.arange(vp.base, vp.base + table.shape[1],
                                 dtype=torch.int32) % vp.size + vp.base
        return dataclasses.replace(m, page_table=table)

    eng._cont_meta = forged
    eng.submit("forger", _prompts(1, salt=5)[0], max_new=5)
    eng.run(max_new_tokens=5)
    decode = _graphs(mgr.pointer_to_symbol[eng._steps.decode_name].jit_cache)
    assert decode and decode[0].replays >= 4
    assert torch.equal(eng._pool.buf["k"][:, phys], k)
    assert torch.equal(eng._pool.buf["v"][:, phys], v)


def test_cohosted_engine_refuses_eager_override():
    """As the reference: step compilation is the shared manager's setting;
    a co-hosted engine refuses ``jit_steps=False``."""
    mgr = ST.make_shared_manager(2, max_batch=2, max_len=64, paged=True,
                                 device="cpu")
    with pytest.raises(ValueError, match="jit_steps"):
        ST.ServeEngine(CFG_T, max_batch=2, max_len=64, manager=mgr,
                       paged=True, jit_steps=False, device="cpu")

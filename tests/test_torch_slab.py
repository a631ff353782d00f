"""The port's slab KV layout and lockstep serving against the JAX reference.

* the slab cache (``models/kvcache.py``): ``init_kv_cache``,
  ``gather_layer_kv``, ``append_token_kv`` and ``write_prefill_kv`` in both
  modes hold the reference's whole pool bit for bit on the same seeded
  inputs — parked rows sharing the scratch slot, and forged slot and page
  ids, included — under BITWISE, MODULO, CHECK and row-mixed guards;
* slab decode attention through K1's plain version, over the flattened
  layer view, within 1e-5 of the reference's ``layers.decode_attention``
  over the gathered history;
* ``build_pool_relocation_step`` equal to the reference's;
* prefill + decode on the slab for reduced stablelm-3b and qwen3-moe
  (logits within 1e-4, greedy ids equal);
* mirrors of the reference's serving tests (``tests/test_system.py``,
  ``test_continuous.py``, ``test_spans.py``) and the lockstep and
  independent legs of ``benchmarks/serve_continuous.py``'s quick trace,
  on the reference's weights: the same tokens and the same drain-cycle,
  decode and launch counts; engine-driven tests run with compiled steps
  and with the eager fallback.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import TOL_F32, TOL_MODEL, assert_close, assert_same, \
    np_of, params_np, t_of  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.fence import FenceTable as FTJ, FencePolicy as PJ  # noqa
from repro.core.fence import FenceParams as FPJ  # noqa: E402
from repro.core.partition import Partition as PartJ  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro.launch import steps as STEPSJ  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro.models import kvcache as KVJ, layers as LJ  # noqa: E402
from repro.models.guard import GuardSpec as GSJ  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.fence import FenceTable as FTT, \
    FencePolicy as PT, FenceParams as FPT  # noqa: E402
from repro_torch.core.partition import Partition as PartT  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.launch import steps as STEPST  # noqa: E402
from repro_torch.models import get_model as get_model_t  # noqa: E402
from repro_torch.models import kvcache as KVT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.guard import GuardSpec as GST  # noqa: E402

CFG_J = get_config("stablelm-3b").reduced()
CFG_T = get_config_t("stablelm-3b").reduced()
MOE_J = get_config("qwen3-moe-30b-a3b").reduced()
MOE_T = get_config_t("qwen3-moe-30b-a3b").reduced()

JIT = pytest.mark.parametrize("jit", [True, False],
                              ids=["compiled", "eager"])
POLICIES = pytest.mark.parametrize(
    "policy", ["bitwise", "modulo", "check", "mixed"])


@pytest.fixture(scope="module")
def params():
    """Reference weights (seed 0, as every reference engine draws them) as
    port params on the CPU."""
    return params_from_jax(
        params_np(get_model_j(CFG_J).init(jax.random.PRNGKey(0))),
        device="cpu")


# ---------------------------------------------------------------------------
# The slab cache, function by function
# ---------------------------------------------------------------------------

#: 8 rows over a 16-slot pool of 2 pages: tenants a [4, 8) and b [8, 12),
#: the engine's scratch partition [0, 4); rows 0-3 serve, rows 4-7 park on
#: the scratch base.  Row 1's slot is forged into b's extent, row 3's page
#: ids are forged (one out of the slab, one negative), row 2 aliases row
#: 0's slot.
B, SLOTS, MAX_LEN = 8, 16, 128
ROW_TENANT = [0, 0, 1, 0, 2, 2, 2, 2]          # a, a, b, a, scratch...
PARTS = [(4, 4), (8, 4), (0, 4)]
SLOT_IDS = np.array([4, 9, 8, 4, 0, 0, 0, 0], np.int32)
TABLE = np.array([[0, 1], [1, 0], [0, 1], [5, -1]] + [[0, 1]] * 4,
                 np.int32)


def _guards(policy):
    """The same per-row guard in both packages: kv and state from the
    fence table's rows (magic included), pages fenced into the slab."""
    pj = [PartJ(f"t{i}", b, s) for i, (b, s) in enumerate(PARTS)]
    pt = [PartT(f"t{i}", b, s) for i, (b, s) in enumerate(PARTS)]
    kj = FTJ.from_partitions(pj, with_magic=True).gather(
        jnp.asarray(ROW_TENANT, jnp.int32))
    kt = FTT.from_partitions(pt, with_magic=True, device="cpu").gather(
        torch.tensor(ROW_TENANT, dtype=torch.int32))
    if policy == "mixed":
        codes = np.array([PJ(p).code for p in
                          ["bitwise", "modulo", "check", "modulo"] * 2],
                         np.int32)
        base_j, base_t = PJ.BITWISE, PT.BITWISE
        rp_j, rp_t = jnp.asarray(codes), torch.tensor(codes)
    else:
        base_j, base_t, rp_j, rp_t = PJ(policy), PT(policy), None, None
    gj = GSJ(policy=base_j, vocab=FPJ(0, 512), kv=kj, state=kj,
             page=FPJ(0, 2), row_policy=rp_j)
    gt = GST(policy=base_t, vocab=FPT(0, 512), kv=kt, state=kt,
             page=FPT(0, 2), row_policy=rp_t)
    return gj, gt


def _caches(seed, seq_lens):
    """Both packages' slab caches over one random f32 pool, with the
    module's slot ids and page table."""
    cj = KVJ.init_kv_cache(CFG_J, B, MAX_LEN, slots=SLOTS,
                           dtype=jnp.float32)
    shape = cj.k.shape
    rng = np.random.default_rng(seed)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    lens = np.asarray(seq_lens, np.int32)
    cj = dataclasses.replace(
        cj, k=jnp.asarray(k), v=jnp.asarray(v),
        slot_ids=jnp.asarray(SLOT_IDS), page_table=jnp.asarray(TABLE),
        seq_lens=jnp.asarray(lens))
    ct = dataclasses.replace(
        KVT.init_kv_cache(CFG_T, B, MAX_LEN, slots=SLOTS,
                          dtype=torch.float32, device="cpu"),
        k=t_of(k), v=t_of(v), slot_ids=t_of(SLOT_IDS),
        page_table=t_of(TABLE), seq_lens=t_of(lens))
    return cj, ct


def _kv(seed, S):
    rng = np.random.default_rng(seed)
    shape = (B, S, CFG_J.n_kv_heads, CFG_J.head_dim)
    return (rng.normal(size=shape).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("batch,max_len,slots",
                         [(4, 64, None), (3, 256, None), (8, 128, 16),
                          (2, 16, 1)])
def test_init_kv_cache_matches_reference(batch, max_len, slots):
    """Shapes, dtypes, the identity page table and ``slot_ids =
    arange(batch)``; ``slots`` defaults to ``pow2(batch)``."""
    for dtype_j, dtype_t in ((jnp.bfloat16, torch.bfloat16),
                             (jnp.float32, torch.float32)):
        cj = KVJ.init_kv_cache(CFG_J, batch, max_len, slots=slots,
                               dtype=dtype_j)
        ct = KVT.init_kv_cache(CFG_T, batch, max_len, slots=slots,
                               dtype=dtype_t, device="cpu")
        spec_j = KVJ.kv_cache_spec(CFG_J, batch, max_len, slots=slots)
        spec_t = KVT.kv_cache_spec(CFG_T, batch, max_len, slots=slots)
        assert {k: tuple(v.shape) for k, v in spec_t.items()} == \
            {k: tuple(v.shape) for k, v in spec_j.items()}
        assert spec_t["k"].device.type == "meta"
        assert ct.k.dtype == dtype_t and not ct.global_paged
        for name in ("k", "v", "page_table", "slot_ids", "seq_lens"):
            assert_same(getattr(ct, name), getattr(cj, name))
        assert (ct.pages_per_slot, ct.page_size, ct.max_len) == \
            (cj.pages_per_slot, cj.page_size, cj.max_len)


@POLICIES
def test_gather_layer_kv_matches_reference(policy):
    """The fenced slab history of every row, forged slot and page ids
    included, bit for bit at both layers."""
    gj, gt = _guards(policy)
    cj, ct = _caches(0, [5] * B)
    for layer in range(CFG_J.n_layers):
        for a, b in zip(KVJ.gather_layer_kv(cj, layer, gj),
                        KVT.gather_layer_kv(ct, layer, gt)):
            assert_same(b, a)


@POLICIES
@pytest.mark.parametrize("seq_lens", [[5] * B, [63, 64, 3, 127, 7, 7, 7, 7],
                                      [200, 0, 64, 65, 0, 0, 0, 0]],
                         ids=["uniform", "page-edges", "past-max-len"])
def test_append_token_kv_matches_reference(policy, seq_lens):
    """The decode append writes the reference's whole pool: the four
    parked rows write one scratch address with different values (the
    last row wins), row 2 aliases row 0's slot, a length past the page
    table writes page 0."""
    gj, gt = _guards(policy)
    cj, ct = _caches(1, seq_lens)
    kn, vn = _kv(2, 1)
    for layer in range(CFG_J.n_layers):
        cj = KVJ.append_token_kv(cj, layer, jnp.asarray(kn),
                                 jnp.asarray(vn), gj)
        ct = KVT.append_token_kv(ct, layer, t_of(kn), t_of(vn), gt)
    assert_same(ct.k, cj.k)
    assert_same(ct.v, cj.v)


@POLICIES
@pytest.mark.parametrize("mode", ["permute", "scatter"])
@pytest.mark.parametrize("S", [12, 64, 70])
def test_write_prefill_kv_matches_reference(policy, mode, S):
    """Both formulations write the reference's whole pool bit for bit: in
    ``permute`` the parked rows' slabs *sum* into the scratch slot (and
    rows 0, 2 into slot 4), in ``scatter`` the last writer wins; a page id
    out of the slab is dropped (permute) or fenced (scatter)."""
    gj, gt = _guards(policy)
    cj, ct = _caches(3, [0] * B)
    kn, vn = _kv(4, S)
    for layer in range(CFG_J.n_layers):
        cj = KVJ.write_prefill_kv(cj, layer, jnp.asarray(kn),
                                  jnp.asarray(vn), gj, mode=mode)
        ct = KVT.write_prefill_kv(ct, layer, t_of(kn), t_of(vn), gt,
                                  mode=mode)
    assert_same(ct.k, cj.k)
    assert_same(ct.v, cj.v)


def test_slab_writes_resolve_duplicates_last_writer_wins():
    """The slab stores are deterministic on any device: every store of a
    duplicated address carries its last writer's value (the scatter's
    ``_last_writer`` redirect), so the four parked rows' scratch address
    holds row 7's K/V."""
    _, gt = _guards("bitwise")
    _, ct = _caches(5, [9] * B)
    kn, vn = _kv(6, 1)
    KVT.append_token_kv(ct, 0, t_of(kn), t_of(vn), gt)
    assert_same(ct.k[0, 0, 0, 9], kn[7, 0])
    keys = torch.tensor([3, 1, 3, 2, 1, 3])
    assert KVT._last_writer(keys).tolist() == [5, 4, 5, 3, 4, 5]


@POLICIES
def test_slab_decode_attention_through_k1_matches_decode_attention(policy):
    """K1's plain version over the flattened ``(slots * P, page, KH, D)``
    layer view, ids ``fenced_slot * P + fenced_page``, equals the
    reference's ``layers.decode_attention`` over the gathered history
    within 1e-5 (forged slot and page ids included), and runs as K1's
    plain version — one call a layer."""
    gj, gt = _guards(policy)
    lens = [5, 64, 3, 100, 7, 7, 7, 7]
    cj, ct = _caches(7, lens)
    rng = np.random.default_rng(8)
    q = rng.normal(size=(B, 1, CFG_J.n_heads, CFG_J.head_dim)).astype(
        np.float32)
    kv_len = np.asarray(lens, np.int32) + 1
    plan = KVT.decode_plan(ct, gt)
    for layer in range(CFG_J.n_layers):
        k_h, v_h = KVJ.gather_layer_kv(cj, layer, gj)
        want = LJ.decode_attention(jnp.asarray(q), k_h, v_h,
                                   jnp.asarray(kv_len))
        kernel = _build.KERNELS["paged_attention"]
        before = kernel.plain_calls
        got = KVT.paged_decode_attention(ct, layer, t_of(q), t_of(kv_len),
                                         gt, plan=plan)
        assert kernel.plain_calls == before + 1
        assert_close(got, want, TOL_F32)


def test_pool_relocation_step_matches_reference():
    """The elastic slab move: slots [src, src + size) copied to dst and
    the source zeroed on every slot-indexed tensor, in place; a tensor too
    short for both extents passes through."""
    rng = np.random.default_rng(9)
    pool = {"k": rng.normal(size=(2, 16, 2, 3)).astype(np.float32),
            "v": rng.normal(size=(2, 16, 2, 3)).astype(np.float32),
            "short": rng.normal(size=(2, 5)).astype(np.float32)}
    for src, dst, size in ((4, 8, 4), (8, 0, 2), (12, 4, 4)):
        fj = STEPSJ.build_pool_relocation_step(src, dst, size)
        ft = STEPST.build_pool_relocation_step(src, dst, size)
        _, pj, _ = fj(jnp.zeros(4), {k: jnp.asarray(v)
                                     for k, v in pool.items()})
        live = {k: t_of(v) for k, v in pool.items()}
        _, out, none = ft(torch.zeros(4), live)
        assert none is None
        for name in pool:
            assert out[name] is live[name]       # written in place
            assert_same(out[name], pj[name])


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("policy", ["bitwise", "modulo", "check"])
def test_slab_prefill_and_decode_match_reference(arch, policy):
    """``api.init_cache`` + prefill + 5 decode steps on the slab, the same
    weights in both packages: logits within 1e-4 each step, greedy ids
    equal, the pool within 1e-4 (rows 0 and 1 in two tenants' slots, row
    1's slot forged into row 0's extent)."""
    cfg_j, cfg_t = (CFG_J, CFG_T) if arch == "stablelm-3b" \
        else (MOE_J, MOE_T)
    api_j, api_t = get_model_j(cfg_j), get_model_t(cfg_t)
    pj = params_np(api_j.init(jax.random.PRNGKey(3)))
    pt = params_from_jax(pj, device="cpu")
    base, size = np.array([0, 4], np.int32), np.array([4, 4], np.int32)
    pol_j, pol_t = PJ(policy), PT(policy)
    tj = FTJ.from_partitions([PartJ("a", 0, 4), PartJ("b", 4, 4)],
                             with_magic=True).gather(jnp.asarray([0, 1]))
    tt = FTT.from_partitions([PartT("a", 0, 4), PartT("b", 4, 4)],
                             with_magic=True, device="cpu").gather(
        torch.tensor([0, 1], dtype=torch.int32))
    assert_same(np_of(tt.base), base)
    expert = cfg_j.moe.num_experts if cfg_j.moe else 0
    gj = GSJ(policy=pol_j, vocab=FPJ(0, 512), kv=tj, state=tj,
             expert=FPJ(0, expert) if expert else None, page=FPJ(0, 2))
    gt = GST(policy=pol_t, vocab=FPT(0, 512), kv=tt, state=tt,
             expert=FPT(0, expert) if expert else None, page=FPT(0, 2))
    slots = np.array([1, 2], np.int32)
    cj = dataclasses.replace(
        api_j.init_cache(2, 128, dtype=jnp.float32, slots=8),
        slot_ids=jnp.asarray(slots))
    ct = dataclasses.replace(
        api_t.init_cache(2, 128, dtype=torch.float32, slots=8,
                         device="cpu"),
        slot_ids=t_of(slots))
    toks = np.random.default_rng(4).integers(0, cfg_j.vocab, size=(2, 9))
    cj, lj = api_j.prefill(pj, cj, {"tokens": jnp.asarray(toks, jnp.int32)},
                           guard=gj)
    ct, lt = api_t.prefill(pt, ct, {"tokens": t_of(toks.astype(np.int32))},
                           guard=gt)
    assert_close(lt, lj, TOL_MODEL)
    nj, nt = jnp.argmax(lj, -1).astype(jnp.int32), lt.argmax(-1).int()
    for _ in range(5):
        assert_same(nt, nj)
        cj, lj = api_j.decode(pj, cj, nj, guard=gj)
        ct, lt = api_t.decode(pt, ct, nt, guard=gt)
        assert_close(lt, lj, TOL_MODEL)
        nj, nt = jnp.argmax(lj, -1).astype(jnp.int32), lt.argmax(-1).int()
    assert_same(nt, nj)
    assert_same(ct.seq_lens, cj.seq_lens)
    assert_close(ct.k, cj.k, TOL_MODEL)
    assert_close(ct.v, cj.v, TOL_MODEL)


def test_fence_modes_equivalent_for_honest_tenant():
    """Mirror of ``test_system.py::test_fence_modes_equivalent_for_honest_
    tenant`` on the serve path (the port has no loss yet): for a tenant
    that owns every slot, BITWISE / MODULO / CHECK / native give the same
    slab prefill and decode logits on reduced qwen3-moe, within 1e-5 of
    each other and of the reference's native run."""
    from repro.launch.steps import make_guard
    from repro.configs import ShapeConfig

    api_j, api_t = get_model_j(MOE_J), get_model_t(MOE_T)
    pj = params_np(api_j.init(jax.random.PRNGKey(0)))
    pt = params_from_jax(pj, device="cpu")
    toks = np.random.default_rng(1).integers(0, MOE_J.vocab, size=(2, 33))
    shape = ShapeConfig("t", "decode", 64, 2)

    def guard_t(policy):
        g = make_guard(MOE_J, shape, PJ(policy))
        fp = (lambda f: None if f is None else FPT(f.base, f.size))
        return GST(policy=PT(policy), vocab=fp(g.vocab), kv=fp(g.kv),
                   state=fp(g.state), expert=fp(g.expert), page=fp(g.page))

    def serve(api, p, cache, tokens, guard):
        cache, first = api.prefill(p, cache, {"tokens": tokens}, guard=guard)
        nxt = first.argmax(-1).int() if isinstance(first, torch.Tensor) \
            else jnp.argmax(first, -1).astype(jnp.int32)
        cache, second = api.decode(p, cache, nxt, guard=guard)
        return np.concatenate([np_of(first), np_of(second)])

    ref = serve(api_j, pj, api_j.init_cache(2, 64, dtype=jnp.float32),
                jnp.asarray(toks, jnp.int32), None)
    logits = {}
    for name in ("native", "bitwise", "modulo", "check"):
        guard = None if name == "native" else guard_t(name)
        cache = api_t.init_cache(2, 64, dtype=torch.float32, device="cpu")
        logits[name] = serve(api_t, pt, cache,
                             t_of(toks.astype(np.int32)), guard)
    for name, got in logits.items():
        assert_close(got, logits["native"], TOL_F32)
    assert_close(logits["native"], ref, TOL_MODEL)


# ---------------------------------------------------------------------------
# Serving: mirrors of the reference's tests, on the reference's weights
# ---------------------------------------------------------------------------

def _engine(params, jit=True, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 64)
    return ST.ServeEngine(CFG_T, jit_steps=jit, params=params,
                          device="cpu", **kw)


def _prompts(n, plen=6, salt=0):
    return [[(7 * i + 3 * j + salt) % 211 + 1 for j in range(plen)]
            for i in range(n)]


def test_slab_engine_is_the_default_and_runs_lockstep(params):
    """``ServeEngine(paged=False)``, the reference's default, serves: a
    slab pool ``(L, 2 * pow2(max_batch), P, page, KH, D)`` on the
    manager, the engine's scratch partition the upper half, the slab step
    symbols of the reference, and each driver refuses the other layout."""
    eng = _engine(params)
    ref = SJ.ServeEngine(CFG_J, max_batch=4, max_len=64)
    assert not eng.paged
    assert tuple(eng.cache.k.shape) == tuple(ref.cache.k.shape)
    assert eng._steps.pool_name == ref._steps.pool_name
    assert eng._steps.decode_name == ref._steps.decode_name
    assert eng._scratch.base == ref._scratch.base
    assert eng._scratch.size == ref._scratch.size
    with pytest.raises(ValueError):
        ST.serve_continuous([eng])
    mgr = ST.make_shared_manager(1, max_batch=4, paged=True, max_len=64,
                                 device="cpu")
    paged = ST.ServeEngine(CFG_T, max_batch=4, max_len=64, manager=mgr,
                           paged=True, params=params, device="cpu")
    with pytest.raises(ValueError):
        ST.serve_engines([paged])


@pytest.fixture(scope="module")
def isolation_ref():
    """``test_system.py::test_serve_engine_multi_tenant_isolation`` on the
    reference: A alone, then A and B co-located."""
    rng = np.random.default_rng(0)
    pa = rng.integers(0, CFG_J.vocab, size=12).astype(np.int32)
    pb = rng.integers(0, CFG_J.vocab, size=12).astype(np.int32)
    e1 = SJ.ServeEngine(CFG_J, max_batch=4, max_len=128)
    e1.register_tenant("a", 2)
    ra = e1.submit("a", pa)
    alone = e1.run(max_new_tokens=8)[ra]
    e2 = SJ.ServeEngine(CFG_J, max_batch=4, max_len=128)
    e2.register_tenant("a", 2)
    e2.register_tenant("b", 2)
    e2.submit("a", pa)
    e2.submit("b", pb)
    return (pa, pb), alone, e2.run(max_new_tokens=8)


@JIT
def test_serve_engine_multi_tenant_isolation(params, isolation_ref, jit):
    """Mirror of the reference test: tenant B's requests do not perturb
    tenant A's generations, and both runs equal the reference's."""
    (pa, pb), ref_alone, ref_both = isolation_ref
    e1 = _engine(params, jit, max_len=128)
    e1.register_tenant("a", 2)
    ra = e1.submit("a", pa)
    out1 = e1.run(max_new_tokens=8)[ra]
    e2 = _engine(params, jit, max_len=128)
    e2.register_tenant("a", 2)
    e2.register_tenant("b", 2)
    ra2 = e2.submit("a", pa)
    e2.submit("b", pb)
    out2 = e2.run(max_new_tokens=8)
    assert out2[ra2] == out1, "tenant B perturbed tenant A"
    assert out1 == ref_alone
    assert out2 == ref_both


@JIT
def test_serve_guard_blocks_forged_slots(params, jit):
    """Mirror of the reference test: a forged slot id (scheduler
    compromise) wraps inside the owner's partition — the victim's slots
    stay byte-equal."""
    eng = _engine(params, jit, max_batch=8, max_len=128)
    vp = eng.register_tenant("victim", 4)
    eng.register_tenant("attacker", 4)
    rng = np.random.default_rng(1)
    eng.submit("victim", rng.integers(0, CFG_T.vocab, 8))
    eng.run(max_new_tokens=2)
    sl = slice(vp.base, vp.base + vp.size)
    victim_rows = eng.cache.k[:, sl].clone()
    assert (victim_rows != 0).any()
    rid_a = eng.submit("attacker",
                       rng.integers(0, CFG_T.vocab, 8).astype(np.int32))
    req = [r for r in eng._requests if r.rid == rid_a][0]
    req.slot = vp.base                     # forged: the victim's slot
    eng.run(max_new_tokens=2)
    assert_same(eng.cache.k[:, sl], victim_rows)


@pytest.fixture(scope="module")
def jit_eager_ref():
    rng = np.random.default_rng(5)
    prompts = {t: rng.integers(0, CFG_J.vocab, 10, np.int32)
               for t in ("a", "b")}
    eng = SJ.ServeEngine(CFG_J, max_batch=4, max_len=64)
    rids = {}
    for t, p in prompts.items():
        eng.register_tenant(t, 2)
        rids[t] = eng.submit(t, p)
    out = eng.run(max_new_tokens=6)
    return prompts, {t: out[r] for t, r in rids.items()}


def test_serve_jit_steps_equal_to_eager(params, jit_eager_ref):
    """Mirror of ``test_serve_jit_steps_bit_identical_to_eager``: compiled
    and eager steps give the same generations (and the reference's); the
    compiled engine keyed its steps, the eager one never did."""
    prompts, ref = jit_eager_ref
    outs = []
    for jit in (True, False):
        eng = _engine(params, jit)
        rids = {}
        for t, p in prompts.items():
            eng.register_tenant(t, 2)
            rids[t] = eng.submit(t, p)
        out = eng.run(max_new_tokens=6)
        outs.append({t: out[r] for t, r in rids.items()})
        graphs = eng.manager.jit_cache_stats()["per_kernel"]
        assert (graphs.get(eng._steps.decode_name, 0) > 0) == jit
    assert outs[0] == outs[1] == ref


@pytest.fixture(scope="module")
def fused_ref():
    """``test_multi_engine_fused_decode_matches_solo`` on the reference."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, CFG_J.vocab, 10, np.int32) for _ in range(2)]
    mgr = SJ.make_shared_manager(2, max_batch=4)
    engines = [SJ.ServeEngine(CFG_J, max_batch=4, max_len=64, manager=mgr)
               for _ in range(2)]
    rids = []
    for i, (eng, prompt) in enumerate(zip(engines, prompts)):
        eng.register_tenant(f"t{i}", 2)
        rids.append(eng.submit(f"t{i}", prompt))
    outs = SJ.serve_engines(engines, max_new_tokens=5)
    return prompts, [outs[i][rids[i]] for i in range(2)]


@JIT
def test_multi_engine_fused_decode_matches_solo(params, fused_ref, jit):
    """Mirror of the reference test: two engines on one manager fuse each
    lockstep into ONE device step (width 2), and each engine's
    generations equal its solo run's and the reference's.  Compiled, the
    fused decode is one graph."""
    prompts, ref = fused_ref
    tokens = 5
    solo = []
    for i, prompt in enumerate(prompts):
        eng = _engine(params, jit)
        eng.register_tenant(f"t{i}", 2)
        rid = eng.submit(f"t{i}", prompt)
        solo.append(eng.run(max_new_tokens=tokens)[rid])
    mgr = ST.make_shared_manager(2, max_batch=4, device="cpu",
                                 jit_trusted=jit)
    engines = [ST.ServeEngine(CFG_T, max_batch=4, max_len=64, manager=mgr,
                              params=params, device="cpu")
               for _ in range(2)]
    rids = []
    for i, (eng, prompt) in enumerate(zip(engines, prompts)):
        eng.register_tenant(f"t{i}", 2)
        rids.append(eng.submit(f"t{i}", prompt))
    outs = ST.serve_engines(engines, max_new_tokens=tokens)
    for i in range(2):
        assert outs[i][rids[i]] == solo[i] == ref[i], f"engine {i}"
    st = mgr.scheduler.stats
    assert engines[0]._steps.decode_name == engines[1]._steps.decode_name
    if not jit:
        # trusted steps fuse only when compiled: the eager fallback
        # dispatches each engine's step alone
        assert (st.fused_steps, st.single_steps) == (0, 2 * (1 + tokens))
        return
    assert st.fused_steps == 1 + tokens
    assert st.mean_batch_width == 2.0
    assert st.single_steps == 0
    if jit:
        # one fused graph for the prefill, one for every decode
        stats = mgr.jit_cache_stats()
        assert (stats["fused_entries"], stats["graphs"]) == (2, 2), stats


@JIT
def test_multi_engine_quarantine_stays_scoped(params, jit):
    """Mirror of the reference test: quarantining a tenant of one
    co-hosted engine drops only that engine's requests."""
    rng = np.random.default_rng(7)
    mgr = ST.make_shared_manager(2, max_batch=4, device="cpu",
                                 jit_trusted=jit)
    engines = [ST.ServeEngine(CFG_T, max_batch=4, max_len=64, manager=mgr,
                              params=params, device="cpu")
               for _ in range(2)]
    rids = []
    for i, eng in enumerate(engines):
        eng.register_tenant(f"t{i}", 2)
        rids.append(eng.submit(f"t{i}",
                               rng.integers(0, CFG_T.vocab, 8, np.int32)))
    assert engines[0].quarantine_tenant("t0", reason="abuse") == [rids[0]]
    outs = ST.serve_engines(engines, max_new_tokens=3)
    assert outs[0] == {}
    assert rids[1] in outs[1] and len(outs[1][rids[1]]) == 3


@pytest.fixture(scope="module")
def resize_ref():
    """``test_serve_pool_resizes_with_tenant`` on the reference."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, CFG_J.vocab, 10, np.int32) for _ in range(3)]
    eng = SJ.ServeEngine(CFG_J, max_batch=8, max_len=64)
    eng.register_tenant("a", 2)
    eng.register_tenant("b", 2)
    rids = [eng.submit("a", p) for p in prompts]
    out = eng.run(max_new_tokens=4)
    return prompts, [out[r] for r in rids], eng.manager.bounds.lookup("a")


@JIT
def test_serve_pool_resizes_with_tenant(params, resize_ref, jit):
    """Mirror of the reference test: a tenant out of KV slots grows at
    submit time through the elastic plane (the relocation step moves its
    slots when the extent relocates), and its generations equal a tenant
    sized big enough up front — and the reference's."""
    prompts, ref, ref_part = resize_ref

    def run(initial):
        eng = _engine(params, jit, max_batch=8)
        eng.register_tenant("a", initial)
        eng.register_tenant("b", 2)
        rids = [eng.submit("a", p) for p in prompts]
        out = eng.run(max_new_tokens=4)
        return [out[r] for r in rids], eng

    small, eng = run(2)
    big, _ = run(4)
    assert small == big == ref
    part = eng.manager.bounds.lookup("a")
    assert (part.base, part.size) == (ref_part.base, ref_part.size) \
        and part.size == 4
    assert any(e.startswith("grow a") for e in eng.manager.elastic.events)


@JIT
def test_relocation_moves_a_tenants_slots(params, jit):
    """A grow that relocates dispatches the pool relocation step: the
    tenant's KV bytes arrive at its new extent, its old slots are zeroed,
    and its pending request re-addresses."""
    eng = _engine(params, jit, max_batch=8)
    eng.register_tenant("a", 2)
    eng.register_tenant("b", 2)
    eng.submit("a", _prompts(1)[0])
    eng.run(max_new_tokens=2)
    old = eng.manager.bounds.lookup("a")
    kv = eng.cache.k[:, old.base:old.end].clone()
    assert (kv != 0).any()
    # two requests fill the extent, the third grows it: b holds the buddy
    pending = [eng.submit("a", p) for p in _prompts(3, salt=1)]
    new = eng.manager.bounds.lookup("a")
    assert new.base != old.base and new.size == 4
    assert eng.manager.elastic.stats["relocations"] == 1
    assert_same(eng.cache.k[:, new.base:new.base + old.size], kv)
    assert (eng.cache.k[:, old.base:old.end] == 0).all()
    slots = [r.slot for r in eng._requests if r.rid in pending]
    assert all(new.base <= s < new.end for s in slots)


@JIT
def test_eviction_scrubs_the_tenants_slots(params, jit):
    """Evicting a tenant zeroes its slab slots (the KV-leak barrier) and
    leaves its co-tenant's as they were."""
    eng = _engine(params, jit)
    for t in ("a", "b"):
        eng.register_tenant(t, 2)
        eng.submit(t, [5, 6, 7, 8])
    eng.run(max_new_tokens=3)
    pa, pb = (eng.manager.bounds.lookup(t) for t in ("a", "b"))
    k = eng._pool.buf["k"]
    assert k[:, pa.base:pa.end].abs().sum() > 0
    kept = k[:, pb.base:pb.end].clone()
    eng.quarantine_tenant("a", reason="test")
    eng.evict_tenant("a")
    assert k[:, pa.base:pa.end].abs().sum() == 0
    assert torch.equal(k[:, pb.base:pb.end], kept)


def _forged_check_run(SV, eng, policy):
    eng.register_tenant("c", 2, policy=policy)
    eng.register_tenant("d", 2)
    rid = eng.submit("c", _prompts(1)[0])
    req = [r for r in eng._requests if r.rid == rid][0]
    req.slot = eng.manager.bounds.lookup("d").base
    out = eng.run(max_new_tokens=3)
    row = eng.manager.violog.row_of("c")
    return out, np_of(eng.manager.violog.buf[row]).tolist()


def test_check_rows_attribute_forged_slots(params):
    """A CHECK tenant's row whose slot left its partition counts one
    GATHER violation per step into the ViolationLog, as the reference's
    ``_attribute`` does: the same counts and tokens as the reference."""
    ref = _forged_check_run(SJ, SJ.ServeEngine(CFG_J, max_batch=4,
                                               max_len=64), PJ.CHECK)
    got = _forged_check_run(ST, _engine(params), PT.CHECK)
    assert got == ref
    assert got[1][0] == 4                      # the prefill + 3 decodes


@pytest.fixture(scope="module")
def lockstep_ref():
    """``test_continuous_matches_lockstep_same_arrival`` on the reference."""
    lock = SJ.ServeEngine(CFG_J, max_batch=4, max_len=64, seed=0)
    lock.register_tenant("t", 4)
    rids = [lock.submit("t", p) for p in _prompts(4)]
    out = SJ.serve_engines([lock], max_new_tokens=5)[0]
    return [out[r] for r in rids]


@JIT
def test_continuous_matches_lockstep_same_arrival(params, lockstep_ref, jit):
    """Mirror of the reference test: the continuous driver on a paged
    engine and the lockstep slab driver emit identical tokens per request
    (and the reference's), with no relocation step."""
    prompts, budget = _prompts(4), 5
    lock = _engine(params, jit)
    lock.register_tenant("t", 4)
    lock_rids = [lock.submit("t", p) for p in prompts]
    lock_out = ST.serve_engines([lock], max_new_tokens=budget)[0]
    mgr = ST.make_shared_manager(1, max_batch=4, paged=True, max_len=64,
                                 device="cpu", jit_trusted=jit)
    cont = ST.ServeEngine(CFG_T, max_batch=4, max_len=64, manager=mgr,
                          paged=True, params=params, device="cpu")
    cont.register_tenant("t", 4)
    cont_rids = [cont.submit("t", p, max_new=budget) for p in prompts]
    cont_out = ST.serve_continuous([cont], max_new_tokens=budget)[0]
    got = [lock_out[r] for r in lock_rids]
    assert got == [cont_out[r] for r in cont_rids] == lockstep_ref
    assert cont.manager.elastic.stats["reloc_steps"] == 0


def test_lockstep_spans_reconcile_and_complete(params):
    """Mirror of ``tests/test_spans.py``'s lockstep test: the slab
    lockstep driver ticks the span API; overflow requests ride hold /
    queue across waves and still reconcile."""
    from repro_torch.core.telemetry import SPAN_PHASES

    mgr = ST.make_shared_manager(2, max_batch=2, device="cpu")
    eng = ST.ServeEngine(CFG_T, max_batch=2, max_len=16, seed=0,
                         manager=mgr, params=params, device="cpu")
    eng.register_tenant("t", 4)
    rids = [eng.submit("t", p) for p in _prompts(3)]
    out: dict = {}
    for _ in range(3):
        out.update(ST.serve_engines([eng], max_new_tokens=3)[0])
        if len(out) == len(rids):
            break
    assert sorted(out) == sorted(rids)
    tel = eng.manager.telemetry
    assert tel.spans.open_count() == 0
    for sp in tel.spans.closed:
        assert sp.outcome == "complete"
        comps = sp.components()
        assert set(comps) == set(SPAN_PHASES)
        assert sum(comps.values()) == sp.e2e_cycles, sp.to_dict()
    assert tel.spans.totals == {"complete": 3}
    assert [sp for sp in tel.spans.closed if sp.slack_cycles() > 0]


#: ``benchmarks/serve_continuous.py``'s quick trace: B = 4, a 10-token
#: straggler at the head of each wave of 4, the rest 3 tokens
QUICK_B = 4
QUICK_BUDGETS = [10, 3, 3, 3, 10, 3, 3, 3]


def _count_drains(mgr):
    count = [0]
    orig = mgr.run_queued

    def counted(*a, **kw):
        count[0] += 1
        return orig(*a, **kw)

    mgr.run_queued = counted
    return count


def _independent(SV, make):
    """One request at a time on one reused slab engine."""
    eng = make(2)
    eng.register_tenant("solo", 2)
    cycles = _count_drains(eng.manager)
    outs = []
    for p, b in zip(_prompts(len(QUICK_BUDGETS)), QUICK_BUDGETS):
        rid = eng.submit("solo", p)
        outs.append(eng.run(max_new_tokens=b)[rid])
    return cycles[0], outs


def _lockstep(SV, make):
    """serve_engines waves: each wave's budget is its longest request's."""
    eng = make(QUICK_B)
    eng.register_tenant("t", QUICK_B)
    cycles = _count_drains(eng.manager)
    prompts, outs, order = _prompts(len(QUICK_BUDGETS)), {}, []
    for w0 in range(0, len(prompts), QUICK_B):
        wave = list(range(w0, min(w0 + QUICK_B, len(prompts))))
        order += [eng.submit("t", prompts[i]) for i in wave]
        outs.update(SV.serve_engines(
            [eng], max_new_tokens=max(QUICK_BUDGETS[i] for i in wave))[0])
    return cycles[0], [outs[r][:b] for r, b in zip(order, QUICK_BUDGETS)]


@pytest.fixture(scope="module")
def quick_ref():
    def make(b):
        return SJ.ServeEngine(CFG_J, max_batch=b, max_len=64, seed=0)
    return _independent(SJ, make), _lockstep(SJ, make)


def test_quick_trace_lockstep_and_independent_cycles(params, quick_ref):
    """The lockstep and independent legs of the quick trace take the
    reference's drain cycles — 22 and 46 (the continuous leg's 13 is held
    by tests/test_torch_continuous.py) — and every request the
    reference's tokens, equal in both drivers."""
    def make(b):
        return ST.ServeEngine(CFG_T, max_batch=b, max_len=64, params=params,
                              device="cpu")
    ind, lock = _independent(ST, make), _lockstep(ST, make)
    (ind_ref, lock_ref) = quick_ref
    assert (ind[0], lock[0]) == (ind_ref[0], lock_ref[0]) == (46, 22)
    assert ind[1] == ind_ref[1]
    assert lock[1] == lock_ref[1] == ind[1]


@pytest.fixture(scope="module")
def moe_slab_ref():
    mgr = SJ.make_shared_manager(1, max_batch=4)
    eng = SJ.ServeEngine(MOE_J, max_batch=4, max_len=64, manager=mgr)
    for t in range(2):
        eng.register_tenant(f"t{t}", 2)
    rids = [eng.submit(f"t{i % 2}", p)
            for i, p in enumerate(_prompts(3, plen=5, salt=2))]
    out = SJ.serve_engines([eng], max_new_tokens=4)[0]
    st = mgr.scheduler.stats
    return (params_np(eng.params), [out[r] for r in rids],
            (eng.decode_steps, int(st.total_launches)))


@JIT
def test_moe_slab_serve_matches_reference(moe_slab_ref, jit):
    """Reduced qwen3-moe through the slab lockstep driver on the
    reference's weights: the same tokens per request, decode steps and
    scheduler launches."""
    pj, ref, ref_counts = moe_slab_ref
    mgr = ST.make_shared_manager(1, max_batch=4, device="cpu",
                                 jit_trusted=jit)
    eng = ST.ServeEngine(MOE_T, max_batch=4, max_len=64, manager=mgr,
                         params=params_from_jax(pj, device="cpu"),
                         device="cpu")
    for t in range(2):
        eng.register_tenant(f"t{t}", 2)
    rids = [eng.submit(f"t{i % 2}", p)
            for i, p in enumerate(_prompts(3, plen=5, salt=2))]
    out = ST.serve_engines([eng], max_new_tokens=4)[0]
    assert [out[r] for r in rids] == ref
    assert (eng.decode_steps,
            int(mgr.scheduler.stats.total_launches)) == ref_counts

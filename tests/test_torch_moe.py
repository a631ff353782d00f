"""The port's MoE family against the JAX reference: the fenced expert
histogram (K5's plain version) against ``repro.kernels.ref`` and the Pallas
kernel, the K5-based capacity dispatch against the reference's float
cumsum ranks (capacity binding, router ties), MoE prefill + decode under
every fence policy, the weight converter on the MoE tree, continuous
serving of the reduced qwen3-moe in both packages, and the port's mirror of
``tests/test_serve_families.py``."""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import TOL_F32, TOL_MODEL, assert_close, assert_same, \
    np_of, params_np, t_of  # noqa: E402
from repro.configs import get_config, list_archs  # noqa: E402
from repro.configs.base import MoEConfig as MoEJ  # noqa: E402
from repro.core.fence import FenceParams as FPJ, FencePolicy as PJ, \
    magic_row  # noqa: E402
from repro.kernels import ops, ref as R  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro.models import kvcache as KVJ, moe as MJ  # noqa: E402
from repro.models.guard import GuardSpec as GSJ, fence as fence_j  # noqa
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.configs.base import MoEConfig as MoET  # noqa: E402
from repro_torch.core.fence import FenceParams as FPT, \
    FencePolicy as PT  # noqa: E402
from repro_torch.kernels import _build, moe_histogram  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.models import get_model as get_model_t  # noqa: E402
from repro_torch.models import kvcache as KVT, moe as MT  # noqa: E402
from repro_torch.models.api import UNPORTED  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.guard import GuardSpec as GST  # noqa: E402

CFG_J = get_config("qwen3-moe-30b-a3b").reduced()
CFG_T = get_config_t("qwen3-moe-30b-a3b").reduced()


# ---------------------------------------------------------------------------
# K5: the fenced expert histogram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,K,E", [(1, 1, 4), (17, 2, 8), (300, 8, 32),
                                   (64, 4, 16), (512, 8, 128)])
def test_moe_histogram_plain_matches_reference_and_pallas(T, K, E):
    """The sweep of ``tests/test_kernels.py`` (plus qwen3's prefill shape):
    ids in [0, 2E) under the half-extent fence ``(0, E/2 - 1)``; counts
    equal the reference oracle's and the Pallas kernel's (interpret mode)
    exactly, and sum to T*K."""
    rng = np.random.default_rng(T * K + E)
    ids = rng.integers(0, 2 * E, size=(T, K)).astype(np.int32)
    mask = E // 2 - 1
    got = moe_histogram(t_of(ids), E, 0, mask)
    assert got.dtype == torch.int32
    assert_same(got, R.moe_histogram_ref(jnp.asarray(ids), E, 0, mask))
    assert_same(got, ops.moe_histogram(jnp.asarray(ids), E, 0, mask))
    assert int(got.sum()) == T * K


@pytest.mark.parametrize("T,K,E", [(17, 2, 8), (300, 8, 32)])
def test_moe_histogram_drops_ids_outside_the_experts(T, K, E):
    """Under the identity fence, negative ids and ids at or past E are
    dropped, as the Pallas kernel's one-hot against iota(E) drops them.
    The reference oracle's scatter-add wraps ids in [-E, 0) NumPy-style
    instead (a divergence no serve-path fence reaches: the expert fence's
    mask is non-negative); ids below -E it drops too."""
    rng = np.random.default_rng(T + E)
    ids = rng.integers(-3 * E, 3 * E, size=(T, K)).astype(np.int32)
    got = moe_histogram(t_of(ids), E, 0, -1)
    want = np.bincount(ids[(ids >= 0) & (ids < E)], minlength=E)
    assert_same(got, want)
    assert_same(got, ops.moe_histogram(jnp.asarray(ids), E, 0, -1))
    wrapped = ids[(ids >= -E) & (ids < 0)] + E
    assert_same(np_of(got) + np.bincount(wrapped, minlength=E),
                R.moe_histogram_ref(jnp.asarray(ids), E, 0, -1))


@pytest.mark.parametrize("E", [8, 128])
def test_moe_histogram_fence_past_the_experts_counts_nothing(E):
    """A fence whose base is E pins every id into [E, 2E): nothing is
    counted, in the port, the oracle and the Pallas kernel."""
    rng = np.random.default_rng(E)
    ids = rng.integers(-2 * E, 2 * E, size=(64, 8)).astype(np.int32)
    got = moe_histogram(t_of(ids), E, E, E - 1)
    assert not np_of(got).any()
    assert_same(got, R.moe_histogram_ref(jnp.asarray(ids), E, E, E - 1))
    assert_same(got, ops.moe_histogram(jnp.asarray(ids), E, E, E - 1))


@pytest.mark.parametrize("T", [8, 512, 1025, 2048, 8192])
@pytest.mark.parametrize("fence", ["serve", "identity", "past"])
def test_moe_histogram_cluster_split_sums_to_the_histogram(T, fence):
    """K5's one launch: one CTA up to 8,192 ids (every serve-path call:
    decode (8, 8), prefill (512, 8)), then a cluster of up to 8 CTAs, rank
    r taking ids i with (i // 1024) % ranks == r.  The ranks' histograms,
    summed in rank order as rank 0 sums them, equal the plain version and
    the Pallas kernel (interpret mode) exactly, under the serve, identity
    and past-the-experts fences, forged ids included."""
    K5 = importlib.import_module("repro_torch.kernels.moe_histogram")
    E, K = 128, 8
    base, mask = {"serve": (0, E - 1), "identity": (0, -1),
                  "past": (E, E - 1)}[fence]
    rng = np.random.default_rng(T)
    ids = rng.integers(-2 * E, 4 * E, size=(T, K)).astype(np.int32)
    n = ids.size
    ranks = K5.cluster_ctas(n)
    assert ranks == min(8, max(1, -(-n // 8192)))
    owner = (np.arange(n) // K5.THREADS) % ranks
    split = sum(np_of(moe_histogram(t_of(ids.reshape(-1)[owner == r])[:, None],
                                    E, base, mask)) for r in range(ranks))
    got = moe_histogram(t_of(ids), E, base, mask)
    assert_same(got, split)
    assert_same(got, ops.moe_histogram(jnp.asarray(ids), E, base, mask))


def test_moe_histogram_wrapper_takes_plain_version_only_on_cpu():
    """A CPU tensor takes the plain version and counts a plain call, not
    a launch; an unsupported device raises."""
    kern = _build.KERNELS["moe_histogram"]
    launches, plain = kern.launches, kern.plain_calls
    moe_histogram(torch.zeros((4, 2), dtype=torch.int32), 4, 0, 3)
    assert (kern.launches, kern.plain_calls) == (launches, plain + 1)
    with pytest.raises(ValueError, match="unsupported device"):
        moe_histogram(torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                      4, 0, 3)


# ---------------------------------------------------------------------------
# moe_apply and its dispatch against the reference (float32)
# ---------------------------------------------------------------------------

def _moe_params(cfg_j, seed, router_scale=None, zero_router=False):
    p = jax.tree.map(np.asarray, MJ.moe_init(jax.random.PRNGKey(seed),
                                             cfg_j))
    p = {k: np.array(v) for k, v in p.items()}
    if router_scale is not None:
        p["router"][:, :2] *= router_scale
    if zero_router:
        p["router"][:] = 0.0
    return p, {k: t_of(v) for k, v in p.items()}


def _expert_guards(E):
    e = 1 << (E - 1).bit_length()
    return (GSJ(policy=PJ.BITWISE, expert=FPJ(0, e)),
            GST(policy=PT.BITWISE, expert=FPT(0, e)))


def _reference_routing(cfg, p, xf, guard, capacity_factor=2.0):
    """``repro/models/moe.py:95-135`` inline: the reference's fenced ids,
    float-cumsum ranks, keep mask and scatter destinations."""
    m = cfg.moe
    T, E, K = xf.shape[0], m.num_experts, m.top_k
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(p["router"]), -1)
    _, ids = jax.lax.top_k(probs, K)
    ids = fence_j(guard, "expert", ids.astype(jnp.int32))
    capacity = max(int(capacity_factor * K * T / E), 8)
    onehot = jax.nn.one_hot(ids, E, dtype=jnp.float32)
    pos_in_e = (jnp.cumsum(onehot.reshape(T * K, E), axis=0) - 1.0
                ).reshape(T, K, E)
    pos = jnp.sum(pos_in_e * onehot, axis=-1).astype(jnp.int32)
    keep = pos < capacity
    dest = (ids * capacity + jnp.minimum(pos, capacity - 1)).reshape(T * K)
    dest = jnp.where(keep.reshape(T * K), dest, E * capacity)
    return ids, pos, keep, dest, capacity


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("case", ["reduced", "capacity_binds", "ties"])
def test_moe_apply_matches_reference(case):
    """Routing, dispatch and output against ``repro.models.moe.moe_apply``:

    * reduced — qwen3's reduced config (4 experts top-2, where C >= T and
      nothing can drop);
    * capacity_binds — 16 experts top-2 whose router's first two columns
      are scaled by 30, so experts 0 and 1 are picked far past their
      capacity: some rank reaches C and is dropped;
    * ties — a zero router: every probability ties, and the ids must be
      JAX's (the lower index first).

    Ranks, keep masks, fenced ids and scatter destinations are equal
    exactly; the output within 1e-5 and the aux loss within 1e-6."""
    cfg_j, cfg_t = CFG_J, CFG_T
    if case == "capacity_binds":
        cfg_j = dataclasses.replace(CFG_J, moe=MoEJ(16, 2, 32))
        cfg_t = dataclasses.replace(CFG_T, moe=MoET(16, 2, 32))
    pj, pt = _moe_params(cfg_j, 3, router_scale=(
        30.0 if case == "capacity_binds" else None),
        zero_router=case == "ties")
    x = _x((4, 16, cfg_j.d_model), 5)
    gj, gt = _expert_guards(cfg_j.moe.num_experts)

    ids, pos, keep, dest, cap = _reference_routing(
        cfg_j, pj, x.reshape(-1, cfg_j.d_model), gj)
    r = MT.route(cfg_t, pt, t_of(x).reshape(-1, cfg_t.d_model), gt)
    assert r.capacity == cap
    assert_same(r.experts, ids)
    assert_same(r.pos, pos)
    assert_same(r.keep, keep)
    assert_same(MT.dispatch_dest(r), dest)
    assert_same(r.counts, np.bincount(np.asarray(ids).reshape(-1),
                                      minlength=cfg_j.moe.num_experts))
    if case == "capacity_binds":
        assert (np.asarray(pos) >= cap).any()
        assert not np.asarray(keep).all()
    if case == "ties":
        K = cfg_j.moe.top_k
        assert_same(r.experts, np.tile(np.arange(K), (x.shape[0] * 16, 1)))

    out_j, aux_j = MJ.moe_apply(cfg_j, jax.tree.map(jnp.asarray, pj),
                                jnp.asarray(x), gj)
    out_t, aux_t = MT.moe_apply(cfg_t, pt, t_of(x), gt)
    assert_close(out_t, out_j, TOL_F32)
    assert abs(float(aux_t) - float(aux_j)) <= 1e-6


# ---------------------------------------------------------------------------
# The model: prefill + decode, weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    params = get_model_j(CFG_J).init(jax.random.PRNGKey(0))
    return params, params_from_jax(params_np(params), device="cpu")


def _guards(policy):
    """Two serving rows in two tenants' virtual extents ([4, 8), [8, 12))
    over a 16-page pool, vocab fenced at 256, experts at 4."""
    base, size = np.array([4, 8], np.int32), np.array([4, 4], np.int32)
    magic = np.array([magic_row(4)] * 2, np.uint32).view(np.int32)
    pmap = np.zeros((16,), np.int32)
    pmap[4:8] = [1, 2, 3, 4]
    pmap[8:12] = [5, 6, 7, 8]
    cols = (base, size, magic[:, 0], magic[:, 1])
    gj = GSJ(policy=PJ(policy), vocab=FPJ(0, 256),
             kv=FPJ(*(jnp.asarray(c) for c in cols)), expert=FPJ(0, 4),
             page=FPJ(0, 16), page_map=jnp.asarray(pmap))
    gt = GST(policy=PT(policy), vocab=FPT(0, 256),
             kv=FPT(*(t_of(c) for c in cols)), expert=FPT(0, 4),
             page=FPT(0, 16), page_map=t_of(pmap))
    return gj, gt


@pytest.mark.parametrize("policy", ["bitwise", "modulo", "check"])
def test_moe_prefill_and_decode_match_reference(weights, policy):
    """Prefill logits and 6 decode steps within 1e-4, greedy ids equal,
    the pool equal at every written page but the garbage page 0; row 0's
    page table is forged with the other tenant's virtual id."""
    pj, pt = weights
    api_j, api_t = get_model_j(CFG_J), get_model_t(CFG_T)
    B, max_len, P = 2, 128, 16
    table = np.array([[4, 9], [8, 9]], np.int32)
    cj = dataclasses.replace(KVJ.init_global_kv_cache(CFG_J, B, max_len, P),
                             page_table=jnp.asarray(table))
    ct = dataclasses.replace(
        KVT.init_global_kv_cache(CFG_T, B, max_len, P, device="cpu"),
        page_table=t_of(table))
    gj, gt = _guards(policy)
    toks = np.random.default_rng(2).integers(0, CFG_J.vocab, size=(B, 7))
    cj, lj = api_j.prefill(pj, cj, {"tokens": jnp.asarray(toks, jnp.int32)},
                           guard=gj)
    ct, lt = api_t.prefill(pt, ct, {"tokens": t_of(toks.astype(np.int32))},
                           guard=gt)
    assert_close(lt, lj, TOL_MODEL)
    nj, nt = jnp.argmax(lj, -1).astype(jnp.int32), lt.argmax(-1).int()
    for _ in range(6):
        assert_same(nt, nj)
        cj, lj = api_j.decode(pj, cj, nj, guard=gj)
        ct, lt = api_t.decode(pt, ct, nt, guard=gt)
        assert_close(lt, lj, TOL_MODEL)
        nj, nt = jnp.argmax(lj, -1).astype(jnp.int32), lt.argmax(-1).int()
    assert_same(nt, nj)
    assert_close(ct.k[:, 1:], np_of(cj.k)[:, 1:], TOL_MODEL)
    assert_close(ct.v[:, 1:], np_of(cj.v)[:, 1:], TOL_MODEL)


def test_params_from_jax_keeps_every_moe_weight_bit(weights):
    """The stacked ``moe`` subtree maps onto per-layer dicts bit for bit;
    in a bfloat16 model the router stays float32."""
    pj, pt = weights
    for l in range(CFG_J.n_layers):
        for name, arr in pj["layers"]["moe"].items():
            assert_same(pt["layers"][l]["moe"][name], np.asarray(arr)[l])
    cfg16 = dataclasses.replace(CFG_J, dtype="bfloat16")
    p16 = get_model_j(cfg16).init(jax.random.PRNGKey(1))
    t16 = params_from_jax(params_np(p16), device="cpu")
    for l in range(cfg16.n_layers):
        moe = t16["layers"][l]["moe"]
        assert moe["router"].dtype == torch.float32
        assert_same(moe["router"], np.asarray(p16["layers"]["moe"]["router"])[l])
        for name in ("wg", "wu", "wd"):
            assert moe[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                moe[name].view(torch.int16).numpy(),
                np.asarray(p16["layers"]["moe"][name])[l].view(np.int16))


def test_moe_init_shapes_and_dtypes():
    """The port's own init: router float32 (d, E), the expert bank in the
    config's dtype, one dict per layer."""
    cfg = dataclasses.replace(CFG_T, dtype="bfloat16")
    p = get_model_t(cfg).init(torch.Generator().manual_seed(0), "cpu")
    m = cfg.moe
    assert len(p["layers"]) == cfg.n_layers
    moe = p["layers"][0]["moe"]
    assert moe["router"].shape == (cfg.d_model, m.num_experts)
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].shape == moe["wu"].shape == (
        m.num_experts, cfg.d_model, m.d_ff_expert)
    assert moe["wd"].shape == (m.num_experts, m.d_ff_expert, cfg.d_model)
    assert {moe[k].dtype for k in ("wg", "wu", "wd")} == {torch.bfloat16}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _counts(mgr, eng):
    stats = mgr.scheduler.stats.summary()
    return {"cycles": mgr.telemetry.registry.counter("drain_cycles"),
            "decodes": eng.decode_steps,
            "prefills": int(stats["total_launches"]) - eng.decode_steps}


@pytest.mark.parametrize("experts", [None, 16])
def test_moe_serve_continuous_matches_reference(experts, monkeypatch):
    """Reduced qwen3-moe through ``serve_continuous`` in both packages on
    the same weights: 3 tenants, 6 requests of mixed lengths and budgets
    arriving over 3 cycles, 3 rows — the same tokens per request and the
    same drain, prefill and decode counts.  With 16 experts top-2 the
    capacity binds in every prefill (the parked rows' identical tokens
    overflow their experts), so the drop path runs end to end."""
    prompts = [[(5 * i + 3 * j) % 199 + 1 for j in range(3 + i % 4)]
               for i in range(6)]
    cfg_j, cfg_t = CFG_J, CFG_T
    if experts:
        cfg_j = dataclasses.replace(CFG_J, moe=MoEJ(experts, 2, 32))
        cfg_t = dataclasses.replace(CFG_T, moe=MoET(experts, 2, 32))
    dropped = []
    route = MT.route

    def counted_route(*a, **kw):
        r = route(*a, **kw)
        dropped.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(MT, "route", counted_route)
    results = []
    for pk, SV, cfg, kw in (("jax", SJ, cfg_j, {}),
                            ("torch", ST, cfg_t, {"device": "cpu"})):
        mgr = SV.make_shared_manager(1, max_batch=4, max_len=64, paged=True,
                                     **kw)
        extra = {} if pk == "jax" else {
            "params": params_from_jax(params_np(jax_params), device="cpu")}
        eng = SV.ServeEngine(cfg, max_batch=4, max_len=64, manager=mgr,
                             paged=True, max_inflight=3, **kw, **extra)
        if pk == "jax":
            jax_params = eng.params
        for t in range(3):
            eng.register_tenant(f"t{t}", 2)
        for i, p in enumerate(prompts):
            eng.submit(f"t{i % 3}", p, max_new=2 + i % 3, arrive=i // 2)
        results.append((SV.serve_continuous([eng], max_new_tokens=4),
                        _counts(mgr, eng)))
    assert len(results[1][0][0]) == len(prompts)
    assert results[1] == results[0]
    assert (sum(dropped) > 0) == bool(experts)


def test_guard_for_rows_carries_the_reference_expert_fence():
    """The port's per-step guard fences expert ids into ``pow2(E)``, as the
    reference's does (a dense model's guard has no expert space)."""
    for arch in ("qwen3-moe-30b-a3b", "grok-1-314b", "stablelm-3b"):
        cj = get_config(arch).reduced()
        ct = get_config_t(arch).reduced()
        ej = SJ.ServeEngine(cj, max_batch=2, max_len=64, paged=True)
        et = ST.ServeEngine(ct, max_batch=2, max_len=64, paged=True,
                            device="cpu")
        for e in (ej, et):
            e.register_tenant("t", 2)
        gj = ej._guard_for_rows([None, None]).expert
        gt = et._guard_for_rows([None, None]).expert
        if cj.moe is None:
            assert gj is None and gt is None
            continue
        assert (gt.base, gt.size) == (gj.base, gj.size)
        assert gt.size == 1 << (cj.moe.num_experts - 1).bit_length()


@pytest.mark.parametrize("arch", list_archs())
def test_family_serves_reduced_or_names_its_gap(arch):
    """The port's mirror of ``tests/test_serve_families.py``: every dense
    and MoE arch serves a request end to end through a reduced paged
    engine, with a request span that reconciles; every other family
    refuses with the gap it names."""
    cfg = get_config_t(arch).reduced()
    if cfg.family not in ("dense", "moe"):
        with pytest.raises(NotImplementedError) as err:
            ST.ServeEngine(cfg, max_batch=2, max_len=64, paged=True,
                           device="cpu")
        assert str(err.value) == UNPORTED[cfg.family]
        return
    eng = ST.ServeEngine(cfg, max_batch=2, max_len=64, paged=True,
                         device="cpu")
    eng.register_tenant("t", 2)
    prompt = np.arange(1, 5, dtype=np.int32) % cfg.vocab
    rid = eng.submit("t", prompt)
    out = eng.run(max_new_tokens=2)
    assert len(out[rid]) == 2
    assert all(0 <= t < cfg.vocab for t in out[rid])
    tel = eng.manager.telemetry
    assert tel.spans.totals == {"complete": 1}
    sp = tel.spans.closed[-1]
    assert sum(sp.components().values()) == sp.e2e_cycles


def test_unported_family_reasons_are_current():
    """Every family the registry holds is served (dense, moe) or named in
    ``UNPORTED`` with its gap, and the table names no family that is gone."""
    families = {get_config_t(a).family for a in list_archs()}
    assert set(UNPORTED) <= families
    assert families - set(UNPORTED) == {"dense", "moe"}

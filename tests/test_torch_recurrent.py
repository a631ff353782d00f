"""The port's recurrent families — zamba2-7b (hybrid) and xlstm-350m (ssm)
— against the JAX reference, at reduced size on the CPU.

* the state pool (``models/kvcache.py`` ``StateCache``): reads and writes
  bit for bit against the reference's whole pool, forged slot ids and
  parked rows sharing the scratch slot included, under BITWISE, MODULO,
  CHECK and row-mixed guards;
* ``models/ssd.py`` (``ssd_chunked`` against the reference's and the
  sequential oracle) and ``models/mamba2.py`` (``block_apply``,
  ``block_step``);
* K1's and K4's plain versions under a sliding window against the
  reference's ``decode_attention`` / ``chunked_attention``;
* prefill + decode of both families on the reference's converted weights
  (mirrors of ``tests/test_models.py``'s decode-matches-forward tests),
  the hybrid with a Mamba tail, and the hybrid's write clamp past the
  slab;
* slab serving: the reference's tokens and drain cycles in lockstep and
  one-request-at-a-time waves, compiled and eager, an eviction's state
  scrub and a relocation of a tenant's state slots.
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
from repro.core.partition import Partition as PartJ  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro.launch import steps as STEPSJ  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro.models import hybrid as HYJ, kvcache as KVJ  # noqa: E402
from repro.models import layers as LJ, mamba2 as M2J  # noqa: E402
from repro.models import ssd as SSDJ, xlstm as XLJ  # noqa: E402
from repro.models.guard import GuardSpec as GSJ  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.fence import FenceTable as FTT, \
    FencePolicy as PT  # noqa: E402
from repro_torch.core.partition import Partition as PartT  # noqa: E402
from repro_torch.kernels import flash_attention, \
    paged_attention  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.launch import steps as STEPST  # noqa: E402
from repro_torch.models import get_model as get_model_t  # noqa: E402
from repro_torch.models import hybrid as HYT, kvcache as KVT  # noqa: E402
from repro_torch.models import mamba2 as M2T, ssd as SSDT  # noqa: E402
from repro_torch.models import xlstm as XLT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.guard import GuardSpec as GST  # noqa: E402

ARCHS = ["zamba2-7b", "xlstm-350m"]
JIT = pytest.mark.parametrize("jit", [True, False],
                              ids=["compiled", "eager"])
POLICIES = pytest.mark.parametrize(
    "policy", ["bitwise", "modulo", "check", "mixed"])
#: the reference's own tolerance in its decode-matches-forward tests
TOL_REF = 3e-4


def _cfgs(arch, **kw):
    cj, ct = get_config(arch).reduced(), get_config_t(arch).reduced()
    if kw:
        cj, ct = dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)
    return cj, ct


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, reference cfg, port cfg, reference params, port params) on
    the reference's seed-0 weights (as every reference engine draws
    them)."""
    cj, ct = _cfgs(request.param)
    pj = params_np(get_model_j(cj).init(jax.random.PRNGKey(0)))
    return request.param, cj, ct, pj, params_from_jax(pj, device="cpu")


# ---------------------------------------------------------------------------
# The state pool
# ---------------------------------------------------------------------------

#: 8 rows over a 16-slot pool: tenants a [4, 8) and b [8, 12), the
#: engine's scratch partition [0, 4); rows 0-3 serve, rows 4-7 park on the
#: scratch base.  Row 1's slot is forged into b's extent, row 2 aliases row
#: 0's slot, row 3's is negative.
B, SLOTS = 8, 16
ROW_TENANT = [0, 0, 1, 0, 2, 2, 2, 2]
PARTS = [(4, 4), (8, 4), (0, 4)]
SLOT_IDS = np.array([4, 9, 8, -3, 0, 0, 0, 0], np.int32)
STATE_SHAPES = {"ssm": (3, 2, 4, 5), "conv": (3, 3, 7)}


def _guards(policy):
    """The same per-row guard in both packages (state space from the fence
    table's rows, magic included)."""
    pj = [PartJ(f"t{i}", b, s) for i, (b, s) in enumerate(PARTS)]
    pt = [PartT(f"t{i}", b, s) for i, (b, s) in enumerate(PARTS)]
    kj = FTJ.from_partitions(pj, with_magic=True).gather(
        jnp.asarray(ROW_TENANT, jnp.int32))
    kt = FTT.from_partitions(pt, with_magic=True, device="cpu").gather(
        torch.tensor(ROW_TENANT, dtype=torch.int32))
    rp_j = rp_t = None
    if policy == "mixed":
        codes = np.array([PJ(p).code for p in
                          ["bitwise", "modulo", "check", "modulo"] * 2],
                         np.int32)
        rp_j, rp_t, policy = jnp.asarray(codes), torch.tensor(codes), \
            "bitwise"
    return (GSJ(policy=PJ(policy), state=kj, row_policy=rp_j),
            GST(policy=PT(policy), state=kt, row_policy=rp_t))


def _state_caches(seed):
    rng = np.random.default_rng(seed)
    pools = {n: rng.normal(size=(s[0], SLOTS, *s[1:])).astype(np.float32)
             for n, s in STATE_SHAPES.items()}
    cj = KVJ.StateCache(pools={n: jnp.asarray(v) for n, v in pools.items()},
                        slot_ids=jnp.asarray(SLOT_IDS),
                        seq_lens=jnp.zeros((B,), jnp.int32))
    ct = KVT.StateCache(pools={n: t_of(v) for n, v in pools.items()},
                        slot_ids=t_of(SLOT_IDS),
                        seq_lens=torch.zeros((B,), dtype=torch.int32))
    return cj, ct


@POLICIES
def test_state_cache_read_and_write_match_reference(policy):
    """Every layer's read, then a write of fresh values at every layer,
    leave the reference's whole pool bit for bit: the parked rows write
    one scratch slot (the last row wins), row 2 aliases row 0, the forged
    and negative ids fence into their tenants' extents."""
    gj, gt = _guards(policy)
    cj, ct = _state_caches(0)
    rng = np.random.default_rng(1)
    for name, shape in STATE_SHAPES.items():
        for layer in range(shape[0]):
            assert_same(ct.read(name, layer, gt), cj.read(name, layer, gj))
            value = rng.normal(size=(B, *shape[1:])).astype(np.float32)
            cj = cj.write(name, layer, jnp.asarray(value), gj)
            assert ct.write(name, layer, t_of(value), gt) is ct
    for name in STATE_SHAPES:
        assert_same(ct.pools[name], cj.pools[name])


# ---------------------------------------------------------------------------
# SSD and the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(16, 4), (37, 8), (64, 64),
                                     (100, 16)])
def test_ssd_chunked_matches_reference(S, chunk):
    """The port's chunked scan against the reference's on the same inputs,
    and against its own sequential oracle (the reference test's
    tolerance)."""
    rng = np.random.default_rng(S)
    Bs, H, P, N = 2, 3, 8, 5
    u, b, c = (rng.normal(size=sh).astype(np.float32)
               for sh in ((Bs, S, H, P), (Bs, S, H, N), (Bs, S, H, N)))
    a = (-np.abs(rng.normal(size=(Bs, S, H))) * 0.2).astype(np.float32)
    h0 = (rng.normal(size=(Bs, H, N, P)) * 0.1).astype(np.float32)
    yj, hj = SSDJ.ssd_chunked(*map(jnp.asarray, (u, a, b, c)),
                              h0=jnp.asarray(h0), chunk=chunk)
    yt, ht = SSDT.ssd_chunked(*map(t_of, (u, a, b, c)), h0=t_of(h0),
                              chunk=chunk)
    assert_close(yt, yj, TOL_F32)
    assert_close(ht, hj, TOL_F32)
    ys, hs = SSDT.ssd_reference(*map(t_of, (u, a, b, c)), h0=t_of(h0))
    assert_close(yt, ys, 2e-4)
    assert_close(ht, hs, 2e-4)


def test_mamba2_block_apply_and_step_match_reference():
    """One reduced zamba2 Mamba2 block on the reference's weights: a
    13-token ``block_apply`` from zero state, another from its final
    states, then three ``block_step`` tokens chained on — outputs, SSM
    states and conv tails within 1e-5 of the reference's."""
    cj, ct = _cfgs("zamba2-7b")
    pj = params_np(M2J.block_init(jax.random.PRNGKey(7), cj))
    pt = params_from_jax({"embed": {}, "norm_f": {}, "layers": {
        k: v[None] for k, v in pj.items()}}, device="cpu")["layers"][0]
    assert M2T.state_shapes(ct) == M2J.state_shapes(cj)
    assert M2T.dims(ct) == M2J.dims(cj)
    rng = np.random.default_rng(8)
    x1, x2 = (rng.normal(size=(2, 13, cj.d_model)).astype(np.float32)
              for _ in range(2))
    apply_j = jax.jit(lambda *a, **kw: M2J.block_apply(cj, *a, **kw))
    step_j = jax.jit(lambda *a: M2J.block_step(cj, *a))
    outj = apply_j(pj, jnp.asarray(x1))
    outt = M2T.block_apply(ct, pt, t_of(x1))
    for a, b in zip(outt, outj):
        assert_close(a, b, TOL_F32)
    outj = apply_j(pj, jnp.asarray(x2), h0=outj[1], conv_tail=outj[2])
    outt = M2T.block_apply(ct, pt, t_of(x2), h0=outt[1], conv_tail=outt[2])
    for a, b in zip(outt, outj):
        assert_close(a, b, TOL_F32)
    hj, tj, ht, tt = outj[1], outj[2], outt[1], outt[2]
    for i in range(3):
        x = rng.normal(size=(2, 1, cj.d_model)).astype(np.float32)
        yj, hj, tj = step_j(pj, jnp.asarray(x), hj, tj)
        yt, ht, tt = M2T.block_step(ct, pt, t_of(x), ht, tt)
        for a, b in ((yt, yj), (ht, hj), (tt, tj)):
            assert_close(a, b, TOL_F32)


# ---------------------------------------------------------------------------
# K1's and K4's plain versions under a window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 1, 8, 32, 100])
def test_k1_plain_version_with_a_window_matches_decode_attention(window):
    """K1's plain version (the CPU side of ``paged_attention``) over a
    paged pool, under a window, against the reference's
    ``decode_attention`` over the gathered history: rows shorter and
    longer than the window, an empty row, a row past its table."""
    rng = np.random.default_rng(window + 11)
    Bk, H, KH, D, P, page, n = 6, 4, 2, 16, 16, 16, 4
    q = rng.normal(size=(Bk, H, D)).astype(np.float32)
    kp, vp = (rng.normal(size=(P, page, KH, D)).astype(np.float32)
              for _ in range(2))
    table = rng.integers(0, P, size=(Bk, n)).astype(np.int32)
    lens = np.array([5, 33, 64, 0, 40, 90], np.int32)
    got = paged_attention(t_of(q), t_of(kp), t_of(vp), t_of(table),
                          t_of(lens), 0, -1, window=window)
    k_h = kp[table].reshape(Bk, n * page, KH, D)
    v_h = vp[table].reshape(Bk, n * page, KH, D)
    want = LJ.decode_attention(jnp.asarray(q[:, None]), jnp.asarray(k_h),
                               jnp.asarray(v_h), jnp.asarray(lens),
                               window=window)
    assert_close(got, np_of(want)[:, 0], TOL_F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 16, 32, 200])
@pytest.mark.parametrize("S", [38, 70])
def test_k4_plain_version_with_a_window_matches_chunked_attention(
        S, window, causal):
    """K4's plain version (the CPU side of ``flash_attention``) under
    ``causal`` and a window, against the reference's
    ``chunked_attention`` masks (GQA, S inside and past the window)."""
    rng = np.random.default_rng(S + window)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = flash_attention(t_of(q), t_of(k), t_of(v), causal=causal,
                          window=window)
    want = LJ.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window)
    assert_close(got, want, TOL_F32)


# ---------------------------------------------------------------------------
# The models: prefill + decode on the reference's weights
# ---------------------------------------------------------------------------

def _modules(arch):
    return (HYJ, HYT) if arch == "zamba2-7b" else (XLJ, XLT)


def _init_caches(arch, cj, ct, batch, max_len):
    aj, at = get_model_j(cj), get_model_t(ct)
    if arch == "xlstm-350m":
        return aj.init_cache(batch), at.init_cache(batch, device="cpu")
    return (aj.init_cache(batch, max_len, dtype=jnp.float32),
            at.init_cache(batch, max_len, dtype=torch.float32, device="cpu"))


def _ref_steps(cj):
    """The reference's prefill and decode, each compiled once (the
    reference serves them jitted too)."""
    aj = get_model_j(cj)
    return jax.jit(aj.prefill), jax.jit(aj.decode)


def _pools(cache):
    """Every pool tensor of a hybrid or state cache, by name."""
    if hasattr(cache, "kv"):
        return {"k": cache.kv.k, "v": cache.kv.v, **_pools(cache.state)}
    return dict(cache.pools)


def test_decode_matches_forward(family):
    """Mirrors of ``test_hybrid_decode_matches_forward`` (B 2, S 40, slab
    64) and ``test_xlstm_decode_matches_forward`` (B 2, S 24) through the
    port's own prefill and decode: the port's forward within 1e-4 of the
    reference's, and each step's logits within 1e-4 of the reference's
    step (the reference holds its own steps to its forward within 3e-4,
    the port is held to that too)."""
    arch, cj, ct, pj, pt = family
    MJ, MT = _modules(arch)
    S = 40 if arch == "zamba2-7b" else 24
    toks = np.random.default_rng(0).integers(0, cj.vocab, (2, S)).astype(
        np.int32)
    full_j = MJ.forward(cj, pj, jnp.asarray(toks))
    full_t = MT.forward(ct, pt, t_of(toks))
    assert_close(full_t, full_j, TOL_MODEL)
    (pre_j, dec_j), at = _ref_steps(cj), get_model_t(ct)
    cache_j, cache_t = _init_caches(arch, cj, ct, 2, 64)
    cache_j, lj = pre_j(pj, cache_j, {"tokens": jnp.asarray(
        toks[:, :S - 2])})
    cache_t, lt = at.prefill(pt, cache_t, {"tokens": t_of(toks[:, :S - 2])})
    assert_close(lt, lj, TOL_MODEL)
    assert_close(lt, full_t[:, S - 3], TOL_REF)
    for t in range(S - 2, S):
        cache_j, lj = dec_j(pj, cache_j, jnp.asarray(toks[:, t]))
        cache_t, lt = at.decode(pt, cache_t, t_of(toks[:, t]))
        assert_close(lt, lj, TOL_MODEL)
        assert_close(lt, full_t[:, t], TOL_REF)
    for name, pool in _pools(cache_t).items():
        assert_close(pool, _pools(cache_j)[name], TOL_MODEL)


def test_hybrid_with_a_mamba_tail_matches_reference():
    """The reduced config has no tail: at 5 layers (2 groups of 2 and a
    1-layer ``mamba_tail``) a 38-token prefill (past the 32-token window)
    and 4 decode steps give the reference's logits, pools and seq lens."""
    cj, ct = _cfgs("zamba2-7b", n_layers=5)
    assert HYT.group_structure(ct) == HYJ.group_structure(cj) == (2, 1)
    pj = params_np(get_model_j(cj).init(jax.random.PRNGKey(2)))
    pt = params_from_jax(pj, device="cpu")
    assert len(pt["mamba"]) == 2 and len(pt["mamba_tail"]) == 1
    (pre_j, dec_j), at = _ref_steps(cj), get_model_t(ct)
    cache_j, cache_t = _init_caches("zamba2-7b", cj, ct, 3, 64)
    toks = np.random.default_rng(3).integers(0, cj.vocab, (3, 42)).astype(
        np.int32)
    cache_j, lj = pre_j(pj, cache_j, {"tokens": jnp.asarray(toks[:, :38])})
    cache_t, lt = at.prefill(pt, cache_t, {"tokens": t_of(toks[:, :38])})
    assert_close(lt, lj, TOL_MODEL)
    for t in range(38, 42):
        cache_j, lj = dec_j(pj, cache_j, jnp.asarray(toks[:, t]))
        cache_t, lt = at.decode(pt, cache_t, t_of(toks[:, t]))
        assert_close(lt, lj, TOL_MODEL)
    for name, pool in _pools(cache_t).items():
        assert_close(pool, _pools(cache_j)[name], TOL_MODEL)
    assert_same(cache_t.kv.seq_lens, cache_j.kv.seq_lens)
    assert_same(cache_t.state.seq_lens, cache_j.state.seq_lens)


def test_hybrid_write_clamp_past_the_slab_matches_reference():
    """The reference's hybrid decode clamps its KV write position to the
    slab's last slot instead of wrapping: a 60-token prompt in a 64-token
    slab decoded 8 steps overwrites slot 63 from the fifth step on, leaves
    slots 0-62 as they were, and gives the reference's logits and pool
    step by step."""
    cj, ct = _cfgs("zamba2-7b")
    pj = params_np(get_model_j(cj).init(jax.random.PRNGKey(4)))
    pt = params_from_jax(pj, device="cpu")
    (pre_j, dec_j), at = _ref_steps(cj), get_model_t(ct)
    cache_j, cache_t = _init_caches("zamba2-7b", cj, ct, 2, 64)
    toks = np.random.default_rng(5).integers(0, cj.vocab, (2, 68)).astype(
        np.int32)
    cache_j, lj = pre_j(pj, cache_j, {"tokens": jnp.asarray(toks[:, :60])})
    cache_t, lt = at.prefill(pt, cache_t, {"tokens": t_of(toks[:, :60])})
    for t in range(60, 68):
        if t == 64:
            held = cache_t.kv.k.clone()
        cache_j, lj = dec_j(pj, cache_j, jnp.asarray(toks[:, t]))
        cache_t, lt = at.decode(pt, cache_t, t_of(toks[:, t]))
        assert_close(lt, lj, TOL_MODEL)
        assert_close(cache_t.kv.k, cache_j.kv.k, TOL_MODEL)
    assert cache_t.kv.max_len == 64
    assert cache_t.kv.seq_lens.tolist() == [68, 68]
    k = cache_t.kv.k.reshape(*cache_t.kv.k.shape[:2], 64, -1)
    k0 = held.reshape(k.shape)
    assert torch.equal(k[:, :2, :63], k0[:, :2, :63])
    assert not torch.equal(k[:, :2, 63], k0[:, :2, 63])


# ---------------------------------------------------------------------------
# Slab serving
# ---------------------------------------------------------------------------

def _prompts(n, plen, salt=0):
    return [[(7 * i + 3 * j + salt) % 211 + 1 for j in range(plen)]
            for i in range(n)]


#: each family's prompt length: the hybrid's passes its 32-token window
PLEN = {"zamba2-7b": 38, "xlstm-350m": 12}
BUDGETS = [6, 3, 3, 6]


def _count_drains(mgr):
    count = [0]
    orig = mgr.run_queued

    def counted(*a, **kw):
        count[0] += 1
        return orig(*a, **kw)

    mgr.run_queued = counted
    return count


def _serve_legs(SV, make, arch):
    """One request at a time on one reused engine, then lockstep waves of
    two requests per tenant on another: (drains, tokens) of each leg."""
    prompts = _prompts(len(BUDGETS), PLEN[arch])
    eng = make()
    eng.register_tenant("solo", 2)
    drains = _count_drains(eng.manager)
    solo = []
    for p, b in zip(prompts, BUDGETS):
        rid = eng.submit("solo", p)
        solo.append(eng.run(max_new_tokens=b)[rid])
    eng = make()
    for t in ("a", "b"):
        eng.register_tenant(t, 2)
    waves = _count_drains(eng.manager)
    lock, order = {}, []
    for w0 in (0, 2):
        order += [eng.submit("ab"[i % 2], prompts[i])
                  for i in range(w0, w0 + 2)]
        lock.update(SV.serve_engines(
            [eng], max_new_tokens=max(BUDGETS[w0:w0 + 2]))[0])
    return (drains[0], solo), (waves[0], [lock[r] for r in order])


@pytest.fixture(scope="module")
def serve_ref(family):
    arch, cj = family[0], family[1]
    return _serve_legs(SJ, lambda: SJ.ServeEngine(cj, max_batch=4,
                                                  max_len=64), arch)


@JIT
def test_slab_serve_matches_reference(family, serve_ref, jit):
    """Reduced zamba2-7b and xlstm-350m on the slab layout, on the
    reference's weights: the reference's tokens and drain cycles one
    request at a time (an engine reused across runs) and in lockstep
    waves of two tenants, compiled and eager."""
    arch, _, ct, _, pt = family

    def make():
        return ST.ServeEngine(ct, max_batch=4, max_len=64, params=pt,
                              jit_steps=jit, device="cpu")
    assert _serve_legs(ST, make, arch) == serve_ref


@JIT
def test_eviction_scrubs_the_tenants_state_slots(family, jit):
    """Evicting a tenant zeroes its slots in every pool of the cache (the
    state pools and, for the hybrid, its KV slabs; the sLSTM stabiliser
    too, as the reference's scrub does) and leaves its co-tenant's as
    they were."""
    arch, _, ct, _, pt = family
    eng = ST.ServeEngine(ct, max_batch=4, max_len=64, params=pt,
                         jit_steps=jit, device="cpu")
    for t in ("a", "b"):
        eng.register_tenant(t, 2)
        eng.submit(t, _prompts(1, PLEN[arch])[0])
    eng.run(max_new_tokens=3)
    pa, pb = (eng.manager.bounds.lookup(t) for t in ("a", "b"))
    pools = _pools(eng.cache)
    assert all(p[:, pa.base:pa.end].abs().sum() > 0 for p in pools.values())
    kept = {n: p[:, pb.base:pb.end].clone() for n, p in pools.items()}
    eng.quarantine_tenant("a", reason="test")
    eng.evict_tenant("a")
    for name, p in _pools(eng.cache).items():
        assert (p[:, pa.base:pa.end] == 0).all(), name
        assert torch.equal(p[:, pb.base:pb.end], kept[name]), name


@JIT
def test_relocation_moves_a_tenants_state_slots(family, jit):
    """A grow that relocates dispatches the pool relocation step over the
    nested pool: the tenant's state (and KV) bytes arrive at its new
    extent, its old slots are zeroed, its pending requests re-address —
    and serving them gives the reference's tokens."""
    arch, cj, ct, _, pt = family

    def run(SV, eng):
        eng.register_tenant("a", 2)
        eng.register_tenant("b", 2)
        eng.submit("a", _prompts(1, PLEN[arch])[0])
        eng.run(max_new_tokens=2)
        old = eng.manager.bounds.lookup("a")
        before = {n: np.array(np_of(p[:, old.base:old.end]))
                  for n, p in _pools(eng.cache).items()}
        pending = [eng.submit("a", p)
                   for p in _prompts(3, PLEN[arch], salt=1)]
        new = eng.manager.bounds.lookup("a")
        assert new.base != old.base and new.size == 4
        after = _pools(eng.cache)
        for name, rows in before.items():
            assert_same(after[name][:, new.base:new.base + old.size], rows)
            assert (np_of(after[name][:, old.base:old.end]) == 0).all()
        out = eng.run(max_new_tokens=3)
        return [out.get(r) for r in pending]

    ref = run(SJ, SJ.ServeEngine(cj, max_batch=8, max_len=64))
    eng = ST.ServeEngine(ct, max_batch=8, max_len=64, params=pt,
                         jit_steps=jit, device="cpu")
    assert run(ST, eng) == ref
    assert eng.manager.elastic.stats["relocations"] == 1


def test_nested_pool_relocation_step_matches_reference():
    """The elastic move over a hybrid pool (``{"kv": {"k", "v"}, "state":
    {"pools": {...}}}``): slots [src, src + size) copied to dst and the
    source zeroed on every leaf, in place, as the reference's."""
    rng = np.random.default_rng(9)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)
    pool = {"kv": {"k": arr(2, 16, 1, 4, 2, 3), "v": arr(2, 16, 1, 4, 2, 3)},
            "state": {"pools": {"ssm": arr(3, 16, 2, 4), "m": arr(3, 16, 2)}}}

    def tree(x, f):
        return {k: tree(v, f) for k, v in x.items()} if isinstance(x, dict) \
            else f(x)

    def leaves(x):
        return [y for k in sorted(x) for y in leaves(x[k])] \
            if isinstance(x, dict) else [x]
    for src, dst, size in ((4, 8, 4), (8, 0, 2), (12, 4, 4)):
        _, pj, _ = STEPSJ.build_pool_relocation_step(src, dst, size)(
            jnp.zeros(4), tree(pool, jnp.asarray))
        live = tree(pool, t_of)
        _, out, _ = STEPST.build_pool_relocation_step(src, dst, size)(
            torch.zeros(4), live)
        for a, b, c in zip(leaves(out), leaves(live), leaves(pj)):
            assert a is b
            assert_same(a, c)


def test_split_and_join_recurse_over_kv_and_state():
    """A hybrid cache splits into ``{"kv": {"k", "v"}, "state": {"pools":
    ...}}`` and a meta with neither, an xLSTM cache into ``{"pools": ...}``
    and a meta with ``pools = {}``, as the reference's; joining gives the
    same tensors back."""
    for arch in ARCHS:
        cj, ct = _cfgs(arch)
        cache_j, cache_t = _init_caches(arch, cj, ct, 2, 64)
        pool_j, meta_j = STEPSJ.split_cache_pool(cache_j)
        pool_t, meta_t = STEPST.split_cache_pool(cache_t)
        assert jax.tree.structure(jax.tree.map(lambda x: 0, pool_j)) == \
            jax.tree.structure(jax.tree.map(
                lambda x: 0, pool_t, is_leaf=lambda x: isinstance(
                    x, torch.Tensor)))
        joined = STEPST.join_cache_pool(pool_t, meta_t)
        for name, p in _pools(joined).items():
            assert p is _pools(cache_t)[name]
        if arch == "zamba2-7b":
            assert meta_t.kv.k is None and meta_t.state.pools == {}
        else:
            assert meta_t.pools == {}

"""The reference's performance variants on the port (mirrors of
``tests/test_perf_variants.py``), against the JAX reference on the same
numpy inputs and converted weights (reduced configs, float32, the CPU):

* the MoE ``einsum`` dispatch (the Mesh-TF one-hot variant): forward, aux
  loss and every gradient against the reference's ``dispatch="einsum"``,
  against the port's scatter dispatch within the reference's H1 bound,
  ``prefill`` / ``decode`` against the reference's, a capacity that binds,
  and a fence that folds two of a token's ids onto one expert;
* the ``dots`` remat policy: bit for bit the ``nothing`` policy's loss and
  gradients, within tolerance of the reference's ``dots``, and its
  backward recomputing no plain product (``aten.mm``) where ``nothing``
  recomputes each;
* the float8 KV pool: the cast against jnp's, the pool bytes after
  prefill and after each decode step equal to the reference's (the
  scratch slot, where parked rows sum, included), the decode logits, the
  H3 mirror (finite, correlated with an f32 pool), and K1's plain version
  on a float8 pool against the oracle and the Pallas kernel in interpret
  mode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_parity import TOL_F32, TOL_MODEL, assert_close, np_of, \
    params_np, t_of  # noqa: E402
from repro.configs import ShapeConfig as ShapeJ, get_config  # noqa: E402
from repro.core.fence import FenceParams as FPJ, \
    FencePolicy as PJ  # noqa: E402
from repro.kernels import ops as OPS, ref as RJ  # noqa: E402
from repro.launch.steps import make_guard as make_guard_j  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro.models import kvcache as KVJ, moe as MOEJ  # noqa: E402
from repro.models.guard import GuardSpec as GSJ  # noqa: E402
from repro_torch.configs import ShapeConfig, \
    get_config as get_config_t  # noqa: E402
from repro_torch.core.fence import FenceParams as FPT, \
    FencePolicy as PT  # noqa: E402
from repro_torch.core.stepgraph import tree_flatten, \
    tree_unflatten  # noqa: E402
from repro_torch.kernels import paged_attention, scatter_pages  # noqa: E402
from repro_torch.kernels import ref as RT  # noqa: E402
from repro_torch.launch.steps import make_guard  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import kvcache as KVT, moe as MOET  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.guard import GuardSpec as GST  # noqa: E402

GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
#: the reference's H1 bound between its two dispatches
H1_TOL = 5e-5
FP8_J, FP8_T = jnp.float8_e4m3fn, torch.float8_e4m3fn


# --------------------------------------------------------------------- #
# MoE: the einsum dispatch and the dots policy                          #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def moe():
    """Reduced qwen3-moe (4 experts top-2, capacity never binds) and the
    same at 16 experts (capacity 16 over 2 x 32 tokens: it binds): per
    name, both configs, the reference's params, the port's copy and a
    (2, 33) token batch."""
    out = {}
    base_j = get_config("qwen3-moe-30b-a3b").reduced()
    base_t = get_config_t("qwen3-moe-30b-a3b").reduced()
    for name, e in (("e4", 4), ("e16", 16)):
        cj = dataclasses.replace(base_j, moe=dataclasses.replace(
            base_j.moe, num_experts=e))
        ct = dataclasses.replace(base_t, moe=dataclasses.replace(
            base_t.moe, num_experts=e))
        pj = jax.jit(get_model_j(cj).init)(jax.random.PRNGKey(0))
        toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 33),
                                             0, cj.vocab)).astype(np.int32)
        out[name] = (cj, ct, pj, params_from_jax(params_np(pj), "cpu"),
                     toks)
    return out


def _ref_loss_grads(cfg, params, toks, guard=None, **kw):
    fn = jax.jit(jax.value_and_grad(lambda p, t: MOEJ.loss_fn(
        cfg, p, {"tokens": t}, guard=guard, **kw)))
    loss, grads = fn(params, jnp.asarray(toks))
    return float(loss), tree_flatten(params_from_jax(params_np(grads),
                                                     "cpu"))[1]


def _port_loss_grads(cfg, params, toks, guard=None, **kw):
    struct, leaves = tree_flatten(params)
    req = [p.detach().clone().requires_grad_() for p in leaves]
    loss = MOET.loss_fn(cfg, tree_unflatten(struct, req),
                        {"tokens": t_of(toks)}, guard=guard, **kw)
    return loss.detach(), torch.autograd.grad(loss, req)


def _assert_leaves(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", ["e4", "e16"])
def test_einsum_dispatch_matches_reference(moe, name):
    """``dispatch="einsum"``: logits and aux loss within 1e-5 of the
    reference's einsum dispatch, the loss within 1e-5 and every gradient
    within atol 1e-5 / rtol 1e-4 under the train guard."""
    cj, ct, pj, pt, toks = moe[name]
    lj, aj = jax.jit(lambda p, t: MOEJ.forward(cj, p, t, dispatch="einsum"))(
        pj, jnp.asarray(toks[:, :-1]))
    with torch.no_grad():
        lt, at = MOET.forward(ct, pt, t_of(toks[:, :-1]), dispatch="einsum")
    assert_close(lt, lj, TOL_F32)
    assert abs(float(at) - float(aj)) < 1e-6
    gj = make_guard_j(cj, ShapeJ("t", "train", 32, 2))
    gt = make_guard(ct, ShapeConfig("t", "train", 32, 2))
    loss_j, grads_j = _ref_loss_grads(cj, pj, toks, gj, remat=False,
                                      dispatch="einsum")
    loss_t, grads_t = _port_loss_grads(ct, pt, toks, gt, remat=False,
                                       dispatch="einsum")
    assert abs(float(loss_t) - loss_j) < 1e-5
    _assert_leaves(grads_t, grads_j)


@pytest.mark.parametrize("name", ["e4", "e16"])
def test_einsum_dispatch_matches_scatter(moe, name):
    """Mirror of ``test_moe_dispatch_scatter_matches_einsum`` (H1) on the
    port: the two dispatches' logits within 5e-5, aux losses within 1e-6,
    every gradient within 5e-5; a dispatch name other than ``einsum`` is
    the scatter dispatch, as the reference reads it."""
    _, ct, _, pt, toks = moe[name]
    with torch.no_grad():
        l1, a1 = MOET.forward(ct, pt, t_of(toks[:, :-1]), dispatch="einsum")
        l2, a2 = MOET.forward(ct, pt, t_of(toks[:, :-1]),
                              dispatch="scatter")
        l3, a3 = MOET.forward(ct, pt, t_of(toks[:, :-1]), dispatch="gather")
    assert_close(l1, l2, H1_TOL)
    assert abs(float(a1) - float(a2)) < 1e-6
    assert torch.equal(l3, l2) and torch.equal(a3, a2)
    _, g1 = _port_loss_grads(ct, pt, toks, remat=False, dispatch="einsum")
    _, g2 = _port_loss_grads(ct, pt, toks, remat=False, dispatch="scatter")
    _assert_leaves(g1, g2, atol=H1_TOL, rtol=0)


def test_einsum_folded_expert_ids_mirror_the_reference(moe):
    """A BITWISE expert fence of size 2 over 4 experts folds a token's two
    ids onto one expert wherever they differ only above bit 0: the einsum
    dispatch then holds two slots of that expert for the token and weighs
    each by the sum of both gates — the reference's einsum result, which
    the scatter dispatch does not give."""
    cj, ct, pj, pt, toks = moe["e4"]
    gj = GSJ(policy=PJ.BITWISE, expert=FPJ(0, 2))
    gt = GST(policy=PT.BITWISE, expert=FPT(0, 2))
    x = np.random.default_rng(5).normal(size=(2, 16, cj.d_model)) \
        .astype(np.float32)
    p_j = jax.tree.map(lambda a: a[0], pj["layers"]["moe"])
    p_t = pt["layers"][0]["moe"]
    with torch.no_grad():
        r = MOET.route(ct, p_t, t_of(x).reshape(32, -1), gt)
    assert (r.experts[:, 0] == r.experts[:, 1]).any()
    outs = {}
    for dispatch in ("einsum", "scatter"):
        yj, aj = jax.jit(lambda p, x: MOEJ.moe_apply(
            cj, p, x, gj, dispatch=dispatch))(p_j, jnp.asarray(x))
        with torch.no_grad():
            yt, at = MOET.moe_apply(ct, p_t, t_of(x), gt, dispatch=dispatch)
        assert_close(yt, yj, TOL_F32)
        assert abs(float(at) - float(aj)) < 1e-6
        outs[dispatch] = yt
    assert (outs["einsum"] - outs["scatter"]).abs().max() > 1e-3
    loss_j, grads_j = _ref_loss_grads(cj, pj, toks, gj, remat=False,
                                      dispatch="einsum")
    loss_t, grads_t = _port_loss_grads(ct, pt, toks, gt, remat=False,
                                       dispatch="einsum")
    assert abs(float(loss_t) - loss_j) < 1e-5
    _assert_leaves(grads_t, grads_j)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_prefill_and_decode_dispatch_match_reference(moe, dispatch):
    """``api.prefill`` / ``api.decode`` with ``dispatch=`` on an f32 slab
    cache: a 24-token prefill and three greedy decode steps, the logits
    within 1e-4 of the reference's and the greedy ids equal."""
    cj, ct, pj, pt, toks = moe["e16"]
    aj, at = get_model_j(cj), get_model(ct)
    pre_j = jax.jit(lambda p, c, t: aj.prefill(p, c, {"tokens": t},
                                               dispatch=dispatch))
    dec_j = jax.jit(lambda p, c, t: aj.decode(p, c, t, dispatch=dispatch))
    cache_j = aj.init_cache(2, 64, dtype=jnp.float32)
    cache_t = at.init_cache(2, 64, dtype=torch.float32, device="cpu")
    cache_j, lj = pre_j(pj, cache_j, jnp.asarray(toks[:, :24]))
    with torch.no_grad():
        cache_t, lt = at.prefill(pt, cache_t, {"tokens": t_of(toks[:, :24])},
                                 dispatch=dispatch)
        for _ in range(3):
            assert_close(lt, lj, TOL_MODEL)
            nxt = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
            assert (lt.argmax(-1).numpy() == nxt).all()
            cache_j, lj = dec_j(pj, cache_j, jnp.asarray(nxt))
            cache_t, lt = at.decode(pt, cache_t, t_of(nxt),
                                    dispatch=dispatch)
    assert_close(lt, lj, TOL_MODEL)


def test_dots_policy_is_nothing_bit_for_bit_and_matches_reference(moe):
    """``remat_policy="dots"`` gives the loss and gradients of ``nothing``
    and of no remat bit for bit (a policy name other than ``dots`` is
    ``nothing``, as the reference reads it), and the reference's ``dots``
    loss within 1e-5 and gradients within atol 1e-5 / rtol 1e-4, for both
    dispatches."""
    cj, ct, pj, pt, toks = moe["e16"]
    for dispatch in ("scatter", "einsum"):
        runs = {pol: _port_loss_grads(ct, pt, toks, remat=True,
                                      remat_policy=pol, dispatch=dispatch)
                for pol in ("dots", "nothing", "full")}
        runs["off"] = _port_loss_grads(ct, pt, toks, remat=False,
                                       dispatch=dispatch)
        for pol in ("nothing", "full", "off"):
            assert torch.equal(runs[pol][0], runs["dots"][0]), pol
            assert all(torch.equal(a, b) for a, b in
                       zip(runs[pol][1], runs["dots"][1])), pol
        loss_j, grads_j = _ref_loss_grads(cj, pj, toks, remat=True,
                                          remat_policy="dots",
                                          dispatch=dispatch)
        assert abs(float(runs["dots"][0]) - loss_j) < 1e-5
        _assert_leaves(runs["dots"][1], grads_j)


class _CountProducts(TorchDispatchMode):
    """Counts the plain products (``aten.mm`` / ``aten.addmm``) and the
    batched ones (``aten.bmm``) dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        elif func is torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_backward_recomputes_no_plain_product(moe):
    """The backward pass's products: with remat off, the gradients' own;
    under ``dots``, exactly as many ``aten.mm`` (the layers' plain
    products are saved) and more ``aten.bmm`` (the expert products are
    recomputed); under ``nothing``, more of both (the whole layer is
    recomputed)."""
    _, ct, _, pt, toks = moe["e16"]
    struct, leaves = tree_flatten(pt)
    counts = {}
    for name, kw in (("off", dict(remat=False)),
                     ("dots", dict(remat=True, remat_policy="dots")),
                     ("nothing", dict(remat=True, remat_policy="nothing"))):
        req = [p.detach().clone().requires_grad_() for p in leaves]
        loss = MOET.loss_fn(ct, tree_unflatten(struct, req),
                            {"tokens": t_of(toks)}, **kw)
        with _CountProducts() as c:
            torch.autograd.grad(loss, req)
        counts[name] = (c.mm, c.bmm)
    assert counts["dots"][0] == counts["off"][0] > 0, counts
    assert counts["dots"][1] > counts["off"][1], counts
    assert counts["nothing"][0] > counts["off"][0], counts
    assert counts["nothing"][1] == counts["dots"][1], counts


# --------------------------------------------------------------------- #
# The float8 KV pool                                                    #
# --------------------------------------------------------------------- #

def test_fp8_cast_matches_jnp():
    """``kernels/ref.py``'s ``to_pool`` to float8 e4m3 gives jnp's ``astype``
    bytes: round to nearest even (the midpoints of every pair of
    neighbouring values, and a float32 step either side), subnormals, and
    NaN past 464 where torch's own cast saturates to 448; from float32,
    bfloat16 and float16."""
    vals = np.asarray(jnp.arange(256, dtype=jnp.uint8).view(FP8_J)
                      .astype(jnp.float32))
    vals = np.sort(vals[np.isfinite(vals)])
    mid = (vals[1:] + vals[:-1]) / 2
    rng = np.random.default_rng(0)
    x = np.concatenate([
        mid, np.nextafter(mid, np.inf), np.nextafter(mid, -np.inf),
        rng.normal(size=4096) * 100, rng.normal(size=1024) * 1e-3,
        [448, 464, 465, 480, 1e4, -465, np.inf, -np.inf, np.nan, 0.0,
         -0.0]]).astype(np.float32)
    for jd, td, bits in ((jnp.float32, torch.float32, np.uint32),
                         (jnp.bfloat16, torch.bfloat16, np.uint16),
                         (jnp.float16, torch.float16, np.uint16)):
        xj = jnp.asarray(x).astype(jd)
        want = np.asarray(xj.astype(FP8_J)).view(np.uint8)
        # the same bits on both sides (torch's own NaN of a cast to bf16
        # has its sign bit set)
        xt = torch.from_numpy(np.asarray(xj).view(bits).astype(
            np.int64)).to(torch.int32 if bits == np.uint32 else torch.int16)
        got = RT.to_pool(xt.view(td), FP8_T).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, want)


#: 4 rows over an 8-slot fp8 pool of 64-token slabs: rows 0 and 1 serve
#: slots 3 and 5, rows 2 and 3 park on the scratch slot 0 (a prefill sums
#: their slabs there; a decode's last row writes)
FP8_SLOTS = np.array([3, 5, 0, 0], np.int32)


@pytest.fixture(scope="module")
def dense():
    cj = get_config("stablelm-3b").reduced()
    ct = get_config_t("stablelm-3b").reduced()
    pj = jax.jit(get_model_j(cj).init)(jax.random.PRNGKey(0))
    return cj, ct, pj, params_from_jax(params_np(pj), "cpu")


def _pool_bytes(cache):
    return [np.asarray(np_of(RT.pool_bytes(t))) if isinstance(
        t, torch.Tensor) else np.asarray(t).view(np.uint8)
        for t in (cache.k, cache.v)]


@pytest.mark.parametrize("mode", ["permute", "scatter"])
def test_fp8_slab_writes_match_reference_bytes(mode):
    """The slab cache's writes into fp8 pools on the same K/V: a 40-token
    prefill write (``mode``) into two layers, then three appends, every
    byte of both pools equal to the reference's fed ``astype(f8)`` values
    — under a BITWISE guard, with a forged slot (fenced onto row 0's), a
    forged page id, two rows parked on the scratch slot (the permute write
    sums their slabs there, in float32, rounded as XLA rounds), values past
    464 (NaN) and a pool of old bytes left where nothing writes."""
    cj, ct = get_config("stablelm-3b").reduced(), \
        get_config_t("stablelm-3b").reduced()
    B, slots, max_len = 4, 8, 128
    rng = np.random.default_rng(4)
    old = (rng.normal(size=(cj.n_layers, slots, 2, 64, cj.n_kv_heads,
                            cj.head_dim)) * 8).astype(np.float32)
    old_j = jnp.asarray(old).astype(FP8_J)
    old_t = torch.from_numpy(np.asarray(old_j).view(np.uint8).copy()) \
        .view(FP8_T)
    slot_ids = np.array([3, 11, 0, 0], np.int32)
    table = np.array([[1, 0], [0, 1], [0, 1], [5, 0]], np.int32)
    cache_j = dataclasses.replace(
        KVJ.init_kv_cache(cj, B, max_len, slots=slots, dtype=FP8_J),
        k=old_j, v=old_j, slot_ids=jnp.asarray(slot_ids),
        page_table=jnp.asarray(table))
    cache_t = dataclasses.replace(
        KVT.init_kv_cache(ct, B, max_len, slots=slots, dtype=FP8_T,
                          device="cpu"),
        k=old_t.clone(), v=old_t.clone(), slot_ids=t_of(slot_ids),
        page_table=t_of(table))
    gj = GSJ(policy=PJ.BITWISE, kv=FPJ(0, 8), page=FPJ(0, 2))
    gt = GST(policy=PT.BITWISE, kv=FPT(0, 8), page=FPT(0, 2))

    def kv(*shape):
        x = (rng.normal(size=shape) * 150).astype(np.float32)
        return x, jnp.asarray(x).astype(FP8_J), t_of(x)

    def same():
        for a, b in ((cache_t.k, cache_j.k), (cache_t.v, cache_j.v)):
            np.testing.assert_array_equal(
                a.view(torch.uint8).numpy(), np.asarray(b).view(np.uint8))

    for layer in range(cj.n_layers):
        (_, kj, kt), (_, vj, vt) = (kv(B, 40, cj.n_kv_heads, cj.head_dim)
                                    for _ in range(2))
        cache_j = KVJ.write_prefill_kv(cache_j, layer, kj, vj, gj, mode=mode)
        KVT.write_prefill_kv(cache_t, layer, kt, vt, gt, mode=mode)
        same()
    assert (np.isnan(np.asarray(cache_j.k.astype(jnp.float32)))).any()
    for step in range(3):
        cache_j = dataclasses.replace(cache_j, seq_lens=jnp.full(
            (B,), 40 + step, jnp.int32))
        cache_t.seq_lens = torch.full((B,), 40 + step, dtype=torch.int32)
        (_, kj, kt), (_, vj, vt) = (kv(B, 1, cj.n_kv_heads, cj.head_dim)
                                    for _ in range(2))
        cache_j = KVJ.append_token_kv(cache_j, 1, kj, vj, gj)
        KVT.append_token_kv(cache_t, 1, kt, vt, gt)
        same()


def test_fp8_pool_bytes_and_logits_match_reference(dense):
    """An fp8 slab pool through the model API: after a 40-token prefill
    and after each of three decode steps, every byte of the K and V pools
    (the scratch slot where rows 2 and 3 sum included) equals the
    reference's, and the logits are within its f32 tolerance."""
    cj, ct, pj, pt = dense
    aj, at = get_model_j(cj), get_model(ct)
    cache_j = dataclasses.replace(aj.init_cache(4, 64, dtype=FP8_J, slots=8),
                                  slot_ids=jnp.asarray(FP8_SLOTS))
    cache_t = dataclasses.replace(
        at.init_cache(4, 64, dtype=FP8_T, slots=8, device="cpu"),
        slot_ids=t_of(FP8_SLOTS))
    toks = np.random.default_rng(2).integers(0, cj.vocab, (4, 43)) \
        .astype(np.int32)
    cache_j, lj = jax.jit(lambda p, c, t: aj.prefill(p, c, {"tokens": t}))(
        pj, cache_j, jnp.asarray(toks[:, :40]))
    dec_j = jax.jit(aj.decode)
    with torch.no_grad():
        cache_t, lt = at.prefill(pt, cache_t, {"tokens": t_of(toks[:, :40])})
        for step in range(4):
            assert cache_t.k.dtype == FP8_T
            assert_close(lt, lj, TOL_MODEL)
            for got, want in zip(_pool_bytes(cache_t), _pool_bytes(cache_j)):
                np.testing.assert_array_equal(got, want)
            if step == 0:
                # the scratch slot holds the parked rows' summed slabs
                k0 = np_of(cache_t.k[:, 0].float())
                assert np.abs(k0).max() > 0
            if step < 3:
                cache_j, lj = dec_j(pj, cache_j,
                                    jnp.asarray(toks[:, 40 + step]))
                cache_t, lt = at.decode(pt, cache_t,
                                        t_of(toks[:, 40 + step]))


def test_fp8_kv_cache_decode_runs(dense):
    """Mirror of the reference's H3 test: the fp8 pool's decode logits are
    finite and correlated (> 0.98) with the f32 pool's."""
    _, ct, _, pt = dense
    api = get_model(ct)
    toks = torch.randint(0, ct.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(0))
    outs = {}
    with torch.no_grad():
        for name, dt in (("f32", torch.float32), ("f8", FP8_T)):
            cache = api.init_cache(2, 64, dtype=dt, device="cpu")
            cache, lg = api.prefill(pt, cache, {"tokens": toks})
            cache, lg = api.decode(pt, cache, lg.argmax(-1).to(torch.int32))
            assert not torch.isnan(lg).any()
            outs[name] = lg.numpy().ravel()
    assert np.corrcoef(outs["f32"], outs["f8"])[0, 1] > 0.98


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,D,page,P_total,max_pages", [
    (2, 2, 2, 80, 64, 16, 2),            # stablelm-3b head/page geometry
    (3, 8, 2, 64, 16, 32, 4),            # GQA, G = 4
    (2, 4, 4, 112, 8, 16, 8),            # zamba2-7b's D
])
def test_paged_attention_plain_on_an_fp8_pool_matches_oracle_and_pallas(
        q_dtype, B, H, KH, D, page, P_total, max_pages):
    """K1's plain version over a float8 e4m3 pool (widened exactly) against
    the oracle and the Pallas kernel in interpret mode on the same pool,
    for a float32 and a bfloat16 query, forged table ids included; and
    equal bit for bit to the plain version over the pool widened to
    float32 first."""
    rng = np.random.default_rng(H * 10 + D)
    jd, td, tol = {"float32": (jnp.float32, torch.float32, TOL_F32),
                   "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[q_dtype]
    qj = jnp.asarray(rng.normal(size=(B, H, D)), jd)
    kj, vj = (jnp.asarray(rng.normal(size=(P_total, page, KH, D)),
                          jnp.float32).astype(FP8_J) for _ in range(2))
    qt = t_of(qj, td)
    kt, vt = (torch.from_numpy(np.asarray(a).view(np.uint8).copy())
              .view(FP8_T) for a in (kj, vj))
    base = np.zeros((B,), np.int32)
    mask = np.full((B,), P_total - 1, np.int32)
    pt = rng.integers(-P_total, 2 * P_total,
                      size=(B, max_pages)).astype(np.int32)
    lens = rng.integers(1, max_pages * page, size=B).astype(np.int32)
    args_j = [jnp.asarray(a) for a in (pt, lens, base, mask)]
    args_t = [t_of(a) for a in (pt, lens, base, mask)]
    want = RJ.paged_attention_ref(qj, kj, vj, *args_j)
    pallas = OPS.paged_attention(qj, kj, vj, *args_j)
    got = paged_attention(qt, kt, vt, *args_t)
    assert got.dtype == td and got.shape == (B, H, D)
    assert_close(got, want, tol)
    assert_close(got, pallas, tol)
    assert torch.equal(got, paged_attention(qt, kt.float(), vt.float(),
                                            *args_t))


@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
def test_scatter_pages_plain_into_an_fp8_pool_matches_oracle_and_pallas(
        src_dtype):
    """K2's plain version storing f32 or bf16 pages into a float8 e4m3
    pool (the global layout's prefill write over an fp8 pool): every byte
    equal to the oracle's and the Pallas kernel's (interpret mode) —
    duplicate fenced destinations (the last writer wins), values past 464
    stored as NaN as jnp's cast stores them, pages no id reaches left at
    their old bytes."""
    rng = np.random.default_rng(7)
    P, page, KH, D, N = 16, 4, 2, 16, 12
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[src_dtype]
    pages = jnp.asarray(rng.normal(size=(N, page, KH, D)) * 200, jd)
    ids = rng.integers(0, 4 * P, size=(N,)).astype(np.int32)
    base, mask = 0, P // 2 - 1
    old = np.asarray(jnp.asarray(rng.normal(size=(P, page, KH, D)),
                                 jnp.float32).astype(FP8_J))
    # (the Pallas kernel writes its pool operand in place)
    want = RJ.scatter_pages_ref(jnp.asarray(old), pages, jnp.asarray(ids),
                                base, mask)
    pallas = OPS.scatter_pages(jnp.asarray(old), pages, jnp.asarray(ids),
                               base, mask)
    src = torch.from_numpy(np.array(pages.astype(jnp.float32))).to(td)
    pools = [torch.from_numpy(old.view(np.uint8).copy()).view(FP8_T)
             for _ in range(2)]
    scatter_pages(*pools, src, src, t_of(ids)[:, None], base, mask)
    for got in pools:
        for ref_pool in (want, pallas):
            np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                          np.asarray(ref_pool).view(np.uint8))
    assert np.isnan(np.asarray(want.astype(jnp.float32))).any()
    assert len(set(((ids & mask) | base).tolist())) < N

"""The port's vision (qwen2-vl-2b) and encoder-decoder
(seamless-m4t-medium) families against the JAX reference, on reduced
configs and the reference's weights (converted), the same numpy inputs
from a seed:

* M-RoPE (``apply_mrope``, ``mrope_sections``, ``positions_rope``) with
  equal and with differing position components (equal components are
  RoPE, so only differing ones can show a section-split fault);
* the vision family's ``forward`` and its prefill + decode over a patch
  grid whose components differ, against ``VLM.forward`` and the
  reference's serving path;
* the encoder-decoder's ``encode``, ``decode_train`` and prefill + decode
  (float32, atol 3e-4 as the reference's own test), the cross pool after
  a prefill under a forged slot id, and ``split_cache_pool`` /
  ``join_cache_pool`` / ``_scrub_slots`` on its cache;
* both losses and every gradient leaf, and ``build_train_step`` on both
  families' batches;
* mirrors of ``tests/test_models.py``'s per-arch smoke tests over every
  arch, on the model API's default (bfloat16) slab cache.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_close, assert_same, np_of, params_np, \
    t_of  # noqa: E402
from repro.configs import ShapeConfig as ShapeJ, get_config, \
    list_archs  # noqa: E402
from repro.core.fence import FenceParams as FPJ, FencePolicy as PJ, \
    FenceTable as FTJ  # noqa: E402
from repro.core.partition import Partition as PartJ  # noqa: E402
from repro.launch import serve as SJ  # noqa: E402
from repro.launch import steps as STEPSJ  # noqa: E402
from repro.models import encdec as EDJ, kvcache as KVJ, layers as LJ, \
    vlm as VLMJ  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro.models.guard import GuardSpec as GSJ  # noqa: E402
from repro_torch.configs import ShapeConfig, \
    get_config as get_config_t  # noqa: E402
from repro_torch.core.fence import FenceParams as FPT, \
    FencePolicy as PT, FenceTable as FTT  # noqa: E402
from repro_torch.core.partition import Partition as PartT  # noqa: E402
from repro_torch.core.stepgraph import tree_flatten, \
    tree_unflatten  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve as ST  # noqa: E402
from repro_torch.launch import steps as STEPST  # noqa: E402
from repro_torch.models import encdec as EDT, kvcache as KVT, \
    layers as LT, vlm as VLMT  # noqa: E402
from repro_torch.models import get_model as get_model_t  # noqa: E402
from repro_torch.models.api import UNPORTED  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.guard import GuardSpec as GST  # noqa: E402

VLM_J, VLM_T = (get_config("qwen2-vl-2b").reduced(),
                get_config_t("qwen2-vl-2b").reduced())
ED_J, ED_T = (get_config("seamless-m4t-medium").reduced(),
              get_config_t("seamless-m4t-medium").reduced())
#: the reference's own tolerance for a served logit (test_models.py)
TOL_SERVE = 3e-4
TOL_LOSS = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def weights():
    """Per family: the reference's params (seed 0) and the port's
    converted copy on the CPU."""
    out = {}
    for cj in (VLM_J, ED_J):
        pj = get_model_j(cj).init(jax.random.PRNGKey(0))
        out[cj.family] = (pj, params_from_jax(params_np(pj), "cpu"))
    return out


def patch_grid(B: int, S: int, side: int) -> np.ndarray:
    """qwen2-vl positions (B, S, 3): ``side`` x ``side`` patches at (t=0,
    h=i // side, w=i % side), then the text, all three components at
    ``side + (i - n_patches)`` (one past the grid's largest id)."""
    n = side * side
    pos = np.zeros((S, 3), np.int32)
    i = np.arange(n)
    pos[:n, 1], pos[:n, 2] = i // side, i % side
    pos[n:] = (side + np.arange(S - n))[:, None]
    return np.broadcast_to(pos, (B, S, 3)).copy()


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_mrope_sections_match_reference(head_dim):
    assert LT.mrope_sections(head_dim) == LJ.mrope_sections(head_dim)


@pytest.mark.parametrize("components", ["equal", "differing"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(components, dtype):
    """``apply_mrope`` and ``positions_rope`` for an M-RoPE config (3-dim
    and text-only 2-dim positions) within 1e-5 (f32) / one bf16 ulp of
    the reference; with equal components M-RoPE is RoPE."""
    rng = np.random.default_rng(5)
    B, S, H, D = 2, 20, 3, 16
    x = rng.normal(size=(B, S, H, D)).astype(np.float32)
    pos = rng.integers(0, 500, size=(B, S, 3)).astype(np.int32)
    if components == "equal":
        pos[..., 1] = pos[..., 2] = pos[..., 0]
    secs = LJ.mrope_sections(D)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    tol = 1e-5 if dtype == "float32" else 1e-2
    xj, xt = jnp.asarray(x).astype(jdt), t_of(x, tdt)
    want = LJ.apply_mrope(xj, jnp.asarray(pos), 1e4, secs)
    got = LT.apply_mrope(xt, t_of(pos), 1e4, secs)
    assert got.dtype == tdt
    assert_close(got, want, tol)
    if components == "equal":
        assert_close(got, LT.apply_rope(xt, t_of(pos[..., 0]), 1e4), tol)
    cfg = dataclasses.replace(VLM_T, head_dim=D, rope_theta=1e4)
    cfg_j = dataclasses.replace(VLM_J, head_dim=D, rope_theta=1e4)
    for p in (pos, pos[..., 0]):
        qj, kj = LJ.positions_rope(cfg_j, xj, xj, jnp.asarray(p))
        qt, kt = LT.positions_rope(cfg, xt, xt, t_of(p))
        assert_close(qt, qj, tol)
        assert_close(kt, kj, tol)


# ---------------------------------------------------------------------------
# Vision family
# ---------------------------------------------------------------------------

def _vlm_inputs(B=2, S=40, side=4):
    rng = np.random.default_rng(6)
    toks = rng.integers(0, VLM_J.vocab, size=(B, S)).astype(np.int32)
    patches = (rng.normal(size=(B, side * side, VLM_J.d_model))
               * 0.02).astype(np.float32)
    return toks, patches, patch_grid(B, S, side)


def test_vlm_forward_matches_reference(weights):
    """``forward`` (fused patches, K3 over every id, M-RoPE over the patch
    grid) within 1e-4 of ``VLM.forward``."""
    pj, pt = weights["vlm"]
    toks, patches, pos = _vlm_inputs()
    want = VLMJ.forward(VLM_J, pj, jnp.asarray(toks), jnp.asarray(patches),
                        jnp.asarray(pos))
    got = VLMT.forward(VLM_T, pt, t_of(toks), t_of(patches), t_of(pos))
    assert_close(got, want, 1e-4)


def test_vlm_prefill_and_decode_match_forward(weights):
    """Mirror of ``test_models.py::test_vlm_decode_matches_forward`` over
    a patch grid, on the reference's weights: a patched prefill of S - 2
    tokens and two text decode steps (positions passed on, past the grid)
    on the API's slab cache, each logit within 3e-4 of the full forward
    (which :func:`test_vlm_forward_matches_reference` holds to the
    reference's); ``decode`` without positions takes ``seq_lens`` as every
    component, the reference's default."""
    pj, pt = weights["vlm"]
    toks, patches, pos = _vlm_inputs()
    S, Sp = toks.shape[1], toks.shape[1] - 2
    full = VLMT.forward(VLM_T, pt, t_of(toks), t_of(patches), t_of(pos))
    api_t = get_model_t(VLM_T)
    ct = api_t.init_cache(2, 64, dtype=torch.float32, device="cpu")
    ct, lt = api_t.prefill(pt, ct, {
        "tokens": t_of(toks[:, :Sp]), "patches": t_of(patches),
        "positions": t_of(pos[:, :Sp])})
    assert_close(lt, full[:, Sp - 1], TOL_SERVE)
    k0 = ct.k.clone()
    for t in range(Sp, S):
        ct, lt = api_t.decode(pt, ct, t_of(toks[:, t]),
                              positions=t_of(pos[:, t, :1]))
        assert_close(lt, full[:, t], TOL_SERVE)
    assert_same(ct.seq_lens, np.full(2, S, np.int32))
    # the default positions: seq_lens in all three components
    ct = dataclasses.replace(ct, seq_lens=torch.full((2,), Sp,
                                                     dtype=torch.int32))
    ct.k.copy_(k0)
    _, l_default = api_t.decode(pt, ct, t_of(toks[:, Sp]))
    ct = dataclasses.replace(ct, seq_lens=torch.full((2,), Sp,
                                                     dtype=torch.int32))
    ct.k.copy_(k0)
    _, l_given = api_t.decode(pt, ct, t_of(toks[:, Sp]),
                              positions=torch.full((2, 1, 3), Sp,
                                                   dtype=torch.int32))
    assert torch.equal(l_default, l_given)


# ---------------------------------------------------------------------------
# Encoder-decoder family
# ---------------------------------------------------------------------------

def _ed_inputs(B=2, S_src=16, S=32):
    rng = np.random.default_rng(7)
    src = rng.normal(size=(B, S_src, ED_J.d_model)).astype(np.float32)
    tgt = rng.integers(0, ED_J.vocab, size=(B, S)).astype(np.int32)
    return src, tgt


def test_encdec_encode_and_decode_train_match_reference(weights):
    """``encode`` (K4 non-causal) and ``decode_train`` (K4 causal, and
    non-causal over the memory's length) within 1e-4 of the reference."""
    pj, pt = weights["encdec"]
    src, tgt = _ed_inputs()
    mem_j = EDJ.encode(ED_J, pj, jnp.asarray(src))
    mem_t = EDT.encode(ED_T, pt, t_of(src))
    assert_close(mem_t, mem_j, 1e-4)
    want = EDJ.decode_train(ED_J, pj, jnp.asarray(tgt), mem_j)
    got = EDT.decode_train(ED_T, pt, t_of(tgt), mem_t)
    assert_close(got, want, 1e-4)


def test_encdec_prefill_and_decode_match_reference(weights):
    """Mirror of ``test_models.py::test_encdec_decode_matches_train_
    forward``: prefill S - 2 target tokens, decode two (self-attention
    and cross-attention through K1's plain version), each logit within
    3e-4 of the teacher-forced decoder and of the reference's served
    logits; the slabs and the cross pools within 1e-4."""
    pj, pt = weights["encdec"]
    src, tgt = _ed_inputs()
    S = tgt.shape[1]
    mem = EDT.encode(ED_T, pt, t_of(src))
    full = EDT.decode_train(ED_T, pt, t_of(tgt), mem)
    api_j, api_t = get_model_j(ED_J), get_model_t(ED_T)
    cj = api_j.init_cache(2, 64, src_len=16, dtype=jnp.float32)
    ct = api_t.init_cache(2, 64, src_len=16, dtype=torch.float32,
                          device="cpu")
    cj, lj = api_j.prefill(pj, cj, {"src": jnp.asarray(src),
                                    "tgt": jnp.asarray(tgt[:, :S - 2])})
    ct, lt = api_t.prefill(pt, ct, {"src": t_of(src),
                                    "tgt": t_of(tgt[:, :S - 2])})
    assert_close(lt, full[:, S - 3], TOL_SERVE)
    assert_close(lt, lj, TOL_SERVE)
    for t in range(S - 2, S):
        cj, lj = api_j.decode(pj, cj, jnp.asarray(tgt[:, t]))
        ct, lt = api_t.decode(pt, ct, t_of(tgt[:, t]))
        assert_close(lt, full[:, t], TOL_SERVE)
        assert_close(lt, lj, TOL_SERVE)
    assert_same(ct.src_lens, cj.src_lens)
    assert_same(ct.kv.seq_lens, cj.kv.seq_lens)
    for a, b in ((ct.kv.k, cj.kv.k), (ct.cross_k, cj.cross_k),
                 (ct.cross_v, cj.cross_v)):
        assert_close(a, b, 1e-4)


def _row_guards(row_tenant, parts):
    """The same per-row guard in both packages: kv from the fence table's
    rows (magic included), pages fenced into the slab's one page."""
    pj = [PartJ(f"t{i}", b, s) for i, (b, s) in enumerate(parts)]
    pt = [PartT(f"t{i}", b, s) for i, (b, s) in enumerate(parts)]
    kj = FTJ.from_partitions(pj, with_magic=True).gather(
        jnp.asarray(row_tenant, jnp.int32))
    kt = FTT.from_partitions(pt, with_magic=True, device="cpu").gather(
        torch.tensor(row_tenant, dtype=torch.int32))
    return (GSJ(policy=PJ.BITWISE, vocab=FPJ(0, 256), kv=kj, page=FPJ(0, 1)),
            GST(policy=PT.BITWISE, vocab=FPT(0, 256), kv=kt,
                page=FPT(0, 1)))


def test_cross_pool_after_prefill_under_a_forged_slot(weights):
    """Four rows over an 8-slot pool: tenants a [4, 6) and b [6, 8), two
    rows parked on the scratch slot 0.  Row 1 (tenant b) names slot 4,
    a's: its fenced stash lands at 6, inside b, after the prefill.  The
    slots a row owns (4, 6) hold the reference's cross pool within 1e-5
    (the two packages' projections round differently), a's slot exactly
    a's own frames and 6 the forged row's; every slot no row writes stays
    zero, as the reference's; the logits agree within 3e-4.  (Parked rows
    share the scratch slot, where JAX's duplicate ``set`` and the port's
    last-writer-wins need not agree.)"""
    pj, pt = weights["encdec"]
    src, tgt = _ed_inputs(B=4, S=8)
    gj, gt = _row_guards([0, 1, 2, 2], [(4, 2), (6, 2), (0, 4)])
    slots = np.array([4, 4, 0, 0], np.int32)
    api_j, api_t = get_model_j(ED_J), get_model_t(ED_T)
    shape = (ED_J.n_layers, 8, 16, ED_J.n_kv_heads, ED_J.head_dim)
    cj = EDJ.EncDecCache(
        kv=dataclasses.replace(
            KVJ.init_kv_cache(ED_J, 4, 64, slots=8, dtype=jnp.float32),
            slot_ids=jnp.asarray(slots)),
        cross_k=jnp.zeros(shape), cross_v=jnp.zeros(shape),
        src_lens=jnp.zeros((4,), jnp.int32))
    ct = EDT.EncDecCache(
        kv=dataclasses.replace(
            KVT.init_kv_cache(ED_T, 4, 64, slots=8, dtype=torch.float32,
                              device="cpu"), slot_ids=t_of(slots)),
        cross_k=torch.zeros(shape), cross_v=torch.zeros(shape),
        src_lens=torch.zeros((4,), dtype=torch.int32))
    cj, lj = api_j.prefill(pj, cj, {"src": jnp.asarray(src),
                                    "tgt": jnp.asarray(tgt)}, guard=gj)
    ct, lt = api_t.prefill(pt, ct, {"src": t_of(src), "tgt": t_of(tgt)},
                           guard=gt)
    assert_close(lt, lj, TOL_SERVE)
    owned, untouched = [4, 6], [1, 2, 3, 5, 7]
    for a, b in ((ct.cross_k, cj.cross_k), (ct.cross_v, cj.cross_v)):
        assert_close(a[:, owned], np_of(b)[:, owned], 1e-5)
        assert_same(a[:, untouched], np_of(b)[:, untouched])
        assert not a[:, untouched].any()
    mem = EDT.encode(ED_T, pt, t_of(src))
    ck = (mem @ pt["dec"][0]["cross"]["wk"]).reshape(
        4, 16, ED_T.n_kv_heads, ED_T.head_dim)
    assert torch.equal(ct.cross_k[0, 4], ck[0])          # a's own frames
    assert torch.equal(ct.cross_k[0, 6], ck[1])          # the forged row


def test_split_join_and_scrub_of_an_encdec_cache_match_reference():
    """``split_cache_pool`` puts the cross pools in the pool half (the
    meta half's are ``None``, the reference's pytree leaves them out),
    ``join_cache_pool`` rebuilds the cache, and ``_scrub_slots`` zeroes
    a slot range of the slabs and of both cross pools, as the
    reference's."""
    rng = np.random.default_rng(8)
    cj = get_model_j(ED_J).init_cache(2, 64, src_len=16, dtype=jnp.float32)
    fill = {n: rng.normal(size=getattr(cj, n).shape).astype(np.float32)
            for n in ("cross_k", "cross_v")}
    kv = {n: rng.normal(size=getattr(cj.kv, n).shape).astype(np.float32)
          for n in ("k", "v")}
    cj = dataclasses.replace(
        cj, kv=dataclasses.replace(cj.kv, **{n: jnp.asarray(a) for n, a in
                                             kv.items()}),
        **{n: jnp.asarray(a) for n, a in fill.items()})
    ct = get_model_t(ED_T).init_cache(2, 64, src_len=16,
                                      dtype=torch.float32, device="cpu")
    ct = dataclasses.replace(
        ct, kv=dataclasses.replace(ct.kv, **{n: t_of(a) for n, a in
                                             kv.items()}),
        **{n: t_of(a) for n, a in fill.items()})
    pool_j, meta_j = STEPSJ.split_cache_pool(cj)
    pool_t, meta_t = STEPST.split_cache_pool(ct)
    assert sorted(pool_t) == sorted(pool_j) == ["cross_k", "cross_v", "kv"]
    assert meta_t.cross_k is None and meta_t.kv.k is None
    for n in ("cross_k", "cross_v"):
        assert_same(pool_t[n], pool_j[n])
    back = STEPST.join_cache_pool(pool_t, meta_t)
    assert back.cross_k is ct.cross_k and back.kv.v is ct.kv.v
    scrubbed_j = SJ._scrub_slots(STEPSJ.join_cache_pool(pool_j, meta_j),
                                 1, 1)
    scrubbed_t = ST._scrub_slots(back, 1, 1)
    for a, b in ((scrubbed_t.cross_k, scrubbed_j.cross_k),
                 (scrubbed_t.cross_v, scrubbed_j.cross_v),
                 (scrubbed_t.kv.k, scrubbed_j.kv.k)):
        assert_same(a, b)
    assert not ct.cross_k[:, 1].any() and ct.cross_k[:, 0].any()


# ---------------------------------------------------------------------------
# Losses, gradients and the train step
# ---------------------------------------------------------------------------

def _batches(family, B=2, S=24):
    """A train batch of each family: vision (16 patches on a 4 x 4 grid),
    encoder-decoder (16 frames)."""
    rng = np.random.default_rng(9)
    if family == "vlm":
        return {"tokens": rng.integers(0, 256, (B, S + 1)).astype(np.int32),
                "patches": (rng.normal(size=(B, 16, 64)) * 0.02
                            ).astype(np.float32),
                "positions": patch_grid(B, S, 4)}
    return {"src": rng.normal(size=(B, 16, 64)).astype(np.float32),
            "tgt": rng.integers(0, 256, (B, S + 1)).astype(np.int32)}


@pytest.fixture(scope="module")
def ref_grads(weights):
    """Per family: the reference's loss and gradients (the port's params
    layout) on :func:`_batches` under the train guard of a (24, 2) batch."""
    out = {}
    for cj in (VLM_J, ED_J):
        api_j = get_model_j(cj)
        gj = STEPSJ.make_guard(cj, ShapeJ("t", "train", 24, 2))
        fn = jax.jit(jax.value_and_grad(lambda p, b: api_j.loss(
            p, b, guard=gj, remat=False)))
        loss, grads = fn(weights[cj.family][0], {
            k: jnp.asarray(v) for k, v in _batches(cj.family).items()})
        out[cj.family] = (float(loss),
                          params_from_jax(params_np(grads), "cpu"))
    return out


@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_loss_and_grads_match_reference(weights, ref_grads, family):
    """The loss within 1e-5 and every gradient leaf within atol 1e-5 /
    rtol 1e-4 of the reference's, under the train guard; remat gives the
    same loss and gradients bit for bit."""
    ct = VLM_T if family == "vlm" else ED_T
    pt = weights[family][1]
    gt = STEPST.make_guard(ct, ShapeConfig("t", "train", 24, 2))
    loss_j, grads_j = ref_grads[family]
    bt = {k: t_of(v) for k, v in _batches(family).items()}

    def port(remat):
        struct, leaves = tree_flatten(pt)
        req = [p.detach().clone().requires_grad_() for p in leaves]
        loss = get_model_t(ct).loss(tree_unflatten(struct, req), bt,
                                    guard=gt, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, req)

    loss_t, grads_t = port(False)
    assert abs(float(loss_t) - loss_j) < TOL_LOSS
    flat_j = tree_flatten(grads_j)[1]
    assert len(flat_j) == len(grads_t)
    for a, b in zip(grads_t, flat_j):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)
    loss_r, grads_r = port(True)
    assert torch.equal(loss_r, loss_t)
    assert all(torch.equal(a, b) for a, b in zip(grads_r, grads_t))


@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_train_step_on_family_batches_matches_reference(weights, ref_grads,
                                                         family):
    """``build_train_step`` (remat, the train guard, AdamW at a constant
    lr of 1e-3) on the family's batch: the first step's loss within 1e-5
    of the reference's loss on the same weights, and three steps on the
    same batch lower it."""
    ct = VLM_T if family == "vlm" else ED_T
    struct, leaves = tree_flatten(weights[family][1])
    params = tree_unflatten(struct, [p.clone() for p in leaves])  # in place
    step = STEPST.build_train_step(ct, ShapeConfig("t", "train", 24, 2),
                                   schedule=lambda s: 1e-3, device="cpu")
    state = step.opt.init(params)
    batch = {k: t_of(v) for k, v in _batches(family).items()}
    losses = []
    for _ in range(3):
        params, state, out = step.fn(params, state, batch)
        losses.append(float(out["loss"]))
    assert abs(losses[0] - ref_grads[family][0]) < TOL_LOSS
    assert losses[2] < losses[1] < losses[0], losses


# ---------------------------------------------------------------------------
# Every family through the model API
# ---------------------------------------------------------------------------

def test_every_family_is_built():
    """``get_model`` builds all six families; nothing is left unported."""
    assert UNPORTED == {}
    families = set()
    for arch in list_archs():
        cfg = get_config_t(arch).reduced()
        assert get_model_t(cfg).cfg is cfg
        families.add(cfg.family)
    assert families == {"dense", "moe", "hybrid", "ssm", "vlm", "encdec"}


def _smoke_batch(cfg, B, S):
    """``tests/test_models.py``'s ``make_batch``, in numpy."""
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        return {"src": np.ones((B, 16, cfg.d_model), np.float32),
                "tgt": rng.integers(0, cfg.vocab, (B, S + 1)).astype(
                    np.int32)}
    toks = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(
        np.int32)}
    if cfg.family == "vlm":
        toks["patches"] = np.ones((B, 8, cfg.d_model), np.float32)
        toks["positions"] = np.tile(
            np.arange(S, dtype=np.int32)[None, :, None], (B, 1, 3))
    return toks


@pytest.mark.parametrize("arch", list_archs())
def test_arch_smoke_train_step(arch):
    """Mirror of ``test_models.py::test_arch_smoke_train_step``: a scalar
    loss, finite, finite gradients, one of them non-zero, for every
    family."""
    cfg = get_config_t(arch).reduced()
    api = get_model_t(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: t_of(v) for k, v in _smoke_batch(cfg, 2, 32).items()}
    struct, leaves = tree_flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    loss = api.loss(tree_unflatten(struct, req), batch, remat=False)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    assert loss.shape == () and torch.isfinite(loss)
    grads = [g for g in grads if g is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(g.abs().max() > 0 for g in grads)


@pytest.mark.parametrize("arch", list_archs())
def test_arch_smoke_serve_step(arch):
    """Mirror of ``test_models.py::test_arch_smoke_serve_step`` on the
    API's default cache (bfloat16 slabs and pools, as on the card):
    prefill 32 tokens and decode one, logits (B, V) and finite, the
    attention families' K1 reading the bfloat16 pool."""
    cfg = get_config_t(arch).reduced()
    api = get_model_t(cfg)
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 32
    if cfg.family == "ssm":
        cache = api.init_cache(B, device="cpu")
    elif cfg.family == "encdec":
        cache = api.init_cache(B, 64, src_len=16, device="cpu")
    else:
        cache = api.init_cache(B, 64, device="cpu")
    batch = {k: t_of(v) for k, v in _smoke_batch(cfg, B, S).items()}
    batch.pop("positions", None)
    for name in ("tokens", "tgt"):
        if name in batch:
            batch[name] = batch[name][:, :S]
    if cfg.family == "vlm":
        batch["positions"] = t_of(np.tile(
            np.arange(S, dtype=np.int32)[None, :, None], (B, 1, 3)))
    _build.reset_counts()
    cache, logits = api.prefill(params, cache, batch)
    assert logits.shape == (B, cfg.vocab)
    cache, logits = api.decode(params, cache, logits.argmax(-1).int())
    assert logits.shape == (B, cfg.vocab)
    assert torch.isfinite(logits).all()
    if cfg.family != "ssm":
        assert _build.KERNELS["paged_attention"].plain_calls > 0

"""The plain PyTorch versions of the port's kernels (K1-K4) against the
JAX oracles (``repro.kernels.ref``) and the Pallas kernels in interpret
mode (``repro.kernels.ops``), on identical numpy inputs; plus the per-row
fences against the reference's jnp serve path.

The CUDA kernels themselves do not run in these CPU tests: on a CPU
tensor each wrapper takes its plain version, which ``chip_smoke.py``
holds every kernel against on the card."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import TOL_BF16, TOL_F32, assert_close, assert_same, \
    np_of, t_of  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.fence import FenceParams as FPJ, FencePolicy as PJ, \
    magic_row  # noqa: E402
from repro.kernels import ops as OPS  # noqa: E402
from repro.kernels import ref as RJ  # noqa: E402
from repro.models import kvcache as KVJ, layers as LJ  # noqa: E402
from repro.models.guard import GuardSpec as GSJ  # noqa: E402
from repro_torch.core.fence import FenceParams as FPT, \
    FencePolicy as PT  # noqa: E402
from repro_torch.kernels import _build, flash_attention, gather_rows, \
    paged_attention, scatter_pages  # noqa: E402
from repro_torch.models import kvcache as KVT, layers as LT  # noqa: E402
from repro_torch.models.guard import GuardSpec as GST  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32, TOL_F32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}


def _both(arr, dtype):
    jd, td, _ = DT[dtype]
    j = jnp.asarray(arr, jd)
    return j, t_of(j, td)


# --------------------------------------------------------------------- #
# K1 paged_attention                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,D,page,P_total,max_pages,mapped", [
    (2, 4, 4, 16, 8, 32, 4, False),      # MHA
    (4, 8, 2, 32, 16, 64, 8, False),     # GQA
    (1, 8, 1, 64, 8, 16, 2, False),      # MQA
    (2, 4, 4, 16, 8, 32, 4, True),       # page map, virtual ids
    (3, 6, 2, 16, 4, 32, 16, True),      # page map, many pages
    (2, 2, 2, 80, 64, 16, 2, True),      # stablelm-3b head/page geometry
])
def test_paged_attention_plain_matches_oracle_and_pallas(
        dtype, B, H, KH, D, page, P_total, max_pages, mapped):
    rng = np.random.default_rng(B * 100 + H + D)
    tol = DT[dtype][2]
    qj, qt = _both(rng.normal(size=(B, H, D)), dtype)
    kj, kt = _both(rng.normal(size=(P_total, page, KH, D)), dtype)
    vj, vt = _both(rng.normal(size=(P_total, page, KH, D)), dtype)
    n_virt = 2 * P_total if mapped else P_total
    half = n_virt // 2
    base = rng.choice([0, half], size=B).astype(np.int32)
    mask = np.full((B,), half - 1, np.int32)
    # forged: ids everywhere in the (virtual) space, not just the extent
    pt = rng.integers(0, n_virt, size=(B, max_pages)).astype(np.int32)
    lens = rng.integers(1, max_pages * page, size=B).astype(np.int32)
    pmap = rng.permutation(P_total)[rng.integers(0, P_total, size=n_virt)] \
        .astype(np.int32) if mapped else None
    args_j = [jnp.asarray(a) for a in (pt, lens, base, mask)]
    pm_j = None if pmap is None else jnp.asarray(pmap)
    want = RJ.paged_attention_ref(qj, kj, vj, *args_j, pm_j)
    pallas = OPS.paged_attention(qj, kj, vj, *args_j, pm_j)
    got = paged_attention(qt, kt, vt, *(t_of(a) for a in (pt, lens, base,
                                                          mask)),
                          None if pmap is None else t_of(pmap))
    assert got.dtype == DT[dtype][1] and got.shape == (B, H, D)
    assert_close(got, want, tol)
    assert_close(got, pallas, tol)


@pytest.mark.parametrize("seed,logsize", [(3, 3), (11, 4), (29, 5)])
def test_paged_attention_page_map_isolation(seed, logsize):
    """An adversarial page table of other tenants' virtual ids only
    reaches the physical pages the map gives the attacker's extent:
    clobbering every other page changes nothing."""
    rng = np.random.default_rng(seed)
    P_total = 2 ** logsize
    half = P_total // 2
    B, H, KH, D, page, max_pages = 2, 4, 2, 16, 4, 4
    pmap = np.zeros((P_total,), np.int32)
    a_phys = [p for p in range(1, P_total) if p % 2 == 1][:half]
    pmap[:len(a_phys)] = a_phys
    q = t_of(rng.normal(size=(B, H, D)), torch.float32)
    kp = rng.normal(size=(P_total, page, KH, D)).astype(np.float32)
    vp = rng.normal(size=(P_total, page, KH, D)).astype(np.float32)
    pt = t_of(rng.integers(0, P_total, size=(B, max_pages)).astype(np.int32))
    lens = torch.full((B,), max_pages * page, dtype=torch.int32)
    base = torch.zeros((B,), dtype=torch.int32)
    mask = torch.full((B,), half - 1, dtype=torch.int32)
    out1 = paged_attention(q, t_of(kp), t_of(vp), pt, lens, base, mask,
                           t_of(pmap))
    others = [p for p in range(P_total) if p not in set(a_phys)]
    kp[others], vp[others] = 31337.0, -31337.0
    out2 = paged_attention(q, t_of(kp), t_of(vp), pt, lens, base, mask,
                           t_of(pmap))
    assert_same(out1, out2)


def test_paged_attention_empty_row_is_uniform_mean():
    """A row with seq_len 0 attends uniformly over all max_pages pages,
    exactly like the reference oracle (masked scores are -1e30, not
    -inf)."""
    rng = np.random.default_rng(0)
    qj, qt = _both(rng.normal(size=(2, 2, 8)), "float32")
    kj, kt = _both(rng.normal(size=(8, 4, 2, 8)), "float32")
    vj, vt = _both(rng.normal(size=(8, 4, 2, 8)), "float32")
    pt = np.array([[1, 2], [3, 4]], np.int32)
    lens = np.array([0, 5], np.int32)
    base, mask = np.zeros(2, np.int32), np.full(2, 7, np.int32)
    want = RJ.paged_attention_ref(qj, kj, vj, *(jnp.asarray(a) for a in
                                                (pt, lens, base, mask)))
    got = paged_attention(qt, kt, vt, *(t_of(a) for a in (pt, lens, base,
                                                          mask)))
    assert_close(got, want, TOL_F32)


# --------------------------------------------------------------------- #
# K2 scatter_pages                                                      #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,page,KH,D,N", [(16, 4, 2, 8, 3),
                                           (64, 16, 4, 32, 8),
                                           (8, 4, 1, 8, 12)])
def test_scatter_pages_plain_matches_oracle_and_pallas(dtype, P, page, KH,
                                                       D, N):
    """Ids drawn from [0, 4P) fenced into P/2 pages: duplicate fenced
    destinations occur, and the last writer wins as in the in-order
    Pallas grid.  Nothing lands at or beyond P/2."""
    rng = np.random.default_rng(P + N)
    pages = rng.normal(size=(N, page, KH, D))
    ids = rng.integers(0, 4 * P, size=(N,)).astype(np.int32)
    base, mask = 0, P // 2 - 1
    jd, td, _ = DT[dtype]
    pj = jnp.asarray(pages, jd)
    want = RJ.scatter_pages_ref(jnp.zeros((P, page, KH, D), jd), pj,
                                jnp.asarray(ids), base, mask)
    pallas = OPS.scatter_pages(jnp.zeros((P, page, KH, D), jd), pj,
                               jnp.asarray(ids), base, mask)
    # the port writes K and V together from (B, S, KH, D) tokens: one
    # "row" per id with one page of tokens
    src = t_of(pj, td).reshape(N, page, KH, D)
    k_pool = torch.zeros((P, page, KH, D), dtype=td)
    v_pool = torch.zeros((P, page, KH, D), dtype=td)
    scatter_pages(k_pool, v_pool, src, -src, t_of(ids)[:, None], base,
                  mask)
    assert_same(k_pool, want)
    assert_same(k_pool, pallas)
    assert_same(v_pool, -np_of(want))
    assert (np_of(k_pool)[P // 2:] == 0).all()
    if N > P // 2:     # more ids than pages: duplicates are certain
        assert len(set(((ids & mask) | base).tolist())) < N


def _serve_guard(framework, policy="bitwise"):
    """Per-row serve guard over 4 rows: two tenants' virtual extents and
    two parked rows on the scratch extent (virtual [0, 4) -> page 0)."""
    base = np.array([8, 16, 0, 0], np.int32)
    size = np.array([8, 8, 4, 4], np.int32)
    magic = np.array([magic_row(int(n)) for n in size], np.uint32) \
        .view(np.int32)
    pmap = np.zeros((32,), np.int32)
    pmap[8:16] = np.arange(1, 9)
    pmap[16:24] = np.arange(9, 17)
    cols = (base, size, magic[:, 0], magic[:, 1])
    if framework == "jax":
        return GSJ(policy=PJ(policy), vocab=FPJ(0, 512),
                   kv=FPJ(*(jnp.asarray(c) for c in cols)),
                   page=FPJ(0, 32), page_map=jnp.asarray(pmap))
    return GST(policy=PT(policy), vocab=FPT(0, 512),
               kv=FPT(*(t_of(c) for c in cols)),
               page=FPT(0, 32), page_map=t_of(pmap))


@pytest.mark.parametrize("policy", ["bitwise", "modulo"])
@pytest.mark.parametrize("S", [3, 64, 70])
def test_write_prefill_kv_per_row_fences_match_jnp_path(policy, S):
    """The prefill page write (K2's plain version under the per-row
    guard, ragged S, forged ids, parked rows colliding on page 0) leaves
    the pool byte-identical to the reference's jnp write everywhere but
    the garbage page 0."""
    cfg = get_config("stablelm-3b").reduced()
    rng = np.random.default_rng(S)
    B, max_len, P = 4, 192, 32
    table = np.array([[8, 9, 10], [16, 27, 18], [0, 1, 2], [3, 3, 3]],
                     np.int32)
    table[0, 1] = 17                     # forged: the other tenant's id
    cj = dataclasses.replace(KVJ.init_global_kv_cache(cfg, B, max_len, P),
                             page_table=jnp.asarray(table))
    ct = dataclasses.replace(
        KVT.init_global_kv_cache(cfg, B, max_len, P, device="cpu"),
        page_table=t_of(table))
    kv = rng.normal(size=(2, B, S, cfg.n_kv_heads, cfg.head_dim))
    cj = KVJ.write_prefill_kv(cj, 1, jnp.asarray(kv[0], jnp.float32),
                              jnp.asarray(kv[1], jnp.float32),
                              _serve_guard("jax", policy))
    KVT.write_prefill_kv(ct, 1, t_of(kv[0], torch.float32),
                         t_of(kv[1], torch.float32),
                         _serve_guard("torch", policy))
    assert_same(ct.k[:, 1:], np_of(cj.k)[:, 1:])
    assert_same(ct.v[:, 1:], np_of(cj.v)[:, 1:])


# --------------------------------------------------------------------- #
# K3 gather_rows                                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,D,N", [(32, 8, 4), (128, 64, 32),
                                   (1024, 128, 7)])
def test_gather_rows_plain_matches_oracle_and_pallas(dtype, V, D, N):
    rng = np.random.default_rng(V + N)
    tj, tt = _both(rng.normal(size=(V, D)), dtype)
    idx = rng.integers(-V, 2 * V, size=(N,)).astype(np.int32)
    base, mask = V // 2, V // 2 - 1
    want = RJ.gather_rows_ref(tj, jnp.asarray(idx), base, mask)
    pallas = OPS.gather_rows(tj, jnp.asarray(idx), base, mask)
    got = gather_rows(tt, t_of(idx), base, mask)
    assert_same(got, want)
    assert_same(got, pallas)


@pytest.mark.parametrize("V", [250, 300, 50304 // 64])
def test_gather_rows_non_pow2_vocab_gives_nan_rows(V):
    """The serve path fences token ids with pow2(vocab), wider than a
    non-pow2 table: a fenced id past the table is a NaN row (the
    reference's jnp.take fills NaN), never an out-of-table read.  Negative
    ids wrap once; per-id fences match a per-element jnp fence."""
    rng = np.random.default_rng(V)
    D = 16
    table = rng.normal(size=(V, D)).astype(np.float32)
    fence = 1 << (V - 1).bit_length()
    idx = rng.integers(0, fence, size=(64,)).astype(np.int32)
    idx[:4] = [V, fence - 1, V - 1, 0]
    pj = {"table": jnp.asarray(table)}
    pt = {"table": t_of(table)}
    for policy in ("bitwise", "modulo"):
        gj = GSJ(policy=PJ(policy), vocab=FPJ(0, fence))
        gt = GST(policy=PT(policy), vocab=FPT(0, fence))
        want = LJ.embed_tokens(pj, jnp.asarray(idx)[None], gj)
        got = LT.embed_tokens(pt, t_of(idx)[None], gt)
        np.testing.assert_array_equal(np_of(got), np_of(want))
        assert np.isnan(np_of(got)[0, 0]).all()
        assert np.isnan(np_of(got)[0, 1]).all()
        assert not np.isnan(np_of(got)[0, 2]).any()
    # per-id fences (one extent per id) and negative ids, identity fence
    base = rng.choice([0, 64, 128], size=64).astype(np.int32)
    mask = np.full(64, 63, np.int32)
    raw = rng.integers(-2 * V, 2 * V, size=64).astype(np.int32)
    want = jnp.take(jnp.asarray(table),
                    (jnp.asarray(raw) & jnp.asarray(mask))
                    | jnp.asarray(base), axis=0)
    assert_same(gather_rows(t_of(table), t_of(raw), t_of(base), t_of(mask)),
                want)
    want = jnp.take(jnp.asarray(table), jnp.asarray(raw), axis=0)
    assert_same(gather_rows(t_of(table), t_of(raw), 0, -1), want)


# --------------------------------------------------------------------- #
# K4 flash_attention                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,D,blk", [
    (1, 128, 4, 4, 32, 128),
    (2, 256, 4, 2, 32, 128),
    (2, 64, 8, 1, 16, 32),
])
def test_flash_attention_plain_matches_oracle_and_pallas(dtype, B, S, H, KH,
                                                         D, blk):
    rng = np.random.default_rng(S + H)
    qj, qt = _both(rng.normal(size=(B, S, H, D)), dtype)
    kj, kt = _both(rng.normal(size=(B, S, KH, D)), dtype)
    vj, vt = _both(rng.normal(size=(B, S, KH, D)), dtype)
    tol = 3e-2 if dtype == "bfloat16" else TOL_F32
    want = RJ.flash_attention_ref(qj, kj, vj, causal=True)
    pallas = OPS.flash_attention(qj, kj, vj, causal=True, q_blk=blk,
                                 kv_blk=blk)
    got = flash_attention(qt, kt, vt)
    assert_close(got, want, tol)
    assert_close(got, pallas, tol)


@pytest.mark.parametrize("S", [1, 3, 57, 65])
def test_flash_attention_ragged_length_matches_chunked_attention(S):
    """Prompts are right-padded to the longest joiner, so S is arbitrary:
    no tile-multiple requirement, against the oracle and the reference's
    model-path attention."""
    rng = np.random.default_rng(S)
    qj, qt = _both(rng.normal(size=(2, S, 4, 16)), "float32")
    kj, kt = _both(rng.normal(size=(2, S, 2, 16)), "float32")
    vj, vt = _both(rng.normal(size=(2, S, 2, 16)), "float32")
    got = flash_attention(qt, kt, vt)
    assert_close(got, RJ.flash_attention_ref(qj, kj, vj), TOL_F32)
    assert_close(got, LJ.chunked_attention(qj, kj, vj, causal=True), 1e-5)


def test_wrappers_take_plain_versions_only_for_cpu_tensors():
    """On CPU tensors every wrapper counts a plain call and no launch."""
    _build.reset_counts()
    q = torch.zeros((1, 2, 2, 8))
    flash_attention(q, q, q)
    gather_rows(torch.zeros((4, 8)), torch.zeros(3, dtype=torch.int32), 0,
                3)
    pool = torch.zeros((4, 2, 2, 8))
    scatter_pages(pool, pool.clone(), torch.zeros((1, 2, 2, 8)),
                  torch.zeros((1, 2, 2, 8)),
                  torch.zeros((1, 1), dtype=torch.int32), 0, 3)
    paged_attention(torch.zeros((1, 2, 8)), pool, pool,
                    torch.zeros((1, 2), dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32), 0, 3)
    assert {k.name: (k.launches, k.plain_calls)
            for k in _build.KERNELS.values()} == {
        "flash_attention": (0, 1), "gather_rows": (0, 1),
        "scatter_pages": (0, 1), "paged_attention": (0, 1)}

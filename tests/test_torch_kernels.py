"""The plain PyTorch versions of the port's kernels (K1-K4; K5 in
``tests/test_torch_moe.py``) against the
JAX oracles (``repro.kernels.ref``) and the Pallas kernels in interpret
mode (``repro.kernels.ops``), on identical numpy inputs; plus the per-row
fences against the reference's jnp serve path.

The CUDA kernels themselves do not run in these CPU tests: on a CPU
tensor each wrapper takes its plain version, which ``chip_smoke.py``
holds every kernel against on the card."""

import ctypes
import dataclasses
import importlib
import math
import re

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
    moe_histogram, paged_attention, scatter_pages  # noqa: E402
from repro_torch.kernels import ref as RT  # noqa: E402
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


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,D,page,P_total,max_pages", [
    (2, 12, 2, 32, 16, 32, 4),           # qwen2-vl-2b's G = 6
    (2, 4, 4, 16, 16, 64, 16),           # seamless's cross view: 16 pages
])
def test_paged_attention_plain_on_a_bf16_pool_matches_oracle_and_pallas(
        q_dtype, B, H, KH, D, page, P_total, max_pages):
    """K1 over a bfloat16 pool (the model API's default cache): the plain
    version, widening the pool to float32 (the Pallas body's astype),
    against the oracle and the Pallas kernel in interpret mode on the same
    bf16 pool, for a float32 and a bfloat16 query."""
    rng = np.random.default_rng(H * 10 + max_pages)
    tol = DT[q_dtype][2]
    qj, qt = _both(rng.normal(size=(B, H, D)), q_dtype)
    kj, kt = _both(rng.normal(size=(P_total, page, KH, D)), "bfloat16")
    vj, vt = _both(rng.normal(size=(P_total, page, KH, D)), "bfloat16")
    base = np.zeros((B,), np.int32)
    mask = np.full((B,), P_total - 1, np.int32)
    pt = rng.integers(-P_total, 2 * P_total,
                      size=(B, max_pages)).astype(np.int32)
    lens = rng.integers(1, max_pages * page, size=B).astype(np.int32)
    args_j = [jnp.asarray(a) for a in (pt, lens, base, mask)]
    want = RJ.paged_attention_ref(qj, kj, vj, *args_j)
    pallas = OPS.paged_attention(qj, kj, vj, *args_j)
    got = paged_attention(qt, kt, vt, *(t_of(a) for a in (pt, lens, base,
                                                          mask)))
    assert got.dtype == DT[q_dtype][1] and got.shape == (B, H, D)
    assert_close(got, want, tol)
    assert_close(got, pallas, tol)
    # the widened pool gives the float32 pool's result bit for bit
    assert_same(got, paged_attention(qt, kt.float(), vt.float(),
                                     *(t_of(a) for a in (pt, lens, base,
                                                         mask))))


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


def _k1_cluster_algorithm(q, k_pages, v_pages, table, lens, base, mask,
                          page_map, cluster, tile=32, window=0):
    """K1's cluster algorithm (``csrc/paged_attention.cu``) in plain
    PyTorch, float32: each (sequence, KV head) splits the positions it
    walks (the held tokens — under a ``window`` > 0 only the last
    ``window`` of them — or all max_pages * page when seq_len <= 0) into
    ``cluster`` contiguous shares of ceil(n / cluster); each share runs an
    online softmax over 32-token tiles from its first position, from (m =
    -1e30, l = 0, acc = 0), and leaves its partial (m, l, acc); the
    partials merge in rank order against their largest m, and the output
    is acc / max(l, 1e-30)."""
    B, H, D = q.shape
    P, page, KH, _ = k_pages.shape
    G = H // KH
    cap = table.shape[1] * page
    phys = RT.resolve_pages(table, base[:, None], mask[:, None], page_map,
                            P).long()
    k = k_pages[phys].reshape(B, cap, KH, D).to(q.dtype).float()
    v = v_pages[phys].reshape(B, cap, KH, D).to(q.dtype).float()
    scale = float(np.float32(1.0 / math.sqrt(D)))
    neg = torch.tensor(-1e30)
    out = torch.empty((B, H, D))
    for b in range(B):
        n = int(lens[b])
        lo, hi = 0, (min(n, cap) if n > 0 else cap)
        if window > 0 and n > 0:
            lo = max(n - window, 0)
            if lo >= hi:             # the band lies past the table: all
                lo, hi = 0, cap      # masked, the uniform mean
        chunk = -(-(hi - lo) // cluster)
        for kh in range(KH):
            qg = q[b, kh * G:(kh + 1) * G].float()
            parts = []
            for r in range(cluster):
                t0 = lo + min(r * chunk, hi - lo)
                t1 = min(t0 + chunk, hi)
                m, l = torch.full((G,), -1e30), torch.zeros(G)
                acc = torch.zeros((G, D))
                for tb in range(t0, t1, tile):
                    te = min(tb + tile, t1)
                    s = (qg @ k[b, tb:te, kh].T) * scale
                    pos = torch.arange(tb, te)[None]
                    band = (pos < n) & (pos >= n - window if window > 0
                                        else True)
                    s = torch.where(band, s, neg)
                    m_new = torch.maximum(m, s.amax(1))
                    w = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + w.sum(1)
                    acc = acc * alpha[:, None] + w @ v[b, tb:te, kh]
                    m = m_new
                parts.append((m, l, acc))
            big_m = torch.stack([p[0] for p in parts]).amax(0)
            big_l, big_acc = torch.zeros(G), torch.zeros((G, D))
            for m, l, acc in parts:
                w = torch.exp(m - big_m)
                big_l = big_l + l * w
                big_acc = big_acc + acc * w[:, None]
            out[b, kh * G:(kh + 1) * G] = big_acc / big_l.clamp_min(
                1e-30)[:, None]
    return out.to(q.dtype)


#: chip_smoke's K1 coverage lengths at max_len 256 (four 64-token pages):
#: a full row, seq_len 0, page boundaries, and lengths ending inside a
#: 32-token tile and inside a cluster rank's share
K1_LENS = [256, 0, 64, 128, 100, 17, 211, 255]


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("H,KH,D", [(4, 4, 80), (32, 4, 128)])
def test_paged_attention_cluster_split_matches_plain_and_pallas(
        H, KH, D, cluster):
    """K1's split of each row over a cluster and the rank-order merge
    (modelled in plain PyTorch) give the plain version within 1e-6 in
    float32, and the Pallas kernel in interpret mode, at both main paths'
    head shapes (G = 1 / D = 80, G = 8 / D = 128): a (8, 4) table of forged
    ids over a page map, a full row, an empty row (the uniform mean over
    all positions), page-boundary and mid-share lengths; a rank whose
    share is empty (cluster 8 on a 17-token row) adds nothing."""
    rng = np.random.default_rng(D + cluster)
    B, page, P = 8, 64, 64
    qj, qt = _both(rng.normal(size=(B, H, D)), "float32")
    kj, kt = _both(rng.normal(size=(P, page, KH, D)), "float32")
    vj, vt = _both(rng.normal(size=(P, page, KH, D)), "float32")
    pmap = np.zeros(64, np.int32)
    pmap[16:32], pmap[32:48] = np.arange(1, 17), np.arange(17, 33)
    pt = rng.integers(0, 64, size=(B, 4)).astype(np.int32)
    lens = np.array(K1_LENS, np.int32)
    base = np.array([16, 16, 32, 32, 16, 32, 0, 0], np.int32)
    mask = np.array([15, 15, 15, 15, 15, 15, 3, 3], np.int32)
    args_t = [t_of(a) for a in (pt, lens, base, mask, pmap)]
    got = _k1_cluster_algorithm(qt, kt, vt, *args_t, cluster=cluster)
    assert_close(got, paged_attention(qt, kt, vt, *args_t), 1e-6)
    pallas = OPS.paged_attention(qj, kj, vj, *(jnp.asarray(a) for a in
                                               (pt, lens, base, mask, pmap)))
    assert_close(got, pallas, 1e-6)


@pytest.mark.parametrize("window", [32, 100])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_paged_attention_cluster_split_with_window_matches_plain(cluster,
                                                                 window):
    """Under a sliding window K1 walks only each row's band (the last
    ``window`` held tokens) and splits it over the cluster; modelled in
    plain PyTorch at zamba2-7b's heads (G = 1, D = 112: 28 lanes of a
    row's quads), it gives the windowed plain version within 1e-6 in
    float32 over chip_smoke's coverage lengths (the band inside a page,
    across a page boundary, past a short row's start, and an empty row's
    uniform mean)."""
    rng = np.random.default_rng(window + cluster)
    B, H, KH, D, page, P = 8, 32, 32, 112, 64, 64
    qt = t_of(rng.normal(size=(B, H, D)), torch.float32)
    kt, vt = (t_of(rng.normal(size=(P, page, KH, D)), torch.float32)
              for _ in range(2))
    pmap = np.zeros(64, np.int32)
    pmap[16:32], pmap[32:48] = np.arange(1, 17), np.arange(17, 33)
    args_t = [t_of(a) for a in (
        rng.integers(0, 64, size=(B, 4)).astype(np.int32),
        np.array(K1_LENS, np.int32),
        np.array([16, 16, 32, 32, 16, 32, 0, 0], np.int32),
        np.array([15, 15, 15, 15, 15, 15, 3, 3], np.int32), pmap)]
    got = _k1_cluster_algorithm(qt, kt, vt, *args_t, cluster=cluster,
                                window=window)
    assert_close(got, paged_attention(qt, kt, vt, *args_t, window=window),
                 1e-6)


def test_paged_attention_cluster_size_fills_the_card():
    """The cluster size is a power of two up to 8 and fills at most one
    wave of one CTA an SM: qwen3-moe's 32 (sequence, KV head) pairs on
    132 SMs take 4 CTAs each, stablelm-3b's 256 pairs one."""
    K1 = importlib.import_module("repro_torch.kernels.paged_attention")
    assert K1.cluster_size(32, 132) == 4
    assert K1.cluster_size(256, 132) == 1
    for pairs in range(1, 300):
        c = K1.cluster_size(pairs, 132)
        assert c in (1, 2, 4, 8)
        assert c == 1 or pairs * c <= 132
        assert c == 8 or pairs * 2 * c > 132


def test_paged_attention_scalar_fence_builds_no_per_row_operands(
        monkeypatch):
    """An int fence reaches K1's C entry point by value (NULL per-row
    pointers, the ints as scalars): neither ``per_id`` nor any (B,)
    operand is built for it.  A tensor fence is passed as per-row
    pointers, and both forms give the same output."""
    K1 = importlib.import_module("repro_torch.kernels.paged_attention")
    rng = np.random.default_rng(2)
    B, H, KH, D, P, page = 3, 4, 2, 8, 8, 4
    q = t_of(rng.normal(size=(B, H, D)), torch.float32)
    kp = t_of(rng.normal(size=(P, page, KH, D)), torch.float32)
    vp = t_of(rng.normal(size=(P, page, KH, D)), torch.float32)
    table = t_of(rng.integers(-20, 20, size=(B, 2)).astype(np.int32))
    lens = torch.tensor([5, 0, 8], dtype=torch.int32)
    per_row = [torch.full((B,), x, dtype=torch.int32) for x in (4, 3)]
    want = paged_attention(q, kp, vp, table, lens, *per_row)

    def refuse(*a, **kw):
        raise AssertionError("per_id called for a scalar fence")

    monkeypatch.setattr(_build, "per_id", refuse)
    base, mask = (_build.fence_operand(x, B, q.device) for x in (4, 3))
    assert (base, mask) == (4, 3)
    args = K1.launch_args(q, kp, vp, table, lens, base, mask, None,
                          torch.empty_like(q), 2)
    assert len(args) + 1 == len(K1.KERNEL.argtypes)
    assert args[5].value is None and args[6].value is None
    assert args[7:9] == [4, 3]
    assert_same(paged_attention(q, kp, vp, table, lens, 4, 3), want)
    monkeypatch.undo()
    rows = [_build.fence_operand(t, B, q.device) for t in per_row]
    args = K1.launch_args(q, kp, vp, table, lens, *rows, None,
                          torch.empty_like(q), 2)
    assert [a.value for a in args[5:7]] == [t.data_ptr() for t in rows]
    assert args[7:9] == [0, 0]


@pytest.mark.parametrize("policy,row_policy", [
    ("bitwise", None), ("modulo", None), ("check", None),
    ("bitwise", [1, 2, 3, 1])])
def test_kernel_fence_operands_give_k1_and_k2_the_fenced_pages(
        policy, row_policy):
    """Under every guard the serve path builds (BITWISE, MODULO, CHECK,
    row-mixed), the operands ``kernel_fence`` hands K1 and K2 reach
    exactly the pages ``fence_pages(spec, fence(spec, "kv", ids))``
    names: each kernel's plain version on them equals the same kernel on
    those physical pages under the identity fence.  A BITWISE guard's mask
    is computed once per guard, not once per layer."""
    GM = importlib.import_module("repro_torch.models.guard")
    guard = _serve_guard("torch", policy)
    if row_policy is not None:
        guard = dataclasses.replace(guard, row_policy=t_of(
            np.array(row_policy, np.int32)))
    rng = np.random.default_rng(len(policy))
    B, H, KH, D, P, page = 4, 4, 2, 8, 32, 4
    table = t_of(rng.integers(-40, 40, size=(B, 3)).astype(np.int32))
    phys = GM.fence_pages(guard, GM.fence(guard, "kv", table))
    ids, base, mask, pmap = GM.kernel_fence(guard, table)
    if policy == "bitwise" and row_policy is None:
        assert mask is GM.kernel_fence(guard, table)[2]
    q = t_of(rng.normal(size=(B, H, D)), torch.float32)
    kp = t_of(rng.normal(size=(P, page, KH, D)), torch.float32)
    vp = t_of(rng.normal(size=(P, page, KH, D)), torch.float32)
    lens = torch.tensor([12, 0, 7, 3], dtype=torch.int32)
    assert_same(paged_attention(q, kp, vp, ids, lens, base, mask, pmap),
                paged_attention(q, kp, vp, phys, lens, 0, -1))
    src = t_of(rng.normal(size=(2, B, 3 * page - 1, KH, D)), torch.float32)
    got = [torch.zeros((P, page, KH, D)) for _ in range(2)]
    want = [torch.zeros((P, page, KH, D)) for _ in range(2)]
    scatter_pages(*got, src[0], src[1], ids, base, mask, pmap)
    scatter_pages(*want, src[0], src[1], phys, 0, -1)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


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
    if dtype == "bfloat16":
        # mixed: bf16 pages into an f32 pool, widened on the store as the
        # Pallas kernel widens them in its body
        pallas = OPS.scatter_pages(jnp.zeros((P, page, KH, D), jnp.float32),
                                   pj, jnp.asarray(ids), base, mask)
        k_pool, v_pool = (torch.zeros((P, page, KH, D)) for _ in range(2))
        scatter_pages(k_pool, v_pool, src, -src, t_of(ids)[:, None], base,
                      mask)
        assert k_pool.dtype == torch.float32
        assert_same(k_pool, pallas)
        assert_same(v_pool, -np_of(pallas))


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
    # float32 K/V, then bfloat16 K/V (the serve path's) into the f32 pool,
    # the reference fed the same bf16 values
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        cj = KVJ.write_prefill_kv(cj, 1, jnp.asarray(kv[0], jd),
                                  jnp.asarray(kv[1], jd),
                                  _serve_guard("jax", policy))
        KVT.write_prefill_kv(ct, 1, t_of(kv[0], torch.float32).to(td),
                             t_of(kv[1], torch.float32).to(td),
                             _serve_guard("torch", policy))
        assert ct.k.dtype == torch.float32
        assert_same(ct.k[:, 1:], np_of(cj.k)[:, 1:])
        assert_same(ct.v[:, 1:], np_of(cj.v)[:, 1:])
        kv = -kv        # the bf16 write must replace the f32 one


def test_scatter_pages_launch_args_pass_ids_and_fences_in_place(
        monkeypatch):
    """K2's C arguments: an int fence by value (NULL pointer, zero strides)
    with no ``per_id`` operand built; a per-row (B,) fence as its pointer
    with strides (1, 0) and a per-id (B, n) fence with its own strides; a
    column slice of the page table as its own pointer and row stride (no
    copy); the (source, pool) dtype pair as the kernel's dtype codes."""
    K2 = importlib.import_module("repro_torch.kernels.scatter_pages")

    def refuse(*a, **kw):
        raise AssertionError("per_id called for a K2 fence")

    monkeypatch.setattr(_build, "per_id", refuse)
    B, S, page, KH, D, P = 3, 11, 4, 2, 8, 16
    k_pool, v_pool = (torch.zeros((P, page, KH, D)) for _ in range(2))
    src = torch.randn((B, S, KH, D)).to(torch.bfloat16)
    table = torch.arange(B * 5, dtype=torch.int32).reshape(B, 5) % P
    ids = table[:, :3]
    assert not ids.is_contiguous()
    base, mask = (K2.fence_view(x, B, 3, "cpu") for x in (4, 3))
    assert (base, mask) == (4, 3)
    args = K2.launch_args(k_pool, v_pool, src, -src, ids, base, mask, None, 7)
    assert len(args) + 1 == len(K2.KERNEL.argtypes)
    assert args[4].value == table.data_ptr()
    assert args[5:7] == [5, 1]
    assert args[7].value is None and args[8:11] == [0, 0, 4]
    assert args[11].value is None and args[12:15] == [0, 0, 3]
    assert args[-4:] == [_build.DTYPE_CODE[torch.bfloat16],
                         _build.DTYPE_CODE[torch.float32], 4, 7]
    scatter_pages(k_pool, v_pool, src, -src, ids, 4, 3)   # no per_id
    monkeypatch.undo()
    per_row = K2.fence_view(torch.tensor([0, 4, 8], dtype=torch.int32), B,
                            3, "cpu")
    per_id = K2.fence_view(torch.full((B, 3), 3, dtype=torch.int32), B, 3,
                           "cpu")
    args = K2.launch_args(k_pool, v_pool, src.float(), src.float(), ids,
                          per_row, per_id, None, 1)
    assert args[7].value == per_row.data_ptr() and args[8:11] == [1, 0, 0]
    assert args[11].value == per_id.data_ptr() and args[12:15] == [3, 1, 0]
    assert args[-4:-2] == [_build.DTYPE_CODE[torch.float32]] * 2
    halves = [x.to(torch.bfloat16) for x in (k_pool, v_pool, src, src)]
    assert K2.launch_args(*halves, ids, 0, -1, None, 1)[-2] == 8
    assert K2.fence_view(torch.tensor(5), B, 3, "cpu").stride() == (0, 0)


@pytest.mark.parametrize("n,S", [(1, 57), (4, 193)])
def test_scatter_pages_strided_ids_and_per_id_fences_match_per_row(n, S):
    """Ids given as a column slice of a wider page table, with per-id
    (B, n) fences that repeat each row's (base, mask) over its pages, write
    exactly what contiguous ids under per-row (B,) fences write — forged
    ids and duplicate destinations within and across rows (parked rows on
    page 0) included — and what the reference's jnp page write does."""
    rng = np.random.default_rng(S)
    B, page, KH, D, P = 8, 64, 2, 8, 64
    table = rng.integers(0, 64, size=(B, 6)).astype(np.int32)
    table[1, 0] = 45                       # forged: another tenant's id
    table[2, :n] = table[2, 0]             # duplicates within a row
    table[3, 0] = table[0, 0]              # and across rows
    base = np.array([16, 16, 32, 32, 0, 0, 0, 0], np.int32)
    mask = np.array([15, 15, 15, 15, 3, 3, 3, 3], np.int32)
    pmap = np.zeros(64, np.int32)
    pmap[16:32], pmap[32:48] = np.arange(1, 17), np.arange(17, 33)
    kv = rng.normal(size=(2, B, S, KH, D)).astype(np.float32)
    src = [t_of(x).to(torch.bfloat16) for x in kv]
    pool0 = rng.normal(size=(P, page, KH, D)).astype(np.float32)
    got = [t_of(pool0) for _ in range(2)]
    want = [t_of(pool0) for _ in range(2)]
    wide = t_of(table)
    scatter_pages(*got, *src, wide[:, :n],
                  t_of(np.repeat(base[:, None], n, 1)),
                  t_of(np.repeat(mask[:, None], n, 1)), t_of(pmap))
    scatter_pages(*want, *src, wide[:, :n].contiguous(), t_of(base),
                  t_of(mask), t_of(pmap))
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    # the reference: fence, map, clamp, then an in-order page write of the
    # zero-padded bf16 values into the f32 pool
    phys = RJ.fence_ref(jnp.asarray(table[:, :n]), jnp.asarray(base)[:, None],
                        jnp.asarray(mask)[:, None])
    phys = jnp.asarray(pmap)[phys] & (P - 1)
    for pool, x in zip(got, kv):
        pages = jnp.pad(jnp.asarray(x, jnp.bfloat16),
                        ((0, 0), (0, n * page - S), (0, 0), (0, 0)))
        ref_pool = RJ.scatter_pages_ref(
            jnp.asarray(pool0), pages.reshape(B * n, page, KH, D),
            phys.reshape(-1), 0, -1)
        assert_same(pool, ref_pool)


def _k2_block_algorithm(k_pool, v_pool, k_src, v_src, ids, base, mask,
                        page_map, group, chunks, order):
    """K2's blocks (``csrc/scatter_pages.cu``) in plain PyTorch, run in the
    given order of (chunk, id, pool): each resolves its id, stops unless no
    later id resolves to the same page, and writes its chunk's groups —
    source groups below the row's S tokens, zeros past them."""
    B, S, KH, D = k_src.shape
    P, page = k_pool.shape[:2]
    n = ids.shape[1]
    phys = RT.resolve_pages(ids, base, mask, page_map, P).reshape(-1)
    row_groups = KH * D // group
    page_groups = page * row_groups
    per_chunk = -(-page_groups // chunks)
    for c, i, which in order:
        if (phys[i + 1:] == phys[i]).any():
            continue
        b, p = divmod(i, n)
        held = max(0, min(page, S - p * page)) * row_groups
        src = (k_src, v_src)[which][b].reshape(-1)[p * page * KH * D:]
        dst = (k_pool, v_pool)[which][int(phys[i])].reshape(-1)
        for g in range(c * per_chunk, min((c + 1) * per_chunk, page_groups)):
            sl = slice(g * group, (g + 1) * group)
            dst[sl] = src[sl].to(dst.dtype) if g < held else 0


@pytest.mark.parametrize("B,n,S,KH,D,pool,n_sm", [
    (8, 1, 57, 2, 40, "float32", 132),   # stablelm-3b's row / 32
    (8, 4, 193, 4, 8, "float32", 132),   # multi-page prefill, 32 ids
    (9, 4, 200, 1, 16, "float32", 20),   # 36 ids: past one warp's match
    (3, 2, 70, 1, 16, "bfloat16", 8),    # bf16 pool: 8-element groups
])
def test_scatter_pages_block_algorithm_matches_plain(B, n, S, KH, D, pool,
                                                     n_sm):
    """K2's split of each page into ``chunks_per_page`` chunks of
    ``group_size`` groups, its source and zero groups, and its last-writer
    test give the plain version's pool exactly, with the blocks run in a
    shuffled order (the card runs them in none)."""
    K2 = importlib.import_module("repro_torch.kernels.scatter_pages")
    rng = np.random.default_rng(B * n + S)
    page, P = 64, 32
    ids = t_of(rng.integers(0, 4 * P, size=(B, n)).astype(np.int32))
    base = t_of(rng.choice([0, 8, 16], size=(B, 1)).astype(np.int32))
    mask = 7
    src = [t_of(rng.normal(size=(B, S, KH, D)), torch.bfloat16)
           for _ in range(2)]
    pool0 = t_of(rng.normal(size=(P, page, KH, D)), DT[pool][1])
    group = K2.group_size(src[0], pool0)
    assert group == (8 if pool == "bfloat16" else 4)
    chunks = K2.chunks_per_page(B * n, page * KH * D // group, n_sm)
    order = [(c, i, w) for c in range(chunks) for i in range(B * n)
             for w in (0, 1)]
    rng.shuffle(order)
    got = [pool0.clone(), pool0.clone()]
    _k2_block_algorithm(*got, *src, ids, base, mask, None, group, chunks,
                        order)
    want = [pool0.clone(), pool0.clone()]
    scatter_pages(*want, *src, ids, base, mask)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


def test_scatter_pages_chunks_cover_the_card():
    """The chunk count: at the main paths' f32 pages (8 ids, 4-element
    groups) stablelm-3b's 40,960 groups take 40 chunks (4 groups a
    thread), qwen3-moe's 8,192 take 17 (136 blocks a pool); every chunk
    gives each thread between one and UNROLL groups where the page
    allows."""
    K2 = importlib.import_module("repro_torch.kernels.scatter_pages")
    assert K2.chunks_per_page(8, 40960, 132) == 40
    assert K2.chunks_per_page(8, 8192, 132) == 17
    assert K2.chunks_per_page(32, 8192, 132) == 8
    for n_ids in (1, 8, 32, 100):
        for gpp in (1, 300, 4096, 20480, 65536):
            c = K2.chunks_per_page(n_ids, gpp, 132)
            assert c >= 1
            assert -(-gpp // c) <= K2.THREADS * K2.UNROLL
            assert c == 1 or gpp // c >= K2.THREADS or \
                c == -(-gpp // (K2.THREADS * K2.UNROLL))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,base,mask", [
    (300, 0, 511),       # pow2 fence wider than the table: NaN rows
    (256, 128, 127),     # half the table
    (300, 0, -1),        # identity: negative ids wrap, others NaN rows
])
def test_gather_rows_scalar_fence_equals_per_id_tensors(dtype, V, base,
                                                        mask):
    """A scalar fence (passed by value to the kernel, no per-id operands)
    gives exactly the rows of the same fence given as (N,) tensors, or as
    a tensor base beside a scalar mask — NaN rows and negative wraps
    included — and the JAX oracle's."""
    rng = np.random.default_rng(V + base)
    N = 64
    tj, tt = _both(rng.normal(size=(V, 16)), dtype)
    idx = rng.integers(-2 * V, 2 * V, size=(N,)).astype(np.int32)
    idx[:4] = [V, -1, -V, V - 1]
    got = gather_rows(tt, t_of(idx), base, mask)
    fenced = (idx & mask) | base
    assert np.isnan(np_of(got)[(fenced >= V) | (fenced < -V)]).all()
    assert_same(got, RJ.gather_rows_ref(tj, jnp.asarray(idx), base, mask))
    full = [torch.full((N,), x, dtype=torch.int32) for x in (base, mask)]
    assert_same(gather_rows(tt, t_of(idx), *full), got)
    assert_same(gather_rows(tt, t_of(idx), full[0], mask), got)


def test_gather_rows_scalar_fence_builds_no_per_id_operands(monkeypatch):
    """Only a tensor fence is broadcast to per-id operands."""
    def refuse(*a, **kw):
        raise AssertionError("per_id called for a scalar fence")

    table = torch.arange(32.0).reshape(8, 4)
    want = gather_rows(table, torch.tensor([1, 9, -3], dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32),
                       torch.full((3,), 7, dtype=torch.int32))
    monkeypatch.setattr(_build, "per_id", refuse)
    assert_same(gather_rows(table, torch.tensor([1, 9, -3],
                                                dtype=torch.int32), 0, 7),
                want)


# --------------------------------------------------------------------- #
# K4 flash_attention                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,D,blk", [
    (1, 128, 4, 4, 32, 128),
    (2, 256, 4, 2, 32, 128),
    (2, 64, 8, 1, 16, 32),
    # the main paths' head shapes at a ragged prefill length (one 57-row
    # block divides S for the Pallas kernel): stablelm-3b D = 80, G = 1;
    # qwen3-moe-30b-a3b D = 128, G = 8
    (1, 57, 8, 8, 80, 57),
    (1, 57, 8, 1, 128, 57),
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,D,blk", [
    (1, 128, 4, 4, 32, 128),
    (2, 64, 8, 1, 16, 32),
    # zamba2-7b's shared attention block: D = 112, G = 1
    (1, 57, 4, 4, 112, 57),
])
def test_flash_attention_non_causal_matches_oracle_and_pallas(dtype, B, S, H,
                                                              KH, D, blk):
    """K4's ``causal=False`` form (the Pallas kernel's other mode, for the
    encoder-decoder family): the plain version against the oracle's
    ``flash_attention_ref(causal=False)`` and the Pallas kernel in
    interpret mode, on the same numpy inputs."""
    rng = np.random.default_rng(S + H + 1)
    qj, qt = _both(rng.normal(size=(B, S, H, D)), dtype)
    kj, kt = _both(rng.normal(size=(B, S, KH, D)), dtype)
    vj, vt = _both(rng.normal(size=(B, S, KH, D)), dtype)
    tol = 3e-2 if dtype == "bfloat16" else TOL_F32
    got = flash_attention(qt, kt, vt, causal=False)
    assert_close(got, RJ.flash_attention_ref(qj, kj, vj, causal=False), tol)
    assert_close(got, OPS.flash_attention(qj, kj, vj, causal=False,
                                          q_blk=blk, kv_blk=blk), tol)
    assert_close(got, LJ.chunked_attention(qj, kj, vj, causal=False), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,H,KH", [
    (5, 64, 4, 4),       # a few target tokens over the encoder's frames
    (32, 100, 4, 2),     # GQA, a ragged key length
    (70, 16, 4, 4),      # more queries than keys
])
def test_flash_attention_cross_lengths_match_chunked_attention(dtype, Sq,
                                                               Skv, H, KH):
    """K4 with a key length of its own (non-causal cross-attention, the
    encoder-decoder family's): the plain version against the reference's
    ``chunked_attention(causal=False)``, which serves it."""
    rng = np.random.default_rng(Sq + Skv)
    qj, qt = _both(rng.normal(size=(2, Sq, H, 16)), dtype)
    kj, kt = _both(rng.normal(size=(2, Skv, KH, 16)), dtype)
    vj, vt = _both(rng.normal(size=(2, Skv, KH, 16)), dtype)
    tol = 3e-2 if dtype == "bfloat16" else TOL_F32
    got = flash_attention(qt, kt, vt, causal=False)
    assert got.shape == (2, Sq, H, 16) and got.dtype == DT[dtype][1]
    assert_close(got, LJ.chunked_attention(qj, kj, vj, causal=False), tol)


def test_flash_attention_causal_needs_equal_lengths():
    """Causal attention with Skv != Sq is undefined (the reference never
    asks for it): the wrapper refuses it on every device, before any
    plain call or launch; a mismatched head dim is refused too."""
    q, k = torch.zeros(1, 4, 2, 16), torch.zeros(1, 8, 2, 16)
    calls = _build.KERNELS["flash_attention"].plain_calls
    with pytest.raises(ValueError, match="causal attention needs"):
        flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k[..., :8], k[..., :8], causal=False)
    assert _build.KERNELS["flash_attention"].plain_calls == calls
    assert flash_attention(q, k, k, causal=False).shape == q.shape


def test_flash_attention_cross_backward_matches_autograd_of_plain():
    """K4's recompute backward over Skv != Sq (cross-attention, GQA groups
    of 2, with and without a window) equals autograd through
    ``ref.flash_attention_ref`` within 1e-5, and passes
    ``torch.library.opcheck`` (schema, autograd registration, fake tensor
    and AOT dispatch)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 7, 4, 16, generator=g)
    k, v = torch.randn(2, 19, 2, 16, generator=g), \
        torch.randn(2, 19, 2, 16, generator=g)
    do = torch.randn(2, 7, 4, 16, generator=g)
    for w in (0, 5):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(flash_attention(*ins, False, w), ins, do)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(RT.flash_attention_ref(*ins, False, w),
                                   ins, do)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    args = tuple(t.clone().requires_grad_() for t in (q, k, v)) + (False, 0)
    result = torch.library.opcheck(
        torch.ops.repro_torch.flash_attention.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


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


def _k4_tensor_core_algorithm(q, k, v, round_p=True):
    """K4's bfloat16 tensor-core algorithm (``csrc/flash_attention.cu``)
    in plain PyTorch, float32 out: 64-key tiles, f32 scores scaled by
    log2(e) / sqrt(D), a running max, unnormalised exp2 weights P rounded
    to bf16 (``round_p``), f32 sums of P V and of the (rounded) P, and one
    division by max(l, 1e-30) at the end."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    qf = q.float().reshape(B, S, KH, H // KH, D)
    kf, vf = k.float(), v.float()
    scale = math.log2(math.e) / math.sqrt(D)
    m = torch.full((B, KH, H // KH, S), -1e30)
    l = torch.zeros((B, KH, H // KH, S))
    o = torch.zeros((B, KH, H // KH, S, D))
    rows = torch.arange(S)
    for k0 in range(0, S, 64):
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, k0:k0 + 64]) * scale
        keys = torch.arange(k0, min(k0 + 64, S))
        s = torch.where(keys[None, :] <= rows[:, None], s,
                        torch.tensor(-1e30))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        if round_p:
            p = p.to(torch.bfloat16).float()
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                vf[:, k0:k0 + 64])
        m = mx
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


@pytest.mark.parametrize("S", [57, 193])
@pytest.mark.parametrize("H,KH,D", [(32, 32, 80), (32, 4, 128)])
def test_flash_attention_tensor_core_numerics_within_tolerance(S, H, KH, D):
    """The card's bf16 K4 rounds P to bf16 before P V; the plain version
    keeps P in f32.  Emulated at chip_smoke's shapes (B 8, one and four key
    tiles, both main paths' heads), the rounding stays within the 2e-2
    chip_smoke holds K4 to, in f32 and after the bf16 store; without the
    rounding the same algorithm matches the plain version within 1e-5, so
    the whole deviation comes from rounding P."""
    rng = np.random.default_rng(1234)
    q, k, v = (t_of(rng.normal(size=(8, S, h, D)), torch.bfloat16)
               for h in (H, KH, KH))
    want = flash_attention(q.float(), k.float(), v.float())
    tc = _k4_tensor_core_algorithm(q, k, v)
    exact_p = _k4_tensor_core_algorithm(q, k, v, round_p=False)
    err = (tc - want).abs().max().item()
    assert 1e-5 < err <= 2e-2
    assert (exact_p - want).abs().max().item() <= 1e-5
    stored = tc.to(torch.bfloat16).float()
    assert (stored - flash_attention(q, k, v).float()).abs().max() <= 2e-2


#: every kernel of the port, by the name of its source and C entry point
KERNEL_NAMES = ["flash_attention", "gather_rows", "moe_histogram",
                "paged_attention", "scatter_pages"]
#: sources built with the kernels that are no kernel: the CUDA-graph
#: conditional nodes of tenant kernels' control flow (no launch counter)
HELPER_NAMES = ["graph_nodes"]


def test_kernel_list_covers_every_source():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        KERNEL_NAMES + HELPER_NAMES)
    assert sorted(_build.KERNELS) == KERNEL_NAMES


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_ctypes_argtypes_match_the_c_entry_point(name):
    """Each wrapper's ctypes argument list matches its source's ``extern
    "C" int <name>_launch(...)`` parameter by parameter: a pointer is a
    ``c_void_p`` (64 bits) and an int a ``c_int``.  A mismatch would pass
    a pointer as a 32-bit int (or an int as a pointer) without error."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    sig = re.search(r'extern "C" int ' + name + r"_launch\(([^)]*)\)", src)
    assert sig, f"no C entry point {name}_launch"
    params = [" ".join(p.split()) for p in sig.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.split()[0] == "int" for p in params), params
    assert _build.KERNELS[name].argtypes == want


def test_graph_nodes_argtypes_match_the_c_entry_points():
    """The conditional-node helper's ctypes argument lists match its
    source's ``extern "C" int graph_nodes_*(...)`` functions parameter by
    parameter, and every such function is bound."""
    from repro_torch.kernels import graph_nodes

    src = (_build.CSRC / f"{graph_nodes.SOURCE}").read_text()
    found = dict(re.findall(r'extern "C" int (graph_nodes_\w+)\(([^)]*)\)',
                            src))

    def ctype(param):
        words = " ".join(param.split()).replace(" *", "*")
        if words.startswith("unsigned long long*"):
            return ctypes.POINTER(ctypes.c_ulonglong)
        if "**" in words:
            return ctypes.POINTER(ctypes.c_void_p)
        if "*" in words:
            return ctypes.c_void_p
        if words.startswith("unsigned long long"):
            return ctypes.c_ulonglong
        assert words.split()[0] == "int", param
        return ctypes.c_int

    assert sorted(found) == sorted(graph_nodes._SIGS)
    for name, params in found.items():
        assert graph_nodes._SIGS[name] == [
            ctype(p) for p in params.split(",")], name


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
    moe_histogram(torch.zeros((3, 2), dtype=torch.int32), 4, 0, 3)
    assert {k.name: (k.launches, k.plain_calls)
            for k in _build.KERNELS.values()} == {
        "flash_attention": (0, 1), "gather_rows": (0, 1),
        "scatter_pages": (0, 1), "paged_attention": (0, 1),
        "moe_histogram": (0, 1)}

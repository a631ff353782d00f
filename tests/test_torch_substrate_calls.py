"""The reference's substrate calls on the port against the JAX reference:
``FenceParams.is_static`` / ``from_partition`` / ``contains``, the fence
table's bounds constructors (the magic-only non-pow2 table too), its row
params, ``guarded_add``, the arena's fenced accessors under every policy,
the KV-page and state arena specs, ``full_guard``, the manager's
``fence_params_for`` and the packages' ``__all__``.  Mirrors
tests/test_fence.py's table tests bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _tenant_parity import JAX, TORCH  # noqa: E402
from _torch_parity import assert_same, np_of, t_of  # noqa: E402
from repro.core import arena as AJ  # noqa: E402
from repro.core import fence as FJ  # noqa: E402
from repro.core.partition import Partition as PartJ  # noqa: E402
from repro_torch.core import arena as AT  # noqa: E402
from repro_torch.core import fence as FT  # noqa: E402
from repro_torch.core.partition import Partition as PartT  # noqa: E402

POLICIES = ("NONE", "BITWISE", "MODULO", "CHECK")

#: a 64-slot arena of 3-wide rows, the partition [16, 32)
SLOTS, BASE, SIZE = 64, 16, 16


def _arena(seed=0):
    return np.random.default_rng(seed).normal(
        size=(SLOTS, 3)).astype(np.float32)


#: ids in the partition, out of it (in the arena: NONE's stores must stay
#: in bounds), and a run straddling the partition's end
IDS = {
    "in_range": np.array([16, 20, 31, 17], np.int32),
    "out_of_range": np.array([2, 40, 63, 33], np.int32),
    "straddling": np.array([29, 30, 31, 32, 33], np.int32),
}


def _params(policy):
    """The partition's params on both sides (MODULO by its static
    magic; its size is pow2, so BITWISE's mask holds)."""
    return (FJ.FenceParams(base=BASE, size=SIZE),
            FT.FenceParams(base=BASE, size=SIZE))


# ---------------------------------------------------------------------------
# FenceParams and FenceTable (tests/test_fence.py mirrors)
# ---------------------------------------------------------------------------

def test_fence_params_traced_vs_static():
    """A tensor bound is dynamic (no static magic); int bounds are
    static, with their mask — as the reference's traced / concrete."""
    p = FT.FenceParams(base=torch.tensor(64, dtype=torch.int32),
                       size=torch.tensor(64, dtype=torch.int32))
    assert not p.is_static
    with pytest.raises(ValueError):
        _ = p.magic
    q = FT.FenceParams(base=64, size=64)
    assert q.is_static and q.mask == 63
    pj = FJ.FenceParams(base=jnp.int32(64), size=jnp.int32(64))
    assert p.is_static == pj.is_static
    assert q.is_static == FJ.FenceParams(base=64, size=64).is_static


def test_from_partition_and_contains():
    pj = FJ.FenceParams.from_partition(PartJ("a", 32, 16))
    pt = FT.FenceParams.from_partition(PartT("a", 32, 16))
    assert (pt.base, pt.size) == (pj.base, pj.size) == (32, 16)
    for lo, hi in ((32, None), (47, None), (48, None), (31, None),
                   (32, 48), (32, 49), (40, 44), (0, 64)):
        assert pt.contains(lo, hi) == pj.contains(lo, hi), (lo, hi)


def test_fence_table_validates_pow2():
    with pytest.raises(ValueError):
        FT.FenceTable.from_bounds(base=[0, 16], size=[16, 48], device="cpu")
    tbl = FT.FenceTable.from_bounds(base=[0, 16], size=[16, 16],
                                    device="cpu")
    ref = FJ.FenceTable.from_bounds(base=[0, 16], size=[16, 16])
    assert_same(tbl.rows, ref.rows)
    np.testing.assert_array_equal(np_of(tbl.rows), [[0, 15], [16, 15]])
    assert tbl.magic is None and ref.magic is None
    with pytest.raises(ValueError):
        FT.FenceTable.from_partitions([], device="cpu")
    with pytest.raises(ValueError):
        FT.FenceTable()


def test_fence_table_rows_len_and_row_params():
    parts = [(0, 16), (16, 16), (64, 64)]
    tj = FJ.FenceTable.from_partitions(
        [PartJ(f"t{i}", b, s) for i, (b, s) in enumerate(parts)],
        with_magic=True)
    tt = FT.FenceTable.from_partitions(
        [PartT(f"t{i}", b, s) for i, (b, s) in enumerate(parts)],
        with_magic=True, device="cpu")
    assert len(tt) == len(tj) == 3
    assert_same(tt.rows, tj.rows)
    assert_same(tt.magic, tj.magic)
    ids = np.array([999, -3, 70, 17, 2 ** 31 - 1], np.int32)
    for r in range(3):
        for get in ("row_params", "magic_row_params"):
            pj, pt = getattr(tj, get)(r), getattr(tt, get)(r)
            for f in ("base", "size", "magic_m", "magic_s"):
                a, b = getattr(pj, f), getattr(pt, f)
                assert (a is None) == (b is None), (get, f)
                if a is not None:
                    assert_same(b, a)
            if get == "row_params":
                # dynamic bounds without a magic row: no MODULO on
                # either side
                for fw, p in ((FJ, pj), (FT, pt)):
                    with pytest.raises(ValueError):
                        fw.apply_fence(fw.FencePolicy.MODULO, ids, p)
            for pol in ("BITWISE", "MODULO", "CHECK"):
                if pol == ("MODULO" if get == "row_params" else "BITWISE"):
                    continue
                fj, okj = FJ.apply_fence(FJ.FencePolicy[pol],
                                         jnp.asarray(ids), pj)
                ft, okt = FT.apply_fence(FT.FencePolicy[pol], t_of(ids),
                                         pt)
                assert_same(ft, fj)
                if okj is not None:
                    assert_same(okt, okj)


def test_fence_table_magic_rows_and_mixed_gather():
    """``from_partitions(with_magic=True)`` carries the (T, 4) magic
    table; ``modulo_from_bounds`` takes non-pow2 sizes (no bitwise rows);
    its gathered params drive ``apply_fence_mixed`` per element — each
    equal to the reference's."""
    parts = [(0, 16), (16, 16)]
    tj = FJ.FenceTable.from_partitions(
        [PartJ(f"t{i}", b, s) for i, (b, s) in enumerate(parts)],
        with_magic=True)
    tt = FT.FenceTable.from_partitions(
        [PartT(f"t{i}", b, s) for i, (b, s) in enumerate(parts)],
        with_magic=True, device="cpu")
    assert tuple(tt.magic.shape) == (2, 4)
    assert_same(tt.magic, tj.magic)

    nj = FJ.FenceTable.modulo_from_bounds([0, 48, 60], [48, 12, 1])
    nt = FT.FenceTable.modulo_from_bounds([0, 48, 60], [48, 12, 1],
                                          device="cpu")
    assert nt.rows is None and len(nt) == 3
    assert_same(nt.magic, nj.magic)
    col = np.array([0, 1, 2, 1], np.int32)
    idx = np.array([100, 49, 999, 45], np.int32)
    codes = np.array([FJ.FencePolicy.MODULO.code] * 2
                     + [FJ.FencePolicy.CHECK.code] * 2, np.int32)
    fj, okj = FJ.apply_fence_mixed(jnp.asarray(codes), jnp.asarray(idx),
                                   nj.gather(jnp.asarray(col)))
    ft, okt = FT.apply_fence_mixed(t_of(codes), t_of(idx),
                                   nt.gather(t_of(col)))
    assert_same(ft, fj)
    assert_same(okt, okj)
    ft = np_of(ft)
    assert ft[0] == 100 % 48 and ft[1] == 48 + (49 - 48) % 12
    assert ft[2] == 60 and ft[3] == 48
    with pytest.raises(ValueError):
        FT.FenceTable.modulo_from_bounds([0], [0], device="cpu")
    with pytest.raises(ValueError):
        FT.FenceTable.from_bounds([0], [16], device="cpu") \
            .magic_row_params(0)


def test_modulo_fused_non_pow2_table_from_bounds():
    """A fused MODULO step over non-pow2 bounds, each side's magic table
    built by its own ``modulo_from_bounds``: the same arena bytes."""
    bounds = [(0, 48), (48, 12), (60, 3)]
    starts = [40, 55, 61]
    ref = np.arange(64, dtype=np.float32)
    base, size = [b for b, _ in bounds], [s for _, s in bounds]

    mj = JAX.manager(total_slots=64)
    mj.register_kernel("kern", JAX.kernel("bump"))
    fused = mj.scheduler._build_fused_modulo(
        mj.pointer_to_symbol["kern"], (("d", (), np.dtype("int32")),
                                       ("s", 8)), 3)
    want, _ = fused(np.asarray(ref),
                    FJ.FenceTable.modulo_from_bounds(base, size).magic,
                    *[JAX.i32(s) for s in starts])

    mt = TORCH.manager(total_slots=64)
    mt.register_kernel("kern", TORCH.kernel("bump"))
    table = FT.FenceTable.modulo_from_bounds(base, size, device="cpu")
    fused_t = mt.scheduler._build_fused_modulo(
        mt.pointer_to_symbol["kern"], (("d", (), torch.int32), ("s", 8)), 3)
    got, _ = fused_t(torch.from_numpy(ref.copy()), table.magic,
                     *[TORCH.i32(s) for s in starts])
    assert_same(got, want)


def test_from_partitions_defaults_to_the_card():
    """The table's entry point places it on ``cuda`` unless told
    otherwise, like every other entry point of the port."""
    import inspect
    sig = inspect.signature(FT.FenceTable.from_partitions)
    assert sig.parameters["device"].default == "cuda"
    for name in ("from_bounds", "modulo_from_bounds"):
        sig = inspect.signature(getattr(FT.FenceTable, name))
        assert sig.parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# guarded_add and the arena's fenced accessors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(IDS))
@pytest.mark.parametrize("policy", POLICIES)
def test_guarded_add_matches_reference(policy, case):
    """Duplicate ids sum, as the reference's ``.at[].add`` does."""
    ids = np.concatenate([IDS[case], IDS[case][:2]])
    vals = np.random.default_rng(1).normal(
        size=(ids.size, 3)).astype(np.float32)
    pj, pt = _params(policy)
    a = _arena()
    want = FJ.guarded_add(jnp.asarray(a), jnp.asarray(ids),
                          jnp.asarray(vals), pj, FJ.FencePolicy[policy])
    arena = t_of(a)
    got = FT.guarded_add(arena, t_of(ids), t_of(vals), pt,
                         FT.FencePolicy[policy])
    assert got is arena                      # in place
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", sorted(IDS))
@pytest.mark.parametrize("policy", POLICIES)
def test_arena_row_accessors_match_reference(policy, case):
    ids = IDS[case]
    vals = np.random.default_rng(2).normal(
        size=(ids.size, 3)).astype(np.float32)
    pj, pt = _params(policy)
    spec_j = AJ.ArenaSpec("a", SLOTS, (3,))
    spec_t = AT.ArenaSpec("a", SLOTS, (3,))
    aj = AJ.Arena(spec_j, jnp.asarray(_arena()))
    at = AT.Arena(spec_t, t_of(_arena()), device="cpu")
    pol_j, pol_t = FJ.FencePolicy[policy], FT.FencePolicy[policy]
    assert_same(at.read_rows(t_of(ids), pt, pol_t),
                aj.read_rows(jnp.asarray(ids), pj, pol_j))
    buf = at.buf
    aj.write_rows(jnp.asarray(ids), jnp.asarray(vals), pj, pol_j)
    at.write_rows(t_of(ids), t_of(vals), pt, pol_t)
    assert at.buf is buf                     # in place
    assert_same(at.buf, aj.buf)


#: window starts: in the partition, straddling its end (pinned inside),
#: and out of it — past the arena too, except for NONE, whose window
#: would leave the arena on both sides
STARTS = [16, 20, 30, 2, 40]
RANGE_CASES = [(p, s) for p in POLICIES
               for s in STARTS + ([] if p == "NONE" else [-5, 2 ** 31 - 1])]


@pytest.mark.parametrize("policy,start", RANGE_CASES)
def test_arena_range_accessors_match_reference(policy, start):
    """Windows of 4 rows read and written through the arena's fenced
    range accessors."""
    vals = np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32)
    pj, pt = _params(policy)
    aj = AJ.Arena(AJ.ArenaSpec("a", SLOTS, (3,)), jnp.asarray(_arena()))
    at = AT.Arena(AT.ArenaSpec("a", SLOTS, (3,)), t_of(_arena()),
                  device="cpu")
    pol_j, pol_t = FJ.FencePolicy[policy], FT.FencePolicy[policy]
    assert_same(at.read_range(start, 4, pt, pol_t),
                aj.read_range(jnp.int32(start), 4, pj, pol_j))
    aj.write_range(jnp.int32(start), jnp.asarray(vals), pj, pol_j)
    at.write_range(start, t_of(vals), pt, pol_t)
    assert_same(at.buf, aj.buf)


def test_arena_specs_and_abstract():
    for fj, ft, args in (
            (AJ.make_kv_page_arena, AT.make_kv_page_arena, (64, 16, 4, 8)),
            (AJ.make_state_arena, AT.make_state_arena, (32, 16, 8)),
            (AJ.make_flat_arena, AT.make_flat_arena, (1024,))):
        sj, st = fj(*args), ft(*args)
        assert (st.name, st.num_slots, st.slot_shape, st.shape) == \
            (sj.name, sj.num_slots, sj.slot_shape, sj.shape)
        assert st.slot_bytes == sj.slot_bytes
        assert st.total_bytes == sj.total_bytes
        ab = st.abstract()
        assert ab.device.type == "meta"
        assert tuple(ab.shape) == tuple(sj.abstract().shape)
        assert str(ab.dtype).split(".")[-1] == \
            {"bfloat16": "bfloat16", "float32": "float32"}[
                np.dtype(sj.abstract().dtype).name]
    with pytest.raises(ValueError):
        AT.make_kv_page_arena(48, 16, 4, 8)


# ---------------------------------------------------------------------------
# full_guard, fence_params_for, the packages' names
# ---------------------------------------------------------------------------

def test_full_guard_matches_reference():
    from repro.models import guard as GJ
    from repro_torch.models import guard as GT
    kw = dict(vocab_slots=512, kv_slots=8, state_slots=0, expert_slots=16,
              page_slots=4, base=0)
    for pol in POLICIES:
        gj = GJ.full_guard(FJ.FencePolicy[pol], **kw)
        gt = GT.full_guard(FT.FencePolicy[pol], **kw)
        assert gt.policy.value == gj.policy.value
        for space in ("vocab", "kv", "state", "expert", "page"):
            pj, pt = gj.params_for(space), gt.params_for(space)
            assert (pj is None) == (pt is None), space
            if pj is not None:
                assert (pt.base, pt.size) == (pj.base, pj.size)
        ids = np.array([-7, 0, 5, 600, 2 ** 31 - 1], np.int32)
        for space in ("vocab", "kv", "expert", "page"):
            assert_same(GT.fence(gt, space, t_of(ids)),
                        GJ.fence(gj, space, jnp.asarray(ids)))


def test_fence_params_for_matches_reference():
    def run(fw):
        mgr = fw.manager(total_slots=256)
        for name, n in (("a", 64), ("b", 32), ("c", 16)):
            mgr.register_tenant(name, n)
        return {t: (mgr.fence_params_for(t).base,
                    mgr.fence_params_for(t).size) for t in "abc"}
    assert run(TORCH) == run(JAX)
    mgr = TORCH.manager(total_slots=64)
    mgr.register_tenant("a", 16)
    assert mgr.fence_params_for("a").is_static


@pytest.mark.parametrize("pkg", ["core", "models", "distributed"])
def test_all_is_a_superset_of_the_reference(pkg):
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert set(ref.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name

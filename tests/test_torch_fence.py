"""The port's fence substrate against the JAX reference: int32 fences bit
for bit (negative ids and ids near +-2**31 included), fence tables, the
guard's per-row fences and the kernels' fence operands, and replays of the
same allocator and PagePool operation sequences."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_same, t_of  # noqa: E402
from repro.core import fence as FJ  # noqa: E402
from repro.core.arena import PagePool as PagePoolJ  # noqa: E402
from repro.core.partition import PartitionBoundsTable as PBTJ  # noqa: E402
from repro.models import guard as GJ  # noqa: E402
from repro_torch.core import fence as FT  # noqa: E402
from repro_torch.core.arena import PagePool as PagePoolT  # noqa: E402
from repro_torch.core.partition import PartitionBoundsTable as PBTT  # noqa
from repro_torch.kernels import ref as RT  # noqa: E402
from repro_torch.models import guard as GT  # noqa: E402

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _sweep(seed=0, n=512):
    """int32 ids: random over the whole range, small negatives, and the
    edges of the type."""
    rng = np.random.default_rng(seed)
    edges = [I32_MIN, I32_MIN + 1, -2, -1, 0, 1, 2, I32_MAX - 1, I32_MAX,
             I32_MAX - 1023, I32_MIN + 1023]
    ids = np.concatenate([
        rng.integers(I32_MIN, I32_MAX, size=n, dtype=np.int64),
        rng.integers(-4096, 4096, size=n // 4), edges])
    return ids.astype(np.int32)


# (base, size): aligned pow2 partitions, one right below 2**31
POW2_PARTS = [(0, 1), (0, 2), (4, 4), (64, 64), (1 << 20, 1 << 20),
              ((1 << 30) + (1 << 29), 1 << 29)]
# arbitrary partitions for MODULO / CHECK (non-pow2, unaligned)
ANY_PARTS = POW2_PARTS + [(3, 5), (100, 7), (1, 1), (12345, 6789),
                          (I32_MAX - 10, 10)]


@pytest.mark.parametrize("base,size", POW2_PARTS)
def test_fence_bitwise_bit_identical(base, size):
    ids = _sweep(size)
    want = FJ.fence_bitwise(jnp.asarray(ids), base, size - 1)
    assert_same(FT.fence_bitwise(t_of(ids), base, size - 1), want)
    # the fence of the kernels' plain versions (and of the CUDA kernels)
    assert_same(RT.fence_ref(t_of(ids), base, size - 1), want)


@pytest.mark.parametrize("base,size", ANY_PARTS)
def test_fence_modulo_forms_bit_identical(base, size):
    """Plain, static-magic and dynamic-magic MODULO: the ``idx - base``
    int32 wrap and the ``& 0x7FFFFFFF`` step match the reference."""
    ids = _sweep(base % 97)
    j, t = jnp.asarray(ids), t_of(ids)
    assert_same(FT.fence_modulo(t, base, size),
                FJ.fence_modulo(j, base, size))
    m, s = FJ.magic_constants(size)
    assert (m, s) == FT.magic_constants(size)
    assert FJ.magic_row(size) == FT.magic_row(size)
    assert_same(FT.fence_modulo_magic(t, base, size, m, s),
                FJ.fence_modulo_magic(j, base, size, m, s))
    mr, sr = FJ.magic_row(size)
    m32 = np.array([mr], np.uint32).view(np.int32)[0]
    assert_same(FT.fence_modulo_magic_dyn(t, base, size, int(m32), sr),
                FJ.fence_modulo_magic_dyn(j, base, size, jnp.int32(m32),
                                          jnp.int32(sr)))


@pytest.mark.parametrize("base,size", ANY_PARTS)
def test_fence_check_bit_identical(base, size):
    ids = _sweep(size % 13)
    sj, okj = FJ.fence_check(jnp.asarray(ids), base, size)
    st_, okt = FT.fence_check(t_of(ids), base, size)
    assert_same(st_, sj)
    assert_same(okt, okj)


@pytest.mark.parametrize("policy", ["bitwise", "modulo", "check", "none"])
def test_apply_fence_static_params(policy):
    ids = _sweep(7)
    pj, pt = FJ.FencePolicy(policy), FT.FencePolicy(policy)
    for base, size in POW2_PARTS:
        fj, okj = FJ.apply_fence(pj, jnp.asarray(ids),
                                 FJ.FenceParams(base, size))
        ft, okt = FT.apply_fence(pt, t_of(ids), FT.FenceParams(base, size))
        assert_same(ft, fj)
        assert (okj is None) == (okt is None)
        if okj is not None:
            assert_same(okt, okj)


def _tables(parts):
    from repro.core.partition import Partition as PJ
    from repro_torch.core.partition import Partition as PT
    tj = FJ.FenceTable.from_partitions(
        [PJ(f"t{i}", b, s) for i, (b, s) in enumerate(parts)],
        with_magic=True)
    tt = FT.FenceTable.from_partitions(
        [PT(f"t{i}", b, s) for i, (b, s) in enumerate(parts)],
        with_magic=True, device="cpu")
    return tj, tt


def test_fence_table_rows_and_mixed_policy_gather():
    """Per-row params gathered through a tenant-id column, and the
    row-mixed policy dispatch over them, match the reference."""
    parts = [(0, 4), (4, 4), (8, 8), (16, 16), (64, 64)]
    tj, tt = _tables(parts)
    assert_same(tt.rows, tj.rows)
    assert_same(tt.magic, tj.magic)
    rng = np.random.default_rng(3)
    cols = rng.integers(0, len(parts), size=256).astype(np.int32)
    codes = rng.integers(0, 4, size=256).astype(np.int32)
    ids = _sweep(11, n=256)[:256]
    pj, pt = tj.gather(jnp.asarray(cols)), tt.gather(t_of(cols))
    for name in ("base", "size", "magic_m", "magic_s"):
        assert_same(getattr(pt, name), getattr(pj, name))
    fj, okj = FJ.apply_fence_mixed(jnp.asarray(codes), jnp.asarray(ids), pj)
    ft, okt = FT.apply_fence_mixed(t_of(codes), t_of(ids), pt)
    assert_same(ft, fj)
    assert_same(okt, okj)
    for policy in ("bitwise", "modulo", "check"):
        fj, _ = FJ.apply_fence(FJ.FencePolicy(policy), jnp.asarray(ids), pj)
        ft, _ = FT.apply_fence(FT.FencePolicy(policy), t_of(ids), pt)
        assert_same(ft, fj)


def _guards(policy, row_policy=None):
    """The same per-row serve guard (kv extents of three tenants + scratch,
    a page map over 32 virtual pages into a 16-page pool) in both
    frameworks."""
    parts = [(0, 4), (8, 8), (16, 8), (24, 8)]
    tj, tt = _tables(parts)
    cols = np.array([1, 2, 3, 0, 1, 2], np.int32)
    pmap = np.zeros((32,), np.int32)
    pmap[8:16] = np.arange(1, 9)
    pmap[16:24] = np.arange(9, 17) % 16
    pmap[24:32] = np.arange(3, 11)
    rp = None if row_policy is None else np.asarray(row_policy, np.int32)
    gj = GJ.GuardSpec(
        policy=FJ.FencePolicy(policy), vocab=FJ.FenceParams(0, 256),
        kv=tj.gather(jnp.asarray(cols)), page=FJ.FenceParams(0, 16),
        row_policy=None if rp is None else jnp.asarray(rp),
        page_map=jnp.asarray(pmap))
    gt = GT.GuardSpec(
        policy=FT.FencePolicy(policy), vocab=FT.FenceParams(0, 256),
        kv=tt.gather(t_of(cols)), page=FT.FenceParams(0, 16),
        row_policy=None if rp is None else t_of(rp),
        page_map=t_of(pmap))
    return gj, gt


GUARD_CASES = [("bitwise", None), ("modulo", None), ("check", None),
               ("bitwise", [1, 2, 3, 1, 2, 3])]


@pytest.mark.parametrize("policy,row_policy", GUARD_CASES)
def test_guard_fences_and_kernel_operands(policy, row_policy):
    """``fence`` / ``fence_pages`` match the reference per row, and the
    (ids, base, mask, page_map) operands the page kernels take resolve to
    exactly those physical pages."""
    gj, gt = _guards(policy, row_policy)
    rng = np.random.default_rng(5)
    table = rng.integers(-100, 100, size=(6, 4)).astype(np.int32)
    table[0, 0], table[1, 1] = I32_MAX, I32_MIN
    vj = GJ.fence(gj, "kv", jnp.asarray(table))
    vt = GT.fence(gt, "kv", t_of(table))
    assert_same(vt, vj)
    pj = GJ.fence_pages(gj, vj)
    assert_same(GT.fence_pages(gt, vt), pj)
    ids, base, mask, pmap = GT.kernel_fence(gt, t_of(table))

    def per_row(v):
        return v[:, None] if isinstance(v, torch.Tensor) and v.dim() == 1 \
            else v

    assert_same(RT.resolve_pages(ids, per_row(base), per_row(mask), pmap,
                                 16), pj)
    toks = rng.integers(-300, 600, size=(6, 3)).astype(np.int32)
    assert_same(GT.fence(gt, "vocab", t_of(toks)),
                GJ.fence(gj, "vocab", jnp.asarray(toks)))


def test_partition_table_replay():
    """The same create / grow / shrink / destroy sequence lands every
    tenant on the same partitions."""
    ops = [("create", "a", 4), ("create", "b", 16), ("create", "c", 3),
           ("grow", "a", 0), ("destroy", "b", 0), ("create", "d", 8),
           ("shrink", "c", 1), ("create", "e", 32), ("grow", "d", 0),
           ("destroy", "a", 0), ("create", "f", 2)]
    tj, tt = PBTJ(128), PBTT(128)
    for op, name, n in ops:
        for tab in (tj, tt):
            if op == "create":
                tab.create(name, n)
            elif op == "grow":
                tab.grow(name)
            elif op == "shrink":
                tab.shrink(name, n)
            else:
                tab.destroy(name)
        assert sorted(tj.tenants()) == sorted(tt.tenants())
        for t in tj.tenants():
            pj, pt = tj.lookup(t), tt.lookup(t)
            assert (pj.base, pj.size) == (pt.base, pt.size)
        assert tj.free_slots() == tt.free_slots()
    for k, v in tj.bounds_arrays().items():
        np.testing.assert_array_equal(v, tt.bounds_arrays()[k])


def test_page_pool_replay():
    """The same bind / grow / shrink / rebase / release sequence gives the
    same page maps and free lists; physical page 0 is never handed out."""
    ops = [("bind", "a", 0, 4), ("bind", "b", 8, 8), ("bind", "a", 0, 8),
           ("shrink", "b", 0, 4), ("rebase", "a", 16, 0),
           ("release", "b", 0, 0), ("bind", "c", 0, 8),
           ("rebase", "c", 24, 0), ("bind", "c", 24, 8)]
    pj, pt = PagePoolJ(32, 32), PagePoolT(32, 32)
    for op, name, base, size in ops:
        for pool in (pj, pt):
            if op == "bind":
                pool.bind_extent(name, base, size)
            elif op == "shrink":
                pool.shrink_extent(name, size)
            elif op == "rebase":
                pool.rebase_extent(name, base)
            else:
                pool.release_extent(name)
        np.testing.assert_array_equal(pj.page_map, pt.page_map)
        assert pj._free == pt._free
        assert pj.extent_of(name) == pt.extent_of(name)
    assert 0 not in set(pt.page_map[pt.page_map != 0].tolist())
    assert pt.occupancy() == pj.occupancy()

"""The port's elastic partitions and pressure tracker against the
reference's: the mirrors of tests/test_elastic.py (core/elastic.py and
core/pressure.py).  The allocator and tracker units feed the same calls
(and the same Hypothesis draws) to both packages and compare what they
return; every manager scenario runs on the reference and on the port
(the CPU, launches compiled and eager) with the tenant kernel in jnp and
in torch, and holds the elastic manager's events and stats, the bounds
table, the waitlist, admission states, the tenants' data read back
through their (translated) handles and the arena bytes equal field by
field, besides the reference test's own assertions on the port's run.
The serving cases run the port's engines on the reference's weights.

The port runs its relocation steps eagerly (``capture=False``), so
``test_launch_with_pre_move_ptr_lands_in_new_extent`` matters most with
compiled launches: a launch keyed before the move must land in the new
extent after it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from _plane_parity import CFG_J, JAX, SERVE_REF, SERVE_SIDES, SIDES, \
    arena_bytes, elastic_view, module, on_both, to_np  # noqa: E402
from _tenant_parity import assert_same_tree  # noqa: E402
from repro.launch import steps as STJ  # noqa: E402
from repro_torch.launch import steps as STT  # noqa: E402

PORT = SIDES["compiled"]
SIDE = pytest.mark.parametrize("side", sorted(SIDES))


def _units(fn):
    """``fn(fw)`` on both packages (no manager, nothing to compile)."""
    return fn(JAX), fn(PORT)


def _f32(n, v):
    return np.full(n, v, np.float32)


def _read(client, p, n):
    return to_np(client.memcpy_d2h(p, n)).copy()


def _state(mgr, t):
    s = mgr.elastic.state_of(t)
    return None if s is None else s.name


# ---------------------------------------------------------------------------
# Buddy/bounds elastic primitives
# ---------------------------------------------------------------------------

def _buddy_grow(fw):
    alloc = module(fw, "partition").BuddyAllocator(64)
    a, _ = alloc.alloc(16)
    b, _ = alloc.alloc(16)
    out = [alloc.grow_in_place(a)]
    alloc.free(b)
    out += [alloc.grow_in_place(a), alloc.grow_in_place(a),
            alloc.grow_in_place(a)]
    alloc.free(a)
    return out + [alloc.free_slots()]


def _buddy_misaligned(fw):
    alloc = module(fw, "partition").BuddyAllocator(64)
    alloc.alloc(16)
    b, _ = alloc.alloc(16)
    return [alloc.grow_in_place(b), alloc._allocated[b]]


def _buddy_shrink(fw):
    alloc = module(fw, "partition").BuddyAllocator(64)
    a, _ = alloc.alloc(32)
    out = [alloc.shrink_in_place(a, 8), alloc.free_slots()]
    return out + [alloc.alloc(16), alloc.largest_free_block()]


def _buddy_peek(fw):
    alloc = module(fw, "partition").BuddyAllocator(64)
    a, _ = alloc.alloc(16)
    alloc.alloc(8)
    alloc.free(a)
    out = []
    for size in (4, 8, 16, 32):
        peek = alloc.peek_alloc(size)
        base, _ = alloc.alloc(size)
        out.append((peek, base))
        alloc.free(base)
    return out + [alloc.peek_alloc(128)]


BUDDY = {"grow_in_place_requires_free_aligned_buddy": _buddy_grow,
         "grow_refuses_misaligned_base": _buddy_misaligned,
         "shrink_in_place_frees_upper_buddies": _buddy_shrink,
         "peek_alloc_mirrors_alloc_choice": _buddy_peek}


@pytest.mark.parametrize("case", sorted(BUDDY))
def test_buddy_units(case):
    """Mirrors test_buddy_grow_in_place_requires_free_aligned_buddy,
    test_buddy_grow_refuses_misaligned_base,
    test_buddy_shrink_in_place_frees_upper_buddies and
    test_buddy_peek_alloc_mirrors_alloc_choice: the port's buddy
    allocator returns the reference's bases, sizes and refusals."""
    ref, got = _units(BUDDY[case])
    want = {"grow_in_place_requires_free_aligned_buddy":
            [None, 32, 64, None, 64],
            "grow_refuses_misaligned_base": [None, 4],
            "shrink_in_place_frees_upper_buddies": [8, 56, (16, 16), 32]}
    if case in want:
        assert got == want[case]
    else:
        assert all(p == b for p, b in got[:-1]) and got[-1] is None
    assert_same_tree(ref, got)


def test_bounds_grow_shrink_relocate_preserve_invariants():
    """Mirrors test_bounds_grow_shrink_relocate_preserve_invariants: the
    bounds table's grow / shrink / relocate give the reference's
    partitions (pow2 sizes at size-aligned bases)."""
    def run(fw):
        table = module(fw, "partition").PartitionBoundsTable(256)
        table.create("a", 16)
        table.create("b", 16)
        out = [table.grow("a")]
        new = table.grow("b")
        out.append(None if new is None else (new.base, new.size))
        shrunk = table.shrink("a", 4)
        out.append((shrunk.base, shrunk.size))
        old, moved = table.relocate("a", 8)
        out += [(old.base, old.size), (moved.base, moved.size)]
        table.release_old(old)
        out.append(table.lookup("a") is moved)
        return out
    ref, got = _units(run)
    assert got[0] is None and got[2] == (0, 4) and got[3][0] == 0
    assert got[4][1] == 8 and got[4][0] % 8 == 0 and got[5]
    assert_same_tree(ref, got)


def _repack(fw, allocs, frees):
    P = module(fw, "partition")
    part = P.Partition(tenant_id="t", base=0, size=64)
    sub = P.IntraPartitionAllocator(part)
    ptrs = [sub.alloc(n) for n in allocs]
    for i in frees:
        sub.free(ptrs[i])
    plan = sub.repack_plan()
    sub.commit_repack(sub.part, plan)
    total = sum(n for i, n in enumerate(allocs) if i not in frees)
    span = sub.live_span()
    tail = sub.alloc(64 - total) if total < 64 else None
    return {"plan": [tuple(m) for m in plan], "span": span, "tail": tail,
            "total": total}


def _check_repack(allocs, frees):
    ref, got = _units(lambda fw: _repack(fw, allocs, frees))
    prev = -1
    for old, new, _ in got["plan"]:
        assert new <= old and new > prev
        prev = new
    assert got["span"] == got["total"]
    if got["total"] < 64:
        assert got["tail"] == got["total"]
    assert_same_tree(ref, got)


def test_repack_plan_sweep():
    """Mirrors test_repack_plan_sweep: five cases; the port's plans are
    the reference's, ascending and packing downward."""
    for allocs, frees in [((8, 8, 8), (1,)), ((4, 4, 4, 4), (0, 2)),
                          ((16, 8, 4), ()), ((2, 2, 2, 2, 2), (0, 1, 3)),
                          ((10, 6, 10), (1,))]:
        _check_repack(allocs, frees)


@settings(max_examples=30, deadline=None)
@given(allocs=st.lists(st.integers(min_value=1, max_value=8), min_size=1,
                       max_size=6),
       seed=st.integers(min_value=0, max_value=2**16))
def test_repack_plan_property(allocs, seed):
    """Mirrors test_repack_plan_property: the same drawn allocations and
    frees on both."""
    if sum(allocs) > 64:
        return
    rng = np.random.default_rng(seed)
    k = int(rng.integers(0, len(allocs) + 1))
    frees = tuple(sorted(rng.choice(len(allocs), size=k,
                                    replace=False).tolist()))
    _check_repack(tuple(allocs), frees)


# ---------------------------------------------------------------------------
# Pressure substrate
# ---------------------------------------------------------------------------

def _ewma(fw):
    ew = fw.core.Ewma(alpha=0.5)
    return [ew.update(4.0), ew.update(0.0), ew.update(2.0)]


def _samples(samples):
    return sorted((s.tenant_id, s.live, s.size, s.utilization,
                   s.shrinkable, s.failures) for s in samples)


def _tracker_gate(fw):
    tr = fw.core.PressureTracker()
    out = [_samples(tr.sample(lambda t: None))]
    tr.note_alloc("a")
    tr.observe("srv", 3, 8)
    out.append(_samples(tr.sample(
        lambda t: (4, 16) if t == "a" else None)))
    out += [tr.dirty, _samples(tr.sample(lambda t: (4, 16)))]
    return out


def _tracker_failures(fw):
    tr = fw.core.PressureTracker()
    tr.note_failure("a")
    out = [_samples(tr.sample(lambda t: (16, 16)))]
    tr.note_alloc("a")
    return out + [_samples(tr.sample(lambda t: (16, 16)))]


PRESSURE = {"ewma_seeds_then_smooths": _ewma,
            "pressure_tracker_dirty_gate_and_shrinkability": _tracker_gate,
            "pressure_failures_reported_once": _tracker_failures}


@pytest.mark.parametrize("case", sorted(PRESSURE))
def test_pressure_units(case):
    """Mirrors test_ewma_seeds_then_smooths,
    test_pressure_tracker_dirty_gate_and_shrinkability and
    test_pressure_failures_reported_once (core/pressure.py): the port's
    EWMA and tracker give the reference's samples."""
    ref, got = _units(PRESSURE[case])
    if case.startswith("ewma"):
        assert got == [4.0, 2.0, 2.0]
    elif case.endswith("shrinkability"):
        rows = {r[0]: r for r in got[1]}
        assert got[0] == [] and rows["a"][3] == 0.25 and rows["a"][4]
        assert not rows["srv"][4] and rows["srv"][1:3] == (3, 8)
        assert not got[2] and got[3] == []
    else:
        assert got[0][0][5] == 1 and got[1][0][5] == 0
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# Admission control + waitlist
# ---------------------------------------------------------------------------

@SIDE
def test_admit_waitlists_instead_of_failing_and_readmits_on_departure(side):
    """Mirrors the reference's
    test_admit_waitlists_instead_of_failing_and_readmits_on_departure: a
    full arena waitlists, a departure admits."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        adm = [mgr.elastic.admit(t, n) for t, n in (("a", 32), ("b", 32),
                                                     ("c", 16))]
        trail = [[a.status.name for a in adm], adm[2].client is None,
                 _state(mgr, "c")]
        mgr.remove_tenant("b")
        trail += [adm[2].status.name, adm[2].client is not None,
                  _state(mgr, "c"), mgr.bounds.lookup("c").size]
        return {"trail": trail, "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["trail"] == [["ADMITTED", "ADMITTED", "WAITLISTED"], True,
                            "WAITLISTED", "ADMITTED", True, "ACTIVE", 16]
    assert_same_tree(ref, got)


@SIDE
def test_waitlist_backfill_fills_holes_the_head_cannot_use(side):
    """Mirrors test_waitlist_backfill_fills_holes_the_head_cannot_use: a
    small tenant backfills a hole the waitlist's head cannot use; the
    head claims the next departure."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        mgr.elastic.admit("a", 32)
        mgr.elastic.admit("b", 16)
        big = mgr.elastic.admit("big", 32)
        small = mgr.elastic.admit("small", 8)
        trail = [big.status.name, small.status.name]
        mgr.remove_tenant("a")
        trail += [big.status.name, mgr.bounds.lookup("big").size]
        return {"trail": trail, "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["trail"] == ["WAITLISTED", "ADMITTED", "ADMITTED", 32]
    assert_same_tree(ref, got)


@SIDE
def test_quarantine_eviction_triggers_waitlist_readmission(side):
    """Mirrors test_quarantine_eviction_triggers_waitlist_readmission:
    quarantine keeps the partition, eviction frees it for the waitlist."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        mgr.elastic.admit("good", 32)
        rogue = mgr.elastic.admit("rogue", 32)
        waiting = mgr.elastic.admit("waiting", 32)
        trail = [rogue.status.name, waiting.status.name]
        mgr.quarantine.quarantine("rogue", reason="test")
        trail.append(waiting.status.name)
        mgr.quarantine.evict("rogue")
        trail.append(waiting.status.name)
        return {"trail": trail, "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["trail"] == ["ADMITTED", "WAITLISTED", "WAITLISTED",
                            "ADMITTED"]
    assert_same_tree(ref, got)


@SIDE
def test_admission_shrinks_idle_reservations_below_low_watermark(side):
    """Mirrors the reference's
    test_admission_shrinks_idle_reservations_below_low_watermark: after a
    poll, admission shrinks an idle reservation and the idle tenant's data
    survives."""
    def run(fw):
        mgr = fw.manager(total_slots=64, elastic_policy=fw.core
                         .ElasticPolicy(min_slots=4, low_watermark=0.25))
        idle = mgr.elastic.admit("idle", 32)
        mgr.elastic.admit("busy", 32)
        p = idle.client.malloc(2)
        idle.client.memcpy_h2d(p, _f32(2, 5.0))
        idle.client.synchronize()
        mgr.elastic.poll()
        adm = mgr.elastic.admit("newcomer", 16)
        return {"status": adm.status.name, "data": _read(idle.client, p, 2),
                "elastic": elastic_view(mgr), "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    assert got["status"] == "ADMITTED"
    assert got["elastic"]["bounds"]["idle"][1] < 32
    np.testing.assert_array_equal(got["data"], _f32(2, 5.0))
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# Live grow/shrink + pointer translation
# ---------------------------------------------------------------------------

@SIDE
def test_malloc_grows_partition_on_failure_and_old_ptrs_survive(side):
    """Mirrors the reference's
    test_malloc_grows_partition_on_failure_and_old_ptrs_survive: a malloc
    past the partition grows it (a relocation) and a handle minted before
    the move still reads its data."""
    def run(fw):
        mgr = fw.manager(total_slots=128, elastic_policy=fw.core
                         .ElasticPolicy(grow_on_failure=True))
        a = mgr.register_tenant("a", 16)
        mgr.register_tenant("b", 16)
        p1 = a.malloc(12)
        a.memcpy_h2d(p1, np.arange(12, dtype=np.float32))
        a.synchronize()
        p2 = a.malloc(10)
        size = mgr.bounds.lookup("a").size
        a.memcpy_h2d(p2, _f32(10, 7.0))
        return {"size": size, "p1": _read(a, p1, 12), "p2": _read(a, p2, 10),
                "elastic": elastic_view(mgr), "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    assert got["size"] == 32
    np.testing.assert_array_equal(got["p1"], np.arange(12, dtype=np.float32))
    np.testing.assert_array_equal(got["p2"], _f32(10, 7.0))
    assert_same_tree(ref, got)


@SIDE
def test_launch_with_pre_move_ptr_lands_in_new_extent(side):
    """Mirrors test_launch_with_pre_move_ptr_lands_in_new_extent: after a
    relocation a launch through a handle minted before it writes the new
    extent — with the launch's key compiled before the move too."""
    def run(fw):
        mgr = fw.manager(total_slots=128)
        a = mgr.register_tenant("a", 16)
        mgr.register_tenant("b", 16)
        a.module_load("bump", fw.kernel("bump"))
        p = a.malloc(4)
        a.memcpy_h2d(p, np.zeros(4, np.float32))
        a.launch_kernel("bump", ptrs=[p], args=(4,))
        a.synchronize()
        mgr.elastic.relocate("a", 16)
        a.launch_kernel("bump", ptrs=[p], args=(4,))
        a.synchronize()
        part = mgr.bounds.lookup("a")
        own = to_np(mgr.arena.unsafe_read_range(part.base, part.size))
        return {"data": _read(a, p, 4), "own": own.copy(),
                "elastic": elastic_view(mgr), "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    np.testing.assert_array_equal(got["data"], _f32(4, 2.0))
    assert (got["own"] == 2.0).sum() == 4
    assert_same_tree(ref, got)


@SIDE
def test_malloc_raises_by_default_without_grow_opt_in(side):
    """Mirrors test_malloc_raises_by_default_without_grow_opt_in."""
    def run(fw):
        mgr = fw.manager(total_slots=128)
        a = mgr.register_tenant("a", 16)
        a.malloc(16)
        with pytest.raises(fw.core.OutOfArenaMemory):
            a.malloc(1)
        return elastic_view(mgr)
    ref, got = on_both(side, run)
    assert got["bounds"]["a"][1] == 16
    assert_same_tree(ref, got)


@SIDE
def test_ptr_epochs_prevent_reused_address_aliasing(side):
    """Mirrors test_ptr_epochs_prevent_reused_address_aliasing: a fresh
    handle at a moved handle's minted address reaches its own storage."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        a = mgr.register_tenant("a", 16)
        mgr.register_tenant("b", 16)
        x, y = a.malloc(4), a.malloc(4)
        a.memcpy_h2d(y, _f32(4, 2.0))
        a.synchronize()
        a.free(x)
        mgr.elastic.shrink("a", 8)
        z = a.malloc(4)
        a.memcpy_h2d(z, _f32(4, 9.0))
        return {"handles": [(h.addr, h.epoch) for h in (y, z)],
                "y": _read(a, y, 4), "z": _read(a, z, 4),
                "elastic": elastic_view(mgr), "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    (ya, ye), (za, ze) = got["handles"]
    assert za == ya and ze != ye
    np.testing.assert_array_equal(got["y"], _f32(4, 2.0))
    np.testing.assert_array_equal(got["z"], _f32(4, 9.0))
    assert_same_tree(ref, got)


@SIDE
def test_auto_resize_poll_grows_under_pressure_and_shrinks_idle(side):
    """Mirrors the reference's
    test_auto_resize_poll_grows_under_pressure_and_shrinks_idle: the poll
    grows a full partition and halves an idle one down to the fixpoint 16;
    the data survives."""
    def run(fw):
        mgr = fw.manager(total_slots=256, elastic_policy=fw.core
                         .ElasticPolicy(auto_resize=True, min_slots=8,
                                        high_watermark=0.85,
                                        low_watermark=0.25))
        a = mgr.register_tenant("a", 32)
        mgr.register_tenant("b", 32)
        ptrs = [a.malloc(8) for _ in range(4)]
        for _ in range(3):
            mgr.elastic.poll()
            mgr.elastic.pressure.note_alloc("a")
        grown = mgr.bounds.lookup("a").size
        for p in ptrs[1:]:
            a.free(p)
        for _ in range(8):
            mgr.elastic.poll()
            mgr.elastic.pressure.note_free("a")
        return {"grown": grown, "data": _read(a, ptrs[0], 8),
                "elastic": elastic_view(mgr), "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    assert got["grown"] > 32 and got["elastic"]["bounds"]["a"][1] == 16
    np.testing.assert_array_equal(got["data"], np.zeros(8, np.float32))
    assert_same_tree(ref, got)


@SIDE
def test_resize_refused_while_tenant_has_queued_work(side):
    """Mirrors test_resize_refused_while_tenant_has_queued_work."""
    def run(fw):
        mgr = fw.manager(total_slots=128)
        a = mgr.register_tenant("a", 16)
        mgr.register_tenant("b", 16)
        a.module_load("bump", fw.kernel("bump"))
        p = a.malloc(4)
        a.memcpy_h2d(p, np.zeros(4, np.float32))
        with pytest.raises(fw.core.ElasticError):
            mgr.elastic.relocate("a", 32)
        a.synchronize()
        return {"size": mgr.elastic.relocate("a", 32).size,
                "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["size"] == 32
    assert_same_tree(ref, got)


@SIDE
def test_grow_in_place_never_needs_idle_tenant(side):
    """Mirrors test_grow_in_place_never_needs_idle_tenant: an in-place
    grow with work queued keeps the base; the queued write lands."""
    def run(fw):
        mgr = fw.manager(total_slots=128)
        a = mgr.register_tenant("a", 16)
        a.module_load("bump", fw.kernel("bump"))
        p = a.malloc(4)
        a.memcpy_h2d(p, np.zeros(4, np.float32))
        new = mgr.elastic.grow("a")
        a.synchronize()
        return {"new": (new.base, new.size), "data": _read(a, p, 4),
                "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["new"] == (0, 32)
    np.testing.assert_array_equal(got["data"], np.zeros(4, np.float32))
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# Compaction churn proof
# ---------------------------------------------------------------------------

@SIDE
def test_churn_compaction_admits_after_reject_raw_launch_plane(side):
    """Mirrors test_churn_compaction_admits_after_reject_raw_launch_plane:
    the fragmented arena refuses a static register, one compaction pass
    admits it, and the survivors' data equals a run without compaction."""
    def run(fw):
        out = {}
        for compaction in (True, False):
            mgr = fw.manager(total_slots=64)
            clients = {}
            for t, n in (("a", 16), ("b", 16), ("c", 16)):
                clients[t] = mgr.elastic.admit(t, n).client
                clients[t].module_load("bump", fw.kernel("bump"))
            ptrs = {}
            for i, (t, c) in enumerate(clients.items()):
                ptrs[t] = c.malloc(8)
                c.memcpy_h2d(ptrs[t], _f32(8, float(i + 1)))
                c.launch_kernel("bump", ptrs=[ptrs[t]], args=(8,))
            mgr.synchronize()
            mgr.remove_tenant("b")
            del clients["b"], ptrs["b"]
            status = None
            if compaction:
                with pytest.raises(fw.core.OutOfArenaMemory):
                    mgr.bounds.create("d", 32)
                status = mgr.elastic.admit("d", 32).status.name
            out[compaction] = {
                "status": status, "elastic": elastic_view(mgr),
                "data": {t: _read(c, ptrs[t], 8)
                         for t, c in clients.items()}}
        return out
    ref, got = on_both(side, run)
    assert got[True]["status"] == "ADMITTED"
    assert got[True]["elastic"]["stats"]["compactions"] >= 1
    for t, v in (("a", 2.0), ("c", 4.0)):
        np.testing.assert_array_equal(got[True]["data"][t], _f32(8, v))
        np.testing.assert_array_equal(got[False]["data"][t], _f32(8, v))
    assert_same_tree(ref, got)


@SIDE
def test_compaction_scrubs_vacated_extents(side):
    """Mirrors test_compaction_scrubs_vacated_extents: compaction moves
    "c" down and hands its old extent back zeroed."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        mgr.elastic.admit("a", 16)
        mgr.elastic.admit("b", 16)
        c = mgr.elastic.admit("c", 16).client
        pc = c.malloc(16)
        c.memcpy_h2d(pc, _f32(16, 9.0))
        c.synchronize()
        mgr.remove_tenant("b")
        old = mgr.bounds.lookup("c")
        moved = mgr.elastic.compact()
        new = mgr.bounds.lookup("c")
        left = to_np(mgr.arena.unsafe_read_range(old.base, old.size))
        return {"moved": moved, "old": (old.base, old.size),
                "new": (new.base, new.size), "left": left.copy(),
                "data": _read(c, pc, 16), "elastic": elastic_view(mgr),
                "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    assert got["moved"] == 1 and got["new"][0] < got["old"][0]
    assert not got["left"].any()
    np.testing.assert_array_equal(got["data"], _f32(16, 9.0))
    assert_same_tree(ref, got)


def _churn_serve(serve, compaction):
    rng = np.random.default_rng(11)
    prompts = {t: rng.integers(0, CFG_J.vocab, 10, np.int32)
               for t in ("t0", "t1", "t2")}
    round2 = {t: rng.integers(0, CFG_J.vocab, 10, np.int32)
              for t in ("t0", "t2", "t3")}
    eng = serve.engine(max_batch=8, max_len=64)
    for t in ("t0", "t1", "t2"):
        eng.register_tenant(t, 2)
    rids = {t: eng.submit(t, p) for t, p in prompts.items()}
    out1 = eng.run(max_new_tokens=4)
    eng.manager.remove_tenant("t1")
    rid3, status = None, None
    if compaction:
        core = (JAX if serve.ref else PORT).core
        with pytest.raises(core.OutOfArenaMemory):
            eng.manager.bounds.create("t3", 4)
        status = eng.manager.elastic.admit("t3", 4).status.name
        eng._tenants.add("t3")
        rid3 = eng.submit("t3", round2["t3"])
    rids2 = {t: eng.submit(t, round2[t]) for t in ("t0", "t2")}
    out2 = eng.run(max_new_tokens=4)
    return {"gens": {t: out1[r] for t, r in rids.items()},
            "gens2": {t: out2[r] for t, r in rids2.items()},
            "t3": out2.get(rid3), "status": status,
            "elastic": elastic_view(eng.manager)}


_REF = {}


@pytest.mark.parametrize("side", sorted(SERVE_SIDES))
def test_churn_compaction_serve_generations_byte_identical(side):
    """Mirrors test_churn_compaction_serve_generations_byte_identical on
    the reference's weights: the fragmented slab pool refuses a tenant
    until a compaction relocates a survivor's slots through the trusted
    relocation step; the survivors' generations equal a run that never
    compacted, and the port's tokens and elastic record equal the
    reference's."""
    if "churn" not in _REF:
        _REF["churn"] = [_churn_serve(SERVE_REF, c) for c in (True, False)]
    ref = _REF["churn"]
    got = [_churn_serve(SERVE_SIDES[side], c) for c in (True, False)]
    with_c, without = got
    assert with_c["status"] == "ADMITTED"
    assert with_c["elastic"]["stats"]["relocations"] >= 1
    assert len(with_c["t3"]) == 4
    assert with_c["gens"] == without["gens"]
    assert with_c["gens2"] == without["gens2"]
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# State machine + stats surface
# ---------------------------------------------------------------------------

@SIDE
def test_elastic_states_follow_the_design_machine(side):
    """Mirrors test_elastic_states_follow_the_design_machine: a
    subscriber sees RESIZING mid-relocation; ACTIVE after; None once
    removed."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        mgr.elastic.admit("a", 16)
        trail = [_state(mgr, "a")]
        mgr.register_tenant("b", 16)
        seen = []
        mgr.elastic.subscribe(
            lambda ev: seen.append((ev.kind, _state(mgr, ev.tenant_id))))
        mgr.elastic.relocate("a", 16)
        trail.append(_state(mgr, "a"))
        mgr.remove_tenant("a")
        trail.append(_state(mgr, "a"))
        return {"trail": trail, "seen": seen, "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["seen"][0] == ("relocate", "RESIZING")
    assert got["trail"] == ["ACTIVE", "ACTIVE", None]
    assert_same_tree(ref, got)


@SIDE
def test_elastic_events_and_stats_accumulate(side):
    """Mirrors test_elastic_events_and_stats_accumulate."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        mgr.elastic.admit("a", 16)
        w = mgr.elastic.admit("w", 64)
        return {"status": w.status.name, "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    el = got["elastic"]
    assert got["status"] == "WAITLISTED"
    assert el["stats"]["admitted"] == 1 and el["stats"]["waitlisted"] == 1
    assert any(e.startswith("admit a") for e in el["events"])
    assert any(e.startswith("waitlist w") for e in el["events"])
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# Review regressions: dedupe, shrink guard, withdraw, placement probe
# ---------------------------------------------------------------------------

@SIDE
def test_relocate_refuses_extent_too_small_for_live_data(side):
    """Mirrors test_relocate_refuses_extent_too_small_for_live_data: the
    refusal comes before any device work; data and bounds intact."""
    def run(fw):
        mgr = fw.manager(total_slots=128)
        a = mgr.register_tenant("a", 64)
        mgr.register_tenant("b", 16)
        p = a.malloc(40)
        a.memcpy_h2d(p, np.arange(40, dtype=np.float32))
        a.synchronize()
        with pytest.raises(fw.core.ElasticError):
            mgr.elastic.relocate("a", 32)
        return {"data": _read(a, p, 40), "elastic": elastic_view(mgr),
                "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    assert got["elastic"]["bounds"]["a"][1] == 64
    np.testing.assert_array_equal(got["data"],
                                  np.arange(40, dtype=np.float32))
    assert_same_tree(ref, got)


@SIDE
def test_withdraw_removes_waitlisted_tenant_before_admission(side):
    """Mirrors test_withdraw_removes_waitlisted_tenant_before_admission:
    a withdrawn waitlisted tenant is not admitted by a later departure;
    a second withdrawal and one of an admitted tenant are refused."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        mgr.elastic.admit("a", 64)
        w = mgr.elastic.admit("w", 16)
        trail = [w.status.name, mgr.elastic.withdraw("w"),
                 mgr.elastic.withdraw("w")]
        mgr.remove_tenant("a")
        trail += [w.status.name, _state(mgr, "w"),
                  mgr.elastic.withdraw("a")]
        return {"trail": trail, "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["trail"] == ["WAITLISTED", True, False, "WAITLISTED", None,
                            False]
    assert_same_tree(ref, got)


def _shared_pool(serve):
    rng = np.random.default_rng(13)
    mgr = serve.manager(2, max_batch=4)
    engines = [serve.engine(max_batch=4, max_len=64, manager=mgr)
               for _ in range(2)]
    engines[0].register_tenant("a", 2)
    r0 = engines[0].submit("a", rng.integers(0, CFG_J.vocab, 8, np.int32))
    r1 = engines[1].submit("a", rng.integers(0, CFG_J.vocab, 8, np.int32))
    outs = serve.lockstep(engines, max_new_tokens=2)
    old = mgr.bounds.lookup("a")
    before = to_np(engines[0]._pool.buf["k"][:, old.base:old.base + old
                                              .size]).copy()
    new = mgr.elastic.relocate("a", old.size)
    after = to_np(engines[0]._pool.buf["k"][:, new.base:new.base + new
                                             .size]).copy()
    return {"tokens": [outs[0][r0], outs[1][r1]], "before": before,
            "after": after, "elastic": elastic_view(mgr)}


@pytest.mark.parametrize("side", sorted(SERVE_SIDES))
def test_shared_pool_relocation_dispatches_once_across_engines(side):
    """Mirrors test_shared_pool_relocation_dispatches_once_across_engines
    on the reference's weights: two engines on one manager observe one
    resize and the shared pool moves once (moved, not wiped); the
    moved K slots equal the reference's within the port's model
    tolerance, the tokens and elastic record exactly."""
    if "shared" not in _REF:
        _REF["shared"] = _shared_pool(SERVE_REF)
    ref, got = _REF["shared"], _shared_pool(SERVE_SIDES[side])
    assert [len(t) for t in got["tokens"]] == [2, 2]
    assert (got["before"] != 0).any()
    np.testing.assert_array_equal(got["before"], got["after"])
    np.testing.assert_allclose(got["after"], ref["after"], atol=1e-4,
                               rtol=1e-4)
    assert_same_tree({k: ref[k] for k in ("tokens", "elastic")},
                     {k: got[k] for k in ("tokens", "elastic")})


@SIDE
def test_ptr_translation_survives_unrelated_moves_between_epochs(side):
    """Mirrors the reference's
    test_ptr_translation_survives_unrelated_moves_between_epochs: an
    epoch-0 handle that sat still through a repack still translates when a
    later relocation moves everything."""
    def run(fw):
        mgr = fw.manager(total_slots=128)
        a = mgr.register_tenant("a", 32)
        mgr.register_tenant("b", 32)
        still, gap, move = a.malloc(4), a.malloc(4), a.malloc(4)
        a.memcpy_h2d(still, _f32(4, 1.0))
        a.memcpy_h2d(move, _f32(4, 3.0))
        a.synchronize()
        a.free(gap)
        mgr.elastic.shrink("a", 8)
        mgr.elastic.relocate("a", 8)
        out = {"still": _read(a, still, 4), "move": _read(a, move, 4)}
        a.free(still)
        return {**out, "elastic": elastic_view(mgr),
                "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    np.testing.assert_array_equal(got["still"], _f32(4, 1.0))
    np.testing.assert_array_equal(got["move"], _f32(4, 3.0))
    assert_same_tree(ref, got)


@SIDE
def test_banned_id_admission_rejects_without_wedging_the_waitlist(side):
    """Mirrors the reference's
    test_banned_id_admission_rejects_without_wedging_the_waitlist: a banned
    id and bad arguments reject on attempt; the true capacity wait is
    admitted by the next departure."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        mgr.elastic.admit("a", 32)
        mgr.elastic.admit("rogue", 16)
        mgr.quarantine.quarantine("rogue", reason="t")
        mgr.quarantine.evict("rogue")
        trail = [mgr.elastic.admit("rogue", 8).status.name]
        w = mgr.elastic.admit("w", 64)
        trail.append(w.status.name)
        trail.append(mgr.elastic.admit(
            "npol", 8, policy=fw.core.FencePolicy.NONE).status.name)
        mgr.remove_tenant("a")
        trail += [w.status.name, len(mgr.elastic.waitlist)]
        return {"trail": trail, "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["trail"] == ["REJECTED", "WAITLISTED", "REJECTED",
                            "ADMITTED", 0]
    assert_same_tree(ref, got)


def test_relocation_scrub_ranges_validated_against_extents():
    """Mirrors test_relocation_scrub_ranges_validated_against_extents:
    both packages refuse a scrub outside both extents and build an
    in-extent one."""
    for steps in (STJ, STT):
        with pytest.raises(ValueError):
            steps.build_flat_relocation_step(
                moves=(), zeros=((64, 16),), src_extent=(0, 16),
                dst_extent=(32, 16))
        assert callable(steps.build_flat_relocation_step(
            moves=((0, 32, 8),), zeros=((0, 16),), src_extent=(0, 16),
            dst_extent=(32, 16)))


@SIDE
def test_relocation_with_repack_copies_already_packed_blocks(side):
    """Mirrors test_relocation_with_repack_copies_already_packed_blocks:
    a block already at its packed offset still crosses to the new
    extent."""
    def run(fw):
        mgr = fw.manager(total_slots=128, elastic_policy=fw.core
                         .ElasticPolicy(grow_on_failure=True))
        a = mgr.register_tenant("a", 16)
        mgr.register_tenant("b", 16)
        front, mid, tail = a.malloc(4), a.malloc(4), a.malloc(4)
        a.memcpy_h2d(front, _f32(4, 1.0))
        a.memcpy_h2d(tail, _f32(4, 3.0))
        a.synchronize()
        a.free(mid)
        mgr.elastic.relocate("a", 8)
        return {"front": _read(a, front, 4), "tail": _read(a, tail, 4),
                "elastic": elastic_view(mgr), "arena": arena_bytes(mgr)}
    ref, got = on_both(side, run)
    np.testing.assert_array_equal(got["front"], _f32(4, 1.0))
    np.testing.assert_array_equal(got["tail"], _f32(4, 3.0))
    assert_same_tree(ref, got)


@SIDE
def test_duplicate_admit_of_live_tenant_rejects_without_state_damage(side):
    """Mirrors the reference's
    test_duplicate_admit_of_live_tenant_rejects_without_state_damage."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        mgr.elastic.admit("a", 16)
        trail = [_state(mgr, "a"), mgr.elastic.admit("a", 8).status.name,
                 _state(mgr, "a")]
        return {"trail": trail, "elastic": elastic_view(mgr)}
    ref, got = on_both(side, run)
    assert got["trail"] == ["ACTIVE", "REJECTED", "ACTIVE"]
    assert got["elastic"]["bounds"]["a"][1] == 16
    assert_same_tree(ref, got)


def test_pool_relocation_skips_tensors_short_of_either_extent():
    """Mirrors test_pool_relocation_skips_tensors_short_of_either_extent:
    a tensor short of the destination passes through untouched and the
    slot-indexed one moves — the port's pool equal to the reference's."""
    import jax.numpy as jnp
    ref_fn = STJ.build_pool_relocation_step(src=0, dst=48, size=16)
    _, ref_pool, _ = ref_fn(None, {
        "short": jnp.arange(56, dtype=jnp.float32).reshape(1, 56),
        "full": jnp.ones((1, 64, 2), jnp.float32)})
    fn = STT.build_pool_relocation_step(src=0, dst=48, size=16)
    short = torch.arange(56, dtype=torch.float32).reshape(1, 56)
    _, pool, _ = fn(None, {"short": short.clone(),
                           "full": torch.ones((1, 64, 2))})
    assert torch.equal(pool["short"], short)
    full = pool["full"]
    assert (full[:, 0:16] == 0).all() and (full[:, 48:64] == 1).all()
    assert_same_tree({k: to_np(v) for k, v in ref_pool.items()},
                     {k: to_np(v) for k, v in pool.items()})

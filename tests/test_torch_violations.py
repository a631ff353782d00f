"""The port's ViolationLog against the reference's: the mirrors of
tests/test_violations.py.  Every scenario runs on the reference and on
the port (the CPU, with its launches compiled — each through its step
graph — and eager), the tenant kernel written in jnp and in torch with
one fenced access of every kind (gather, scatter, slice, update), and
holds the log's snapshot, rows and capacity, the quarantine states and
the arena bytes equal field by field, besides the reference test's own
assertions on the port's run.

The log's device half was rewritten in the port: an in-place ``(T, K)``
int32 tensor that grows by ``torch.cat``, held by fused CHECK graphs as a
resident operand.  ``test_register_past_log_capacity_grows_and_attributes``
and its cached-key twin launch a fused CHECK key before the log grows
and replay it after, so a graph that kept the old table would count into
it and the counts would be missing from the new rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from _plane_parity import JAX, SIDES, arena_bytes, on_both, \
    violog_view  # noqa: E402
from _tenant_parity import assert_same_tree  # noqa: E402

TOTAL = 512
SIDE = pytest.mark.parametrize("side", sorted(SIDES))



def setup_manager(fw, **kw):
    kw.setdefault("total_slots", TOTAL)
    kw.setdefault("policy", fw.core.FencePolicy.CHECK)
    kw.setdefault("quarantine_policy",
                  fw.core.ThresholdPolicy(quarantine_after=1 << 30))
    mgr = fw.manager(**kw)
    a = mgr.register_tenant("a", 128)
    b = mgr.register_tenant("b", 128)
    a.module_load("mixed", fw.kernel("mixed"))
    b.module_load("mixed", fw.kernel("mixed"))
    return mgr, a, b


def launch_mixed(fw, mgr, client, idx, start):
    client.launch_kernel("mixed", args=(
        fw.i32(np.asarray(idx, np.int64)), fw.i32(int(start)), 0))
    mgr.run_queued()


def expected(part, idx, start):
    n_oob = int(sum(1 for i in idx if not (part.base <= i < part.end)))
    start_oob = int(not (part.base <= start < part.end))
    return {"gather": n_oob, "scatter": n_oob,
            "slice": start_oob, "update": start_oob}


def _log(mgr, *tenants):
    return {"view": violog_view(mgr),
            "counts": {t: mgr.violog.counts(t) for t in tenants},
            "totals": {t: mgr.violog.total(t) for t in tenants},
            "arena": arena_bytes(mgr)}


# ---------------------------------------------------------------------------
# Exact accounting
# ---------------------------------------------------------------------------

@SIDE
def test_counts_match_injected_oob_exactly_sweep(side):
    """Mirrors test_counts_match_injected_oob_exactly_sweep: six launches
    of seeded in- and out-of-bounds indices and starts; the port's
    per-kind counts are exact and equal the reference's."""
    def run(fw):
        mgr, a, _ = setup_manager(fw)
        part = mgr.bounds.lookup("a")
        rng = np.random.default_rng(0)
        want = {"gather": 0, "scatter": 0, "slice": 0, "update": 0}
        for _ in range(6):
            n = int(rng.integers(1, 9))
            inside = rng.integers(part.base, part.end, size=n)
            oob = rng.random(n) < 0.4
            idx = np.where(oob, inside + part.size, inside)
            start = int(rng.choice([part.base + 1, part.end + 7]))
            for k, v in expected(part, idx, start).items():
                want[k] += v
            launch_mixed(fw, mgr, a, idx, start)
        return _log(mgr, "a", "b"), want
    (ref, _), (got, want) = on_both(side, run)
    assert got["counts"]["a"] == want
    assert got["totals"]["a"] == sum(want.values())
    assert_same_tree(ref, got)


@SIDE
def test_zero_false_positives_under_safe_traffic(side):
    """Mirrors test_zero_false_positives_under_safe_traffic: in-bounds
    traffic of both tenants logs nothing and quarantines no one."""
    def run(fw):
        mgr, a, b = setup_manager(fw)
        for client in (a, b):
            part = mgr.bounds.lookup(client.tenant_id)
            rng = np.random.default_rng(1)
            for _ in range(4):
                idx = rng.integers(part.base, part.end, size=8)
                launch_mixed(fw, mgr, client, idx, part.base + 2)
        return {**_log(mgr, "a", "b"), "admissible": [
            mgr.quarantine.state_of(t).admissible for t in ("a", "b")]}
    ref, got = on_both(side, run)
    assert not np.asarray(got["view"]["snapshot"]).any()
    assert got["admissible"] == [True, True]
    assert_same_tree(ref, got)


@SIDE
def test_attribution_lands_on_the_offending_tenant_only(side):
    """Mirrors test_attribution_lands_on_the_offending_tenant_only: "a"
    attacks b's range in the drain where b stays in bounds; the counts
    land on a's row only."""
    def run(fw):
        mgr, a, b = setup_manager(fw)
        pa, pb = mgr.bounds.lookup("a"), mgr.bounds.lookup("b")
        launch_mixed(fw, mgr, a, np.arange(pb.base, pb.base + 8), pa.base)
        launch_mixed(fw, mgr, b, np.arange(pb.base, pb.base + 8), pb.base)
        return _log(mgr, "a", "b")
    ref, got = on_both(side, run)
    assert got["counts"]["a"]["gather"] == 8
    assert got["counts"]["a"]["scatter"] == 8
    assert got["totals"]["b"] == 0
    assert_same_tree(ref, got)


@given(st.lists(st.booleans(), min_size=1, max_size=8), st.booleans())
@settings(max_examples=6, deadline=None)
def test_counts_match_injected_oob_property(oob_mask, start_oob):
    """Mirrors test_counts_match_injected_oob_property: the same drawn
    masks on both, compiled on the port; exact counts, equal logs."""
    def run(fw):
        mgr, a, _ = setup_manager(fw)
        part = mgr.bounds.lookup("a")
        idx = np.array([part.end + 3 if bad else part.base + j
                        for j, bad in enumerate(oob_mask)], np.int32)
        start = part.end + 1 if start_oob else part.base
        launch_mixed(fw, mgr, a, idx, start)
        return _log(mgr, "a"), expected(part, idx, start)
    (ref, _), (got, want) = on_both("compiled", run, cache=False)
    assert got["counts"]["a"] == want
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# Log row lifecycle
# ---------------------------------------------------------------------------

def _row_recycling(fw):
    log = fw.core.ViolationLog(capacity=2) if fw is JAX else \
        fw.core.ViolationLog(capacity=2, device="cpu")
    r0 = log.assign("a")
    trail = [r0, log.assign("a")]
    log.add("a", np.array([1, 2, 3, 4], np.int32))
    trail.append(log.total("a"))
    log.reset("a")
    trail.append(log.total("a"))
    log.add("a", np.array([5, 0, 0, 0], np.int32))
    log.release("a")
    r1 = log.assign("b")
    trail.append(r1)
    if r1 != r0:
        trail.append(log.assign("c"))
    return {"trail": trail, "snapshot": np.asarray(log.snapshot())}, r0


def _assign_past_capacity(fw):
    log = fw.core.ViolationLog(capacity=1) if fw is JAX else \
        fw.core.ViolationLog(capacity=1, device="cpu")
    r0 = log.assign("a")
    log.add("a", np.array([1, 2, 3, 4], np.int32))
    r1 = log.assign("b")
    out = {"r0": r0, "r1": r1, "capacity": log.capacity,
           "row_a": log.row_of("a"), "total_a": log.total("a"),
           "total_b": log.total("b"), "shape": tuple(log.buf.shape)}
    log.release("a")
    out["c"] = log.assign("c")
    return out


@pytest.mark.parametrize("case", ["row_recycling_and_reset",
                                  "assign_past_capacity_grows_table"])
def test_log_row_lifecycle(case):
    """Mirrors test_row_recycling_and_reset (assign is idempotent, reset
    zeroes, a released row comes back zeroed) and
    test_assign_past_capacity_grows_table (assigning past capacity
    doubles the ``(T, K)`` table by ``torch.cat``; rows keep their
    indices and counts, a freed row still recycles): the port's log
    walks the reference's states."""
    if case == "row_recycling_and_reset":
        (ref, _), (got, r0) = _row_recycling(JAX), _row_recycling(SIDES[
            "compiled"])
        assert got["trail"][:4] == [r0, r0, 10, 0]
        assert r0 in got["trail"][4:]
        assert not got["snapshot"].any()
    else:
        ref, got = _assign_past_capacity(JAX), _assign_past_capacity(
            SIDES["compiled"])
        assert got["capacity"] == 2 and got["r1"] != got["r0"]
        assert got["row_a"] == got["r0"] and got["total_a"] == 10
        assert got["total_b"] == 0 and got["shape"] == (2, 4)
        assert got["c"] == got["r0"]
    assert_same_tree(ref, got)


@SIDE
def test_register_past_log_capacity_grows_and_attributes(side):
    """Mirrors test_register_past_log_capacity_grows_and_attributes:
    three tenants on a ``max_tenants=2`` manager grow the log to 4 rows;
    "a" (a row before the growth) and "c" (after it) go out of bounds
    and each count lands on its own row."""
    def run(fw):
        mgr = fw.manager(total_slots=512, max_tenants=2,
                         policy=fw.core.FencePolicy.CHECK,
                         quarantine_policy=fw.core.ThresholdPolicy(
                             quarantine_after=1 << 30))
        clients = {t: mgr.register_tenant(t, 64) for t in ("a", "b", "c")}
        for c in clients.values():
            c.module_load("mixed", fw.kernel("mixed"))
        pa, pc = mgr.bounds.lookup("a"), mgr.bounds.lookup("c")
        launch_mixed(fw, mgr, clients["a"], np.full(3, pa.end + 1), pa.base)
        launch_mixed(fw, mgr, clients["c"], np.full(5, pc.end + 9), pc.base)
        return _log(mgr, "a", "b", "c")
    ref, got = on_both(side, run)
    assert got["view"]["capacity"] == 4
    assert sorted(got["view"]["rows"].values()) == [0, 1, 2]
    assert got["counts"]["a"]["gather"] == 3
    assert got["counts"]["c"]["gather"] == 5
    assert got["totals"]["b"] == 0
    assert_same_tree(ref, got)


@SIDE
def test_cached_fused_check_key_replays_into_grown_log(side):
    """The port's own risk behind
    test_register_past_log_capacity_grows_and_attributes: a fused CHECK
    launch of "a" and "b" caches its key (a step graph on the port); a
    third tenant grows the log from 2 rows to 4; the same key replays
    with "b" and "c" out of bounds, and the counts land in their rows —
    "c"'s a row the old table did not have — as on the reference."""
    def run(fw):
        mgr = fw.manager(total_slots=512, max_tenants=2,
                         policy=fw.core.FencePolicy.CHECK,
                         quarantine_policy=fw.core.ThresholdPolicy(
                             quarantine_after=1 << 30))
        clients = {t: mgr.register_tenant(t, 64) for t in ("a", "b")}
        for c in clients.values():
            c.module_load("mixed", fw.kernel("mixed"))

        def fused(pairs):
            for t, bad in pairs:
                p = mgr.bounds.lookup(t)
                idx = np.full(4, p.end + 2) if bad else \
                    np.arange(p.base, p.base + 4)
                clients[t].launch_kernel("mixed", args=(
                    fw.i32(idx), fw.i32(p.base), 0))
            mgr.run_queued()

        fused([("a", True), ("b", False)])
        before = _log(mgr, "a", "b")
        clients["c"] = mgr.register_tenant("c", 64)
        clients["c"].module_load("mixed", fw.kernel("mixed"))
        fused([("b", True), ("c", True)])
        stats = mgr.scheduler.stats
        return {"before": before, "after": _log(mgr, "a", "b", "c"),
                "fused_steps": stats.fused_steps,
                "widths": list(stats.batch_widths)}
    ref, got = on_both(side, run)
    assert got["before"]["view"]["capacity"] == 2
    assert got["after"]["view"]["capacity"] == 4
    for t in ("a", "b", "c"):
        assert got["after"]["counts"][t]["gather"] == 4, t
    assert got["fused_steps"] == 2
    assert_same_tree(ref, got)


@SIDE
def test_duplicate_registration_cannot_reset_counters(side):
    """Mirrors test_duplicate_registration_cannot_reset_counters: a
    refused duplicate ``register_tenant`` leaves the live tenant's row,
    counts and lifecycle record as they were."""
    def run(fw):
        mgr, a, _ = setup_manager(fw)
        part = mgr.bounds.lookup("a")
        launch_mixed(fw, mgr, a, np.full(4, part.end + 1), part.base)
        before = mgr.violog.total("a")
        with pytest.raises(ValueError):
            mgr.register_tenant("a", 64)
        return {"before": before, **_log(mgr, "a", "b"),
                "state": mgr.quarantine.state_of("a").name}
    ref, got = on_both(side, run)
    assert got["before"] == 8 and got["totals"]["a"] == 8
    assert got["view"]["rows"]["a"] is not None
    assert_same_tree(ref, got)


@SIDE
def test_register_failure_leaks_nothing(side):
    """Mirrors test_register_failure_leaks_nothing: a registration that
    fails on its partition takes back its log row and leaves no record;
    the id stays usable."""
    def run(fw):
        mgr = fw.manager(total_slots=512, max_tenants=2)
        mgr.register_tenant("a", 64)
        mgr.register_tenant("b", 64)
        free, rows = mgr.bounds.free_slots(), len(mgr.violog.tenants())
        with pytest.raises(fw.core.OutOfArenaMemory):
            mgr.register_tenant("c", 1024)
        out = {"free": (free, mgr.bounds.free_slots()),
               "rows": (rows, len(mgr.violog.tenants())),
               "record": mgr.quarantine.state_of("c"),
               "reported": "c" in mgr.violation_report()["tenants"]}
        c = mgr.register_tenant("c", 64)
        out["client"] = c is mgr._clients["c"]
        out["view"] = violog_view(mgr)
        return out
    ref, got = on_both(side, run)
    assert got["free"][0] == got["free"][1]
    assert got["rows"][0] == got["rows"][1]
    assert got["record"] is None and not got["reported"] and got["client"]
    assert_same_tree(ref, got)


@SIDE
def test_dirty_flag_gates_polling(side):
    """Mirrors test_dirty_flag_gates_polling: BITWISE traffic never marks
    the log dirty."""
    def run(fw):
        mgr = fw.manager(total_slots=TOTAL,
                         policy=fw.core.FencePolicy.BITWISE)
        a = mgr.register_tenant("a", 128)
        mgr.register_tenant("b", 128)
        a.module_load("mixed", fw.kernel("mixed"))
        part = mgr.bounds.lookup("a")
        dirty = [mgr.violog.dirty]
        launch_mixed(fw, mgr, a, np.arange(part.base, part.base + 4),
                     part.base)
        dirty.append(mgr.violog.dirty)
        return {"dirty": dirty, **_log(mgr, "a", "b")}
    ref, got = on_both(side, run)
    assert got["dirty"] == [False, False]
    assert not np.asarray(got["view"]["snapshot"]).any()
    assert_same_tree(ref, got)


@SIDE
def test_operator_reads_do_not_suppress_poll(side):
    """Mirrors test_operator_reads_do_not_suppress_poll: an operator's
    ``violation_report()`` keeps the dirty flag; only the poll clears
    it."""
    def run(fw):
        mgr, a, _ = setup_manager(fw, quarantine_poll_every=100)
        part = mgr.bounds.lookup("a")
        launch_mixed(fw, mgr, a, np.full(4, part.end + 1), part.base)
        dirty = [mgr.violog.dirty]
        report = mgr.violation_report()
        dirty.append(mgr.violog.dirty)
        mgr.quarantine.poll()
        dirty.append(mgr.violog.dirty)
        return {"dirty": dirty, "report": report, **_log(mgr, "a")}
    ref, got = on_both(side, run)
    assert got["dirty"] == [True, True, False]
    assert_same_tree(ref, got)


def test_violation_kind_order_is_stable():
    """Mirrors test_violation_kind_order_is_stable: the report columns
    are the reference's, in its order."""
    names = [k.name.lower() for k in SIDES["compiled"].core.ViolationKind]
    assert names == [k.name.lower() for k in JAX.core.ViolationKind] == [
        "gather", "scatter", "slice", "update"]

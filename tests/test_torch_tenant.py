"""The port's tenant-kernel plane against the JAX reference: registration
through ``module_load``, the NONE / BITWISE / MODULO / CHECK launch paths
solo and fused, selective CHECK commit, quarantine of a rogue tenant, the
simulated libraries, and the README's API snippet.

Every scenario runs once on the reference and once on the port (CPU),
with the same kernels written in jnp and in torch, and holds arena bytes,
integer results, ViolationLog rows, drain statistics and quarantine
states equal; float reductions within ``TOL_F32``.  Mirrors
tests/test_manager.py:48-209, the tenant-kernel cases of
tests/test_scheduler.py and the CHECK / rogue cases of
tests/test_quarantine.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _tenant_parity import JAX, TORCH, assert_same_tree, \
    on_both  # noqa: E402
from _torch_parity import TOL_F32, assert_close, np_of  # noqa: E402


def _tenants(fw, n=4, slots=512, kernels=("bump", "evil"), **kw):
    mgr = fw.manager(total_slots=slots, **kw)
    clients = [mgr.register_tenant(f"t{i}", slots // (2 * n))
               for i in range(n)]
    for c in clients:
        for k in kernels:
            c.module_load(k, fw.kernel(k))
    return mgr, clients


def _stats(mgr):
    st = mgr.scheduler.stats
    return {"fused_steps": st.fused_steps, "single_steps": st.single_steps,
            "check_steps": st.check_steps, "proven_steps": st.proven_steps,
            "batch_widths": list(st.batch_widths),
            "dispatch_log": list(mgr.scheduler.dispatch_log)}


def _violog(mgr):
    return {t: mgr.violog.counts(t) for t in sorted(mgr.violog.tenants())}


# ---------------------------------------------------------------------------
# Registration and the per-launch paths (tests/test_manager.py:48-209)
# ---------------------------------------------------------------------------

def test_module_load_registers_a_sandboxed_kernel():
    """``GuardianClient.module_load`` reaches ``register_kernel``: the
    entry carries a twin for every fence mode."""
    mgr = TORCH.manager(total_slots=256)
    c = mgr.register_tenant("a", 64)
    c.module_load("bump", TORCH.kernel("bump"))
    entry = mgr.pointer_to_symbol["bump"]
    assert not entry.trusted and entry.verify
    for twin in ("native", "fenced_dyn", "checked_dyn", "modulo_dyn"):
        assert callable(getattr(entry, twin))


def test_sandboxed_kernel_cannot_touch_neighbour():
    def run(fw):
        mgr = fw.manager(total_slots=256, policy=fw.core.FencePolicy.BITWISE)
        a = mgr.register_tenant("a", 64)
        b = mgr.register_tenant("b", 64)
        pb = b.malloc(16)
        b.memcpy_h2d(pb, np.full(16, 7.0, np.float32))
        b.synchronize()
        a.module_load("evil", fw.kernel("evil"))
        a.launch_kernel("evil", args=(fw.i32(pb.addr), 16))
        a.synchronize()
        return {"b": b.memcpy_d2h(pb, 16), "arena": fw.arena(mgr)}
    ref, got = on_both(run)
    np.testing.assert_array_equal(got["b"], np.full(16, 7.0, np.float32))
    assert (got["arena"] == 999.0).any()
    assert_same_tree(ref, got)


@pytest.mark.parametrize("batch", [False, True], ids=["time_share",
                                                      "unbatched"])
def test_check_policy_per_launch_raises_and_rolls_back(batch):
    def run(fw):
        kw = ({"batch_launches": False} if batch else
              {"mode": fw.core.SharingMode.TIME_SHARE})
        mgr = fw.manager(total_slots=256, policy=fw.core.FencePolicy.CHECK,
                         **kw)
        a = mgr.register_tenant("a", 64)
        mgr.register_tenant("b", 64)
        a.module_load("oob", fw.kernel("oob"), verify=False)
        raised = False
        try:
            a.launch_kernel("oob", args=(4,))
            mgr.synchronize()
        except fw.core.GuardianViolation:
            raised = True
        return {"raised": raised, "log": _violog(mgr),
                "arena": fw.arena(mgr), "n_violations": len(mgr.violations)}
    ref, got = on_both(run)
    assert got["raised"] and got["log"]["a"]["scatter"] == 4
    assert_same_tree(ref, got)


def test_standalone_fast_path():
    mgr = TORCH.manager(total_slots=256)
    mgr.register_tenant("a", 64)
    assert mgr.standalone
    assert mgr._effective_policy() is TORCH.core.FencePolicy.NONE
    mgr.register_tenant("b", 64)
    assert mgr._effective_policy() is TORCH.core.FencePolicy.BITWISE


def test_modulo_policy_roundtrip():
    def run(fw):
        mgr = fw.manager(total_slots=256, policy=fw.core.FencePolicy.MODULO,
                         mode=fw.core.SharingMode.TIME_SHARE)
        a = mgr.register_tenant("a", 64)
        mgr.register_tenant("b", 64)
        pa = a.malloc(8)
        a.memcpy_h2d(pa, np.arange(8, dtype=np.float32))
        a.module_load("bump", fw.kernel("bump"))
        a.launch_kernel("bump", ptrs=[pa], args=(8,))
        a.synchronize()
        return a.memcpy_d2h(pa, 8)
    ref, got = on_both(run)
    np.testing.assert_array_equal(got, np.arange(8, dtype=np.float32) + 1)
    assert_same_tree(ref, got)


def test_teardown_scrubs_partition():
    mgr = TORCH.manager(total_slots=256)
    a = mgr.register_tenant("a", 64)
    pa = a.malloc(8)
    a.memcpy_h2d(pa, np.full(8, 5.0, np.float32))
    a.synchronize()
    base = mgr.bounds.lookup("a").base
    mgr.remove_tenant("a")
    assert (np_of(mgr.arena.unsafe_read_range(base, 64)) == 0).all()


def test_spatial_round_robin_interleaves():
    mgr = TORCH.manager(total_slots=256)
    a = mgr.register_tenant("a", 64)
    b = mgr.register_tenant("b", 64)
    a.module_load("ka", TORCH.kernel("noop"))
    b.module_load("kb", TORCH.kernel("noop"))
    for c, k in ((a, "ka"), (b, "kb")):
        for _ in range(3):
            c.launch_kernel(k, args=(1,))
    order = []
    real = mgr._run_op

    def spy(op):
        order.append(op.tenant_id)
        return real(op)

    mgr._run_op = spy
    mgr.run_queued()
    assert order == ["a", "b", "a", "b", "a", "b"]


def test_unknown_kernel_fails_closed():
    mgr = TORCH.manager(total_slots=256)
    a = mgr.register_tenant("a", 64)
    with pytest.raises(TORCH.core.GuardianViolation):
        a.launch_kernel("not_registered")


# ---------------------------------------------------------------------------
# Fused batches (tests/test_scheduler.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
def test_compatible_launches_fuse_into_one_step(policy):
    def run(fw):
        mgr, clients = _tenants(fw, policy=getattr(fw.core.FencePolicy,
                                                   policy))
        ptrs = []
        for c in clients:
            p = c.malloc(8)
            c.memcpy_h2d(p, np.zeros(8, np.float32))
            ptrs.append(p)
        for _ in range(3):
            for c, p in zip(clients, ptrs):
                c.launch_kernel("bump", ptrs=[p], args=(8,))
        mgr.synchronize()
        return {"stats": _stats(mgr), "arena": fw.arena(mgr),
                "log": _violog(mgr)}
    ref, got = on_both(run)
    assert got["stats"]["batch_widths"] == [4, 4, 4]
    assert_same_tree(ref, got)


@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
def test_fused_matches_per_launch_drain(policy):
    """Fused rows are bit-identical to the per-launch drain, on each side
    and across the two."""
    def run(fw):
        arenas = []
        for batched in (True, False):
            mgr, clients = _tenants(
                fw, policy=getattr(fw.core.FencePolicy, policy),
                batch_launches=batched)
            for i, c in enumerate(clients):
                p = c.malloc(16)
                c.memcpy_h2d(p, np.arange(16, dtype=np.float32) * (i + 1))
                for _ in range(i + 1):
                    c.launch_kernel("bump", ptrs=[p], args=(16,))
            mgr.synchronize()
            arenas.append(fw.arena(mgr))
        np.testing.assert_array_equal(arenas[0], arenas[1])
        return arenas[0]
    ref, got = on_both(run)
    assert_same_tree(ref, got)


@pytest.mark.parametrize("policy", ["BITWISE", "MODULO"])
def test_fused_batch_cross_tenant_isolation(policy):
    """Four tenants aim a forged slot id at their neighbour in one fused
    step: every write wraps into the attacker's own partition."""
    def run(fw):
        mgr, clients = _tenants(fw, policy=getattr(fw.core.FencePolicy,
                                                   policy))
        ptrs = []
        for i, c in enumerate(clients):
            p = c.malloc(16)
            c.memcpy_h2d(p, np.full(16, float(i + 1), np.float32))
            ptrs.append(p)
        mgr.synchronize()
        before = fw.arena(mgr)
        for i, c in enumerate(clients):
            c.launch_kernel("evil",
                            args=(fw.i32(ptrs[(i + 1) % 4].addr), 16))
        mgr.synchronize()
        return {"before": before, "after": fw.arena(mgr),
                "stats": _stats(mgr)}
    ref, got = on_both(run)
    assert got["stats"]["batch_widths"] == [4]
    mgr = TORCH.manager(total_slots=512)
    for i in range(4):
        part = mgr.bounds.create(f"t{i}", 64)
        own = got["after"][part.base:part.end]
        changed = own != got["before"][part.base:part.end]
        assert (own == 999.0).any() and (own[changed] == 999.0).all()
    assert_same_tree(ref, got)


def test_fused_isolation_matches_sequential_wraparound():
    def run(fw):
        out = []
        for batched in (True, False):
            mgr, clients = _tenants(fw, n=2, batch_launches=batched)
            other = mgr.bounds.lookup("t1")
            clients[0].launch_kernel("evil",
                                     args=(fw.i32(other.base + 3), 8))
            t0 = mgr.bounds.lookup("t0")
            clients[1].launch_kernel("evil", args=(fw.i32(t0.base + 5), 8))
            mgr.synchronize()
            out.append(fw.arena(mgr))
        np.testing.assert_array_equal(out[0], out[1])
        return out[0]
    assert_same_tree(*on_both(run))


def test_coalescing_preserves_round_robin_fairness():
    def run(fw):
        mgr, clients = _tenants(fw, n=3)
        ptrs = [c.malloc(4) for c in clients]
        for c, p in zip(clients, ptrs):
            c.memcpy_h2d(p, np.zeros(4, np.float32))
        mgr.synchronize()
        mgr.scheduler.dispatch_log.clear()
        for i, c in enumerate(clients):
            for _ in range({0: 4, 1: 2, 2: 1}[i]):
                c.launch_kernel("bump", ptrs=[ptrs[i]], args=(4,))
        mgr.synchronize()
        return {"log": list(mgr.scheduler.dispatch_log),
                "arena": fw.arena(mgr)}
    ref, got = on_both(run)
    assert got["log"] == [("t0", "t1", "t2"), ("t0", "t1"), ("t0",),
                          ("t0",)]
    assert_same_tree(ref, got)


def test_modulo_fused_non_pow2_partition_sizes():
    """The magic row table handles arbitrary partition sizes: a fused
    MODULO step over non-pow2 bounds gives the reference's bytes."""
    from repro.core import FenceTable as FTJ
    from repro_torch.core.fence import magic_row

    bounds = [(0, 48), (48, 12), (60, 3)]
    starts = [40, 55, 61]
    ref = np.arange(64, dtype=np.float32)

    mj = JAX.manager(total_slots=64)
    mj.register_kernel("kern", JAX.kernel("bump"))
    table = FTJ.modulo_from_bounds([b for b, _ in bounds],
                                   [s for _, s in bounds])
    fused = mj.scheduler._build_fused_modulo(
        mj.pointer_to_symbol["kern"], (("d", (), np.dtype("int32")),
                                       ("s", 8)), 3)
    want, _ = fused(np.asarray(ref), table.magic,
                    *[JAX.i32(s) for s in starts])

    mt = TORCH.manager(total_slots=64)
    mt.register_kernel("kern", TORCH.kernel("bump"))
    magic = np.zeros((3, 4), np.uint32)
    for r, (b, s) in enumerate(bounds):
        magic[r] = (b, s, *magic_row(s))
    fused_t = mt.scheduler._build_fused_modulo(
        mt.pointer_to_symbol["kern"], (("d", (), torch.int32), ("s", 8)), 3)
    arena = torch.from_numpy(ref.copy())
    got, _ = fused_t(arena, torch.from_numpy(magic.view(np.int32)),
                     *[TORCH.i32(s) for s in starts])
    np.testing.assert_array_equal(np_of(got), np_of(want))


def test_per_tenant_policies_fuse_in_separate_batches():
    def run(fw):
        P = fw.core.FencePolicy
        mgr = fw.manager(total_slots=512, policy=P.BITWISE)
        clients = [mgr.register_tenant("m0", 32, policy=P.MODULO),
                   mgr.register_tenant("m1", 32, policy=P.MODULO),
                   mgr.register_tenant("b0", 32),
                   mgr.register_tenant("b1", 32)]
        ptrs = []
        for c in clients:
            c.module_load("bump", fw.kernel("bump"))
            p = c.malloc(8)
            c.memcpy_h2d(p, np.zeros(8, np.float32))
            ptrs.append(p)
        mgr.synchronize()
        mgr.scheduler.dispatch_log.clear()
        for c, p in zip(clients, ptrs):
            c.launch_kernel("bump", ptrs=[p], args=(8,))
        mgr.synchronize()
        return {"log": sorted(mgr.scheduler.dispatch_log),
                "arena": fw.arena(mgr)}
    ref, got = on_both(run)
    assert got["log"] == [("b0", "b1"), ("m0", "m1")]
    assert_same_tree(ref, got)


@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
def test_launch_result_handle_filled_by_drain(policy):
    def run(fw):
        mgr, clients = _tenants(fw, n=2, kernels=("echo",),
                                policy=getattr(fw.core.FencePolicy, policy))
        reqs = []
        for i, c in enumerate(clients):
            p = c.malloc(4)
            c.memcpy_h2d(p, np.full(4, float(i + 1), np.float32))
            reqs.append(c.launch_kernel("echo", ptrs=[p], args=(4,)))
        mgr.synchronize()
        return [float(np_of(r.result)) for r in reqs]
    ref, got = on_both(run)
    assert got == [4.0, 8.0]
    assert ref == got


def test_check_policy_contains_and_attributes_on_scheduler_path():
    def run(fw):
        mgr = fw.manager(total_slots=256, policy=fw.core.FencePolicy.CHECK)
        a = mgr.register_tenant("a", 64)
        mgr.register_tenant("b", 64)
        a.module_load("oob", fw.kernel("oob200"))
        a.launch_kernel("oob", args=(4,))
        mgr.synchronize()
        return {"stats": _stats(mgr), "arena": fw.arena(mgr),
                "log": _violog(mgr)}
    ref, got = on_both(run)
    assert got["stats"]["check_steps"] == 1
    assert not (got["arena"] == 1.0).any()
    assert got["log"]["a"]["scatter"] == 4
    assert sum(got["log"]["b"].values()) == 0
    assert_same_tree(ref, got)


def test_incompatible_signatures_do_not_fuse():
    def run(fw):
        mgr, clients = _tenants(fw, n=2)
        ptrs = [c.malloc(8) for c in clients]
        for c, p in zip(clients, ptrs):
            c.memcpy_h2d(p, np.zeros(8, np.float32))
        mgr.synchronize()
        clients[0].launch_kernel("bump", ptrs=[ptrs[0]], args=(8,))
        clients[1].launch_kernel("bump", ptrs=[ptrs[1]], args=(4,))
        mgr.synchronize()
        return {"stats": _stats(mgr), "arena": fw.arena(mgr)}
    ref, got = on_both(run)
    assert got["stats"]["fused_steps"] == 0
    assert got["stats"]["single_steps"] == 2
    assert_same_tree(ref, got)


def test_max_fuse_caps_batch_width():
    def run(fw):
        mgr = fw.manager(total_slots=1024, max_fuse=2)
        clients = [mgr.register_tenant(f"t{i}", 64) for i in range(5)]
        ptrs = []
        for c in clients:
            c.module_load("bump", fw.kernel("bump"))
            p = c.malloc(4)
            c.memcpy_h2d(p, np.zeros(4, np.float32))
            ptrs.append(p)
        mgr.synchronize()
        for c, p in zip(clients, ptrs):
            c.launch_kernel("bump", ptrs=[p], args=(4,))
        mgr.synchronize()
        return {"stats": _stats(mgr), "arena": fw.arena(mgr)}
    ref, got = on_both(run)
    assert max(got["stats"]["batch_widths"]) == 2
    assert_same_tree(ref, got)


def test_standalone_single_tenant_native_fast_path():
    def run(fw):
        mgr = fw.manager(total_slots=256)
        c = mgr.register_tenant("solo", 64)
        c.module_load("bump", fw.kernel("bump"))
        p = c.malloc(8)
        c.memcpy_h2d(p, np.zeros(8, np.float32))
        for _ in range(4):
            c.launch_kernel("bump", ptrs=[p], args=(8,))
        mgr.synchronize()
        return {"stats": _stats(mgr), "data": c.memcpy_d2h(p, 8),
                "native": any(k[0] == "native" for k in
                              mgr.pointer_to_symbol["bump"].jit_cache)}
    ref, got = on_both(run)
    assert got["stats"]["single_steps"] == 4 and got["native"]
    np.testing.assert_array_equal(got["data"], np.full(8, 4.0, np.float32))
    assert_same_tree(ref, got)


def test_stale_standalone_policy_reresolved_at_drain():
    """A launch enqueued while standalone (NONE) runs fenced once a second
    tenant has registered before the drain."""
    def run(fw):
        mgr = fw.manager(total_slots=256)
        a = mgr.register_tenant("a", 64)
        a.module_load("evil", fw.kernel("evil"))
        a.launch_kernel("evil", args=(fw.i32(64 + 3), 8))
        b = mgr.register_tenant("b", 64)
        pb = b.malloc(16)
        b.memcpy_h2d(pb, np.full(16, 7.0, np.float32))
        mgr.synchronize()
        return fw.arena(mgr)
    ref, got = on_both(run)
    mgr = TORCH.manager(total_slots=256)
    pa, pb = mgr.bounds.create("a", 64), mgr.bounds.create("b", 64)
    assert not (got[pb.base:pb.end] == 999.0).any()
    assert (got[pa.base:pa.end] == 999.0).any()
    assert_same_tree(ref, got)


def _lookahead_stats(mgr):
    st = mgr.scheduler.stats
    return {**_stats(mgr), "lookahead_fused": st.lookahead_fused,
            "queue_ages": list(st.queue_ages),
            "queue_age_sum": st.queue_age_sum,
            "summary": st.summary(), "pending": mgr.scheduler.pending}


@pytest.mark.parametrize("look,depths", [(1, (1, 1)), (3, (5, 1, 2)),
                                         (2, (4, 4, 0)), (1, (7, 2, 5))])
def test_lookahead_holds_and_fuses_across_cycles(look, depths):
    """Cross-cycle lookahead over tenant kernels: held batches, queue
    ages, lookahead-fused counts and the final arena equal the
    reference's, and no launch waits past its budget."""
    def run(fw):
        mgr, clients = _tenants(fw, n=len(depths), lookahead_cycles=look,
                                max_fuse=4)
        ptrs = []
        for i, c in enumerate(clients):
            p = c.malloc(4)
            c.memcpy_h2d(p, np.arange(4, dtype=np.float32) * (i + 1))
            ptrs.append(p)
        mgr.synchronize()
        for c, p, d in zip(clients, ptrs, depths):
            for _ in range(d):
                c.launch_kernel("bump", ptrs=[p], args=(4,))
        mgr.synchronize()
        return {"stats": _lookahead_stats(mgr), "arena": fw.arena(mgr)}
    ref, got = on_both(run)
    assert got["stats"]["pending"] == 0
    assert all(a <= look for a in got["stats"]["queue_ages"])
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# Selective commit and the quarantine lifecycle (tests/test_quarantine.py)
# ---------------------------------------------------------------------------

def _q_manager(fw, n=3, after=1 << 30, **kw):
    kw.setdefault("policy", fw.core.FencePolicy.CHECK)
    return _tenants(
        fw, n=n, quarantine_policy=fw.core.ThresholdPolicy(
            quarantine_after=after), **kw)


def test_fused_check_selective_commit_matches_standalone():
    def run(fw):
        refs = {}
        for i in range(2):
            mgr, clients = _q_manager(fw)
            c = clients[i]
            p = c.malloc(8)
            c.memcpy_h2d(p, np.arange(8, dtype=np.float32))
            for _ in range(3):
                c.launch_kernel("bump", ptrs=[p], args=(8,))
            mgr.synchronize()
            part = mgr.bounds.lookup(f"t{i}")
            refs[i] = fw.read(mgr, part.base, part.size)
        mgr, clients = _q_manager(fw)
        ptrs = []
        for c in clients[:2]:
            p = c.malloc(8)
            c.memcpy_h2d(p, np.arange(8, dtype=np.float32))
            ptrs.append(p)
        mgr.synchronize()
        victim = mgr.bounds.lookup("t0")
        for _ in range(3):
            for c, p in zip(clients[:2], ptrs):
                c.launch_kernel("bump", ptrs=[p], args=(8,))
            clients[2].launch_kernel("bump",
                                     args=(fw.i32(victim.base), 8))
        mgr.synchronize()
        for i in range(2):
            part = mgr.bounds.lookup(f"t{i}")
            np.testing.assert_array_equal(
                fw.read(mgr, part.base, part.size), refs[i])
        return {"stats": _stats(mgr), "log": _violog(mgr),
                "arena": fw.arena(mgr)}
    ref, got = on_both(run)
    assert got["stats"]["batch_widths"] == [3, 3, 3]
    assert got["stats"]["check_steps"] == 3
    assert got["log"]["t2"] == {"gather": 24, "scatter": 24, "slice": 0,
                                "update": 0}
    assert_same_tree(ref, got)


def test_threshold_quarantines_offender_cotenants_uninterrupted():
    def run(fw):
        mgr, clients = _q_manager(fw, after=16)
        ptrs = []
        for c in clients[:2]:
            p = c.malloc(8)
            c.memcpy_h2d(p, np.zeros(8, np.float32))
            ptrs.append(p)
        victim = mgr.bounds.lookup("t0")
        for _ in range(6):
            for c, p in zip(clients[:2], ptrs):
                c.launch_kernel("bump", ptrs=[p], args=(8,))
            clients[2].launch_kernel("evil", args=(fw.i32(victim.base), 8))
        mgr.synchronize()
        with pytest.raises(fw.core.TenantQuarantined):
            clients[2].launch_kernel("bump", args=(fw.i32(0), 8))
        report = mgr.violation_report()
        return {"state": mgr.quarantine.state_of("t2").name,
                "log": _violog(mgr),
                "data": [c.memcpy_d2h(p, 8) for c, p in zip(clients, ptrs)],
                "report_state": report["tenants"]["t2"]["state"],
                "events": list(mgr.quarantine.events)}
    ref, got = on_both(run)
    assert got["state"] == "QUARANTINED"
    assert sum(got["log"]["t2"].values()) == 16
    assert_same_tree(ref, got)


def test_eviction_scrubs_reclaims_and_bans():
    def run(fw):
        mgr, clients = _q_manager(fw, n=2, after=8)
        part = mgr.bounds.lookup("t1")
        p = clients[1].malloc(8)
        clients[1].memcpy_h2d(p, np.full(8, 5.0, np.float32))
        clients[1].launch_kernel(
            "evil", args=(fw.i32(mgr.bounds.lookup("t0").base), 8))
        mgr.synchronize()
        state = mgr.quarantine.state_of("t1").name
        free_before = mgr.bounds.free_slots()
        mgr.quarantine.evict("t1")
        scrubbed = fw.read(mgr, part.base, part.size)
        rep = mgr.violation_report()["tenants"]["t1"]
        with pytest.raises(fw.core.QuarantineError):
            mgr.register_tenant("t1", 64)
        mgr.quarantine.readmit("t1")
        mgr.register_tenant("t1", 64)
        return {"state": state, "scrubbed": scrubbed,
                "freed": mgr.bounds.free_slots() - free_before,
                "rep": (rep["state"], rep["scatter"]),
                "base": mgr.bounds.lookup("t1").base == part.base}
    ref, got = on_both(run)
    assert got["state"] == "QUARANTINED" and (got["scrubbed"] == 0).all()
    assert got["rep"] == ("evicted", 8) and got["base"]
    assert_same_tree(ref, got)


def test_remove_and_readmit_of_quarantined_tenant():
    def run(fw):
        mgr, clients = _q_manager(fw, n=2, after=8)
        clients[1].launch_kernel(
            "evil", args=(fw.i32(mgr.bounds.lookup("t0").base), 8))
        mgr.synchronize()
        with pytest.raises(fw.core.QuarantineError):
            mgr.remove_tenant("t1")
        total = sum(mgr.violog.counts("t1").values())
        mgr.quarantine.readmit("t1")
        after_readmit = sum(mgr.violog.counts("t1").values())
        p = clients[1].malloc(4)
        clients[1].memcpy_h2d(p, np.ones(4, np.float32))
        clients[1].launch_kernel("bump", ptrs=[p], args=(4,))
        mgr.synchronize()
        return {"total": total, "after": after_readmit,
                "state": mgr.quarantine.state_of("t1").name,
                "data": clients[1].memcpy_d2h(p, 4)}
    ref, got = on_both(run)
    assert got["total"] == 8 and got["after"] == 0
    np.testing.assert_array_equal(got["data"], np.full(4, 2.0, np.float32))
    assert_same_tree(ref, got)


@pytest.mark.parametrize("how", ["remove", "quarantine"])
def test_native_programs_purged_on_tenant_set_change(how):
    """No NONE-policy (unfenced) program survives a tenant-set or
    lifecycle change, as the reference's native jit entries do not."""
    def run(fw):
        mgr = fw.manager(total_slots=256, quarantine_policy=(
            fw.core.ThresholdPolicy(quarantine_after=1 << 30)))
        solo = mgr.register_tenant("solo", 64)
        solo.module_load("bump", fw.kernel("bump"))
        p = solo.malloc(8)
        solo.memcpy_h2d(p, np.zeros(8, np.float32))
        solo.launch_kernel("bump", ptrs=[p], args=(8,))
        mgr.synchronize()
        entry = mgr.pointer_to_symbol["bump"]
        had = any(k[0] == "native" for k in entry.jit_cache)
        if how == "remove":
            mgr.remove_tenant("solo")
        else:
            mgr.quarantine.quarantine("solo", reason="operator action")
        return had, any(k[0] == "native" for k in entry.jit_cache)
    ref, got = on_both(run)
    assert got == (True, False) and ref == got


def test_eviction_purges_modulo_and_table_caches():
    def run(fw):
        mgr, clients = _q_manager(fw, n=2, policy=fw.core.FencePolicy.MODULO,
                                  mode=fw.core.SharingMode.TIME_SHARE)
        part = mgr.bounds.lookup("t1")
        p = clients[1].malloc(4)
        clients[1].memcpy_h2d(p, np.ones(4, np.float32))
        clients[1].launch_kernel("bump", ptrs=[p], args=(4,))
        mgr.synchronize()
        entry = mgr.pointer_to_symbol["bump"]
        key = (part.base, part.size)
        had = key in entry.modulo_static
        mgr.quarantine.quarantine("t1")
        mgr.quarantine.evict("t1")
        left = key in entry.modulo_static or any(
            k[0] == f"mod{part.base}.{part.size}" for k in entry.jit_cache)
        return had, left
    ref, got = on_both(run)
    assert got == (True, False) and ref == got


def _quarantine_rogue(fw, mgr, clients):
    rogue = clients[-1]
    outside = fw.i32(mgr.bounds.total_slots - 8)
    while mgr.quarantine.state_of(rogue.tenant_id).admissible:
        rogue.launch_kernel("evil", args=(outside, 8))
        mgr.run_queued()
    return rogue.tenant_id


@pytest.mark.parametrize("readmit_after", [None, 1, 3])
def test_readmission_probes(readmit_after):
    """Probe readmission into a probation partition after N clean cycles,
    eviction on a probation offence, and no probe when disabled."""
    def run(fw):
        mgr, clients = _q_manager(fw, after=4, readmit_after=readmit_after)
        good, rogue_id = clients[0], _quarantine_rogue(fw, mgr, clients)
        p = good.malloc(4)
        good.memcpy_h2d(p, np.zeros(4, np.float32))
        for _ in range(readmit_after or 5):
            good.launch_kernel("bump", ptrs=[p], args=(4,))
            mgr.run_queued()
        rec = mgr.quarantine.machine.record_of(rogue_id)
        out = {"state": rec.state.name, "probation": rec.probation,
               "size": mgr.bounds.lookup(rogue_id).size,
               "log": _violog(mgr)}
        if rec.probation:
            clients[-1].launch_kernel(
                "evil", args=(fw.i32(mgr.bounds.total_slots - 8), 8))
            mgr.run_queued()
            out["after_offence"] = mgr.quarantine.state_of(rogue_id).name
        return out
    ref, got = on_both(run)
    if readmit_after is None:
        assert got["state"] == "QUARANTINED"
    else:
        assert got["probation"] and got["after_offence"] == "EVICTED"
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# NONE: out-of-arena indices, the reference's values and no fault
# ---------------------------------------------------------------------------

def test_none_policy_out_of_arena_launch_matches_reference():
    """A standalone tenant (NONE policy, the native twin) launches with
    indices past both ends of the arena: the reference's clamped gathers
    and dropped scatters, no exception, and the next launch runs."""
    def run(fw):
        mgr = fw.manager(total_slots=64)
        a = mgr.register_tenant("a", 64)
        a.module_load("echo", fw.kernel("echo"))
        p = a.malloc(8)
        a.memcpy_h2d(p, np.arange(8, dtype=np.float32))
        r1 = a.launch_kernel("echo", args=(fw.i32(60), 8))
        r2 = a.launch_kernel("echo", args=(fw.i32(-70), 8))
        r3 = a.launch_kernel("echo", ptrs=[p], args=(8,))
        mgr.synchronize()
        return {"results": [np_of(r.result) for r in (r1, r2, r3)],
                "arena": fw.arena(mgr)}
    ref, got = on_both(run)
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# The simulated libraries (core/libsim.py)
# ---------------------------------------------------------------------------

def _libsim(fw):
    if fw is JAX:
        from repro.core import libsim as L
    else:
        from repro_torch.core import libsim as L
    return L


def test_libsim_end_to_end_with_implicit_calls():
    def run(fw):
        L = _libsim(fw)
        mgr = fw.manager(total_slots=1024,
                         mode=fw.core.SharingMode.TIME_SHARE)
        L.register_all_libraries(mgr)
        a = mgr.register_tenant("a", 256)
        blas = L.GrdBLAS(a).create()
        x = a.malloc(16)
        a.memcpy_h2d(x, np.arange(16, dtype=np.float32) - 8)
        idx = blas.isamax(x, 16)
        calls = a.trace.implicit_calls()
        return {"idx": int(np_of(idx)), "calls": calls}
    ref, got = on_both(run)
    assert got["idx"] == 0
    assert got["calls"]["cublasCreate"]["cudaMalloc"] == 3
    assert_same_tree(ref, got)


@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
def test_libsim_outputs_match_reference(policy):
    """Every library kernel at a small size, in a shared arena (fenced),
    seeded inputs; the forged-column SpMV stays inside its tenant."""
    rng = np.random.default_rng(7)
    data = {k: rng.uniform(0, 1, n).astype(np.float32) for k, n in
            (("a", 64), ("b", 64), ("x", 32), ("y", 32), ("v", 16))}
    cols = rng.integers(0, 16, 16).astype(np.float32)

    def run(fw):
        L = _libsim(fw)
        mgr = fw.manager(total_slots=2048,
                         policy=getattr(fw.core.FencePolicy, policy),
                         quarantine_policy=fw.core.ThresholdPolicy(
                             quarantine_after=1 << 30))
        L.register_all_libraries(mgr)
        a = mgr.register_tenant("a", 512)
        b = mgr.register_tenant("b", 512)
        victim = b.malloc(16)
        b.memcpy_h2d(victim, np.full(16, 3.0, np.float32))
        ptr = {}
        for k, arr in data.items():
            ptr[k] = a.malloc(arr.size)
            a.memcpy_h2d(ptr[k], arr)
        ptr["c"], ptr["out"], ptr["f"] = (a.malloc(64), a.malloc(1),
                                          a.malloc(32))
        ptr["cols"], ptr["sy"] = a.malloc(16), a.malloc(16)
        a.memcpy_h2d(ptr["cols"], cols)
        blas = L.GrdBLAS(a).create()
        blas.gemm(ptr["a"], ptr["b"], ptr["c"], 8, 8, 8)
        d = blas.dot(ptr["x"], ptr["y"], ptr["out"], 32)
        blas.axpby(2.0, ptr["x"], 0.5, ptr["y"], 32)
        L.GrdFFT(a).exec_c2c(ptr["x"], ptr["f"], 16)
        sp = L.GrdSPARSE(a)
        sp.csr_spmv(ptr["v"], ptr["cols"], ptr["x"], ptr["sy"], 16, 16)
        forged = a.malloc(16)
        a.memcpy_h2d(forged, np.full(16, float(victim.addr), np.float32))
        sp.csr_spmv(ptr["v"], forged, ptr["x"], ptr["sy"], 16, 16)
        mgr.synchronize()
        out = {k: a.memcpy_d2h(ptr[k], n) for k, n in
               (("c", 64), ("out", 1), ("y", 32), ("f", 32), ("sy", 16))}
        out["dot"] = np_of(d.result)
        out["victim"] = b.memcpy_d2h(victim, 16)
        out["log"] = _violog(mgr)
        return out
    ref, got = on_both(run)
    np.testing.assert_array_equal(got["victim"], np.full(16, 3.0,
                                                         np.float32))
    assert ref["log"] == got["log"]
    for k in ("c", "out", "y", "f", "sy", "dot"):
        assert_close(got[k], ref[k], TOL_F32)


# ---------------------------------------------------------------------------
# Tracing, the README snippet
# ---------------------------------------------------------------------------

def test_registration_and_tracing_leave_the_arena_untouched():
    """Tracing runs on fake tensors: a kernel that stores into the arena
    is traced (and its proof computed) without writing the live arena."""
    mgr = TORCH.manager(total_slots=256)
    a = mgr.register_tenant("a", 64)
    mgr.register_tenant("b", 64)
    a.module_load("evil", TORCH.kernel("evil"))
    before = np_of(mgr.arena.buf).copy()
    proof = mgr.sandbox_report("evil", example_args=(TORCH.i32(0), 16))
    from repro_torch.core.sandbox import sandbox
    prog = sandbox(TORCH.kernel("evil")).program(
        None, (mgr.arena.buf, TORCH.i32(0), 16))
    assert proof.n_fenced == 1 and prog.report.fenced_scatters == 1
    np.testing.assert_array_equal(np_of(mgr.arena.buf), before)


def test_readme_thirty_seconds_of_api_in_torch():
    """README's "Thirty seconds of API", in the port, on the CPU."""
    from repro_torch.core import GuardianManager, TenantClassPolicy

    def bump(arena, ptr, n):
        idx = ptr + torch.arange(n, dtype=torch.int32, device=arena.device)
        arena[idx] = torch.take(arena, idx.long()) + 1.0
        return arena, None

    mgr = GuardianManager(total_slots=256, lookahead_cycles=2, device="cpu")
    lc = mgr.register_tenant(
        "search", 64, tenant_class=TenantClassPolicy.latency_critical())
    be = mgr.register_tenant("batch", 64, tenant_class="best_effort")
    for client in (lc, be):
        client.module_load("bump", bump)
    p = lc.malloc(8)
    lc.memcpy_h2d(p, np.zeros(8, np.float32))
    lc.launch_kernel("bump", ptrs=[p], args=(8,))
    mgr.run_queued()
    assert (lc.memcpy_d2h(p, 8) == 1.0).all()
    assert mgr.metrics_report()["tenants"]["search"]["class"] == \
        "latency_critical"


def test_quickstart_and_failover_run_on_the_cpu():
    from repro_torch.examples import failover, quickstart
    quickstart.main(["--device", "cpu", "--launches", "3"])
    failover.main(["--device", "cpu"])


def test_forged_device_ptr_memcpy_rejected():
    mgr = TORCH.manager(total_slots=256)
    a = mgr.register_tenant("a", 64)
    b = mgr.register_tenant("b", 64)
    pa, pb = a.malloc(8), b.malloc(8)
    forged = dataclasses.replace(pa, addr=pb.addr)
    with pytest.raises(TORCH.core.GuardianViolation):
        a.memcpy_h2d(forged, np.zeros(8, np.float32))
    with pytest.raises(TORCH.core.GuardianViolation):
        a.memcpy_d2h(forged, 8)

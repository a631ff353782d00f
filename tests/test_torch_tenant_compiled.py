"""Compiled tenant launches (``GuardianManager._launch_compiled``,
:mod:`repro_torch.core.stepgraph`) on the CPU, where a step graph runs its
step on the same staged operands a CUDA replay reads: the per-launch
twins and the scheduler's fused BITWISE / MODULO / CHECK steps, one graph
per (kernel, policy, operand signature, width).

Each scenario runs on the reference too where it has a counterpart
(``on_both``) and holds arena bytes, ViolationLog rows and results equal;
the graph counts, the purges of graphs and the staging are the port's
own.  The fence rows, row scalars and log row ids are staged at dispatch:
a partition that moved between two replays of one key is fenced at its
new row, and tenant sets of one signature share one graph.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _tenant_parity import JAX, TORCH, assert_same_tree, \
    on_both  # noqa: E402
from _torch_parity import np_of  # noqa: E402
from repro_torch.core.stepgraph import StepCaptureError, \
    StepGraph  # noqa: E402

N = 8                       # slots each launch stores
POLICIES = ["BITWISE", "MODULO", "CHECK"]


def _graphs(mgr):
    """Every tenant graph of the port's manager: (cache key, graph)."""
    caches = [e.jit_cache for e in mgr.pointer_to_symbol.values()]
    caches.append(mgr.scheduler._fused_cache)
    return [(k, g) for c in caches for k, g in c.items()
            if isinstance(g, StepGraph)]


def _violog(mgr):
    return {t: mgr.violog.counts(t) for t in sorted(mgr.violog.tenants())}


class _Plane:
    """A manager whose tenants each own one ``N``-slot buffer filled with
    5.0 and launch ``evil`` (store 999.0 at a target) at it, or at an
    address of their choosing."""

    def __init__(self, fw, slots=1024, **kw):
        self.fw = fw
        kw.setdefault("quarantine_policy", fw.core.ThresholdPolicy(
            quarantine_after=1 << 30))
        self.mgr = fw.manager(total_slots=slots, **kw)
        self.clients, self.bufs = {}, {}

    def join(self, t, slots=64, pad=0):
        c = self.clients[t] = self.mgr.register_tenant(t, slots)
        c.module_load("evil", self.fw.kernel("evil"))
        if pad:
            c.malloc(pad)
        self.bufs[t] = c.malloc(N)
        c.memcpy_h2d(self.bufs[t], np.full(N, 5.0, np.float32))

    def launch(self, t, at=None):
        """``t`` stores at its own buffer (through its pointer, which the
        manager translates after a move), or at address ``at``."""
        if at is None:
            return self.clients[t].launch_kernel(
                "evil", ptrs=[self.bufs[t]], args=(N,))
        return self.clients[t].launch_kernel(
            "evil", args=(self.fw.i32(at), N))

    def round(self, who, forged=None):
        for t in who:
            self.launch(t, None if forged is None else forged.get(t))
        self.mgr.run_queued()

    def arena(self):
        return self.fw.arena(self.mgr)


# --------------------------------------------------------------------- #
# Fence rows staged at dispatch                                         #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("width", [1, 4])
def test_fence_row_is_read_at_dispatch_not_at_enqueue(width):
    """A launch enqueued before its tenant's partition grew in place runs,
    at the drain, fenced at the grown row: the forged address lies in the
    grown extent only, and lands there instead of wrapping into the old
    one.  Port only: the reference's queued request keeps the row of its
    enqueue (both rows lie inside the tenant's partition)."""
    p = _Plane(TORCH, slots=512, policy=TORCH.core.FencePolicy.BITWISE)
    for t, slots in (("t0", 64), ("t1", 64), ("t2", 128), ("t3", 64)):
        p.join(t, slots)
    who = ["t3"] if width == 1 else ["t0", "t1", "t2", "t3"]
    p.round(who)                                    # capture
    old = p.mgr.bounds.lookup("t3")
    at = old.end + 8                # inside the buddy t3 grows into
    for t in who:
        p.launch(t, at if t == "t3" else None)      # enqueued
    new = p.mgr.elastic.grow("t3")
    assert (new.base, new.size) == (old.base, 2 * old.size)
    p.mgr.synchronize()
    arena = p.arena()
    np.testing.assert_array_equal(arena[at:at + N], np.full(N, 999.0))
    wrapped = old.base + (at & old.mask)
    assert (arena[wrapped:wrapped + N] == 0.0).all()
    ((_, graph),) = _graphs(p.mgr)
    assert graph.replays == 1


@pytest.mark.parametrize("policy", POLICIES)
def test_partition_moved_between_replays_is_fenced_at_its_new_row(policy):
    """t0..t3 replay one fused key; the elastic plane relocates t3 and t4
    registers into t3's old extent; the next replay, with t3's pointer
    forged at t4's buffer, is fenced at t3's new row — t4's extent holds
    only its own bytes — and t0, t1, t2, t4 then replay the same graph.
    Arena bytes and log rows equal the reference's."""
    def run(fw):
        p = _Plane(fw, policy=getattr(fw.core.FencePolicy, policy))
        for t in ("t0", "t1", "t2", "t3"):
            p.join(t, pad=2 * N if t == "t3" else 0)
        four = ["t0", "t1", "t2", "t3"]
        p.round(four)
        p.round(four)
        old = p.mgr.bounds.lookup("t3")
        new = p.mgr.elastic.relocate("t3", 64)
        p.join("t4")
        p.round(four, forged={"t3": p.bufs["t4"].addr})
        p.round(["t0", "t1", "t2", "t4"])
        p.mgr.synchronize()
        return {"arena": p.arena(), "log": _violog(p.mgr),
                "bounds": [(q.base, q.size) for q in (
                    old, new, p.mgr.bounds.lookup("t4"))]}, p
    (ref, _), (got, p) = on_both(run)
    old, new, t4 = got["bounds"]
    assert t4 == old and new != old
    arena = got["arena"]
    want = np.zeros(64, np.float32)
    want[:N] = 999.0                       # t4's own stores, nothing else
    np.testing.assert_array_equal(arena[t4[0]:t4[0] + 64], want)
    landed = (arena[new[0]:new[0] + N] == 999.0).all()
    assert landed == (policy != "CHECK")
    assert got["log"]["t3"]["scatter"] == (N if policy == "CHECK" else 0)
    ((_, graph),) = _graphs(p.mgr)
    assert graph.replays == 3
    assert_same_tree(ref, got)


@pytest.mark.parametrize("policy", POLICIES)
def test_tenant_sets_of_one_signature_share_one_graph(policy):
    """Three different sets of four co-located tenants launch one kernel
    signature: one fused graph, captured once and replayed twice, each
    row fenced with its own tenant's row; the bytes equal the
    reference's."""
    sets = [["t0", "t1", "t2", "t3"], ["t2", "t3", "t4", "t5"],
            ["t1", "t3", "t4", "t5"]]

    def run(fw):
        p = _Plane(fw, policy=getattr(fw.core.FencePolicy, policy))
        for i in range(6):
            p.join(f"t{i}")
        for who in sets:
            # each set's last tenant forges at t0's buffer
            p.round(who, forged={who[-1]: p.bufs["t0"].addr})
        p.mgr.synchronize()
        return {"arena": p.arena(), "log": _violog(p.mgr)}, p
    (ref, _), (got, p) = on_both(run)
    ((key, graph),) = _graphs(p.mgr)
    assert graph.replays == 2 and key[3] == 4
    assert p.mgr.scheduler.stats.fused_steps == 3
    assert p.mgr.jit_cache_stats()["graphs"] == 1
    assert_same_tree(ref, got)


# --------------------------------------------------------------------- #
# Purges                                                                #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("how", ["remove", "quarantine", "join"])
def test_native_graphs_purged_on_tenant_set_change(how):
    """A standalone tenant's NONE graph (captured, then replayed) does not
    survive a tenant-set change; after a join the standalone tenant's next
    launch, forged at the newcomer's buffer, runs fenced.  The reference
    purges its native programs on remove and quarantine (compared); the
    port also purges on a join, where the reference's policy re-resolution
    alone keeps the native binary from running (the bytes compared)."""
    def run(fw):
        p = _Plane(fw, slots=256)
        p.join("solo")
        p.round(["solo"])
        p.round(["solo"])
        cache = p.mgr.pointer_to_symbol["evil"].jit_cache
        had = any(k[0] == "native" for k in cache)
        graphs = [g.replays for k, g in cache.items()
                  if k[0] == "native" and isinstance(g, StepGraph)]
        if how == "remove":
            p.mgr.remove_tenant("solo")
        elif how == "quarantine":
            p.mgr.quarantine.quarantine("solo", reason="operator action")
        else:
            p.join("late")
            p.round(["solo"], forged={"solo": p.bufs["late"].addr})
            p.mgr.synchronize()
        left = any(k[0] == "native" for k in cache)
        late = p.bufs["late"].addr if how == "join" else None
        return {"had": had, "left": left, "arena": p.arena(),
                "late": late}, graphs
    (ref, _), (got, graphs) = on_both(run)
    assert got["had"] and not got["left"] and graphs == [1]
    if how == "join":
        # the newcomer's buffer kept its bytes: the forgery wrapped
        late = got["arena"][got["late"]:got["late"] + N]
        np.testing.assert_array_equal(late, np.full(N, 5.0))
        ref.pop("left"), got.pop("left")
    assert_same_tree(ref, got)


@pytest.mark.parametrize("how", ["evict", "relocate"])
def test_modulo_graphs_purged_on_partition_death(how):
    """A per-launch MODULO graph has its partition's bounds as constants
    (mode ``mod{base}.{size}``): eviction or a move of the partition drops
    it with its programs, as the reference drops its jit entries; the
    moved tenant's next launch captures a graph for its new bounds."""
    def run(fw):
        p = _Plane(fw, policy=fw.core.FencePolicy.MODULO,
                   mode=fw.core.SharingMode.TIME_SHARE)
        for t in ("t0", "t1"):
            p.join(t)
        for _ in range(2):
            p.launch("t1")
        part = p.mgr.bounds.lookup("t1")
        mode = f"mod{part.base}.{part.size}"
        cache = p.mgr.pointer_to_symbol["evil"].jit_cache
        had = any(k[0] == mode for k in cache)
        if how == "evict":
            p.mgr.quarantine.quarantine("t1")
            p.mgr.quarantine.evict("t1")
        else:
            new = p.mgr.elastic.relocate("t1", part.size)
            p.launch("t1")
            had = had and any(k[0] == f"mod{new.base}.{new.size}"
                              for k in cache)
        left = any(k[0] == mode for k in cache)
        return {"had": had, "left": left, "arena": p.arena()}, p
    (ref, _), (got, p) = on_both(run)
    assert got["had"] and not got["left"]
    assert len(_graphs(p.mgr)) == (0 if how == "evict" else 1)
    assert_same_tree(ref, got)


# --------------------------------------------------------------------- #
# CHECK under replay                                                    #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("path", ["per_launch", "fused"])
def test_check_after_a_replay_matches_reference(path):
    """CHECK replayed: the per-launch path raises on the faulting launch,
    which never lands, with its counts logged; the fused path commits the
    offender's row selectively.  Each first captures its key with in-range
    launches; the arena bytes and log rows equal the reference's."""
    def run(fw):
        kw = ({"mode": fw.core.SharingMode.TIME_SHARE}
              if path == "per_launch" else {})
        p = _Plane(fw, policy=fw.core.FencePolicy.CHECK, **kw)
        for t in ("t0", "t1", "t2"):
            p.join(t)
        who = ["t2"] if path == "per_launch" else ["t0", "t1", "t2"]
        p.round(who)
        raised = False
        try:        # at the slots past t0's buffer
            p.round(who, forged={"t2": p.bufs["t0"].addr + N})
            p.mgr.synchronize()
        except fw.core.GuardianViolation:
            raised = True
        return {"raised": raised, "log": _violog(p.mgr),
                "arena": p.arena(),
                "violations": len(p.mgr.violations)}, p
    (ref, _), (got, p) = on_both(run)
    assert got["raised"] == (path == "per_launch")
    assert got["log"]["t2"]["scatter"] == N
    at = p.bufs["t0"].addr + N
    assert (got["arena"][at:at + N] == 0.0).all()
    ((_, graph),) = _graphs(p.mgr)
    assert graph.replays == 1
    assert_same_tree(ref, got)


class _Replayed:
    """Stands in for a captured CUDA graph: a replay runs nothing on the
    host."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_host_counts_are_added_per_replay():
    """What the traced Python does on the host happens once, at capture:
    a replay runs no Python, yet each fused CHECK replay adds its rows'
    rollback bytes (a by-value result of the step) and each graph replay
    adds its captured kernel launches."""
    from repro_torch.kernels import _build

    p = _Plane(TORCH, policy=TORCH.core.FencePolicy.CHECK)
    for t in ("t0", "t1", "t2", "t3"):
        p.join(t)
    who = ["t0", "t1", "t2", "t3"]
    st = p.mgr.scheduler.stats
    p.round(who)
    per_round = 4 * N * 4           # four rows, N f32 stores each logged
    assert st.rollback_bytes == per_round
    ((_, graph),) = _graphs(p.mgr)
    kernel = next(iter(_build.KERNELS.values()))
    launches = kernel.launches
    graph.graph = stub = _Replayed()
    graph.launches = {kernel: 3}
    try:
        for _ in range(2):
            p.round(who)
        assert stub.replays == 2 and kernel.launches == launches + 6
    finally:
        kernel.launches = launches
    assert st.rollback_bytes == 3 * per_round


# --------------------------------------------------------------------- #
# What cannot be compiled, and what is staged                           #
# --------------------------------------------------------------------- #

def _fresh(arena, ptr, n):
    """Stores out of place: hands back a new arena tensor."""
    idx = ptr + torch.arange(n, dtype=torch.int32, device=arena.device)
    return arena.index_put((idx.long(),), torch.ones(n)), None


@pytest.mark.parametrize("policy,fused", [
    ("NONE", False), ("BITWISE", False), ("MODULO", False),
    ("CHECK", False), ("BITWISE", True), ("CHECK", True)])
def test_twin_returning_a_fresh_arena_is_refused_by_name(policy, fused):
    """A kernel whose twin hands back a fresh arena tensor cannot be
    compiled: the launch raises StepCaptureError naming the kernel, and
    the manager's arena stays the tensor it was.  Port only (the
    reference's arena is functional)."""
    core = TORCH.core
    kw = {} if fused else {"mode": core.SharingMode.TIME_SHARE}
    mgr = TORCH.manager(total_slots=256, policy=getattr(
        core.FencePolicy, "BITWISE" if policy == "NONE" else policy), **kw)
    who = ["a"] if policy == "NONE" else ["a", "b"]
    clients = [mgr.register_tenant(t, 64) for t in who]
    clients[0].module_load("fresh", _fresh)
    buf = mgr.arena.buf
    with pytest.raises(StepCaptureError, match="'fresh"):
        for c in clients:
            c.launch_kernel("fresh", args=(TORCH.i32(3), 4))
        mgr.synchronize()
    assert mgr.arena.buf is buf


def test_operand_tensors_are_staged_never_bound():
    """Every tensor a tenant graph reads but the arena is a staged copy,
    rewritten at dispatch: axpby's alpha and beta, passed as host 0-d
    tensors, reach the replay of one key with each launch's own values,
    and no caller tensor is bound into the graph.  The stored bytes equal
    the reference's."""
    x = np.arange(N, dtype=np.float32)

    def run(fw):
        from importlib import import_module
        L = import_module(f"{fw.core.__name__}.libsim")
        mgr = fw.manager(total_slots=256,
                         mode=fw.core.SharingMode.TIME_SHARE)
        L.register_all_libraries(mgr)
        a = mgr.register_tenant("a", 64)
        mgr.register_tenant("b", 64)
        px, py = a.malloc(N), a.malloc(N)
        a.memcpy_h2d(px, x)
        a.memcpy_h2d(py, x)
        alphas = []
        for alpha, beta in ((2.0, 0.5), (3.0, 1.0), (-1.0, 0.0)):
            ab = (fw.f32(alpha), fw.f32(beta))
            alphas.append(ab)
            a.launch_kernel("grdblas.axpby", ptrs=[px, py], args=(*ab, N))
        return {"y": a.memcpy_d2h(py, N)}, (mgr, alphas)
    (ref, _), (got, (mgr, alphas)) = on_both(run)
    ((_, graph),) = [kg for kg in _graphs(mgr)
                     if kg[1].name.startswith("grdblas.axpby")]
    assert graph.replays == 2
    staged = {id(t) for _, t in graph.staged}
    caller = {id(t) for ab in alphas for t in ab}
    assert len(graph.staged) == 6      # base, mask, x, y, alpha, beta
    assert not staged & caller
    assert all(t.device == mgr.device and t.dim() == 0
               for _, t in graph.staged)
    np.testing.assert_array_equal(np_of(got["y"]), np_of(ref["y"]))
    assert_same_tree(ref, got)

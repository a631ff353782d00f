"""Tenant kernels with structural control flow: the port's sandbox,
verifier and manager interpret ``torch.cond`` / ``while_loop`` / ``scan``
as the reference interprets ``lax.cond`` / ``lax.while_loop`` /
``lax.scan``.  Each kernel exists in jnp and in torch (a real
higher-order op, no unrolled loop), runs through both sides on the same
numpy inputs, and gives equal results, ``ok``, violation counts, report
counts and verdicts.  Mirrors tests/test_sandbox.py's loop cases (their
unrolled twins stay in tests/test_torch_sandbox.py) and
tests/test_verifier.py's scan proof, plus what only the structural form
can say: a trip count read from the arena, CHECK's rollback of a loop's
stores, the launch through the manager's graphs, solo and fused, and a
moved partition fenced at its new row inside a loop."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._higher_order_ops.scan import scan  # noqa: E402
from torch._higher_order_ops.while_loop import while_loop  # noqa: E402

from _tenant_parity import JAX, TORCH, assert_same_tree  # noqa: E402
from _torch_parity import np_of, t_of  # noqa: E402
from repro.core import fence as FJ  # noqa: E402
from repro.core import verifier as VJ  # noqa: E402
from repro_torch.core import fence as FT  # noqa: E402
from repro_torch.core import verifier as VT  # noqa: E402

SJ = importlib.import_module("repro.core.sandbox")
ST = importlib.import_module("repro_torch.core.sandbox")

I32 = torch.int32
ARENA = np.arange(256, dtype=np.float32)
SIGNS = np.where(np.random.default_rng(0).random(256) > 0.5, 1.0,
                 -1.0).astype(np.float32)


def _iota(n, like):
    return torch.arange(n, dtype=I32, device=like.device)


def _both(kj, kt, args_np, policy="BITWISE", count=False, base=64,
          size=64, verify=False):
    sj = SJ.sandbox(kj, policy=getattr(FJ.FencePolicy, policy),
                    count_violations=count, verify=verify)
    st_ = ST.sandbox(kt, policy=getattr(FT.FencePolicy, policy),
                     count_violations=count, verify=verify)
    arrays = (np.ndarray, np.generic)
    aj = [jnp.asarray(a) if isinstance(a, arrays) else a for a in args_np]
    at = [t_of(np.asarray(a)) if isinstance(a, arrays) else a
          for a in args_np]
    return (sj(FJ.FenceParams(base=base, size=size), *aj),
            st_(FT.FenceParams(base=base, size=size), *at))


def _counts(rep):
    return {k: getattr(rep, k) for k in (
        "fenced_gathers", "fenced_scatters", "fenced_dynamic_slices",
        "fenced_dynamic_updates", "elided_gathers", "elided_scatters",
        "elided_dynamic_slices", "elided_dynamic_updates")}


# ---------------------------------------------------------------------------
# The kernels, in jnp and in torch
# ---------------------------------------------------------------------------

def carried_j(arena, n):
    def body(a, _):
        return a, None
    a, _ = jax.lax.scan(body, arena, jnp.arange(4))
    return a, None


def carried_t(arena, n):
    def body(a, x):
        return a.clone(), x + 1
    a, _ = scan(body, arena, _iota(4, arena))
    return a, None


def scan_gather_j(arena, ptr):
    def body(carry, x):
        return carry + 1, jnp.take(arena, carry + x, axis=0)
    _, ys = jax.lax.scan(body, ptr, jnp.arange(4, dtype=jnp.int32))
    return arena, ys


def scan_gather_t(arena, ptr):
    def body(carry, x):
        return carry + 1, torch.take(arena, (carry + x).long().reshape(1))[0]
    _, ys = scan(body, ptr, _iota(4, arena))
    return arena, ys


def while_j(arena, ptr):
    def cond(state):
        return state[0] < ptr + 4

    def body(state):
        i, acc = state
        return i + 1, acc + jnp.take(arena, i, axis=0)

    _, acc = jax.lax.while_loop(cond, body, (ptr, jnp.float32(0)))
    return arena, acc


def while_t(arena, ptr):
    def cond(i, acc):
        return i < ptr + 4

    def body(i, acc):
        return i + 1, acc + torch.take(arena, i.long().reshape(1))[0]

    _, acc = while_loop(cond, body, (ptr.clone(), torch.zeros(
        (), dtype=arena.dtype, device=arena.device)))
    return arena, acc


def cond_j(arena, ptr, flag):
    return arena, jax.lax.cond(flag > 0,
                               lambda p: jnp.take(arena, p, axis=0),
                               lambda p: jnp.float32(0.0), ptr)


def cond_t(arena, ptr, flag):
    return arena, torch.cond(
        flag > 0, lambda p: torch.take(arena, p.long().reshape(1))[0],
        lambda p: torch.zeros((), device=p.device), (ptr,))


def chase_j(arena, lst, cap, n):
    """Walks a list whose node k holds the next node's index at lst + k
    (-1 ends it) and marks each visit at lst + n + k: the trip count is
    the arena's data."""
    def cond(state):
        _, k, h = state
        return (k >= 0) & (h < cap)

    def body(state):
        a, k, h = state
        p = lst + k
        nxt = jnp.take(a, p, axis=0).astype(jnp.int32)
        return a.at[p + n].set((h + 1).astype(a.dtype)), nxt, h + 1

    a, _, h = jax.lax.while_loop(cond, body,
                                 (arena, jnp.int32(0), jnp.int32(0)))
    return a, h


def chase_t(arena, lst, cap, n):
    def cond(a, k, h):
        return (k >= 0) & (h < cap)

    def body(a, k, h):
        p = (lst + k).reshape(1)
        nxt = a.index_select(0, p)[0].to(I32)
        a = a.index_put((p + n,), (h + 1).to(a.dtype).reshape(1))
        return a, nxt, h + 1

    zero = torch.zeros((), dtype=I32, device=arena.device)
    a, _, h = while_loop(cond, body, (arena, zero.clone(), zero))
    return a, h


def axpy_j(arena, x, y, alpha, chunks, c):
    """y += alpha * x over ``chunks`` chunks of ``c``, a scan carrying the
    arena; the ys are each chunk's dot."""
    def body(carry, j):
        a, acc = carry
        idx = j * c + jnp.arange(c, dtype=jnp.int32)
        xv = jnp.take(a, x + idx, axis=0)
        yv = jnp.take(a, y + idx, axis=0)
        d = jnp.dot(xv, yv)
        return (a.at[y + idx].set(alpha * xv + yv), acc + d), d

    (a, acc), ys = jax.lax.scan(body, (arena, jnp.float32(0)),
                                jnp.arange(chunks, dtype=jnp.int32))
    return a, (acc, ys)


def axpy_t(arena, x, y, alpha, chunks, c):
    def body(carry, j):
        a, acc = carry
        idx = j * c + _iota(c, a)
        xv = a.index_select(0, x + idx)
        yv = a.index_select(0, y + idx)
        d = torch.dot(xv, yv)
        return (a.index_put((y + idx,), alpha * xv + yv), acc + d), d

    (a, acc), ys = scan(body, (arena, torch.zeros((), device=arena.device)),
                        _iota(chunks, arena))
    return a, (acc, ys)


def store_j(arena, p, flag, n):
    """Stores 7.0 at p .. p + n in one branch only."""
    def store(a, q):
        return a.at[q + jnp.arange(n, dtype=jnp.int32)].set(7.0)

    return jax.lax.cond(flag > 0, store, lambda a, q: a, arena, p), None


def store_t(arena, p, flag, n):
    def store(a, q):
        return a.index_put((q + _iota(n, a),),
                           torch.full((n,), 7.0, device=a.device))

    return torch.cond(flag > 0, store, lambda a, q: a.clone(),
                      (arena, p)), None


def nested_j(arena, p, n):
    """A ``cond`` nested in a ``while``: over k < n, 1.0 stored at
    p + n + k where the slot p + k is positive."""
    def cond(state):
        return state[1] < n

    def body(state):
        a, k = state
        v = jnp.take(a, p + k, axis=0)
        a = jax.lax.cond(v > 0, lambda a: a.at[p + n + k].set(1.0),
                         lambda a: a, a)
        return a, k + 1

    return jax.lax.while_loop(cond, body, (arena, jnp.int32(0)))[0], None


def nested_t(arena, p, n):
    def cond(a, k):
        return k < n

    def body(a, k):
        v = a.index_select(0, (p + k).reshape(1))[0]

        def mark(a, k):
            return a.index_put(((p + n + k).reshape(1),),
                               torch.ones(1, device=a.device))

        return torch.cond(v > 0, mark, lambda a, k: a.clone(), (a, k)), \
            k + 1

    zero = torch.zeros((), dtype=I32, device=arena.device)
    return while_loop(cond, body, (arena, zero))[0], None


STRUCT = {name: (globals()[name + "_j"], globals()[name + "_t"])
          for name in ("chase", "axpy", "store")}


# ---------------------------------------------------------------------------
# Mirrors of tests/test_sandbox.py's loop cases
# ---------------------------------------------------------------------------

def test_loop_carried_arena_supported():
    """scan with the arena in the carry is interpreted, not rejected; the
    body's ``a.clone()`` of the carry it replaces is elided, so the arena
    comes back as the tensor the kernel was given."""
    ref, got = _both(carried_j, carried_t, (np.zeros(64, np.float32),
                                            np.int32(0)))
    assert_same_tree(ref, got)
    arena = torch.zeros(64)
    (a, _), ok = ST.sandbox(carried_t)(FT.FenceParams(base=0, size=64),
                                       arena, torch.tensor(0, dtype=I32))
    assert a is arena and bool(ok)


@pytest.mark.parametrize("ptr", [64, 200])
@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
def test_scan_gather_fenced_per_iteration(ptr, policy):
    ref, got = _both(scan_gather_j, scan_gather_t,
                     (ARENA, np.int32(ptr)), policy, count=True)
    assert_same_tree(ref, got)
    ys = np_of(got[0][1])
    assert ((ys >= 64) & (ys < 128)).all()
    if policy == "CHECK":
        assert int(np_of(got[2])[0]) == (4 if ptr == 200 else 0)
        assert bool(got[1]) == (ptr == 64)


@pytest.mark.parametrize("ptr", [64, 200])
def test_while_loop_fenced_and_counted(ptr):
    ref, got = _both(while_j, while_t, (ARENA, np.int32(ptr)), "CHECK",
                     count=True)
    assert_same_tree(ref, got)
    assert bool(got[1]) == (ptr == 64)
    assert int(np_of(got[2])[0]) == (0 if ptr == 64 else 4)


@pytest.mark.parametrize("flag", [1, 0])
def test_cond_branches_fenced(flag):
    """The executed branch's access is fenced and counted; the untaken
    branch never runs its access."""
    ref, got = _both(cond_j, cond_t, (ARENA, np.int32(200), np.int32(flag)),
                     "CHECK", count=True)
    assert_same_tree(ref, got)
    assert bool(got[1]) == (flag == 0)


@pytest.mark.parametrize("name,args", [
    ("scan_gather", (ARENA, np.int32(0))),
    ("while", (ARENA, np.int32(0))),
    ("cond", (ARENA, np.int32(0), np.int32(1))),
    ("chase", (ARENA, np.int32(0), np.int32(8), 16)),
    ("axpy", (ARENA, np.int32(0), np.int32(32), np.float32(2.0), 2, 8)),
    ("store", (ARENA, np.int32(0), np.int32(1), 4)),
    ("nested", (SIGNS, np.int32(0), 8)),
])
def test_report_counts_match_reference(name, args):
    """Each body's sites are counted once, as the reference counts one
    trace of each body."""
    kj, kt = {"scan_gather": (scan_gather_j, scan_gather_t),
              "while": (while_j, while_t),
              "cond": (cond_j, cond_t),
              "nested": (nested_j, nested_t)}.get(name) or STRUCT[name]
    arrays = (np.ndarray, np.generic)
    rj = SJ.sandbox_report(kj, [jnp.asarray(a) if isinstance(a, arrays)
                                else a for a in args])
    rt = ST.sandbox_report(kt, [t_of(np.asarray(a)) if isinstance(
        a, arrays) else a for a in args])
    assert _counts(rt) == _counts(rj)
    assert rt.fenced_total > 0


@pytest.mark.parametrize("p", [64, 100, 300])
@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
def test_cond_nested_in_a_while(policy, p):
    """A ``cond`` inside a ``while`` body: the branch's store and the
    body's load are fenced on every iteration, and a pointer past the row
    (300) is wrapped into it or, under CHECK, counted — as the reference
    does it."""
    ref, got = _both(nested_j, nested_t, (SIGNS, np.int32(p), 8), policy,
                     count=True)
    assert_same_tree(ref, got)
    assert bool(got[1]) == (p != 300 or policy != "CHECK")


def test_saved_partition_must_be_aligned():
    """CHECK saves a ``while``'s partition as one block of its size: a row
    not aligned to its size is refused, not saved in part."""
    sb = ST.sandbox(store_t, policy=FT.FencePolicy.CHECK)
    args = (torch.zeros(256), torch.tensor(64, dtype=I32),
            torch.tensor(1, dtype=I32), 4)
    with pytest.raises(ST.SandboxError, match="aligned"):
        sb(FT.FenceParams(base=32, size=64), *args, undo=ST.UndoLog(span=64))


def _list_arena(order, forged_next=None):
    """The arena of the chase: a list at slot 64 visiting ``order``
    (node indices), its marks at 64 + 16."""
    arena = np.zeros(256, np.float32)
    prev = 0
    for k in order:
        arena[64 + prev] = k
        prev = k
    arena[64 + prev] = -1 if forged_next is None else forged_next
    return arena


@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
@pytest.mark.parametrize("order", [[3, 7, 1], [5], list(range(1, 12))])
def test_while_trip_count_from_the_arena(policy, order):
    """A ``while_loop`` whose trip count is read from the arena (a list
    walk): as many iterations as the list has nodes, each visit marked —
    a loop no unrolled twin can write."""
    ref, got = _both(chase_j, chase_t, (_list_arena(order), np.int32(64),
                                        np.int32(64), 16), policy,
                     count=True)
    assert_same_tree(ref, got)
    assert int(got[0][1]) == len(order) + 1
    assert bool(got[1])


@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
def test_forged_pointer_inside_a_loop_stays_in_the_row(policy):
    """The list's last node points far outside the row: the body's load
    and its mark store are fenced on that iteration (wrapped into the row,
    or under CHECK counted), and the walk goes on inside the row until the
    hop cap."""
    arena = _list_arena([3, 7], forged_next=100_000)
    ref, got = _both(chase_j, chase_t, (arena, np.int32(64), np.int32(6),
                                        16), policy, count=True)
    assert_same_tree(ref, got)
    out = np_of(got[0][0])
    changed = np.nonzero(out != arena)[0]
    assert ((changed >= 64) & (changed < 128)).all()
    if policy == "CHECK":
        assert not bool(got[1]) and int(np_of(got[2]).sum()) > 0


def test_check_in_while_condition_refused():
    """A CHECK-fenced access in a ``while`` condition cannot report its
    ``ok``: refused with the reference's message; a fencing policy
    fences it."""
    def kj(arena, ptr):
        def cond(state):
            return jnp.take(arena, state[0], axis=0) < 100.0
        return arena, jax.lax.while_loop(
            cond, lambda s: (s[0] + 1,), (ptr,))[0]

    def kt(arena, ptr):
        def cond(i):
            return torch.take(arena, i.long().reshape(1))[0] < 100.0
        return arena, while_loop(cond, lambda i: (i + 1,), (ptr.clone(),))[0]

    args = (ARENA, np.int32(64))
    with pytest.raises(SJ.SandboxError, match="while` condition"):
        _both(kj, lambda a, p: (a, None), args, "CHECK")
    with pytest.raises(ST.SandboxError, match="while` condition under CHECK"):
        _both(lambda a, p: (a, None), kt, args, "CHECK")
    ref, got = _both(kj, kt, args, "BITWISE")
    assert_same_tree(ref, got)
    assert int(got[0][1]) == 100


# ---------------------------------------------------------------------------
# CHECK's rollback of a loop's or a branch's stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chase", "axpy", "store"])
def test_check_rollback_restores_exactly_the_row(name):
    """A violating CHECK launch of a structural kernel leaves the arena as
    it was: the stores of every iteration or branch are undone (a scan's
    per iteration, a while's or a cond's from the row's partition saved
    before the node), on the device and without a host sync."""
    arena0 = _list_arena([3, 7], forged_next=100_000)
    args = {"chase": (torch.tensor(64, dtype=I32), torch.tensor(6, dtype=I32),
                      16),
            "axpy": (torch.tensor(64, dtype=I32), torch.tensor(
                120, dtype=I32), torch.tensor(2.0), 2, 8),
            "store": (torch.tensor(124, dtype=I32), torch.tensor(1, dtype=I32),
                      8)}[name]
    sb = ST.sandbox(STRUCT[name][1], policy=FT.FencePolicy.CHECK,
                    count_violations=True)
    arena = torch.from_numpy(arena0.copy())
    undo = ST.UndoLog()
    (out, _), ok, counts = sb(FT.FenceParams(base=64, size=64), arena, *args,
                              undo=undo)
    assert not bool(ok) and int(counts.sum()) > 0
    assert out is arena and not torch.equal(arena, torch.from_numpy(arena0))
    undo.rollback(ok)
    assert torch.equal(arena, torch.from_numpy(arena0))
    per_iteration = name == "axpy"
    assert (undo.nbytes == 64 * 4) != per_iteration


def test_saved_partition_needs_its_size():
    """A row given as tensors carries no size by value: the launch that
    must save the partition says so (the manager passes it)."""
    sb = ST.sandbox(store_t, policy=FT.FencePolicy.CHECK)
    fp = FT.FenceParams(base=torch.tensor(64, dtype=I32),
                        size=torch.tensor(64, dtype=I32))
    args = (torch.zeros(256), torch.tensor(64, dtype=I32),
            torch.tensor(1, dtype=I32), 4)
    with pytest.raises(ST.SandboxError, match="span"):
        sb(fp, *args, undo=ST.UndoLog())
    (out, _), ok = sb(fp, *args, undo=ST.UndoLog(span=64))
    assert bool(ok) and float(out[64:68].sum()) == 28.0


# ---------------------------------------------------------------------------
# What stays refused
# ---------------------------------------------------------------------------

def _map_kernel(arena, ptr):
    from torch._higher_order_ops.map import map as hop_map
    return arena, hop_map(lambda x, a: torch.take(a, x.long().reshape(1)),
                          ptr.reshape(1), arena)


def _scan_over_arena(arena, ptr):
    return arena, scan(lambda c, x: (c + x, x * 2), torch.zeros(()),
                       arena)[0]


def _mutating_body(arena, ptr):
    def body(i):
        arena.index_put_((i.long().reshape(1),), torch.ones(1))
        return (i + 1,)
    return arena, while_loop(lambda i: i < 4, body, (ptr.clone(),))[0]


def _item_in_body(arena, ptr):
    def body(i):
        return (i + arena[int(i.item())].to(I32),)
    return arena, while_loop(lambda i: i < 4, body, (ptr.clone(),))[0]


@pytest.mark.parametrize("kernel", [_map_kernel, _scan_over_arena,
                                    _mutating_body, _item_in_body],
                         ids=["map", "scan_over_arena", "mutating_body",
                              "item_in_body"])
def test_unsupported_structures_fail_closed(kernel):
    """A higher-order op the sandbox does not interpret (``map``), a scan
    that slices the arena itself (every partition), a body that mutates
    (torch refuses to trace it: a body stores by carrying the arena) and
    a data-dependent value inside a body (the trace that ``while_loop``
    needs holds it as a symbol) all raise :class:`SandboxError`."""
    with pytest.raises(ST.SandboxError):
        ST.sandbox(kernel)(FT.FenceParams(base=64, size=64),
                           torch.arange(256.), torch.tensor(0, dtype=I32))


# ---------------------------------------------------------------------------
# The verifier over loops
# ---------------------------------------------------------------------------

def _rem_carry_j(arena, ptr):
    def body(carry, _):
        nxt = 64 + jax.lax.rem(carry + 1, jnp.int32(64))
        return nxt, jnp.take(arena, carry, axis=0)
    _, ys = jax.lax.scan(body, 64 + (ptr & 63), None, length=4)
    return arena, ys


def _rem_carry_t(arena, ptr):
    def body(carry, _):
        nxt = 64 + torch.fmod(carry + 1, 64)
        return nxt, torch.take(arena, carry.long().reshape(1))[0]
    _, ys = scan(body, 64 + (ptr & 63), torch.zeros(4, dtype=I32,
                                                    device=arena.device))
    return arena, ys


def _verdicts(proof):
    return [s.verdict for s in proof.sites]


@pytest.mark.parametrize("static", [True, False], ids=["static", "symbolic"])
def test_scan_carry_widening_proves(static):
    """The reference proves its scan carry through the widened fixpoint;
    the port's structural scan gives the same verdicts, with the site's
    path through the scan's body."""
    pj = VJ.verify(_rem_carry_j, (jnp.asarray(ARENA), jnp.int32(0)),
                   params=FJ.FenceParams(base=64, size=64) if static else None)
    pt = VT.verify(_rem_carry_t, (torch.from_numpy(ARENA), torch.tensor(
        0, dtype=I32)), params=FT.FenceParams(base=64, size=64)
        if static else None)
    assert _verdicts(pt) == _verdicts(pj)
    if static:
        assert pt.fully_proven and pt.sites[0].interval == "[64, 127]"
    assert pt.sites[0].path[1:] == (0, "take")


@pytest.mark.parametrize("name,kj,kt,args", [
    ("while", while_j, while_t, (ARENA, np.int32(0))),
    ("cond", cond_j, cond_t, (ARENA, np.int32(0), np.int32(1))),
    ("chase", chase_j, chase_t, (ARENA, np.int32(64), np.int32(8), 16)),
    ("axpy", axpy_j, axpy_t, (ARENA, np.int32(64), np.int32(96),
                              np.float32(2.0), 2, 8)),
    ("store", store_j, store_t, (ARENA, np.int32(64), np.int32(1), 4)),
    ("nested", nested_j, nested_t, (ARENA, np.int32(64), 8)),
])
@pytest.mark.parametrize("static", [True, False], ids=["static", "symbolic"])
def test_loop_verdicts_match_reference(name, kj, kt, args, static):
    """Every body's sites, in the reference's order (a while's condition
    before its body, a cond's false branch before its true one), with the
    reference's verdicts.  ``i < ptr + 4`` does not bound the while's
    carry: its access is FENCED, never PROVEN."""
    arrays = (np.ndarray, np.generic)
    pj = VJ.verify(kj, [jnp.asarray(a) if isinstance(a, arrays) else a
                        for a in args],
                   params=FJ.FenceParams(base=64, size=64) if static else None)
    pt = VT.verify(kt, [t_of(np.asarray(a)) if isinstance(a, arrays) else a
                        for a in args],
                   params=FT.FenceParams(base=64, size=64) if static else None)
    assert _verdicts(pt) == _verdicts(pj)
    assert "proven" not in _verdicts(pt) or name != "while"


def _extent_scan(arena, ptr):
    def body(carry, _):
        return 64 + torch.fmod(carry + 1, 64), torch.take(
            arena, carry.long().reshape(1))[0]
    return arena, scan(body, 64 + (ptr & 63),
                       torch.zeros(4, dtype=I32, device=arena.device))[1]


def _extent_scan_j(arena, ptr):
    def body(carry, _):
        return 64 + jax.lax.rem(carry + 1, jnp.int32(64)), jnp.take(
            arena, carry, axis=0)
    return arena, jax.lax.scan(body, 64 + (ptr & 63), None, length=4)[1]


def test_extent_mode_interprets_loops():
    """Extent mode walks a loop's body at its fixpoint too: the access
    stays inside the arena's extent, as the reference proves it."""
    pj = VJ.verify(_extent_scan_j, (jnp.asarray(ARENA), jnp.int32(0)),
                   mode="extent")
    pt = VT.verify(_extent_scan, (torch.from_numpy(ARENA), torch.tensor(
        0, dtype=I32)), mode="extent")
    assert _verdicts(pt) == _verdicts(pj) == ["proven"]


WRAP = 1 << 16


def _carry_overflow(k):
    """A scan whose carry the interval arithmetic keeps in the row while
    int32 wraps it out on the device: ``(c + k) * 4 // 4 - k``."""
    def kernel(arena, own):
        def body(c, _):
            arena_c = ((c + k) * 4) // 4 - k
            return arena_c, torch.take(arena, c.long().reshape(1))[0]
        start = torch.clamp(own, WRAP, 2 * WRAP - 1)
        return arena, scan(body, start, torch.zeros(
            4, dtype=I32, device=arena.device))[1]
    return kernel


def test_wrapping_loop_carry_is_not_proven():
    """A carry that overflows int32 across iterations (``2**29`` added
    before a ``* 4``) is ⊤ in the port, so the body's site is FENCED; the
    same carry without the overflow (``2**20``) stays PROVEN.  On the
    device the wrapped carry reaches far outside the row, and the fence
    keeps the load inside it."""
    arena = torch.zeros(4 * WRAP)
    own = torch.tensor(WRAP, dtype=I32)
    fp = FT.FenceParams(base=WRAP, size=WRAP)
    got = VT.verify(_carry_overflow(1 << 29), (arena, own), params=fp)
    fits = VT.verify(_carry_overflow(1 << 20), (arena, own), params=fp)
    assert _verdicts(got) == ["fenced"] and _verdicts(fits) == ["proven"]
    arena[WRAP:2 * WRAP] = 1.0
    (_, ys), _ = ST.sandbox(_carry_overflow(1 << 29), verify=True)(
        fp, arena, own)
    assert torch.equal(ys, torch.ones(4))


# ---------------------------------------------------------------------------
# Through the manager: compiled launches, solo and fused
# ---------------------------------------------------------------------------

def _plane(fw, policy, batch=True, tenants=4):
    mgr = fw.manager(total_slots=1024, policy=getattr(
        fw.core.FencePolicy, policy), batch_launches=batch,
        quarantine_policy=fw.core.ThresholdPolicy(quarantine_after=1 << 30))
    clients, bufs = [], []
    for t in range(tenants):
        c = mgr.register_tenant(f"t{t}", 256)
        for name, (kj, kt) in STRUCT.items():
            c.module_load(name, kj if fw is JAX else kt)
        b = {"lst": c.malloc(32), "x": c.malloc(16), "y": c.malloc(16),
             "s": c.malloc(8)}
        nxt = np.zeros(16, np.float32)
        for k, v in {0: 3 + t, 3 + t: 7, 7: 1, 1: -1}.items():
            nxt[k] = v
        c.memcpy_h2d(b["lst"], nxt)
        c.memcpy_h2d(b["x"], np.arange(16, dtype=np.float32) + t)
        c.memcpy_h2d(b["y"], np.ones(16, np.float32))
        clients.append(c)
        bufs.append(b)
    return mgr, clients, bufs


def _round(fw, mgr, clients, bufs, forged=None, flag=1):
    """Each tenant launches the three kernels; ``forged`` (a tenant, an
    address) aims that tenant's stores elsewhere."""
    reqs = []
    for t, (c, b) in enumerate(zip(clients, bufs)):
        fake = forged is not None and forged[0] == t
        reqs.append(c.launch_kernel("chase", ptrs=[b["lst"]], args=(
            fw.i32(64), 16)))
        y = [] if fake else [b["y"]]
        yarg = (fw.i32(forged[1]),) if fake else ()
        reqs.append(c.launch_kernel(
            "axpy", ptrs=[b["x"], *y],
            args=(*yarg, fw.f32(2.0), 2, 8)))
        s = [] if fake else [b["s"]]
        sarg = (fw.i32(forged[1]),) if fake else ()
        reqs.append(c.launch_kernel("store", ptrs=s,
                                    args=(*sarg, fw.i32(flag), 8)))
    raised = 0
    for _ in range(len(reqs) + 1):   # a per-launch CHECK drain raises once
        try:                         # a violating launch, then goes on
            mgr.synchronize()
            break
        except Exception as e:       # each side's own GuardianViolation
            if type(e).__name__ != "GuardianViolation":
                raise
            raised += 1
    res = []
    for r in reqs:
        out = r.result
        if isinstance(out, tuple):
            out = tuple(np_of(o) for o in out)
        elif out is not None:
            out = np_of(out)
        res.append(out)
    return res, raised


@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
@pytest.mark.parametrize("batch", [True, False], ids=["fused", "per_launch"])
def test_manager_launches_match_reference(policy, batch):
    """Four tenants launch the three structural kernels, then again with
    the cond's branch not taken, then once more with t3's axpy and store
    aimed at t0's buffers: on the reference and on the port, fused four
    wide and per launch, the same arena, results and violation rows.  The
    port runs every launch through its graphs (captured, then replayed);
    its forged stores stay in t3's partition (or, under CHECK, roll
    back)."""
    def scenario(fw):
        mgr, clients, bufs = _plane(fw, policy, batch)
        out = []
        for flag in (1, 0):
            out.append(_round(fw, mgr, clients, bufs, flag=flag))
        before = fw.arena(mgr)
        out.append(_round(fw, mgr, clients, bufs,
                          forged=(3, bufs[0]["y"].addr)))
        after = fw.arena(mgr)
        parts = [mgr.bounds.lookup(f"t{t}") for t in range(4)]
        return (out, after, mgr.violog.counts("t3"),
                [(p.base, p.size) for p in parts], before,
                bufs[0]["x"].addr, bufs[0]["y"].addr)

    ref, got = scenario(JAX), scenario(TORCH)
    assert_same_tree(ref[:4], got[:4])
    before, after, x0, y0 = got[4], got[1], got[5], got[6]
    # t0's y holds its own axpy of the round and nothing of t3's
    np.testing.assert_array_equal(after[y0:y0 + 16],
                                  before[y0:y0 + 16] + 2 * before[x0:x0 + 16])
    if policy == "CHECK":
        assert got[2]["scatter"] > 0


@pytest.mark.parametrize("policy", ["BITWISE", "CHECK"])
def test_manager_one_graph_per_key_and_replays(policy):
    """Three rounds of the same four-wide launches: one graph per kernel
    (CHECK: keyed by the rows' partition sizes, which the partition's
    save needs), captured once and replayed."""
    from repro_torch.core.stepgraph import StepGraph
    mgr, clients, bufs = _plane(TORCH, policy)
    for flag in (1, 0, 1):
        _round(TORCH, mgr, clients, bufs, flag=flag)
    graphs = [g for g in mgr.scheduler._fused_cache.values()
              if isinstance(g, StepGraph)]
    assert len(graphs) == 3 and sorted(g.replays for g in graphs) == [2] * 3
    if policy == "CHECK":
        # the chase and the store save the partition: their keys hold the
        # rows' partition sizes; the scan logs per iteration
        keys = [k for k, g in mgr.scheduler._fused_cache.items()
                if isinstance(g, StepGraph)]
        assert sorted(str(k[-2]) for k in keys) == sorted(
            [str((256,) * 4)] * 2 + ["None"])


def test_moved_partition_is_fenced_at_its_new_row_inside_a_loop():
    """t3's partition moves between two replays of the fused key; its
    store kernel's forged address, fenced inside the cond's branch, lands
    at the offset inside the new row, and the old extent's new owner
    keeps its bytes."""
    from repro_torch.core.stepgraph import StepGraph
    mgr = TORCH.manager(total_slots=2048,
                        policy=TORCH.core.FencePolicy.BITWISE)
    clients, sbufs = [], []
    for t in range(4):
        c = mgr.register_tenant(f"t{t}", 256)
        c.module_load("store", store_t)
        clients.append(c)
        sbufs.append(c.malloc(8))

    def replay(target=None):
        for t, (c, s) in enumerate(zip(clients, sbufs)):
            if t == 3 and target is not None:
                c.launch_kernel("store", args=(TORCH.i32(target),
                                               TORCH.i32(1), 8))
            else:
                c.launch_kernel("store", ptrs=[s], args=(TORCH.i32(1), 8))
        mgr.run_queued()

    replay()
    old = mgr.bounds.lookup("t3")
    new = mgr.elastic.relocate("t3", 256)
    assert new.base != old.base
    mgr.register_tenant("t4", 256)
    assert mgr.bounds.lookup("t4").base == old.base
    replay(target=old.base + 100)
    mgr.synchronize()
    arena = np_of(mgr.arena.buf)
    assert (arena[old.base:old.end] == 0).all()
    assert (arena[new.base + 100:new.base + 108] == 7.0).all()
    graphs = [g for g in mgr.scheduler._fused_cache.values()
              if isinstance(g, StepGraph)]
    assert len(graphs) == 1 and graphs[0].replays == 1


@pytest.mark.parametrize("policy", ["BITWISE", "CHECK"])
def test_many_conditional_keys_in_one_manager(policy):
    """One manager launches the ``cond``-in-``while`` kernel under 16
    operand signatures (its static length), each a graph of its own with
    a ``while`` node and the two ``if`` nodes nested in its body: the
    arena equals the reference manager's after every launch."""
    def scenario(fw):
        mgr = fw.manager(total_slots=1024, policy=getattr(
            fw.core.FencePolicy, policy),
            quarantine_policy=fw.core.ThresholdPolicy(
                quarantine_after=1 << 30))
        c = mgr.register_tenant("t0", 256)
        c.module_load("nested", nested_j if fw is JAX else nested_t)
        buf = c.malloc(64)
        c.memcpy_h2d(buf, SIGNS[:64])
        out = []
        for n in range(1, 17):
            c.launch_kernel("nested", ptrs=[buf], args=(n,))
            mgr.synchronize()
            out.append(fw.arena(mgr)[buf.addr:buf.addr + 64].copy())
        return out, mgr

    ref, (got, mgr) = scenario(JAX)[0], scenario(TORCH)
    assert_same_tree(ref, got)
    entry = next(iter(mgr.pointer_to_symbol.values()))
    assert len(entry.partition_saving) == (16 if policy == "CHECK" else 0)


def test_partition_saving_planned_once_per_signature():
    """Whether a CHECK launch saves the partition is planned once per
    operand signature; later launches of the signature look it up."""
    mgr = TORCH.manager(total_slots=1024, policy=TORCH.core.FencePolicy.CHECK,
                        batch_launches=False)
    c = mgr.register_tenant("t0", 256)
    c.module_load("store", store_t)
    c.module_load("axpy", axpy_t)
    s, x, y = c.malloc(8), c.malloc(16), c.malloc(16)
    entries = {e.name: e for e in mgr.pointer_to_symbol.values()}
    planned = []
    for e in entries.values():
        e.saves_partition = (lambda f, name: lambda *a: planned.append(
            name) or f(*a))(e.saves_partition, e.name)
    for _ in range(3):
        c.launch_kernel("store", ptrs=[s], args=(TORCH.i32(1), 8))
        c.launch_kernel("axpy", ptrs=[x, y], args=(TORCH.f32(2.0), 2, 8))
        mgr.synchronize()
    assert sorted(planned) == ["axpy", "store"]
    assert [list(entries[n].partition_saving.values())
            for n in ("store", "axpy")] == [[True], [False]]

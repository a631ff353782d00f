"""The port's aten-graph sandboxer against the reference's jaxpr
sandboxer: fenced gathers, scatters and dynamic slices give the
reference's values, CHECK reports the same ok and per-kind counts, the
reports count the same sites by kind, the taint warnings fire, and the
NONE policy keeps the reference's out-of-range semantics for every access
op.  Mirrors tests/test_sandbox.py; its ``scan`` / ``while_loop`` cases
run here in unrolled form (a Python loop traces to straight-line code),
beside their structural mirrors in tests/test_torch_structural.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _tenant_parity import assert_same_tree  # noqa: E402
from _torch_parity import np_of, t_of  # noqa: E402
from repro.core import fence as FJ  # noqa: E402
from repro_torch.core import fence as FT  # noqa: E402

# the packages re-export the ``sandbox`` function under the module's name
SJ = importlib.import_module("repro.core.sandbox")
ST = importlib.import_module("repro_torch.core.sandbox")

I32 = torch.int32


def _pj(base=64, size=64):
    return FJ.FenceParams(base=base, size=size)


def _pt(base=64, size=64):
    return FT.FenceParams(base=base, size=size)


def _iota(n, like):
    return torch.arange(n, dtype=I32, device=like.device)


def _both(kj, kt, args_np, policy="BITWISE", count=False, base=64, size=64,
          verify=False):
    """Run the two sandboxed kernels on the same numpy args; returns
    (reference result, port result)."""
    sj = SJ.sandbox(kj, policy=getattr(FJ.FencePolicy, policy),
                    count_violations=count, verify=verify)
    st_ = ST.sandbox(kt, policy=getattr(FT.FencePolicy, policy),
                     count_violations=count, verify=verify)
    arrays = (np.ndarray, np.generic)
    aj = [jnp.asarray(a) if isinstance(a, arrays) else a for a in args_np]
    at = [t_of(np.asarray(a)) if isinstance(a, arrays) else a
          for a in args_np]
    return sj(_pj(base, size), *aj), st_(_pt(base, size), *at)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_sandbox.py
# ---------------------------------------------------------------------------

def _gather_j(arena, ptr):
    return arena, jnp.take(arena, ptr + jnp.arange(8, dtype=jnp.int32),
                           axis=0)


def _gather_t(arena, ptr):
    return arena, torch.take(arena, (ptr + _iota(8, arena)).long())


@pytest.mark.parametrize("ptr", [64, 200, -5, 2 ** 31 - 4])
@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
def test_gather_is_fenced(ptr, policy):
    ref, got = _both(_gather_j, _gather_t,
                     (np.arange(256, dtype=np.float32), np.int32(ptr)),
                     policy)
    out = np_of(got[0][1])
    assert ((out >= 64) & (out < 128)).all()
    assert_same_tree(ref, got)


def _scatter_j(arena, ptr):
    return arena.at[ptr + jnp.arange(4, dtype=jnp.int32)].set(-1.0), None


def _scatter_t(arena, ptr):
    arena[ptr + _iota(4, arena)] = -1.0
    return arena, None


@pytest.mark.parametrize("policy", ["BITWISE", "MODULO", "CHECK"])
def test_scatter_is_fenced(policy):
    ref, got = _both(_scatter_j, _scatter_t,
                     (np.zeros(256, np.float32), np.int32(250)), policy)
    touched = np.nonzero(np_of(got[0][0]) == -1.0)[0]
    assert ((touched >= 64) & (touched < 128)).all()
    assert_same_tree(ref, got)


def _dslice_j(arena, start):
    return arena, jax.lax.dynamic_slice_in_dim(arena, start, 16)


def _dslice_t(arena, start):
    return arena, ST.dynamic_slice(arena, start, 16)


@pytest.mark.parametrize("start", [70, 120, 500, -3])
def test_dynamic_slice_is_fenced_and_pinned(start):
    ref, got = _both(_dslice_j, _dslice_t,
                     (np.arange(256, dtype=np.float32), np.int32(start)),
                     "CHECK", count=True)
    vals = np_of(got[0][1])
    assert vals.min() >= 64 and vals.max() < 128
    assert_same_tree(ref, got)


def _dupdate_j(arena, start, v):
    return jax.lax.dynamic_update_slice_in_dim(arena, v, start, 0), None


def _dupdate_t(arena, start, v):
    return ST.dynamic_update_slice(arena, start, v), None


@pytest.mark.parametrize("start", [70, 125, 500])
@pytest.mark.parametrize("policy", ["NONE", "BITWISE", "CHECK"])
def test_dynamic_update_slice_is_fenced_and_pinned(start, policy):
    ref, got = _both(_dupdate_j, _dupdate_t,
                     (np.zeros(256, np.float32), np.int32(start),
                      np.full(8, 5.0, np.float32)), policy, count=True)
    assert_same_tree(ref, got)


def _double_j(arena, cols_ptr, x_ptr):
    cols = jnp.take(arena, cols_ptr + jnp.arange(4, dtype=jnp.int32),
                    axis=0).astype(jnp.int32)
    return arena, jnp.take(arena, x_ptr + cols, axis=0)


def _double_t(arena, cols_ptr, x_ptr):
    cols = torch.take(arena, (cols_ptr + _iota(4, arena)).long()).to(I32)
    return arena, torch.take(arena, (x_ptr + cols).long())


def test_double_indirection_fenced():
    arena = np.arange(256, dtype=np.float32)
    arena[64:68] = 200.0                       # poisoned indices
    ref, got = _both(_double_j, _double_t,
                     (arena, np.int32(64), np.int32(0)))
    out = np_of(got[0][1])
    assert ((out >= 64) & (out < 128)).all()
    assert_same_tree(ref, got)


@pytest.mark.parametrize("ptr", [64, 200])
def test_check_policy_reports(ptr):
    ref, got = _both(_gather_j, _gather_t,
                     (np.arange(256, dtype=np.float32), np.int32(ptr)),
                     "CHECK", count=True)
    assert bool(got[1]) == (ptr == 64)
    assert_same_tree(ref, got)


def _report_j(arena, ptr):
    idx = ptr + jnp.arange(4, dtype=jnp.int32)
    vals = jnp.take(arena, idx, axis=0)
    arena = arena.at[idx].set(vals * 2)
    return arena, jax.lax.dynamic_slice_in_dim(arena, ptr, 4)


def _report_t(arena, ptr):
    idx = ptr + _iota(4, arena)
    arena[idx] = torch.take(arena, idx.long()) * 2
    return arena, ST.dynamic_slice(arena, ptr, 4)


def _counts(rep):
    return {k: getattr(rep, k) for k in (
        "fenced_gathers", "fenced_scatters", "fenced_dynamic_slices",
        "fenced_dynamic_updates", "elided_gathers", "elided_scatters",
        "elided_dynamic_slices", "elided_dynamic_updates")}


def test_report_counts():
    rj = SJ.sandbox_report(_report_j, (jnp.zeros(64), jnp.int32(0)))
    rt = ST.sandbox_report(_report_t, (torch.zeros(64), torch.tensor(
        0, dtype=I32)))
    assert rt.fenced_total == 3
    assert _counts(rj) == _counts(rt)


def test_private_tensors_not_fenced():
    def kj(arena, private, ptr):
        return arena, jnp.take(private, ptr, axis=0)

    def kt(arena, private, ptr):
        return arena, torch.take(private, ptr.long())

    rj = SJ.sandbox_report(kj, (jnp.zeros(64), jnp.zeros(16),
                                jnp.int32(0)))
    rt = ST.sandbox_report(kt, (torch.zeros(64), torch.zeros(16),
                                torch.tensor(0, dtype=I32)))
    assert rt.fenced_total == 0 and _counts(rj) == _counts(rt)


def test_loop_carried_arena_unrolled():
    """The reference's ``scan`` carrying the arena, as a Python loop."""
    def kj(arena, n):
        a, _ = jax.lax.scan(lambda a, _: (a, None), arena, jnp.arange(4))
        return a, None

    def kt(arena, n):
        for _ in range(4):
            arena = arena.view(-1)
        return arena, None

    ref, got = _both(kj, kt, (np.zeros(64, np.float32), np.int32(0)))
    assert bool(got[1])
    assert_same_tree(ref, got)


def _scan_gather_j(arena, ptr):
    def body(carry, x):
        return carry + 1, jnp.take(arena, carry + x, axis=0)
    _, ys = jax.lax.scan(body, ptr, jnp.arange(4, dtype=jnp.int32))
    return arena, ys


def _scan_gather_t(arena, ptr):
    ys, carry = [], ptr
    for x in range(4):
        ys.append(torch.take(arena, (carry + x).long().reshape(1)))
        carry = carry + 1
    return arena, torch.cat(ys)


@pytest.mark.parametrize("ptr", [64, 200])
def test_scan_gather_fenced_per_iteration_unrolled(ptr):
    for policy in ("BITWISE", "CHECK"):
        ref, got = _both(_scan_gather_j, _scan_gather_t,
                         (np.arange(256, dtype=np.float32), np.int32(ptr)),
                         policy, count=True)
        assert_same_tree(ref, got)
    assert int(np_of(got[2])[0]) == (4 if ptr == 200 else 0)


def test_while_loop_fenced_and_counted_unrolled():
    """The reference's ``while_loop`` runs its body 4 times from any
    start; the unrolled twin counts the same 4 violating gathers."""
    def kj(arena, ptr):
        def body(state):
            i, acc = state
            return i + 1, acc + jnp.take(arena, i, axis=0)
        _, acc = jax.lax.while_loop(lambda s: s[0] < ptr + 4, body,
                                    (ptr, jnp.float32(0)))
        return arena, acc

    def kt(arena, ptr):
        acc, i = torch.zeros((), dtype=arena.dtype), ptr
        for _ in range(4):
            acc = acc + torch.take(arena, i.long().reshape(1))[0]
            i = i + 1
        return arena, acc

    ref, got = _both(kj, kt, (np.arange(256, dtype=np.float32),
                              np.int32(200)), "CHECK", count=True)
    assert not bool(got[1]) and int(np_of(got[2])[0]) == 4
    assert_same_tree(ref, got)


def test_higher_order_cond_fails_closed():
    """``torch.cond`` over the arena is interpreted structurally (its
    mirrors: tests/test_torch_structural.py) and each branch is held to
    the kernel's rule: a branch that reads a static slice of the arena's
    slot axis still fails closed, the same ``cond`` with a legal branch
    gives the reference's ``lax.cond`` result, and a higher-order op the
    sandbox does not interpret (``map``) fails closed."""
    def kt(arena, ptr, flag):
        return arena, torch.cond(flag > 0, lambda p: torch.take(
            arena, p.long().reshape(1)), lambda p: arena[0:1] * 0, (ptr,))

    def legal_t(arena, ptr, flag):
        return arena, torch.cond(flag > 0, lambda p: torch.take(
            arena, p.long().reshape(1)), lambda p: torch.zeros(
                1, device=p.device), (ptr,))

    def legal_j(arena, ptr, flag):
        return arena, jax.lax.cond(
            flag > 0, lambda p: jnp.take(arena, p, axis=0).reshape(1),
            lambda p: jnp.zeros(1, jnp.float32), ptr)

    def map_t(arena, ptr, flag):
        from torch._higher_order_ops.map import map as hop_map
        return arena, hop_map(lambda x, a: torch.take(
            a, x.long().reshape(1)), ptr.reshape(1), arena)

    args = (torch.arange(256.), torch.tensor(200, dtype=I32),
            torch.tensor(1, dtype=I32))
    for kernel in (kt, map_t):
        with pytest.raises(ST.SandboxError):
            ST.sandbox(kernel)(_pt(), *args)
    ref, got = _both(legal_j, legal_t, (np.arange(256, dtype=np.float32),
                                        np.int32(200), np.int32(1)),
                     "CHECK", count=True)
    assert_same_tree(ref, got)
    assert not bool(got[1])


def test_reshape_splitting_dim0_keeps_taint():
    def kj(arena, ptr):
        folded = arena.reshape(2, -1)
        return arena, jax.lax.dynamic_slice(folded, (ptr, jnp.int32(0)),
                                            (1, 8))

    def kt(arena, ptr):
        folded = arena.reshape(2, -1)
        return arena, ST.dynamic_slice(folded, ptr, 1)[:, :8]

    with pytest.warns(SJ.GuardianTaintWarning):
        rj = SJ.sandbox_report(kj, (jnp.zeros(64), jnp.int32(0)))
    with pytest.warns(ST.GuardianTaintWarning):
        rt = ST.sandbox_report(kt, (torch.zeros(64), torch.tensor(
            0, dtype=I32)))
    assert rt.fenced_dynamic_slices == 1 and _counts(rj) == _counts(rt)


def test_transpose_demoting_dim0_keeps_taint():
    def kj(arena, ptr):
        return arena, jax.lax.dynamic_slice(arena.T, (ptr, jnp.int32(0)),
                                            (1, 8))

    def kt(arena, ptr):
        return arena, ST.dynamic_slice(arena.T, ptr, 1)[:, :8]

    with pytest.warns(SJ.GuardianTaintWarning):
        rj = SJ.sandbox_report(kj, (jnp.zeros((64, 4)), jnp.int32(0)))
    with pytest.warns(ST.GuardianTaintWarning):
        rt = ST.sandbox_report(kt, (torch.zeros((64, 4)), torch.tensor(
            0, dtype=I32)))
    assert rt.fenced_dynamic_slices == 1 and _counts(rj) == _counts(rt)


def test_nested_call_instrumented():
    """Fences land inside library wrappers (the implicit-call case): the
    trace inlines the helper."""
    inner_j = jax.jit(lambda arena, idx: jnp.take(arena, idx, axis=0))

    def kj(arena, ptr):
        return arena, inner_j(arena, ptr + jnp.arange(4, dtype=jnp.int32))

    def inner_t(arena, idx):
        return torch.take(arena, idx.long())

    def kt(arena, ptr):
        return arena, inner_t(arena, ptr + _iota(4, arena))

    ref, got = _both(kj, kt, (np.arange(256, dtype=np.float32),
                              np.int32(200)))
    out = np_of(got[0][1])
    assert ((out >= 64) & (out < 128)).all()
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# NONE: the reference's out-of-range semantics, per access op
# ---------------------------------------------------------------------------

IDX = np.array([-9, -1, 3, 8, 100, -2 ** 31], np.int32)
VALS = np.array([10, 20, 30, 40, 50, 60], np.float32)

#: (jnp access, torch access) pairs over an 8-slot arena
ACCESS_PAIRS = {
    "index": (lambda a, i, v: (a, a[i]),
              lambda a, i, v: (a, a[i])),
    "take": (lambda a, i, v: (a, jnp.take(a, i)),
             lambda a, i, v: (a, torch.take(a, i.long()))),
    "index_select": (lambda a, i, v: (a, jnp.take(a, i, axis=0)),
                     lambda a, i, v: (a, a.index_select(0, i))),
    "gather": (lambda a, i, v: (a, jnp.take_along_axis(a, i, axis=0)),
               lambda a, i, v: (a, torch.gather(a, 0, i.long()))),
    "index_put": (lambda a, i, v: (a.at[i].set(v), None),
                  lambda a, i, v: (a.index_put_((i,), v), None)),
    "index_put_add": (lambda a, i, v: (a.at[i].add(v), None),
                      lambda a, i, v: (a.index_put_((i,), v,
                                                    accumulate=True), None)),
    "index_copy": (lambda a, i, v: (a.at[i].set(v), None),
                   lambda a, i, v: (a.index_copy_(0, i.long(), v), None)),
    "index_add": (lambda a, i, v: (a.at[i].add(v), None),
                  lambda a, i, v: (a.index_add_(0, i, v), None)),
    "scatter": (lambda a, i, v: (a.at[i].set(v), None),
                lambda a, i, v: (a.scatter_(0, i.long(), v), None)),
    "scatter_add": (lambda a, i, v: (a.at[i].add(v), None),
                    lambda a, i, v: (a.scatter_add_(0, i.long(), v), None)),
    "scatter_max": (lambda a, i, v: (a.at[i].max(v), None),
                    lambda a, i, v: (a.scatter_reduce_(
                        0, i.long(), v, "amax"), None)),
}


@pytest.mark.parametrize("op", sorted(ACCESS_PAIRS))
@pytest.mark.parametrize("policy", ["NONE", "BITWISE", "CHECK"])
def test_out_of_arena_indices_match_reference(op, policy):
    """Indices past both ends of an 8-slot arena (and the int32 minimum):
    the reference's values under NONE (clamped / NaN-filled gathers,
    dropped scatters) and the fenced values under a fence, with no
    out-of-range index ever reaching the torch op."""
    kj, kt = ACCESS_PAIRS[op]
    ref, got = _both(kj, kt, (np.arange(8, dtype=np.float32), IDX, VALS),
                     policy, count=True, base=4, size=4)
    assert_same_tree(ref, got)


def test_scatter_drop_keeps_the_last_in_range_writer():
    """Duplicate in-range destinations keep the last writer when
    out-of-range elements are dropped around them."""
    idx = np.array([2, 50, 2, -40, 2, 99], np.int32)
    kj, kt = ACCESS_PAIRS["index_put"]
    ref, got = _both(kj, kt, (np.zeros(8, np.float32), idx, VALS), "NONE")
    assert np_of(got[0][0])[2] == 50.0
    assert_same_tree(ref, got)


# ---------------------------------------------------------------------------
# Fail-closed cases, guarded ops, the undo log
# ---------------------------------------------------------------------------

def _refused(fn, *args):
    with pytest.raises(ST.SandboxError):
        ST.sandbox(fn)(_pt(), *args)


@pytest.mark.parametrize("case", [
    "item", "mask", "narrow", "reduce_arena", "scale_arena", "return_arena",
    "new_arena", "dim1_access", "static_slice", "inplace_fill",
    "index_from_arena", "private_embedding", "private_scatter_reduce_kw",
])
def test_unsupported_constructs_fail_closed(case):
    arena = torch.arange(256.).reshape(256)
    p = torch.tensor(3, dtype=I32)
    kernels = {
        "item": lambda a, q: (a, a[: q.item()]),
        "mask": lambda a, q: (a, a[a > 3]),
        "narrow": lambda a, q: (a, a.narrow(0, q, 2)),
        "reduce_arena": lambda a, q: (a, a.sum()),
        "scale_arena": lambda a, q: (a, a * 2),
        "return_arena": lambda a, q: (a, a),
        "new_arena": lambda a, q: (torch.zeros_like(a), None),
        "dim1_access": lambda a, q: (a, a.view(64, 4).index_select(
            1, q.reshape(1).long())),
        "static_slice": lambda a, q: (a, a[3:7][q]),
        "inplace_fill": lambda a, q: (a.fill_(0.0), None),
        "index_from_arena": lambda a, q: (a, torch.take(a, a.long())),
        # index ops with no in-range rewrite, even on private tensors: an
        # out-of-range id there would be a device-side assert
        "private_embedding": lambda a, q: (a, torch.nn.functional.embedding(
            q.reshape(1).long(), torch.ones(4, 3))),
        "private_scatter_reduce_kw": lambda a, q: (a, torch.zeros(4).scatter_(
            0, q.reshape(1).long(), 1.0, reduce="add")),
    }
    _refused(kernels[case], arena, p)


def test_guarded_take_and_update_match_reference():
    ids = np.array([-3, 0, 70, 200, 1 << 20], np.int32)
    for policy in ("BITWISE", "MODULO", "CHECK"):
        pj, pt = getattr(FJ.FencePolicy, policy), getattr(FT.FencePolicy,
                                                          policy)
        aj = jnp.arange(256, dtype=jnp.float32)
        at = torch.arange(256, dtype=torch.float32)
        np.testing.assert_array_equal(
            np_of(FT.guarded_take(at, t_of(ids), _pt(), pt)),
            np_of(FJ.guarded_take(aj, jnp.asarray(ids), _pj(), pj)))
        vals = np.arange(5, dtype=np.float32) + 500
        want = FJ.guarded_update(aj, jnp.asarray(ids), jnp.asarray(vals),
                                 _pj(), pj)
        got = FT.guarded_update(at, t_of(ids), t_of(vals), _pt(), pt)
        assert got is at               # in place
        np.testing.assert_array_equal(np_of(got), np_of(want))


def test_undo_log_rolls_back_exactly_what_was_written():
    """A CHECK launch's fenced stores are logged; rolling back restores
    the arena bit for bit and moves only the elements written."""
    def kt(arena, ptr):
        idx = ptr + _iota(16, arena)
        arena[idx] = -7.0
        arena.index_add_(0, idx[:4], torch.ones(4))
        return arena, None

    arena = torch.arange(256, dtype=torch.float32)
    before = arena.clone()
    sb = ST.sandbox(kt, policy=FT.FencePolicy.CHECK, count_violations=True)
    undo = ST.UndoLog()
    (out, _), ok, counts = sb(_pt(), arena, torch.tensor(120, dtype=I32),
                              undo=undo)
    assert out is arena and not bool(ok)
    assert np_of(counts).tolist() == [0, 8, 0, 0]   # 128..135
    assert undo.nbytes == (16 + 4) * 4
    undo.rollback(ok)
    np.testing.assert_array_equal(np_of(arena), np_of(before))

"""The port's row-mode bounds verifier against the reference's: the same
verdicts for each abstract-domain feature, PROVEN sites elided with
results bit-identical to the fenced build, REFUTED kernels refused at
trace time (and caught by the runtime CHECK counter when forced
through), and the manager / scheduler wiring (``sandbox_report``,
fence-aware kernels under every policy, fully proven CHECK batches on
the plain fused path).  Mirrors the row-mode cases of
tests/test_verifier.py; its loop kernel runs unrolled."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _tenant_parity import JAX, KERNELS, TORCH, assert_same_tree, \
    on_both  # noqa: E402
from _torch_parity import np_of  # noqa: E402
from repro.core import fence as FJ  # noqa: E402
from repro.core import verifier as VJ  # noqa: E402
from repro_torch.core import fence as FT  # noqa: E402
from repro_torch.core import verifier as VT  # noqa: E402

SJ = importlib.import_module("repro.core.sandbox")
ST = importlib.import_module("repro_torch.core.sandbox")

I32 = torch.int32
ARENA = np.arange(256, dtype=np.float32)


def _p(mod, base=64, size=64):
    return mod.FenceParams(base=base, size=size)


def _verdicts(proof):
    return [s.verdict for s in proof.sites]


def _verify_both(name, args, **kw):
    """(reference proof, port proof) of one kernel on the same args."""
    kj, kt = KERNELS[name]
    params = kw.pop("params", None)
    pj = _p(FJ) if params else None
    pt = _p(FT) if params else None
    aj = [jnp.asarray(a) for a in args]
    at = [torch.from_numpy(np.asarray(a)) for a in args]
    return (VJ.verify(kj, aj, params=pj, **kw),
            VT.verify(kt, at, params=pt, **kw))


ZERO = np.int32(0)


@pytest.mark.parametrize("name,args,kw,want", [
    ("fence_aware", (ARENA, ZERO, ZERO, ZERO), {"bound_argnums": (1, 2)},
     ["proven"]),
    ("clamped", (ARENA, ZERO), {"params": True}, ["proven"]),
    ("raw_pointer", (ARENA, ZERO), {"params": True}, ["fenced"]),
    ("static_oob", (ARENA, np.float32(0)), {"params": True}, ["refuted"]),
    ("raw_pointer", (ARENA, ZERO), {}, ["fenced"]),
    ("bump", (ARENA, ZERO, 8), {}, ["fenced", "fenced"]),
])
def test_verdicts_match_reference(name, args, kw, want):
    if len(args) == 3 and isinstance(args[2], int):   # a launch dim
        kj, kt = KERNELS[name]
        pj = VJ.verify(kj, (jnp.asarray(args[0]), jnp.int32(0), 8))
        pt = VT.verify(kt, (torch.from_numpy(args[0]),
                            torch.tensor(0, dtype=I32), 8))
    else:
        pj, pt = _verify_both(name, args, **kw)
    assert _verdicts(pt) == want
    assert _verdicts(pj) == _verdicts(pt)
    assert pj.symbolic == pt.symbolic
    assert [s.kind for s in pj.sites] == [s.kind for s in pt.sites]


def test_refuted_site_diagnostic():
    _, pt = _verify_both("static_oob", (ARENA, np.float32(0)), params=True)
    assert pt.refuted_sites()[0].kind.name == "GATHER"
    sb = ST.sandbox(KERNELS["static_oob"][1], verify=True)
    with pytest.raises(VT.GuardianStaticViolation) as ei:
        sb(_p(FT), torch.from_numpy(ARENA), torch.tensor(0.0))
    assert "provably out-of-bounds" in str(ei.value)
    assert "gather" in str(ei.value)


# index expressions over a launch pointer, in jnp and in torch: each is
# (name, jnp expr, torch expr) of ``(ptr, iota)`` with ``iota`` = 0..3
_EXPRS = [
    ("raw", lambda p, i: p + i, lambda p, i: p + i),
    ("mask_or", lambda p, i: ((p + i) & 63) | 64,
     lambda p, i: ((p + i) & 63) | 64),
    ("mask_or_high", lambda p, i: ((p + i) & 63) | 128,
     lambda p, i: ((p + i) & 63) | 128),
    ("clip_in", lambda p, i: jnp.clip(p, 64, 124) + i,
     lambda p, i: torch.clamp(p, 64, 124) + i),
    ("clip_straddle", lambda p, i: jnp.clip(p, 60, 124) + i,
     lambda p, i: torch.clamp(p, 60, 124) + i),
    ("clip_past", lambda p, i: jnp.clip(p, 130, 200) + i,
     lambda p, i: torch.clamp(p, 130, 200) + i),
    ("rem", lambda p, i: 64 + jax.lax.rem(p & 1023, jnp.int32(60)) + i,
     lambda p, i: 64 + torch.fmod(p & 1023, 60) + i),
    ("const_in", lambda p, i: 70 + i, lambda p, i: 70 + i),
    ("const_below", lambda p, i: 10 + i, lambda p, i: 10 + i),
    ("scaled", lambda p, i: 64 + 8 * (i + (p & 3)),
     lambda p, i: 64 + 8 * (i + (p & 3))),
    ("min_max", lambda p, i: jnp.minimum(jnp.maximum(p, 64), 100) + i,
     lambda p, i: torch.minimum(torch.maximum(p, torch.tensor(
         64, dtype=p.dtype)), torch.tensor(100, dtype=p.dtype)) + i),
    ("shift", lambda p, i: 64 + ((i + 60) >> 2), lambda p, i: 64 + (
        (i + 60) >> 2)),
]


@pytest.mark.parametrize("name,ej,et", _EXPRS, ids=[e[0] for e in _EXPRS])
@pytest.mark.parametrize("static", [True, False], ids=["static", "symbolic"])
def test_index_expression_verdicts_match_reference(name, ej, et, static):
    """One gather per index expression: the same verdict as the
    reference's, against the static row [64, 128) and the symbolic row."""
    def kj(arena, ptr):
        return arena, jnp.take(arena, ej(ptr, jnp.arange(
            4, dtype=jnp.int32)), axis=0)

    def kt(arena, ptr):
        i = torch.arange(4, dtype=I32, device=arena.device)
        return arena, torch.take(arena, et(ptr, i).long())

    pj = VJ.verify(kj, (jnp.asarray(ARENA), jnp.int32(0)),
                   params=_p(FJ) if static else None)
    pt = VT.verify(kt, (torch.from_numpy(ARENA), torch.tensor(
        0, dtype=I32)), params=_p(FT) if static else None)
    assert _verdicts(pt) == _verdicts(pj)


def _rem_carry_j(arena, ptr):
    def body(carry, _):
        nxt = 64 + jax.lax.rem(carry + 1, jnp.int32(64))
        return nxt, jnp.take(arena, carry, axis=0)
    _, ys = jax.lax.scan(body, 64 + (ptr & 63), None, length=4)
    return arena, ys


def _rem_carry_t(arena, ptr):
    carry, ys = 64 + (ptr & 63), []
    for _ in range(4):
        ys.append(torch.take(arena, carry.long().reshape(1)))
        carry = 64 + torch.fmod(carry + 1, 64)
    return arena, torch.cat(ys)


def test_rem_carried_index_proven_unrolled():
    """The reference proves its scan carry through widening; the unrolled
    twin proves every iteration's site."""
    pj = VJ.verify(_rem_carry_j, (jnp.asarray(ARENA), jnp.int32(0)),
                   params=_p(FJ))
    pt = VT.verify(_rem_carry_t, (torch.from_numpy(ARENA),
                                  torch.tensor(0, dtype=I32)),
                   params=_p(FT))
    assert pj.fully_proven and pt.fully_proven
    assert _verdicts(pt) == ["proven"] * 4


def _run_both_builds(kernel, fp, args, bound=()):
    elided = ST.sandbox(kernel, verify=True, bound_argnums=bound)
    fenced = ST.sandbox(kernel, verify=False, bound_argnums=bound)
    arena = torch.from_numpy(ARENA.copy())
    (_, out_e), _ = elided(fp, arena, *args)
    (_, out_f), _ = fenced(fp, arena, *args)
    return np_of(out_e), np_of(out_f)


@pytest.mark.parametrize("ptr", list(range(-8, 300, 31)) + [2 ** 31 - 1,
                                                           -2 ** 31])
def test_proven_sites_elide_bit_identical_sweep(ptr):
    """Every launch of a proven kernel gives the same result with its
    fences elided or kept, and the reference's result."""
    fp = _p(FT)
    p = torch.tensor(ptr, dtype=I32)
    cases = [("clamped", (p,), ()),
             ("fence_aware", (torch.tensor(64, dtype=I32),
                              torch.tensor(63, dtype=I32), p), (1, 2))]
    for name, args, bound in cases:
        out_e, out_f = _run_both_builds(KERNELS[name][1], fp, args, bound)
        np.testing.assert_array_equal(out_e, out_f)
        (_, want), _ = SJ.sandbox(KERNELS[name][0], bound_argnums=bound)(
            _p(FJ), jnp.asarray(ARENA), *[jnp.asarray(np_of(a))
                                          for a in args])
        np.testing.assert_array_equal(out_e, np_of(want))
    out_e, out_f = _run_both_builds(_rem_carry_t, fp, (p,))
    np.testing.assert_array_equal(out_e, out_f)


def test_elision_actually_removes_fences():
    for verify, want in ((True, (1, 0)), (False, (0, 1))):
        rj = SJ.sandbox_report(KERNELS["clamped"][0],
                               (jnp.asarray(ARENA), jnp.int32(0)),
                               verify=verify, params=_p(FJ))
        rt = ST.sandbox_report(KERNELS["clamped"][1],
                               (torch.from_numpy(ARENA),
                                torch.tensor(0, dtype=I32)),
                               verify=verify, params=_p(FT))
        assert (rt.elided_total, rt.fenced_total) == want
        assert (rj.elided_total, rj.fenced_total) == want


@pytest.mark.parametrize("shift", [256, 4099, 1 << 20, 1 << 24])
def test_refuted_always_trips_check(shift):
    """An always out-of-bounds constant offset: REFUTED on both sides, and
    the runtime CHECK counter fires on every forced launch."""
    def kj(arena, x):
        return arena, jnp.take(arena, jnp.arange(4, dtype=jnp.int32)
                               + shift, axis=0) + x

    def kt(arena, x):
        idx = torch.arange(4, dtype=I32, device=arena.device) + shift
        return arena, torch.take(arena, idx.long()) + x

    pj = VJ.verify(kj, (jnp.asarray(ARENA), jnp.float32(0)), params=_p(FJ))
    pt = VT.verify(kt, (torch.from_numpy(ARENA), torch.tensor(0.0)),
                   params=_p(FT))
    assert _verdicts(pj) == _verdicts(pt) == ["refuted"]
    sb = ST.sandbox(kt, policy=FT.FencePolicy.CHECK, count_violations=True,
                    verify=False)
    (_, _), ok, counts = sb(_p(FT), torch.from_numpy(ARENA),
                            torch.tensor(0.0))
    assert not bool(ok) and int(np_of(counts)[0]) == 4


# ---------------------------------------------------------------------------
# Manager + scheduler wiring
# ---------------------------------------------------------------------------

def _manager(fw, policy, slots=2048):
    return fw.manager(total_slots=slots, standalone_fast_path=False,
                      policy=getattr(fw.core.FencePolicy, policy))


def test_manager_sandbox_report_api():
    def run(fw):
        mgr = _manager(fw, "BITWISE")
        mgr.register_tenant("t1", 256)
        mgr.register_tenant("t2", 256)
        mgr.register_kernel("fa", fw.kernel("fence_aware"), fence_aware=True)
        mgr.register_kernel("raw", fw.kernel("raw_pointer"))
        fa = mgr.sandbox_report("fa", example_args=(fw.i32(0),))
        raw = mgr.sandbox_report("raw", example_args=(fw.i32(0),))
        return [(p.symbolic, p.fully_proven, p.n_fenced, _verdicts(p))
                for p in (fa, raw)]
    ref, got = on_both(run)
    assert got == [(True, True, 0, ["proven"]), (True, False, 1, ["fenced"])]
    assert ref == got


@pytest.mark.parametrize("policy", ["BITWISE", "CHECK", "MODULO"])
def test_manager_fence_aware_kernel_all_policies(policy):
    def run(fw):
        mgr = _manager(fw, policy)
        c1 = mgr.register_tenant("t1", 256)
        mgr.register_tenant("t2", 256)
        mgr.register_kernel("fa", fw.kernel("fence_aware"), fence_aware=True)
        p = mgr.malloc("t1", 16)
        c1.memcpy_h2d(p, np.arange(16.0))
        mgr.synchronize()
        req = mgr.launch_kernel("t1", "fa", args=(fw.i32(p.addr),))
        mgr.synchronize()
        return np_of(req.result)
    ref, got = on_both(run)
    np.testing.assert_array_equal(got, np.arange(8.0))
    assert_same_tree(ref, got)


def test_scheduler_routes_proven_check_batches_to_fused_path():
    def run(fw):
        mgr = _manager(fw, "CHECK")
        c1 = mgr.register_tenant("t1", 256)
        c2 = mgr.register_tenant("t2", 256)
        mgr.register_kernel("fa", fw.kernel("fence_aware"), fence_aware=True)
        mgr.register_kernel("raw", fw.kernel("raw_pointer"))
        p1, p2 = mgr.malloc("t1", 16), mgr.malloc("t2", 16)
        c1.memcpy_h2d(p1, np.arange(16.0))
        c2.memcpy_h2d(p2, np.arange(100.0, 116.0))
        mgr.synchronize()
        r1 = mgr.launch_kernel("t1", "fa", args=(fw.i32(p1.addr),))
        r2 = mgr.launch_kernel("t2", "fa", args=(fw.i32(p2.addr),))
        mgr.synchronize()
        st = mgr.scheduler.stats
        first = (st.proven_steps, st.check_steps)
        mgr.launch_kernel("t1", "raw", args=(fw.i32(p1.addr),))
        mgr.launch_kernel("t2", "raw", args=(fw.i32(p2.addr),))
        mgr.synchronize()
        return {"r": [np_of(r1.result), np_of(r2.result)], "first": first,
                "second": (st.proven_steps, st.check_steps),
                "summary": "proven_steps" in st.summary()}
    ref, got = on_both(run)
    assert got["first"] == (1, 0) and got["second"] == (1, 1)
    assert_same_tree(ref, got)


def test_manager_refutes_oob_kernel_at_trace_time():
    for fw, V in ((JAX, VJ), (TORCH, VT)):
        mgr = _manager(fw, "BITWISE")
        mgr.register_tenant("t1", 256)
        mgr.register_tenant("t2", 256)
        mgr.register_kernel("oob", fw.kernel("static_oob"))
        with pytest.raises(V.GuardianStaticViolation):
            mgr.launch_kernel("t1", "oob", args=(fw.f32(0.0),))
            mgr.synchronize()


def test_symbolic_proof_cached_per_signature():
    mgr = _manager(TORCH, "CHECK")
    mgr.register_tenant("t1", 256)
    mgr.register_kernel("fa", TORCH.kernel("fence_aware"), fence_aware=True)
    entry = mgr.pointer_to_symbol["fa"]
    args = (TORCH.i32(0),)
    p1 = mgr.symbolic_proof(entry, args)
    assert p1 is not None and p1.fully_proven
    assert mgr.symbolic_proof(entry, args) is p1
    assert len([k for k in entry.proofs if k[0] == "sym"]) == 1


# ---------------------------------------------------------------------------
# Index arithmetic that wraps in its dtype
# ---------------------------------------------------------------------------
#
# The interval domain computes in unbounded integers; the device computes
# in the tensor's dtype.  An int16 round-trip or an int32 overflow makes
# the two disagree, and such a site must come out FENCED, not PROVEN: a
# proven site runs without its fence.  Tenants are 2**16 slots, so the
# attacker (t1, base 2**16) truncated to int16 lands in t0's partition,
# and ``u // 2**16`` with ``u = 2**30 * 4`` reads 2**16 in the verifier
# and 0 on the device, one partition further on.

WRAP = 1 << 16


def _wrap_narrow(i):
    return i.to(torch.int16).to(I32)


def _wrap_overflow(i):
    u = torch.full(i.shape, 1 << 30, dtype=I32, device=i.device) * 4
    return i + WRAP - u // WRAP


_WRAPS = {"narrow16": _wrap_narrow, "overflow32": _wrap_overflow}


def _wrap_kernel(wrap):
    def kernel(arena, own):
        i = torch.arange(8, dtype=I32, device=arena.device) + own
        arena[wrap(i)] = 999.0
        return arena, None
    return kernel


def _wrap_kernel_fence_aware(wrap):
    def kernel(arena, base, mask, ptr):
        i = torch.arange(8, dtype=I32, device=arena.device) + ptr
        arena[wrap((i & mask) | base)] = 999.0
        return arena, None
    return kernel


@pytest.mark.parametrize("wrap", sorted(_WRAPS))
@pytest.mark.parametrize("static", [True, False], ids=["static", "symbolic"])
def test_wrapping_index_math_is_not_proven(wrap, static):
    """The wrapped site is FENCED against the attacker's own row and the
    symbolic row; the same expression whose values fit the dtype stays
    PROVEN (the domain is not blanket-⊤ on casts and products)."""
    arena = torch.zeros(4 * WRAP)
    zero = torch.tensor(0, dtype=I32)
    if static:
        got = VT.verify(_wrap_kernel(_WRAPS[wrap]), (arena, WRAP),
                        params=FT.FenceParams(base=WRAP, size=WRAP))
    else:
        got = VT.verify(_wrap_kernel_fence_aware(_WRAPS[wrap]),
                        (arena, zero, zero, zero), bound_argnums=(1, 2))
    assert _verdicts(got) == ["fenced"]
    if wrap == "narrow16":            # values that fit int16: proven
        fits = VT.verify(_wrap_kernel(_WRAPS[wrap]), (arena, 64),
                         params=FT.FenceParams(base=64, size=64))
    else:                             # the same sum without the overflow
        fits = VT.verify(_wrap_kernel(lambda i: i + WRAP - WRAP),
                         (arena, WRAP),
                         params=FT.FenceParams(base=WRAP, size=WRAP))
    assert _verdicts(fits) == ["proven"]


@pytest.mark.parametrize("wrap", sorted(_WRAPS))
@pytest.mark.parametrize("path", ["modulo_per_launch", "bitwise_aware",
                                  "check_aware"])
def test_wrapping_index_cannot_reach_a_neighbour(wrap, path):
    """The attack through the manager: MODULO's per-launch static twin (a
    concrete proof) and a fence-aware kernel under BITWISE and CHECK (a
    symbolic proof).  Every other partition keeps its bytes; under the
    fencing policies the stores land in the attacker's own partition,
    under CHECK the launch is refused and rolled back."""
    policy = {"modulo_per_launch": "MODULO", "bitwise_aware": "BITWISE",
              "check_aware": "CHECK"}[path]
    mgr = TORCH.manager(total_slots=4 * WRAP, batch_launches=False,
                        policy=getattr(FT.FencePolicy, policy))
    clients = [mgr.register_tenant(f"t{i}", WRAP) for i in range(4)]
    parts = [mgr.bounds.lookup(f"t{i}") for i in range(4)]
    assert [p.base for p in parts] == [i * WRAP for i in range(4)]
    aware = path != "modulo_per_launch"
    kernel = (_wrap_kernel_fence_aware if aware else _wrap_kernel)(
        _WRAPS[wrap])
    clients[1].module_load("wrap", kernel, fence_aware=aware)
    before = mgr.arena.buf.clone()
    arg = torch.tensor(0, dtype=I32) if aware else WRAP
    try:
        clients[1].launch_kernel("wrap", args=(arg,))
        mgr.synchronize()
        raised = False
    except TORCH.core.GuardianViolation:
        raised = True
    after = mgr.arena.buf
    for p in parts[:1] + parts[2:]:
        assert torch.equal(after[p.base:p.end], before[p.base:p.end])
    own = after[parts[1].base:parts[1].end]
    if policy == "CHECK":
        assert raised and torch.equal(own, before[WRAP:2 * WRAP])
        assert mgr.violog.counts("t1")["scatter"] == 8
    else:
        assert not raised and int((own == 999.0).sum()) == 8


def _narrow_private_j(arena, priv):
    idx = (jnp.arange(8, dtype=jnp.int32) + 32765).astype(
        jnp.int16).astype(jnp.int32) - 32700
    return arena, (priv[idx], jnp.take(priv, idx, axis=0))


def _narrow_private_t(arena, priv):
    idx = (torch.arange(8, dtype=I32, device=arena.device) + 32765).to(
        torch.int16).to(I32) - 32700
    return arena, (priv[idx], torch.index_select(priv, 0, idx))


@pytest.mark.parametrize("policy", ["NONE", "BITWISE", "CHECK"])
def test_wrapping_index_into_private_tensor_is_guarded(policy):
    """The interval arithmetic puts the index in [65, 72] of an 80-row
    private tensor; on the device five of the eight wrap to -65468 and
    below.  The access keeps its out-of-range guard, so no index reaches
    the op out of range, and the values are the reference's."""
    priv = np.arange(80, dtype=np.float32) * 3.0
    sj = SJ.sandbox(_narrow_private_j, verify=True,
                    policy=getattr(FJ.FencePolicy, policy))
    st_ = ST.sandbox(_narrow_private_t, verify=True,
                     policy=getattr(FT.FencePolicy, policy))
    (_, want), _ = sj(_p(FJ), jnp.asarray(ARENA), jnp.asarray(priv))
    (_, got), _ = st_(_p(FT), torch.from_numpy(ARENA.copy()),
                      torch.from_numpy(priv))
    assert_same_tree([np_of(w) for w in want], [np_of(g) for g in got])

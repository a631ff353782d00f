"""Extent-mode proofs of trusted steps in the port (``core/verifier.py``'s
extent mode, ``register_trusted_kernel(verify=True)``) and the kernels'
declared accesses (``kernels/access.py``) the verifier reads through their
custom ops.  Mirrors of ``tests/test_verifier.py`` run the reference and the
port on the same numpy inputs; the serve-step proofs are held against the
reference's lint fixture; every trace here is on fake tensors, on the CPU
and on the CUDA device alike, and launches nothing."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fence import FenceParams as FPJ  # noqa: E402
from repro.core.manager import GuardianManager as GMJ  # noqa: E402
from repro.core.verifier import verify as verify_j  # noqa: E402
from repro_torch.core.fence import FenceParams as FPT  # noqa: E402
from repro_torch.core.manager import GuardianManager  # noqa: E402
from repro_torch.core.sandbox import SandboxError, sandbox  # noqa: E402
from repro_torch.core.verifier import FENCED, KERNEL_OPS, PROVEN, \
    GuardianStaticViolation, trace_kernel, verify  # noqa: E402
from repro_torch.kernels import _build, access, flash_attention, \
    gather_rows, moe_histogram, paged_attention, ref, \
    scatter_pages  # noqa: E402
from repro_torch.lint import paged_serve_fixture, slab_serve_fixture, \
    step_operands  # noqa: E402

I32 = torch.int32
ARENA = np.arange(256.0, dtype=np.float32)


def _counts():
    return {k.name: (k.launches, k.plain_calls)
            for k in _build.KERNELS.values()}


def _rows(proof):
    """A proof's sites without the graph's node names."""
    return [(s.kind, s.prim, s.verdict, s.interval, s.target)
            for s in proof.sites]


# --------------------------------------------------------------------- #
# Mirrors of tests/test_verifier.py's extent-mode tests                 #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "tensor"])
def test_extent_mode_admits_guardspec_partitions(dynamic):
    """Mirror of ``test_extent_mode_admits_guardspec_partitions``: a
    FenceParams among the operands declares an admissible partition; one
    given as tensors gets a symbol pair of its own, and an index fenced
    with it is proven inside that partition (not inside any extent)."""
    base, size = 128, 64

    def step_j(arena, idx, fp):
        fenced = (idx & (fp.size - 1)) | fp.base
        return arena, jnp.take(arena, fenced, axis=0)

    def step_t(arena, idx, fp):
        fenced = (idx & (fp.size - 1)) | fp.base
        return arena, arena.index_select(0, fenced.reshape(1))

    def fp_of(FP, arr):
        return FP(base=arr(base), size=arr(size)) if dynamic \
            else FP(base=base, size=size)

    idx = np.int32(999)
    pj = verify_j(step_j, (jnp.asarray(ARENA), jnp.asarray(idx),
                           fp_of(FPJ, lambda v: jnp.asarray(np.int32(v)))),
                  mode="extent")
    pt = verify(step_t, (torch.from_numpy(ARENA), torch.tensor(idx),
                         fp_of(FPT, lambda v: torch.tensor(np.int32(v)))),
                mode="extent")
    for proof in (pj, pt):
        assert proof.fully_proven and proof.mode == "extent"
    assert pt.summary() == pj.summary()
    assert pt.sites[0].target == ("guard[B0, -1+B0+S0]" if dynamic
                                  else "extent[0, 255]")


def test_extent_mode_fences_what_it_cannot_bound_and_never_refutes():
    """A raw pointer into the arena is FENCED in extent mode (never
    refuted, unlike row mode), as in the reference."""
    def step_j(arena, ptr):
        return arena, jnp.take(arena, ptr + jnp.arange(4, dtype=jnp.int32),
                               axis=0)

    def step_t(arena, ptr):
        return arena, arena.index_select(
            0, ptr + torch.arange(4, dtype=I32))

    pj = verify_j(step_j, (jnp.asarray(ARENA), jnp.int32(4096)),
                  mode="extent")
    pt = verify(step_t, (torch.from_numpy(ARENA), torch.tensor(4096,
                                                               dtype=I32)),
                mode="extent")
    assert [s.verdict for s in pt.sites] == [s.verdict for s in pj.sites] \
        == [FENCED]
    assert pt.n_refuted == 0 and not pt.fully_proven


def _good_step(xnp):
    def good(arena, x):
        idx = xnp.arange(8, dtype=xnp.int32) & 63
        if xnp is jnp:
            return arena, jnp.take(arena, idx, axis=0) + x
        return arena, arena.index_select(0, idx) + x
    return good


def _bad_step(xnp):
    def bad(arena, ptr):
        idx = ptr + xnp.arange(4, dtype=xnp.int32)
        if xnp is jnp:
            return arena, jnp.take(arena, idx, axis=0)
        return arena, arena.index_select(0, idx)
    return bad


def _drive_pair(mgr, name, args, width):
    """Launch ``name`` from ``width`` tenants (one drain) and return the
    results."""
    clients = [mgr.register_tenant(f"t{i}", 64) for i in range(width)]
    reqs = [c.launch_kernel(name, args=(a,)) for c, a in zip(clients, args)]
    mgr.synchronize()
    return [r.result for r in reqs]


PATHS = [("compiled", True, 1), ("eager", False, 1), ("fused", True, 2)]


@pytest.mark.parametrize("path,jit,width", PATHS,
                         ids=[p[0] for p in PATHS])
def test_trusted_verify_owes_the_proof_on_every_path(path, jit, width):
    """Mirror of ``test_trusted_verify_demands_full_proof`` on the compiled
    solo, the eager and the fused (width 2) paths: the good step runs with
    its proof cached once per signature, the bad step raises before any
    graph exists.  On the fused path the reference never proves (its
    ``_execute_trusted`` builds the fused step without
    ``_verify_trusted``): its bad step runs — the gap ROADMAP.md §3
    records."""
    mgr = GuardianManager(total_slots=1024, device="cpu", jit_trusted=jit)
    mgr.register_trusted_kernel("good", _good_step(torch), verify=True)
    mgr.register_trusted_kernel("bad", _bad_step(torch), verify=True)
    outs = _drive_pair(mgr, "good", [torch.tensor(1.0)] * width, width)
    assert all(tuple(o.shape) == (8,) for o in outs)
    entry = mgr.pointer_to_symbol["good"]
    assert [k[0] for k in entry.proofs] == ["extent"]
    assert next(iter(entry.proofs.values())).fully_proven
    if path == "fused":
        assert mgr.scheduler.stats.fused_steps == 1
    mgr = GuardianManager(total_slots=1024, device="cpu", jit_trusted=jit)
    mgr.register_trusted_kernel("bad", _bad_step(torch), verify=True)
    with pytest.raises(GuardianStaticViolation, match="verify=True"):
        _drive_pair(mgr, "bad", [torch.tensor(0, dtype=I32)] * width, width)
    assert not mgr.pointer_to_symbol["bad"].jit_cache
    assert not mgr.scheduler._fused_cache
    if path == "fused":
        ref = GMJ(total_slots=1024)
        ref.register_trusted_kernel("bad", _bad_step(jnp), verify=True)
        outs = _drive_pair(ref, "bad", [jnp.int32(0)] * 2, 2)
        assert ref.scheduler.stats.fused_steps == 1
        assert all(np.asarray(o).shape == (4,) for o in outs)


def test_trusted_step_bundle_threads_verify():
    """Mirror of ``test_trusted_step_bundle_threads_verify``."""
    from repro.launch.steps import TrustedStepBundle as TSBJ
    from repro_torch.launch.steps import TrustedStepBundle

    def step(arena, pool, x):
        return arena, pool, x

    for Bundle, mgr, pool in (
            (TSBJ, GMJ(total_slots=512), {"buf": jnp.zeros((4, 4))}),
            (TrustedStepBundle, GuardianManager(total_slots=512,
                                                device="cpu"),
             {"buf": torch.zeros((4, 4))})):
        bundle = Bundle(pool_name="p", prefill_name="pf", decode_name="dc",
                        prefill_fn=step, decode_fn=step, verify=True)
        bundle.register(mgr, pool)
        assert mgr.pointer_to_symbol["pf"].verify
        assert mgr.pointer_to_symbol["dc"].verify
        assert not Bundle(pool_name="p", prefill_name="pf",
                          decode_name="dc", prefill_fn=step,
                          decode_fn=step).verify


# --------------------------------------------------------------------- #
# Declared accesses against the plain versions                          #
# --------------------------------------------------------------------- #

P, PAGE, KH, D, B, H = 64, 8, 2, 4, 2, 4


def _fence_args(fence):
    """(base, mask, page_map) of a fence case: 0-d tensors carried in by
    ``bound_argnums`` (the symbolic row), ints by value, or tensors of
    unknown value."""
    return {"row": (torch.tensor(0, dtype=I32), torch.tensor(0, dtype=I32)),
            "static": (32, 15), "identity": (0, -1),
            "tensor": (torch.tensor(0, dtype=I32),
                       torch.tensor(0, dtype=I32))}[fence]


def _row_tensor(v, n):
    return v.expand(n) if isinstance(v, torch.Tensor) \
        else torch.full((n,), v, dtype=I32)


def _k3(op):
    def kernel(table, base, mask, idx):
        if op:
            return table, gather_rows(table, idx, base, mask)
        return table, ref.gather_rows_ref(table, idx, base, mask)
    return kernel, (0,), lambda b, m: (
        torch.zeros(256, 8), b, m, torch.zeros(16, dtype=I32))


def _k1(op, mapped, window=0):
    def kernel(k_pages, base, mask, q, v_pages, table, lens, page_map):
        if op:
            out = paged_attention(q, k_pages, v_pages, table, lens, base,
                                  mask, page_map, window=window)
        else:
            out = ref.paged_attention_ref(
                q, k_pages, v_pages, table, lens, _row_tensor(base, B),
                _row_tensor(mask, B), page_map, window=window)
        return k_pages, out
    return kernel, (0, 4), lambda b, m: (
        torch.zeros(P, PAGE, KH, D), b, m, torch.zeros(B, H, D),
        torch.zeros(P, PAGE, KH, D), torch.zeros(B, 4, dtype=I32),
        torch.ones(B, dtype=I32),
        torch.zeros(16, dtype=I32) if mapped else None)


def _k2(op, mapped):
    def kernel(k_pool, base, mask, v_pool, k_src, v_src, ids, page_map):
        if op:
            scatter_pages(k_pool, v_pool, k_src, v_src, ids, base, mask,
                          page_map)
        else:
            ref.scatter_pages_ref(k_pool, v_pool, k_src, v_src, ids, base,
                                  mask, page_map)
        return k_pool, None
    return kernel, (0, 3), lambda b, m: (
        torch.zeros(P, PAGE, KH, D), b, m, torch.zeros(P, PAGE, KH, D),
        torch.zeros(B, 12, KH, D), torch.zeros(B, 12, KH, D),
        torch.zeros(B, 2, dtype=I32),
        torch.zeros(16, dtype=I32) if mapped else None)


def _k4(op):
    def kernel(arena, base, mask, q, k, v):
        return arena, (flash_attention if op else ref.flash_attention_ref)(
            q, k, v)
    return kernel, (0,), lambda b, m: (
        torch.zeros(256), b, m, torch.zeros(B, 8, 4, 16),
        torch.zeros(B, 8, 2, 16), torch.zeros(B, 8, 2, 16))


def _k5(op):
    def kernel(arena, ids):
        fn = moe_histogram if op else ref.moe_histogram_ref
        return arena, fn(ids, 16, 0, 15)
    return kernel, (0,), lambda b, m: (torch.zeros(256),
                                       torch.zeros(8, 2, dtype=I32))


KERNEL_CASES = {
    "gather_rows": _k3,
    "paged_attention": lambda op: _k1(op, False),
    "paged_attention_mapped": lambda op: _k1(op, True),
    # a window narrows which fenced pages are read, never where
    "paged_attention_window": lambda op: _k1(op, False, window=40),
    "scatter_pages": lambda op: _k2(op, False),
    "scatter_pages_mapped": lambda op: _k2(op, True),
    "flash_attention": _k4,
    "moe_histogram": _k5,
}


def _proof(case, op, fence):
    kernel, arena_argnums, make = KERNEL_CASES[case](op)
    args = make(*_fence_args(fence))
    if case == "moe_histogram":
        return verify(kernel, args, arena_argnums=arena_argnums,
                      mode="row" if fence == "row" else "extent")
    if fence in ("row", "identity"):
        return verify(kernel, args, arena_argnums=arena_argnums,
                      bound_argnums=(1, 2) if fence == "row" else ())
    return verify(kernel, args, arena_argnums=arena_argnums, mode="extent")


@pytest.mark.parametrize("fence", ["row", "identity", "static", "tensor"])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_declared_accesses_match_the_plain_version(case, fence):
    """Each kernel op's declared accesses give the verdicts the verifier
    gives on the kernel's plain version traced into aten, under the same
    fence: the symbolic row (row mode), the identity fence by value (row
    mode), a static fence and a tensor fence of unknown value (extent
    mode).  K1-K3 address one site per accessed operand; K4 and K5 none."""
    before = _counts()
    op, plain = _proof(case, True, fence), _proof(case, False, fence)
    assert [s.verdict for s in op.sites] == [s.verdict for s in plain.sites]
    n = {"gather_rows": 1, "flash_attention": 0, "moe_histogram": 0}.get(
        case, 2)
    assert len(op.sites) == n
    assert all(s.prim == case.replace("_mapped", "").replace("_window", "")
               for s in op.sites)
    if fence == "row" and n:
        # a page map's entries are the manager's: through one, the page is
        # anywhere in the pool, never provably in the row
        assert op.symbolic and op.fully_proven == ("mapped" not in case)
    assert _counts() == before        # traced on fakes: nothing ran


@pytest.mark.parametrize("name", sorted(access.ACCESSES))
def test_declared_accesses_name_their_source_and_arguments(name):
    """Every declared access names op arguments that exist and the line of
    its source that forms the address: the CUDA source of a kernel, the
    plain version in ``kernels/ref.py`` of an op written in PyTorch (K3's
    backward)."""
    op = getattr(torch.ops.repro_torch, name).default
    params = {a.name for a in op._schema.arguments}
    for acc in access.ACCESSES[name]:
        assert {acc.operand, acc.index, *acc.base, *acc.mask} <= params
        assert acc.page_map is None or acc.page_map in params
        src, line = acc.source.split(":")
        cuda = src.endswith(".cu")
        root = _build.CSRC if cuda else _build.CSRC.parent
        text = (root / src).read_text().splitlines()[int(line) - 1]
        assert ("resolve_page" if acc.page_map else
                "fence_id" if cuda else "fence_ref") in text


# --------------------------------------------------------------------- #
# The serve steps                                                       #
# --------------------------------------------------------------------- #

ARCHS = ["stablelm-3b", "qwen3-moe-30b-a3b"]


def _reference_proof(arch, step):
    """The reference's lint proof of a paged serve step on the same
    fixture (``repro/lint.py``'s ``_paged_serve_fixture``, for ``arch``,
    with the port fixture's expert fence)."""
    import jax
    from repro.configs import get_config
    from repro.core.fence import FencePolicy
    from repro.launch.steps import build_trusted_serve_steps, \
        split_cache_pool
    from repro.models import get_model
    from repro.models import kvcache as KVJ
    from repro.models.guard import GuardSpec

    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    cache = jax.eval_shape(lambda: KVJ.init_global_kv_cache(
        cfg, 4, KVJ.PAGE_SIZE, 8))
    pool, meta = split_cache_pool(cache)
    params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    guard = GuardSpec(
        policy=FencePolicy.BITWISE, vocab=FPJ(base=0, size=256),
        kv=FPJ(base=0, size=8), page=FPJ(base=0, size=8),
        expert=FPJ(base=0, size=cfg.moe.num_experts) if cfg.moe else None,
        page_map=jax.ShapeDtypeStruct((8,), jnp.int32))
    bundle = build_trusted_serve_steps(api, "lint.paged")
    i32 = jax.ShapeDtypeStruct
    x = i32((4,), jnp.int32) if step == "decode" \
        else {"tokens": i32((4, 16), jnp.int32)}
    return verify_j(getattr(bundle, f"{step}_fn"),
                    (i32((1024,), jnp.float32), pool, params, meta, x,
                     guard), arena_argnums=(0, 1), mode="extent")


@pytest.fixture(scope="module", params=ARCHS)
def fixture(request):
    return request.param, paged_serve_fixture(request.param)


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_serve_step_proof_on_cuda_fakes_equals_cpu_and_reference(fixture,
                                                                 step):
    """A reduced paged prefill / decode step proven on fake CUDA tensors
    gives the proof it gives on fake CPU tensors — the kernels' custom ops
    in both, no launch, no plain call — and it is fully proven.  Its
    ``fully_proven`` and refuted count equal the reference lint's on the
    same fixture but for one named site: the decode's K/V append
    (``index_put_`` here, the reference's ``scatter``), FENCED in the
    reference because its layers are a ``scan`` whose layer index the
    interval fixpoint widens to ±∞, PROVEN here where the layer loop is
    unrolled and ``select(pool, 0, layer)`` is static."""
    arch, fx = fixture
    fn = getattr(fx[0], f"{step}_fn")
    before = _counts()
    proofs = {dev: verify(fn, step_operands(fx, step), arena_argnums=(0, 1),
                          mode="extent", device=dev)
              for dev in ("cpu", "cuda")}
    assert _counts() == before
    assert _rows(proofs["cuda"]) == _rows(proofs["cpu"])
    port = proofs["cpu"]
    assert port.fully_proven and port.mode == "extent"
    kernel = "scatter_pages" if step == "prefill" else "paged_attention"
    assert sum(s.prim == kernel for s in port.sites) == 4   # 2 layers x K, V
    traced = trace_kernel(fn, step_operands(fx, step), (0, 1), mode="extent")
    ops = [n.target for n in traced.gm.graph.nodes if n.op == "call_function"
           and n.target in KERNEL_OPS]
    want = {"gather_rows": 1, kernel: 2,
            "flash_attention": 2 if step == "prefill" else 0,
            "moe_histogram": 2 if "moe" in arch else 0}
    assert {name: ops.count(getattr(torch.ops.repro_torch, name).default)
            for name in want} == want        # every kernel of the step
    ref_proof = _reference_proof(arch, step)
    assert ref_proof.n_refuted == port.n_refuted == 0
    if step == "prefill":
        assert ref_proof.fully_proven
        return
    fenced = [s for s in ref_proof.sites if s.verdict != PROVEN]
    assert not ref_proof.fully_proven
    assert [(s.prim, s.interval, s.why) for s in fenced] == \
        [("scatter", "[-inf, +inf]", "interval unbounded")] * 2
    appends = [s for s in port.sites if s.prim == "index_put_"]
    assert len(appends) == 8 and all(s.verdict == PROVEN for s in appends)


#: the recurrent families' state pools a decode step reads and writes,
#: per Mamba layer (hybrid) or per (mLSTM, sLSTM) pair (xLSTM)
RECURRENT = {"zamba2-7b": ("ssm", "conv"),
             "xlstm-350m": ("mlstm_h", "mlstm_n", "slstm_c", "slstm_n",
                            "slstm_h", "slstm_m")}


@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_recurrent_slab_decode_step_is_proven(arch):
    """A reduced hybrid and a reduced xLSTM slab decode step, proven on
    fake CUDA tensors and on fake CPU tensors, give one proof, fully
    proven: every state-pool read (an ``index``) and write (an
    ``index_put_``) PROVEN inside the pool's slots, the hybrid's K/V
    appends (slot, page and offset, K and V) and its K1 reads too.  The
    step registered with ``verify=True`` proves itself at its first
    dispatch and then runs."""
    fx = slab_serve_fixture(arch)
    bundle, pool, params, meta, guard = fx
    ops = step_operands(fx, "decode")
    before = _counts()
    proofs = {dev: verify(bundle.decode_fn, ops, arena_argnums=(0, 1),
                          mode="extent", device=dev)
              for dev in ("cpu", "cuda")}
    assert _counts() == before
    assert _rows(proofs["cuda"]) == _rows(proofs["cpu"])
    port = proofs["cpu"]
    assert port.fully_proven and port.n_refuted == 0
    state = pool.get("state", pool)["pools"]
    layers = next(iter(state.values())).shape[0]
    slots = f"extent[0, {next(iter(state.values())).shape[1] - 1}]"
    n = len(RECURRENT[arch]) * layers
    # the hybrid's K and V appends: one site per index (slot, page, offset)
    appends = 2 * len(params.get("mamba", ()))
    reads = [s for s in port.sites if s.prim == "index"]
    writes = [s for s in port.sites if s.prim == "index_put_"]
    assert len(reads) == n and all(s.target == slots for s in reads)
    assert len(writes) == n + 3 * appends
    assert sum(s.target == slots for s in writes) == n + appends
    mgr = GuardianManager(total_slots=64, device="cpu")
    verified = dataclasses.replace(bundle, verify=True)
    verified.register(mgr, pool)
    client = mgr.register_tenant("t", 8)
    client.launch_kernel(verified.decode_name, args=ops[2:])
    mgr.synchronize()
    entry = mgr.pointer_to_symbol[verified.decode_name]
    assert entry.verify and entry.proofs
    assert all(p.fully_proven for p in entry.proofs.values())


def _unfenced(decode_fn):
    """A decode step whose page index skips the fence: the K/V append
    writes the page map's entry unfenced (no kv and no page partition)."""
    def step(arena, pool, params, meta, toks, guard):
        return decode_fn(arena, pool, params, meta, toks,
                         dataclasses.replace(guard, kv=None, page=None))
    return step


def test_unfenced_page_index_is_not_proven_and_verify_raises():
    """The negative control: the append's page index unfenced leaves its
    sites FENCED, and the step registered with ``verify=True`` raises at
    its first dispatch, before any graph exists."""
    bundle, pool, params, meta, guard = paged_serve_fixture()
    step = _unfenced(bundle.decode_fn)
    ops = step_operands((bundle, pool, params, meta, guard), "decode")
    proof = verify(step, ops, arena_argnums=(0, 1), mode="extent")
    fenced = {s.prim for s in proof.sites if s.verdict == FENCED}
    assert not proof.fully_proven and fenced == {"index_put_"}
    mgr = GuardianManager(total_slots=64, device="cpu")
    mgr.register_pool("p", pool)
    mgr.register_trusted_kernel("unfenced", step, pool_arena="p",
                                resident_argnums=(1,), verify=True)
    client = mgr.register_tenant("t", 8)
    before = _counts()
    with pytest.raises(GuardianStaticViolation, match="index_put_"):
        client.launch_kernel("unfenced", args=ops[2:])
        mgr.synchronize()
    assert _counts() == before
    assert not mgr.pointer_to_symbol["unfenced"].jit_cache


def test_tenant_kernel_handing_the_arena_to_a_kernel_op_fails_closed():
    """A tenant kernel whose graph hands the arena to a ``repro_torch``
    kernel op is refused, by the sandbox and at the manager's launch; the
    same op over a tensor of the tenant's own runs."""
    def evil(arena, idx):
        return arena, gather_rows(arena.reshape(-1, 4), idx, 0, 63)

    def own(arena, table, idx):
        return arena, gather_rows(table, idx, 0, 7)

    idx = torch.zeros(4, dtype=I32)
    with pytest.raises(SandboxError, match="hand-written kernel"):
        sandbox(evil, verify=True)(FPT(0, 64), torch.zeros(256), idx)
    mgr = GuardianManager(total_slots=256, device="cpu")
    mgr.register_kernel("evil", evil)
    mgr.register_kernel("own", own)
    client = mgr.register_tenant("t", 64)
    out = client.launch_kernel("own", args=(torch.ones(8, 4), idx))
    mgr.synchronize()
    assert tuple(out.result.shape) == (4, 4)
    with pytest.raises(SandboxError, match="hand-written kernel"):
        client.launch_kernel("evil", args=(idx,))
        mgr.synchronize()


def test_cuda_tensors_never_reach_a_plain_version():
    """Every kernel op called with (fake) CUDA tensors gets its fake
    implementation's shapes — never the plain version, never a launch —
    and ``_build.ptr`` refuses a tensor with no storage behind it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = _counts()
    with FakeTensorMode():
        dev = dict(device="cuda")
        ids = torch.zeros(B, 2, dtype=I32, **dev)
        pool = torch.zeros(P, PAGE, KH, D, **dev)
        outs = [
            gather_rows(torch.zeros(64, 8, **dev),
                        torch.zeros(5, dtype=I32, **dev), 0, 63),
            paged_attention(torch.zeros(B, H, D, **dev), pool, pool.clone(),
                            ids, torch.ones(B, dtype=I32, **dev), 0, -1),
            flash_attention(*(torch.zeros(B, 8, 4, 16, **dev),) * 3),
            moe_histogram(torch.zeros(8, 2, dtype=I32, **dev), 16, 0, 15)]
        scatter_pages(pool, pool.clone(), torch.zeros(B, 12, KH, D, **dev),
                      torch.zeros(B, 12, KH, D, **dev), ids, 0, -1)
        fake = torch.zeros(4, **dev)
    assert [tuple(o.shape) for o in outs] == [(5, 8), (B, H, D),
                                              (B, 8, 4, 16), (16,)]
    assert all(o.device.type == "cuda" for o in outs)
    assert _counts() == before
    for t in (fake, torch.zeros(4, device="meta")):
        with pytest.raises(ValueError, match="no storage"):
            _build.ptr(t)
    assert _build.ptr(torch.zeros(4)).value is not None


def test_serve_run_with_verify_equals_a_run_without():
    """A paged engine whose steps were registered with ``verify=True``
    (``launch.serve.register_verified_steps``, before the engine) proves
    each step signature once and serves the same tokens in the same drain
    cycles as one registered without."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeEngine, make_shared_manager, \
        register_verified_steps, serve_continuous
    from repro_torch.models import get_model

    cfg = get_config("stablelm-3b").reduced()
    params = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")

    def run(verified):
        mgr = make_shared_manager(1, max_batch=4, max_len=128, paged=True,
                                  device="cpu")
        if verified:
            register_verified_steps(mgr, cfg, max_batch=4, max_len=128)
        eng = ServeEngine(cfg, max_batch=4, max_len=128, manager=mgr,
                          paged=True, params=params, device="cpu")
        for t in ("a", "b"):
            eng.register_tenant(t, 4)
        rids = [eng.submit("ab"[i % 2], [(5 * i + j) % 250 + 1
                                         for j in range(6 + i)],
                           max_new=4, arrive=i // 2) for i in range(4)]
        outs = serve_continuous([eng], max_new_tokens=4)[0]
        entries = [mgr.pointer_to_symbol[n] for n in
                   (eng._steps.prefill_name, eng._steps.decode_name)]
        return ([outs[r] for r in rids],
                mgr.telemetry.registry.counter("drain_cycles"), entries)

    toks, cycles, entries = run(True)
    toks0, cycles0, entries0 = run(False)
    assert (toks, cycles) == (toks0, cycles0)
    assert all(e.verify and e.proofs for e in entries)
    assert all(p.fully_proven for e in entries for p in e.proofs.values())
    assert not any(e.verify or e.proofs for e in entries0)


def test_sandbox_report_of_a_trusted_step_is_its_extent_proof():
    """``sandbox_report`` of a trusted step returns its extent-mode proof,
    traced on fakes of the manager's device: meta tensors stand in for
    every operand's shape and give the proof real operands give."""
    from repro_torch.core.stepgraph import tree_flatten, tree_unflatten

    bundle, pool, params, meta, guard = paged_serve_fixture()
    mgr = GuardianManager(total_slots=1024, device="cpu")
    bundle.register(mgr, pool)
    args = step_operands((bundle, pool, params, meta, guard), "decode")[2:]

    def on_meta(x):
        struct, leaves = tree_flatten(x)
        return tree_unflatten(struct, [
            t.to("meta") if isinstance(t, torch.Tensor) else t
            for t in leaves])

    real = mgr.sandbox_report(bundle.decode_name, args)
    stand_in = mgr.sandbox_report(bundle.decode_name,
                                  tuple(on_meta(a) for a in args))
    assert real.mode == "extent" and real.fully_proven
    assert _rows(stand_in) == _rows(real) and len(real.sites) == 12

"""The port's training path against the JAX reference on the same numpy
inputs and converted weights: schedules, AdamW / Adafactor, the data
pipeline and the checkpoint store (mirrors of ``tests/test_substrate.py``),
K3's and K4's backwards, the dense and MoE losses and their gradients, the
fence modes, a forged batch, the train step and the restart-exact contract
(mirrors of ``tests/test_system.py``).  Reduced configs, float32."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import np_of, params_np, t_of  # noqa: E402
from repro.checkpoint import CheckpointStore as StoreJ  # noqa: E402
from repro.configs import ShapeConfig as ShapeJ, get_config  # noqa: E402
from repro.core.fence import FenceParams as FPJ, \
    FencePolicy as PJ  # noqa: E402
from repro.data import DataConfig as DataJ, FileTokens as FileJ, \
    SyntheticLM as SynJ  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.launch.steps import build_train_step as build_j, \
    make_guard as make_guard_j  # noqa: E402
from repro.models import get_model as get_model_j  # noqa: E402
from repro.models.guard import GuardSpec as GSJ  # noqa: E402
from repro.optim import adafactor as adafactor_j, adamw as adamw_j, \
    apply_updates as apply_j, constant as constant_j, cosine as cosine_j, \
    wsd as wsd_j  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import ShapeConfig, \
    get_config as get_config_t  # noqa: E402
from repro_torch.core.fence import FenceParams, FencePolicy  # noqa: E402
from repro_torch.core.stepgraph import tree_flatten, \
    tree_unflatten  # noqa: E402
from repro_torch.core.verifier import PROVEN, verify  # noqa: E402
from repro_torch.data import DataConfig, FileTokens, SyntheticLM, \
    make_source  # noqa: E402
from repro_torch.kernels import flash_attention, gather_rows, \
    ref  # noqa: E402
from repro_torch.launch.steps import build_train_step, \
    make_guard  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.guard import GuardSpec  # noqa: E402
from repro_torch.optim import adafactor, adamw, apply_updates, \
    clip_by_global_norm, constant, cosine, global_norm, wsd  # noqa: E402

#: loss and gradient tolerances against the reference (float32; XLA
#: orders its sums otherwise)
TOL_LOSS = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


# --------------------------------------------------------------------- #
# Schedules and optimizers                                              #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["cosine", "wsd", "constant"])
def test_schedules_match_reference(name):
    """Every step 0..120 of each schedule in float32, as the reference
    computes it, from a Python step and from an on-device int32 step."""
    make = {"cosine": lambda m: m(1.0, 10, 100),
            "wsd": lambda m: m(1.0, 10, 50, 40),
            "constant": lambda m: m(0.3)}[name]
    f = make({"cosine": cosine, "wsd": wsd, "constant": constant}[name])
    g = make({"cosine": cosine_j, "wsd": wsd_j, "constant": constant_j}[name])
    steps = np.arange(121)
    want = np.array([np.float32(g(int(s))) for s in steps])
    got = np.array([f(int(s)).item() for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    got_t = np.array([f(torch.tensor(int(s), dtype=torch.int32)).item()
                      for s in steps], np.float32)
    np.testing.assert_array_equal(got_t, got)


def test_schedules():
    """Mirror of ``test_substrate.py::test_schedules``."""
    f = cosine(1.0, warmup=10, total=100)
    assert float(f(5)) == pytest.approx(0.5)
    assert float(f(10)) == pytest.approx(1.0)
    assert float(f(100)) == pytest.approx(0.1, abs=1e-3)
    g = wsd(1.0, warmup=10, stable=50, decay=40)
    assert float(g(30)) == pytest.approx(1.0)
    assert float(g(100)) < 0.02


def _tree_np(rng, bf16_shape):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=bf16_shape).astype(np.float32),
            "nested": [rng.normal(size=(3,)).astype(np.float32)]}


def _to_j(tree):
    return {"w": jnp.asarray(tree["w"]),
            "b": jnp.asarray(tree["b"]).astype(jnp.bfloat16),
            "nested": [jnp.asarray(tree["nested"][0])]}


def _to_t(tree):
    return {"w": t_of(tree["w"]), "b": t_of(tree["b"]).to(torch.bfloat16),
            "nested": [t_of(tree["nested"][0])]}


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def _assert_tree_close(pt, pj):
    """float32 leaves within 1e-6 relative, bfloat16 leaves within one ulp
    (their bits one apart at most)."""
    np.testing.assert_allclose(np_of(pt["w"]), np_of(pj["w"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(np_of(pt["nested"][0]),
                               np_of(pj["nested"][0]), rtol=1e-6, atol=1e-7)
    assert np.abs(_bf16_bits(pt["b"]) - _bf16_bits(pj["b"])).max() <= 1


@pytest.mark.parametrize("name,grad_scale", [
    ("adamw", 0.3), ("adamw", 5.0),       # under / over the clip norm
    ("adamw_nodecay", 5.0), ("adafactor", 1.0)])
def test_optimizer_updates_match_reference(name, grad_scale):
    """Five updates of a tree with float32 leaves and a bfloat16 leaf
    (a 2-D one for Adafactor's factored moments) from the same numpy
    params and gradients: params within 1e-6 relative (bf16 within one
    ulp), the float32 moments too — those of the bfloat16 leaf within
    one bfloat16 ulp (2**-8 relative): they sum its gradient after the
    clip, taken in bfloat16 with a scale whose last float32 bit depends
    on the order of the global norm's sum."""
    make = {"adamw": lambda a, s: a(s(0.1)),
            "adamw_nodecay": lambda a, s: a(s(0.05), weight_decay=0.0,
                                            clip_norm=None),
            "adafactor": lambda a, s: a(s(0.1), weight_decay=0.01)}[name]
    is_ada = name == "adafactor"
    opt_t = make(adafactor if is_ada else adamw, constant)
    opt_j = make(adafactor_j if is_ada else adamw_j, constant_j)
    rng = np.random.default_rng(7)
    p0 = _tree_np(rng, (5, 6) if is_ada else (5,))
    pt, pj = _to_t(p0), _to_j(p0)
    st, sj = opt_t.init(pt), opt_j.init(pj)
    for _ in range(5):
        g = _tree_np(rng, p0["b"].shape)
        g = {k: (v * grad_scale if k != "nested"
                 else [v[0] * grad_scale]) for k, v in g.items()}
        ut, st = opt_t.update(_to_t(g), st, pt)
        pt = apply_updates(pt, ut)
        uj, sj = opt_j.update(_to_j(g), sj, pj)
        pj = apply_j(pj, uj)
        _assert_tree_close(pt, pj)
    assert int(st["step"]) == int(sj["step"]) == 5
    moments = [k for k in st if k != "step"]
    for key in moments:
        for leaf in ("w", "b", "nested"):
            a, b = st[key][leaf], sj[key][leaf]
            mom_t, mom_j = tree_flatten(a)[1], jax.tree.leaves(b)
            assert len(mom_t) == len(mom_j)
            for x, y in zip(mom_t, mom_j):
                assert x.dtype == torch.float32
                np.testing.assert_allclose(
                    np_of(x), np_of(y), atol=1e-8,
                    rtol=2.0 ** -8 if leaf == "b" else 2e-6)


@pytest.mark.parametrize("make_opt,tol", [
    (lambda: adamw(constant(0.1), weight_decay=0.0), 1e-2),
    (lambda: adafactor(constant(0.5)), 0.5),
])
def test_optimizer_minimizes_quadratic(make_opt, tol):
    """Mirror of ``test_substrate.py::test_optimizer_minimizes_quadratic``."""
    opt = make_opt()
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    state = opt.init(params)

    def loss_fn(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    start = float(loss_fn(params))
    for _ in range(200):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(
            loss_fn(leaves), list(leaves.values()))))
        updates, state = opt.update(grads, state, params)
        params = apply_updates(params, updates)
    final = float(loss_fn(params))
    assert final < tol and final < start / 50


def test_clip_by_global_norm():
    """Mirror of ``test_substrate.py::test_clip_by_global_norm``."""
    g = {"a": torch.full((4,), 3.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 6.0) < 1e-5
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert torch.equal(g["a"], torch.full((4,), 3.0))    # not in place


# --------------------------------------------------------------------- #
# Data pipeline                                                         #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("host_count", [1, 2])
def test_synthetic_batches_match_reference(host_count):
    """Every host's batch at steps 0, 1, 5 and 17, bit for bit."""
    for host in range(host_count):
        kw = dict(vocab=128, seq_len=32, global_batch=8, seed=3,
                  host_index=host, host_count=host_count)
        s_t, s_j = SyntheticLM(DataConfig(**kw)), SynJ(DataJ(**kw))
        np.testing.assert_array_equal(s_t._succ, s_j._succ)
        for step in (0, 1, 5, 17):
            b = s_t.batch(step)["tokens"]
            assert b.dtype == np.int32 and b.shape == (8 // host_count, 33)
            np.testing.assert_array_equal(b, s_j.batch(step)["tokens"])


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_file_tokens_match_reference(tmp_path, dtype):
    """Windows of a token file the test writes, over steps and two hosts
    (wrapping past the file's end), bit for bit, through make_source."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 500, 1_000).astype(dtype).tofile(
        path)
    for host in range(2):
        kw = dict(vocab=500, seq_len=16, global_batch=8, seed=0,
                  host_index=host, host_count=2)
        f_t = make_source(DataConfig(**kw), str(path))
        f_t = f_t if dtype == np.uint16 else FileTokens(DataConfig(**kw),
                                                        str(path), dtype)
        f_j = FileJ(DataJ(**kw), str(path), dtype)
        for step in range(20):
            np.testing.assert_array_equal(f_t.batch(step)["tokens"],
                                          f_j.batch(step)["tokens"])


def test_data_deterministic_and_host_shards_disjoint():
    """Mirrors of ``test_data_deterministic_and_restart_exact``,
    ``test_data_host_shards_disjoint`` and
    ``test_data_has_learnable_structure``."""
    cfg = DataConfig(vocab=128, seq_len=32, global_batch=8, seed=3)
    for step in (0, 5, 17):
        np.testing.assert_array_equal(SyntheticLM(cfg).batch(step)["tokens"],
                                      SyntheticLM(cfg).batch(step)["tokens"])
    h = [DataConfig(vocab=64, seq_len=16, global_batch=8, seed=1,
                    host_index=i, host_count=2) for i in range(2)]
    assert h[0].local_batch == 4
    assert not np.array_equal(SyntheticLM(h[0]).batch(2)["tokens"],
                              SyntheticLM(h[1]).batch(2)["tokens"])
    src = SyntheticLM(DataConfig(vocab=64, seq_len=128, global_batch=4))
    toks = src.batch(0)["tokens"]
    assert (src._succ[toks[:, :-1]] == toks[:, 1:]).mean() > 0.5
    with pytest.raises(ValueError):
        DataConfig(vocab=64, seq_len=16, global_batch=6,
                   host_count=4).local_batch


# --------------------------------------------------------------------- #
# Checkpointing                                                         #
# --------------------------------------------------------------------- #

def test_checkpoint_roundtrip(tmp_path):
    """Mirror of ``test_checkpoint_roundtrip``, with a bfloat16 leaf whose
    bits come back exactly and the reference's path-joined keys."""
    store = CheckpointStore(str(tmp_path), keep=2)
    bf = torch.randn(5, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "s": torch.tensor(7, dtype=torch.int32),
            "nested": {"b": torch.ones(4), "l": [bf]}}
    store.save(10, tree)
    got, step = store.restore(tree)
    assert step == 10
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert int(got["s"]) == 7 and got["s"].dtype == torch.int32
    assert got["nested"]["l"][0].dtype == torch.bfloat16
    assert torch.equal(got["nested"]["l"][0].view(torch.int16),
                       bf.view(torch.int16))
    # the reference's store names the same leaves the same way
    ref_dir = tmp_path / "ref"
    StoreJ(str(ref_dir)).save(10, {"w": np.zeros((2, 3)), "s": np.int32(7),
                                   "nested": {"b": np.ones(4),
                                              "l": [np.zeros(5)]}})
    import json
    keys = lambda d: json.load(open(os.path.join(  # noqa: E731
        d, "step_000000000010", "manifest.json")))["keys"]
    assert keys(str(tmp_path)) == keys(str(ref_dir))


def test_checkpoint_async_and_retention(tmp_path):
    """Mirror of ``test_checkpoint_async_and_retention``; ``save_async``
    snapshots at the call, so a later in-place update is not saved."""
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(8)}
    for s in (1, 2, 3, 4):
        x = torch.full((8,), float(s))
        store.save_async(s, {"x": x})
        x.add_(100.0)
    store.wait()
    assert store.steps() == [3, 4]
    got, step = store.restore(tree)
    assert step == 4 and float(got["x"][0]) == 4.0


def test_checkpoint_partial_write_ignored(tmp_path):
    """Mirror of ``test_checkpoint_partial_write_ignored``."""
    store = CheckpointStore(str(tmp_path))
    store.save(5, {"x": torch.ones(3)})
    os.makedirs(tmp_path / "step_000000000009.tmp-zzz")
    assert store.latest_step() == 5
    store.save(6, {"x": torch.ones(3)})
    assert not any(".tmp-" in n for n in os.listdir(tmp_path))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    """Mirror of ``test_checkpoint_shape_mismatch_rejected``, and a
    missing key."""
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"x": torch.ones(3)})
    with pytest.raises(ValueError):
        store.restore({"x": torch.ones(4)})
    with pytest.raises(KeyError):
        store.restore({"y": torch.ones(3)})


def test_checkpoint_wait_reraises_writer_error(tmp_path, monkeypatch):
    store = CheckpointStore(str(tmp_path))

    def fail(step, host):
        raise OSError("disk full")
    monkeypatch.setattr(store, "_write", fail)
    store.save_async(1, {"x": torch.ones(3)})
    with pytest.raises(OSError, match="disk full"):
        store.wait()
    store.wait()                      # the error is raised once


# --------------------------------------------------------------------- #
# K3 and K4 backwards                                                   #
# --------------------------------------------------------------------- #

I32 = torch.int32


def _k3_inputs():
    g = torch.Generator().manual_seed(0)
    table = torch.randn(40, 8, generator=g)
    idx = torch.tensor([1, 5, 5, 39, -3, 17, 5, 70, -100, 33], dtype=I32)
    return table, idx, torch.randn(10, 8, generator=g)


@pytest.mark.parametrize("fence", ["scalar", "identity", "per-id"])
def test_gather_rows_backward_matches_autograd_of_plain(fence):
    """K3's registered backward equals autograd through the plain version
    (``ref.gather_rows_ref``): rows added at the fenced ids, equal ids
    summed, ids past the table (NaN rows) dropped."""
    table, idx, grad = _k3_inputs()
    base, mask = {"scalar": (0, 63), "identity": (0, -1),
                  "per-id": (torch.tensor([0, 32] * 5, dtype=I32),
                             torch.full((10,), 15, dtype=I32))}[fence]
    a = table.clone().requires_grad_()
    out = gather_rows(a, idx, base, mask)
    (d_op,) = torch.autograd.grad(out, a, torch.where(out.isnan(), 0.0,
                                                      grad))
    b = table.clone().requires_grad_()
    want = ref.gather_rows_ref(b, idx, base, mask)
    (d_ref,) = torch.autograd.grad(want, b, torch.where(want.isnan(), 0.0,
                                                        grad))
    torch.testing.assert_close(d_op, d_ref, rtol=0, atol=1e-6)
    rows = ref.fence_ref(idx, base, mask)
    rows = torch.where(rows < 0, rows + 40, rows)
    hit = set(rows[(rows >= 0) & (rows < 40)].tolist())
    assert set(d_op.abs().sum(1).nonzero().flatten().tolist()) <= hit


def test_flash_attention_backward_matches_autograd_of_plain():
    """K4's recompute backward equals autograd through
    ``ref.flash_attention_ref`` in every form (causal, windowed,
    non-causal, GQA groups of 2), within 1e-5."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 13, 4, 16, generator=g)
    k, v = torch.randn(2, 13, 2, 16, generator=g), \
        torch.randn(2, 13, 2, 16, generator=g)
    do = torch.randn(2, 13, 4, 16, generator=g)
    for causal, w in ((True, 0), (True, 5), (False, 0), (False, 4)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(flash_attention(*ins, causal, w), ins, do)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(*ins, causal, w),
                                   ins, do)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["gather_rows", "gather_rows_per_id",
                                  "flash_attention",
                                  "flash_attention_window"])
def test_opcheck(case):
    """``torch.library.opcheck`` of the differentiable ops: schema,
    autograd registration, fake tensor and AOT dispatch (forward and
    backward) — the ids inside the table (opcheck compares outputs without
    NaN equality)."""
    g = torch.Generator().manual_seed(2)
    if case.startswith("gather_rows"):
        table = torch.randn(20, 8, generator=g, requires_grad=True)
        idx = torch.tensor([1, 5, 5, 17, -3, 19, 7, 35], dtype=I32)
        per = case.endswith("per_id")
        args = (table, idx,
                torch.zeros(8, dtype=I32) if per else None,
                torch.full((8,), 15, dtype=I32) if per else None,
                0, -1 if per else 15)
        op = torch.ops.repro_torch.gather_rows.default
    else:
        q = torch.randn(2, 9, 4, 16, generator=g, requires_grad=True)
        k = torch.randn(2, 9, 2, 16, generator=g, requires_grad=True)
        v = torch.randn(2, 9, 2, 16, generator=g, requires_grad=True)
        args = (q, k, v, True, 3 if case.endswith("window") else 0)
        op = torch.ops.repro_torch.flash_attention.default
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("fence", ["static", "tensor"])
def test_gather_rows_backward_proven_where_the_gather_is(fence):
    """The backward's declared store (into the table's rows, at the fenced
    ids) gets the gather's verdict under the same fence, a static one and
    one of unknown value: PROVEN, since neither forms an address outside
    the table (a NaN row, a dropped store)."""
    base, mask = (0, 15) if fence == "static" else (
        torch.zeros((), dtype=I32), torch.zeros((), dtype=I32))

    def step(table, idx, grad, base, mask):
        with torch.enable_grad():
            t = table.detach().requires_grad_()
            rows = gather_rows(t, idx, base, mask)
            (d_table,) = torch.autograd.grad(rows, t, grad)
        return table, (rows.detach(), d_table)

    args = (torch.zeros(16, 4), torch.zeros(6, dtype=I32),
            torch.zeros(6, 4), base, mask)
    proof = verify(step, args, arena_argnums=(0,), mode="extent")
    kinds = [(s.prim, s.verdict) for s in proof.sites]
    assert [p for p, _ in kinds] == ["gather_rows", "gather_rows_backward"]
    assert kinds[0][1] == kinds[1][1] == PROVEN


# --------------------------------------------------------------------- #
# Losses and gradients against the reference                            #
# --------------------------------------------------------------------- #

ARCHS = ["stablelm-3b", "minicpm-2b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module")
def models():
    """Per arch: reduced configs, the reference's params and the port's
    converted copy, and a (2, 33) token batch."""
    out = {}
    for arch in ARCHS:
        cj = get_config(arch).reduced()
        ct = get_config_t(arch).reduced()
        pj = get_model_j(cj).init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(0, cj.vocab, (2, 33)) \
            .astype(np.int32)
        out[arch] = (cj, ct, pj, params_from_jax(params_np(pj), "cpu"),
                     toks)
    return out


def _ref_loss_grads(cfg, params, toks, guard=None):
    api = get_model_j(cfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, t: api.loss(p, {"tokens": t}, guard=guard, remat=False)))
    loss, grads = fn(params, jnp.asarray(toks))
    return float(loss), params_from_jax(params_np(grads), "cpu")


def _port_loss_grads(cfg, params, toks, guard=None, remat=False):
    struct, leaves = tree_flatten(params)
    req = [p.detach().clone().requires_grad_() for p in leaves]
    loss = get_model(cfg).loss(tree_unflatten(struct, req),
                               {"tokens": t_of(toks)}, guard=guard,
                               remat=remat)
    grads = torch.autograd.grad(loss, req)
    return loss.detach(), tree_unflatten(struct, list(grads))


def _assert_grads_close(gt, gj):
    lt, lj = tree_flatten(gt)[1], tree_flatten(gj)[1]
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(models, arch):
    """The loss (MoE: plus 0.01 x the aux loss) within 1e-5 and every
    gradient leaf within atol 1e-5 / rtol 1e-4 of the reference's, under
    the train guard (minicpm-2b: tied embeddings, the table's gradient the
    K3 scatter-add plus the LM head's product); remat on gives the same
    loss and gradients bit for bit."""
    cj, ct, pj, pt, toks = models[arch]
    gj = make_guard_j(cj, ShapeJ("t", "train", 32, 2))
    gt = make_guard(ct, ShapeConfig("t", "train", 32, 2))
    loss_j, grads_j = _ref_loss_grads(cj, pj, toks, gj)
    loss_t, grads_t = _port_loss_grads(ct, pt, toks, gt)
    assert abs(float(loss_t) - loss_j) < TOL_LOSS
    _assert_grads_close(grads_t, grads_j)
    loss_r, grads_r = _port_loss_grads(ct, pt, toks, gt, remat=True)
    assert torch.equal(loss_r, loss_t)
    for a, b in zip(tree_flatten(grads_r)[1], tree_flatten(grads_t)[1]):
        assert torch.equal(a, b)


def test_fence_modes_equivalent_for_honest_tenant(models):
    """Mirror of ``test_system.py::test_fence_modes_equivalent_for_honest
    _tenant`` (reduced qwen3-moe): native, BITWISE, MODULO and CHECK give
    the same loss, each within 1e-5 of the reference's in that mode."""
    cj, ct, pj, pt, _ = models["qwen3-moe-30b-a3b"]
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 33), 0,
                                         cj.vocab)).astype(np.int32)
    api_j, api_t = get_model_j(cj), get_model(ct)
    losses = {}
    for name, policy, enabled in [("native", "bitwise", False),
                                  ("bitwise", "bitwise", True),
                                  ("modulo", "modulo", True),
                                  ("check", "check", True)]:
        gj = make_guard_j(cj, ShapeJ("t", "train", 32, 2), PJ(policy),
                          enabled)
        gt = make_guard(ct, ShapeConfig("t", "train", 32, 2),
                        FencePolicy(policy), enabled)
        assert (gt is None) == (gj is None)
        if gt is not None:
            for space in ("vocab", "kv", "state", "expert", "page"):
                a, b = getattr(gt, space), getattr(gj, space)
                assert (a.base, a.size) == (b.base, b.size)
        with torch.no_grad():
            losses[name] = float(api_t.loss(pt, {"tokens": t_of(toks)},
                                            guard=gt, remat=False))
        want = float(api_j.loss(pj, {"tokens": jnp.asarray(toks)},
                                guard=gj, remat=False))
        assert abs(losses[name] - want) < TOL_LOSS, (name, losses[name], want)
    for name, v in losses.items():
        assert abs(v - losses["native"]) < 1e-5, losses


@pytest.mark.parametrize("policy", ["bitwise", "modulo"])
def test_forged_batch_gradient_stays_in_the_vocab_partition(models, policy):
    """A tenant owning vocab rows [128, 256) of the reduced stablelm-3b's
    (untied) table sends a batch whose first column is forged (ids past
    the table, negative, in the other half): every fenced id lands in the
    tenant's rows, so the table's gradient — K3's scatter-add alone — is
    zero outside them, and equals the reference's."""
    cj, ct, pj, pt, _ = models["stablelm-3b"]
    toks = np.random.default_rng(3).integers(128, 256, (2, 33)) \
        .astype(np.int32)
    toks[:, 0] = [5, 1_000_003] if policy == "bitwise" else [-7, 300]
    gj = GSJ(policy=PJ(policy), vocab=FPJ(128, 128))
    gt = GuardSpec(policy=FencePolicy(policy), vocab=FenceParams(128, 128))
    loss_j, grads_j = _ref_loss_grads(cj, pj, toks, gj)
    loss_t, grads_t = _port_loss_grads(ct, pt, toks, gt)
    assert abs(float(loss_t) - loss_j) < TOL_LOSS
    d = grads_t["embed"]["table"]
    assert d[:128].abs().max() == 0 and d[128:].abs().max() > 0
    _assert_grads_close(grads_t, grads_j)


# --------------------------------------------------------------------- #
# The train step and restart-exactness                                  #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-moe-30b-a3b"])
def test_train_step_losses_match_reference(models, arch):
    """Ten steps of ``build_train_step`` (remat on, the guard, AdamW under
    the reference's cosine at peak lr 0.5 — warm-up lr up to 2.5e-3) on
    SyntheticLM batches, against the reference's jitted step from the
    same weights: every step's loss within 1e-4."""
    cj, ct, pj, pt, _ = models[arch]
    shape_j, shape_t = ShapeJ("t", "train", 32, 2), \
        ShapeConfig("t", "train", 32, 2)
    bj = build_j(cj, shape_j, make_local_mesh(), peak_lr=0.5)
    step_j = jax.jit(bj.fn)
    bt = build_train_step(ct, shape_t, peak_lr=0.5, device="cpu")
    params_t = params_from_jax(params_np(pj), "cpu")
    sj = adamw_j(cosine_j(0.5, 2_000, 100_000)).init(pj)
    st = bt.opt.init(params_t)
    data = SyntheticLM(DataConfig(vocab=ct.vocab, seq_len=32,
                                  global_batch=2))
    params_j = pj
    for s in range(10):
        toks = data.batch(s)["tokens"]
        params_j, sj, out_j = step_j(params_j, sj,
                                     {"tokens": jnp.asarray(toks)})
        params_t, st, out_t = bt.fn(params_t, st, {"tokens": t_of(toks)})
        assert abs(float(out_t["loss"]) - float(out_j["loss"])) < 1e-4, s


def test_training_restart_exact(tmp_path):
    """Mirror of ``test_system.py::test_training_restart_exact``:
    checkpoint at step 20, restore, and reach the same step-40 params as
    an uninterrupted run — on the port, bit for bit."""
    cfg = get_config_t("minicpm-2b").reduced()
    api = get_model(cfg)
    step = build_train_step(cfg, ShapeConfig("t", "train", 32, 4),
                            remat=False, schedule=constant(1e-3),
                            device="cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4, seed=0))

    def fresh():
        p = api.init(torch.Generator().manual_seed(0), "cpu")
        return p, step.opt.init(p)

    def run(start, stop, params, opt_state):
        for s in range(start, stop):
            params, opt_state, _ = step.fn(
                params, opt_state,
                {"tokens": torch.from_numpy(data.batch(s)["tokens"])})
        return params, opt_state

    pA, sA = run(0, 40, *fresh())
    pB, sB = run(0, 20, *fresh())
    store = CheckpointStore(str(tmp_path))
    store.save(20, (pB, sB))
    (pB, sB), at = store.restore(fresh())
    assert at == 20 and int(sB["step"]) == 20
    pB, sB = run(20, 40, pB, sB)
    for a, b in zip(tree_flatten((pA, sA))[1], tree_flatten((pB, sB))[1]):
        assert torch.equal(a, b)


def test_train_step_frees_its_gradients_without_the_cycle_collector(
        monkeypatch):
    """A train step leaves no reference cycle around its gradients or
    updates (GBs at full size): with the cyclic garbage collector off,
    both are freed when the step returns (``stepgraph.tree_unflatten``
    once closed over itself, so every tree it built waited for the
    collector)."""
    import gc
    import weakref

    from repro_torch.launch import steps as S
    cfg = get_config_t("minicpm-2b").reduced()
    step = build_train_step(cfg, ShapeConfig("t", "train", 32, 2),
                            remat=False, device="cpu")
    params = step.api.init(torch.Generator().manual_seed(0), "cpu")
    opt_state = step.opt.init(params)
    grad, apply = torch.autograd.grad, S.apply_updates
    seen = []

    def spy_grad(*a, **kw):
        out = grad(*a, **kw)
        seen.append(weakref.ref(out[0]))
        return out

    def spy_apply(params, updates):
        seen.append(weakref.ref(tree_flatten(updates)[1][0]))
        return apply(params, updates)

    monkeypatch.setattr(torch.autograd, "grad", spy_grad)
    monkeypatch.setattr(S, "apply_updates", spy_apply)
    toks = torch.from_numpy(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=2)).batch(0)["tokens"])
    # a first step after the ops are registered: the first call of a
    # custom op keeps its caller's frames once (PyTorch's lazy set-up)
    params, opt_state, _ = step.fn(params, opt_state, {"tokens": toks})
    seen.clear()
    gc.collect()
    gc.disable()
    try:
        step.fn(params, opt_state, {"tokens": toks})
        assert len(seen) == 2 and all(r() is None for r in seen)
    finally:
        gc.enable()

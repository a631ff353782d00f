"""The port's cost model over a traced aten graph
(``repro_torch/launch/graph_analysis.py``) against the reference's HLO
cost model (``repro/launch/hlo_analysis.py``):

* trip counts: a ``scan`` of 5 matmuls, a ``while_loop`` (its trips from
  the condition's constant) and a ``cond`` (its worst branch), each
  equal to the reference's ``analyze_hlo`` of the same function under
  ``lax.scan`` / ``while_loop`` / ``cond``;
* FLOPs of every family's train / prefill / decode bundle on a reduced
  config equal to the reference's ``analyze_hlo`` of its compiled bundle
  within 2 %, or, for the rows that differ by design (``PINNED``, the
  ops named in PERF.md), equal to the pinned ratio within 1 %;
* bytes, vector FLOPs and the liveness walk hand-counted on a small step
  with a view, an in-place write, a foreach op and a donated output;
* each kernel's cost rule at two shapes, and an unknown custom op
  refused;
* the cut loops (the SSD's chunks, the sLSTM's positions) extrapolated
  to the same costs as the unrolled trace;
* a trace launches nothing and runs no plain version; CUDA fakes (on a
  build without CUDA) count what CPU fakes count.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as ShapeJ, get_config  # noqa: E402
from repro.launch import mesh as MJ, steps as STJ  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro_torch.configs import ShapeConfig, \
    get_config as get_config_t  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import graph_analysis as GA, mesh as MT, \
    steps as STT  # noqa: E402

F32 = torch.float32


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _hlo(fn, *specs):
    return analyze_hlo(jax.jit(fn).lower(*specs).compile().as_text())


# ---------------------------------------------------------------------------
# Trip counts
# ---------------------------------------------------------------------------

def test_scan_of_matmuls_counts_trips():
    """The reference's ``test_hlo_analyzer_counts_scan_trips``: a scan of
    5 (8, 64) x (64, 64) products counts 5 x 2·8·64·64, exactly here and
    within the reference's 5 % there."""
    from torch._higher_order_ops.scan import scan

    def f(ws, x):
        def body(x, w):
            y = torch.relu(x @ w)
            return y, y.clone()
        return scan(body, x, ws)[0]

    want = 5 * 2 * 8 * 64 * 64
    got = GA.analyze_graph(GA.trace_step(f, (_meta(5, 64, 64),
                                             _meta(8, 64)), "cpu"))
    assert got.flops == want

    def fj(ws, x):
        def body(x, w):
            return jax.nn.relu(x @ w), None
        return jax.lax.scan(body, x, ws)[0]

    ref = _hlo(fj, jax.ShapeDtypeStruct((5, 64, 64), jnp.float32),
               jax.ShapeDtypeStruct((8, 64), jnp.float32))
    assert abs(ref.flops - want) / want < 0.05
    assert abs(got.flops - ref.flops) / ref.flops < 0.05


def test_while_loop_counts_its_condition_constant():
    """A ``while_loop`` body counts x the largest int constant of its
    condition, as the reference reads a ``while``'s."""
    from torch._higher_order_ops.while_loop import while_loop

    def f(i, x):
        return while_loop(lambda i, x: i < 7,
                          lambda i, x: (i + 1, x @ x), (i, x))[1]

    got = GA.analyze_graph(GA.trace_step(
        f, (_meta(dtype=torch.int32), _meta(8, 8)), "cpu"))

    def fj(x):
        return jax.lax.while_loop(lambda c: c[0] < 7,
                                  lambda c: (c[0] + 1, c[1] @ c[1]),
                                  (0, x))[1]

    ref = _hlo(fj, jax.ShapeDtypeStruct((8, 8), jnp.float32))
    assert got.flops == 7 * 2 * 8 ** 3 == ref.flops


def test_cond_counts_its_worst_branch():
    def f(p, x):
        return torch.cond(p, lambda x: (x @ x).sin(), lambda x: x.cos(),
                          (x,))

    got = GA.analyze_graph(GA.trace_step(
        f, (_meta(dtype=torch.bool), _meta(8, 8)), "cpu"))

    def fj(p, x):
        return jax.lax.cond(p, lambda x: jnp.sin(x @ x), jnp.cos, x)

    ref = _hlo(fj, jax.ShapeDtypeStruct((), jnp.bool_),
               jax.ShapeDtypeStruct((8, 8), jnp.float32))
    assert got.flops == 2 * 8 ** 3 == ref.flops


# ---------------------------------------------------------------------------
# FLOPs parity: every family's bundles against the reference's HLO
# ---------------------------------------------------------------------------

FAMILIES = {"dense": "stablelm-3b", "moe": "qwen3-moe-30b-a3b",
            "hybrid": "zamba2-7b", "ssm": "xlstm-350m",
            "vlm": "qwen2-vl-2b", "encdec": "seamless-m4t-medium"}

#: rows whose FLOPs differ by design, with the measured ratio (port /
#: reference): the vision family's prompt holds its 256 patches, so its
#: rows run at S = 256, where K4 visits only the key tiles on or below
#: the diagonal (10 of 16) and the reference's attention takes every
#: (query, key) pair; K4's backward recomputes the scores (one more QK^T
#: ``bmm`` a layer than the reference's autodiff of its remat pass), which
#: seamless's 1,024-frame encoder makes 9.6 % of its train step
PINNED = {("vlm", "train"): 0.972222, ("vlm", "prefill"): 0.823934,
          ("encdec", "train"): 1.096262}


def _bundle_specs(family, kind):
    """Both sides' bundles and inputs at reduced width, S = 64 (the vision
    family: 256), batch 2 (decode: 4); the encoder-decoder's frames in
    float32, the reduced config's type (the reference's encoder takes
    them in the model's type only)."""
    name = FAMILIES[family]
    S, B = (256 if family == "vlm" else 64), (4 if kind == "decode" else 2)
    cj, ct = get_config(name).reduced(), get_config_t(name).reduced()
    bj = STJ.build_step(cj, ShapeJ("t", kind, S, B), MJ.make_local_mesh())
    kw = {"device": "cpu"} if kind == "train" else {}
    bt = STT.build_step(ct, ShapeConfig("t", kind, S, B),
                        MT.make_local_mesh("cpu"), **kw)
    specs_j, specs_t = bj.in_specs, bt.in_specs
    if family == "encdec" and kind != "decode":
        src = specs_j[2]["src"].shape
        specs_j = (*specs_j[:2], {**specs_j[2], "src": jax.ShapeDtypeStruct(
            src, jnp.float32)})
        specs_t = (*specs_t[:2], {**specs_t[2], "src": _meta(*src)})
    return bj, specs_j, bt, specs_t


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flops_match_reference_hlo(family, kind):
    bj, specs_j, bt, specs_t = _bundle_specs(family, kind)
    ref = _hlo(bj.fn, *specs_j).flops
    got = GA.analyze_graph(GA.trace_step(bt.step, specs_t, "cpu")).flops
    ratio = got / ref
    if (family, kind) in PINNED:
        assert abs(ratio / PINNED[family, kind] - 1) < 0.01, ratio
    else:
        assert abs(ratio - 1) < 0.02, ratio


# ---------------------------------------------------------------------------
# Hand counts: bytes, vector FLOPs, the liveness walk
# ---------------------------------------------------------------------------

def _small_step(x, w, ms):
    """x (4, 8), w (8, 8), ms two (8,) moments (donated)."""
    y = x @ w                                    # mm
    z = y.t().sum(dim=1)                         # a view, then a reduction
    z.mul_(2.0)                                  # in place
    torch._foreach_add_(ms, [z, z])              # foreach, in place
    return ms, z


def test_hand_counted_costs_and_memory():
    gm = GA.trace_step(_small_step, (_meta(4, 8), _meta(8, 8),
                                     [_meta(8), _meta(8)]), "cpu")
    c = GA.analyze_graph(gm)
    assert c.flops == 2 * 4 * 8 * 8
    # mm (x, w in, y out) + sum (y in, z out) + mul_ (z once) + foreach
    # (the two moments and z twice)
    assert c.bytes == 4 * ((32 + 64 + 32) + (32 + 8) + 8 + (16 + 16))
    # sum's 8 outputs, mul_'s 8 written, the foreach's 16 written
    assert c.vector_flops == 8 + 8 + 16
    assert c.collective_bytes == 0
    mem = GA.peak_live_bytes(gm, donated=(2,))
    # inputs 32 + 64 + 16 floats; outputs the two moments (aliasing the
    # donated input) and z; the one temp is y (its view adds nothing)
    assert mem == GA.Memory(argument=4 * 112, output=4 * 24, temp=4 * 32,
                            alias=4 * 16)
    assert mem.peak == 4 * (112 + 32 + 24 - 16)
    # undonated, the moments' storage is still the input's: no alias
    assert GA.peak_live_bytes(gm).alias == 0


# ---------------------------------------------------------------------------
# The kernels' cost rules
# ---------------------------------------------------------------------------

OPS = torch.ops.repro_torch


def _one_op(fn, *specs):
    gm = GA.trace_step(fn, specs, "cpu")
    model = GA.GraphCostModel(gm)
    return model.analyze(), model.launches


@pytest.mark.parametrize("B,H,KH,D,P,n,per_row",
                         [(2, 4, 4, 16, 16, 4, False),
                          (3, 8, 2, 32, 8, 5, True)])
def test_paged_attention_rule(B, H, KH, D, P, n, per_row):
    page = 64
    c, launches = _one_op(
        lambda q, k, v, t, l, f: OPS.paged_attention(q, k, v, t, l, f, f, 0,
                                                     P - 1, None, 0),
        _meta(B, H, D), _meta(P, page, KH, D, dtype=torch.bfloat16),
        _meta(P, page, KH, D, dtype=torch.bfloat16),
        _meta(B, n, dtype=torch.int32), _meta(B, dtype=torch.int32),
        _meta(B, dtype=torch.int32) if per_row else None)
    assert c.flops == 4 * B * H * D * n * page
    tokens = min(B * n, P) * page
    assert c.bytes == (2 * tokens * KH * D * 2 + 2 * B * H * D * 4
                       + B * n * 4 + (3 if per_row else 1) * B * 4)
    assert launches == {"paged_attention": 1}


@pytest.mark.parametrize("Sq,Skv,causal,window",
                         [(200, 200, True, 0), (130, 70, False, 0),
                          (256, 256, True, 100)])
def test_flash_attention_rule(Sq, Skv, causal, window):
    B, H, KH, D = 2, 4, 2, 16
    c, launches = _one_op(
        lambda q, k, v: OPS.flash_attention(q, k, v, causal, window),
        _meta(B, Sq, H, D, dtype=torch.bfloat16),
        _meta(B, Skv, KH, D, dtype=torch.bfloat16),
        _meta(B, Skv, KH, D, dtype=torch.bfloat16))
    # the key tiles each 64-row query tile visits, counted by hand
    pairs = 0
    for q0 in range(0, Sq, 64):
        rows = min(64, Sq - q0)
        hi = (q0 + rows - 1) // 64 + 1 if causal else -(-Skv // 64)
        lo = max(q0 - window + 1, 0) // 64 if window else 0
        pairs += rows * (min(hi * 64, Skv) - lo * 64)
    assert GA.flash_pairs(Sq, Skv, causal, window) == pairs
    assert c.flops == 4 * B * H * D * pairs
    assert c.bytes == (2 * B * Sq * H + 2 * B * Skv * KH) * D * 2
    assert launches == {"flash_attention": 1}
    if causal and not window:
        assert pairs < Sq * Skv


@pytest.mark.parametrize("V,D,N", [(100, 16, 7), (4096, 64, 33)])
def test_gather_rows_rules(V, D, N):
    c, launches = _one_op(
        lambda t, i: OPS.gather_rows(t, i, None, None, 0, 127),
        _meta(V, D, dtype=torch.bfloat16), _meta(N, dtype=torch.int32))
    assert (c.flops, c.bytes) == (0, 2 * N * D * 2 + N * 4)
    assert launches == {"gather_rows": 1}
    per_id = _meta(N, dtype=torch.int32)
    c, launches = _one_op(
        lambda t, g, i, b: OPS.gather_rows_backward(t, g, i, b, None, 0, 0),
        _meta(V, D), _meta(N, D), _meta(N, dtype=torch.int32), per_id)
    # the gradient table written, the rows scattered read, ids and fence
    assert c.bytes == V * D * 4 + N * D * 4 + N * 4 + N * 4
    assert launches == {}


@pytest.mark.parametrize("B,S,KH,D,src", [(2, 57, 4, 16, F32),
                                          (3, 130, 2, 32, torch.bfloat16)])
def test_scatter_pages_rule(B, S, KH, D, src):
    P, page = 32, 64
    n = -(-S // page)

    def f(kp, vp, k, v, ids, base):
        OPS.scatter_pages(kp, vp, k, v, ids, base, None, 0, 31, None)
        return kp, vp

    c, launches = _one_op(f, _meta(P, page, KH, D), _meta(P, page, KH, D),
                          _meta(B, S, KH, D, dtype=src),
                          _meta(B, S, KH, D, dtype=src),
                          _meta(B, n, dtype=torch.int32),
                          _meta(B, dtype=torch.int32))
    el = torch.empty((), dtype=src).element_size()
    assert c.bytes == (2 * (B * S * KH * D * el + B * n * page * KH * D * 4)
                       + B * n * 4 + B * 4)
    assert launches == {"scatter_pages": 1}


@pytest.mark.parametrize("T,K,E", [(8, 2, 16), (2048, 8, 128)])
def test_moe_histogram_rule(T, K, E):
    c, launches = _one_op(lambda ids: OPS.moe_histogram(ids, E, 0, E - 1),
                          _meta(T, K, dtype=torch.int32))
    assert (c.flops, c.bytes, c.vector_flops) == (0, T * K * 4 + E * 4, E)
    assert launches == {"moe_histogram": 1}


@torch.library.custom_op("repro_torch::cost_rule_probe", mutates_args=())
def _probe(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_probe.register_fake
def _(x):
    return torch.empty_like(x)


def test_unknown_custom_op_raises():
    gm = GA.trace_step(lambda x: OPS.cost_rule_probe(x), (_meta(4),), "cpu")
    with pytest.raises(ValueError, match="cost_rule_probe"):
        GA.analyze_graph(gm)


# ---------------------------------------------------------------------------
# Cut loops, counters, devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,kind", [("ssm", "train"),
                                         ("hybrid", "prefill")])
def test_cut_loops_extrapolate_to_the_unrolled_trace(family, kind,
                                                     monkeypatch):
    """The SSD's and the sLSTM's loops traced at 2 and 3 steps and
    extrapolated count what the unrolled trace counts, FLOP for FLOP and
    byte for byte (their stacks become a ``cat`` with a free pad)."""
    ct = get_config_t(FAMILIES[family]).reduced()
    bt = STT.build_step(ct, ShapeConfig("t", kind, 32, 2),
                        MT.make_local_mesh("cpu"),
                        **({"device": "cpu"} if kind == "train" else {}))
    cut = GA.GraphCostModel(GA.trace_step(bt.step, bt.in_specs, "cpu"))
    assert cut.gm.meta["loops"]
    monkeypatch.setattr(GA, "LOOP_KINDS", ())
    full = GA.GraphCostModel(GA.trace_step(bt.step, bt.in_specs, "cpu"))
    assert not full.gm.meta["loops"]
    a, b = cut.analyze(), full.analyze()
    assert (a.flops, a.vector_flops, a.bytes) == \
        (b.flops, b.vector_flops, b.bytes)
    skip = {"aten.cat.default", "aten.stack.default"}
    assert {k: v for k, v in cut.ops.items() if k not in skip} == \
        {k: v for k, v in full.ops.items() if k not in skip}


def _counts():
    return {k.name: (k.launches, k.plain_calls)
            for k in _build.KERNELS.values()}


@pytest.mark.parametrize("kind", ("train", "decode"))
def test_trace_launches_nothing(kind):
    ct = get_config_t("qwen3-moe-30b-a3b").reduced()
    bt = STT.build_step(ct, ShapeConfig("t", kind, 64, 2),
                        MT.make_local_mesh("cpu"),
                        **({"device": "cpu"} if kind == "train" else {}))
    before = _counts()
    model = GA.GraphCostModel(GA.trace_step(bt.step, bt.in_specs, "cpu"))
    model.analyze()
    assert _counts() == before
    assert model.launches["gather_rows"] == 1
    # a train step's forward and its recompute (remat) each route
    assert model.launches["moe_histogram"] == ct.n_layers * (
        2 if kind == "train" else 1)


def test_cuda_fakes_count_what_cpu_fakes_count():
    """A decode step traced on CUDA fakes (on a build without CUDA, through
    the verifier's aten indexing) gives the CPU fakes' costs, memory and
    op counts."""
    ct = get_config_t("stablelm-3b").reduced()
    bt = STT.build_step(ct, ShapeConfig("t", "decode", 64, 4),
                        MT.make_local_mesh("cpu"))
    out = {}
    for dev in ("cuda", "cpu"):
        gm = GA.trace_step(bt.step, bt.in_specs, dev)
        model = GA.GraphCostModel(gm)
        out[dev] = (dataclasses.astuple(model.analyze()), model.ops,
                    GA.peak_live_bytes(gm, bt.donate_argnums))
    assert out["cuda"] == out["cpu"]


def test_cuda_backward_without_cuda_raises_before_the_engine():
    """A train step on CUDA fakes, on a build of torch without CUDA, stops
    with a RuntimeError where its backward starts (the autograd engine
    would end the process) and is not traced on the CPU instead."""
    if torch.backends.cuda.is_built():
        pytest.skip("this build of torch has CUDA: the step traces")
    ct = get_config_t("stablelm-3b").reduced()
    bt = STT.build_step(ct, ShapeConfig("t", "train", 32, 2),
                        MT.make_local_mesh("cpu"), device="cpu")
    with pytest.raises(RuntimeError, match="backward pass cannot be traced"):
        GA.trace_step(bt.step, bt.in_specs, "cuda")
    with pytest.raises(RuntimeError, match="backward pass cannot be traced"):
        GA.refuse_cuda_backward("cuda")
    GA.refuse_cuda_backward("cpu")
    assert np.isfinite(GA.analyze_graph(
        GA.trace_step(bt.step, bt.in_specs, "cpu")).flops)

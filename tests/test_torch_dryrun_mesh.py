"""The port's dry run on a production-like mesh — the step bundles
partitioned by DTensor over a ``fake`` process group, rank 0's program
traced (``StepBundle.partitioned``, ``launch/graph_analysis.py``) —
against the reference's partitioned HLO (``jax.jit(fn, in_shardings=,
out_shardings=)`` on a (data=2, model=4) mesh of 8 host devices, read by
``analyze_hlo``):

* a hand-built two-layer tensor-parallel MLP on (2, 2): collective bytes
  and counts by kind equal the reference's exactly;
* every family x train / prefill / decode bundle on a reduced config
  (``test_torch_graph_analysis._bundle_specs``' shapes) on (2, 4):
  per-device FLOPs within 2 % of the reference's and the dense rows'
  collective bytes within 25 %, the rows that miss either bound held at
  their measured ratio and listed as open (``FLOPS_UNMET``,
  ``DENSE_COLL_UNMET``); the other rows' collective bytes and every
  row's temp bytes (XLA's ``memory_analysis``) pinned (PERF.md §6
  explains each);
* a cut loop's collectives extrapolate to the unrolled trace's;
* the process group is torn down after a trace, also one that raises, and
  none is open after a serve, train or one-card dry-run step;
* a custom op without a sharding rule raises with its name;
* heads the model axis does not divide are padded, each rank running its
  share.

The reference's rows come from one subprocess (its device count is fixed
at JAX's first use), started with the module (an autouse fixture) and
read by each case once the port's side of it is traced; the tests that
need none of it run first.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import ShapeConfig, \
    get_config as get_config_t  # noqa: E402
from repro_torch.distributed import partition as PT  # noqa: E402
from repro_torch.launch import dryrun as DR, graph_analysis as GA, \
    mesh as MT, steps as STT  # noqa: E402
from test_torch_graph_analysis import FAMILIES, PINNED  # noqa: E402

#: the reference's side: every family x kind bundle on (data=2, model=4)
#: and the tensor-parallel MLP on (2, 2); one JSON object on stdout
REFERENCE = r"""
import json, os
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ShapeConfig, get_config
from repro.launch import steps as ST
from repro.launch.hlo_analysis import analyze_hlo

FAMILIES = json.loads(os.environ["FAMILIES"])
out = {}

def row(compiled):
    c = analyze_hlo(compiled.as_text())
    return {"flops": c.flops,
            "temp": compiled.memory_analysis().temp_size_in_bytes,
            "coll": {k: v for k, v in c.collectives.items() if v},
            "counts": {k: v for k, v in c.collective_counts.items() if v}}

mesh = jax.make_mesh((2, 4), ("data", "model"))
for fam, name in FAMILIES.items():
    for kind in ("train", "prefill", "decode"):
        S, B = (256 if fam == "vlm" else 64), (4 if kind == "decode" else 2)
        b = ST.build_step(get_config(name).reduced(),
                          ShapeConfig("t", kind, S, B), mesh)
        specs = b.in_specs
        if fam == "encdec" and kind != "decode":
            src = specs[2]["src"].shape
            specs = (*specs[:2], {**specs[2], "src": jax.ShapeDtypeStruct(
                src, jnp.float32)})
        jitted = jax.jit(b.fn, in_shardings=b.in_shardings,
                         out_shardings=b.out_shardings,
                         donate_argnums=b.donate_argnums)
        with mesh:
            out[f"{fam}/{kind}"] = row(jitted.lower(*specs).compile())

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
S = lambda *s: NamedSharding(mesh, P(*s))
sd = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
mlp = jax.jit(lambda x, w1, w2: jax.nn.relu(x @ w1) @ w2,
              in_shardings=(S("data", None), S(None, "model"),
                            S("model", None)),
              out_shardings=S("data", None))
out["mlp"] = row(mlp.lower(sd(8, 16), sd(16, 32), sd(32, 16)).compile())
print(json.dumps(out))
"""


class _Reference:
    """The reference's subprocess, read once on first use."""

    def __init__(self):
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        env = {**os.environ, "PYTHONPATH": os.path.abspath(src),
               "JAX_PLATFORMS": "cpu", "FAMILIES": json.dumps(FAMILIES),
               "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
        self.proc = subprocess.Popen([sys.executable, "-c", REFERENCE],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=env)
        self.rows = None

    def __getitem__(self, key):
        if self.rows is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-3000:]
            self.rows = json.loads(out.strip().splitlines()[-1])
        return self.rows[key]


@pytest.fixture(scope="module", autouse=True)
def reference():
    ref = _Reference()
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.communicate()


def _costs(gm):
    c = GA.GraphCostModel(gm).analyze()
    return {"flops": c.flops,
            "coll": {k: v for k, v in c.collectives.items() if v},
            "counts": {k: v for k, v in c.collective_counts.items() if v}}


# ---------------------------------------------------------------------------
# Every family's bundles on (2, 4)
# ---------------------------------------------------------------------------

#: The acceptance bounds: per-device FLOPs within 2 % of the reference's
#: (the rows of ``PINNED`` in test_torch_graph_analysis.py, whose global
#: FLOPs differ by design, within 1 % of that pin), and total collective
#: bytes within 25 % on the dense rows.
FLOPS_TOL, DENSE_COLL_TOL = 0.02, 0.25

#: Rows that miss the FLOPs bound: (family, kind) -> the port's measured
#: per-device FLOPs over the reference's.  NOT the reference's answer: an
#: open gap, held here so that a change to it shows (PERF.md §6 gives each
#: cause).  Below 1 the reference's partitioner runs work on more ranks
#: than the port does: the train step's attention on the whole batch on
#: every data rank (dense, MoE, vision), the xLSTM decode's projections
#: whole.  Above 1 the port does: the hybrid's SSD scan runs its two heads
#: on every model rank (the reference pads them to one a rank), the
#: xLSTM train runs the sLSTM's input projection whole on the model axis.
FLOPS_UNMET = {("dense", "train"): 0.883, ("moe", "train"): 0.891,
               ("vlm", "train"): 0.921, ("hybrid", "prefill"): 1.118,
               ("ssm", "train"): 1.320, ("ssm", "decode"): 0.832}

#: Dense rows that miss the collectives bound, measured as above: the
#: decode's K1 gathers the bf16 pool where the reference gathers it
#: widened to f32; the train step gathers weights and reduce-scatters
#: their gradients where the reference moves activations (all-to-all,
#: then an all-reduce of each product's partial sums over the data axis).
DENSE_COLL_UNMET = {("dense", "train"): 0.641, ("dense", "decode"): 0.561}

#: Every other row's total collective bytes over the reference's,
#: measured and pinned (PERF.md §6): the reference reshards with
#: all-to-alls and collective-permutes the port does not make, and the
#: port reduce-scatters FSDP gradients the reference all-reduces.
COLL_PINNED = {
    ("moe", "train"): 1.605, ("moe", "prefill"): 0.947,
    ("moe", "decode"): 0.625,
    ("hybrid", "train"): 0.507, ("hybrid", "prefill"): 0.835,
    ("hybrid", "decode"): 1.262,
    ("ssm", "train"): 1.264, ("ssm", "prefill"): 1.071,
    ("ssm", "decode"): 1.442,
    ("vlm", "train"): 1.121, ("vlm", "prefill"): 0.775,
    ("vlm", "decode"): 0.895,
    ("encdec", "train"): 0.924, ("encdec", "prefill"): 1.174,
    ("encdec", "decode"): 0.505,
}

#: Per-device temp bytes, the liveness walk over rank 0's graph over XLA's
#: ``memory_analysis().temp_size_in_bytes`` of the same partitioned step,
#: measured and pinned: the walk counts each op's result as live from the
#: op to its last reader, XLA its buffer assignment after fusion (no
#: buffer for a fused intermediate, one shared buffer for a loop's
#: carries, and its own copies and collective buffers).
TEMP_PINNED = {
    ("dense", "train"): 0.759, ("dense", "prefill"): 0.462,
    ("dense", "decode"): 0.321,
    ("moe", "train"): 1.402, ("moe", "prefill"): 1.537,
    ("moe", "decode"): 0.306,
    ("hybrid", "train"): 0.888, ("hybrid", "prefill"): 1.176,
    ("hybrid", "decode"): 0.682,
    ("ssm", "train"): 0.927, ("ssm", "prefill"): 1.068,
    ("ssm", "decode"): 3.519,
    ("vlm", "train"): 0.764, ("vlm", "prefill"): 0.305,
    ("vlm", "decode"): 0.680,
    ("encdec", "train"): 0.772, ("encdec", "prefill"): 0.089,
    ("encdec", "decode"): 0.316,
}

MESH_24 = MT.Mesh(("data", "model"), {"data": 2, "model": 4})


def _bundle(family, kind):
    """The port's bundle of ``_bundle_specs``' shapes on the (2, 4) mesh
    (the encoder-decoder's frames in float32, as there)."""
    S, B = (256 if family == "vlm" else 64), (4 if kind == "decode" else 2)
    ct = get_config_t(FAMILIES[family]).reduced()
    bt = STT.build_step(ct, ShapeConfig("t", kind, S, B), MESH_24,
                        **({"device": "cpu"} if kind == "train" else {}))
    if family == "encdec" and kind != "decode":
        src = bt.in_specs[2]["src"].shape
        bt.in_specs = (*bt.in_specs[:2], {
            **bt.in_specs[2], "src": torch.empty(src, device="meta")})
    return bt


def _partitioned_trace(bundle, mesh=MESH_24):
    with mesh.open("cpu") as dm:
        fn, specs = bundle.partitioned(dm)
        return GA.trace_step(fn, specs, "cpu")


@functools.lru_cache(maxsize=None)
def _row(family, kind):
    """A family x kind bundle and its partitioned trace, traced once for
    the cases that read it."""
    bt = _bundle(family, kind)
    return bt, _partitioned_trace(bt)


def test_partitioned_temp_is_per_device():
    """The liveness walk over the partitioned graph: rank 0's temporaries,
    fewer than the whole program's, and the argument bytes its shards'."""
    bt, gm = _row("dense", "prefill")
    part = GA.peak_live_bytes(gm, bt.donate_argnums)
    whole = GA.peak_live_bytes(GA.trace_step(bt.step, bt.in_specs, "cpu"),
                               bt.donate_argnums)
    assert 0 < part.temp < whole.temp
    assert part.argument < whole.argument


def test_cut_loops_extrapolate_collectives(monkeypatch):
    """The SSD's chunk loop, cut to 2 and 3 steps and extrapolated, counts
    the collectives of the unrolled partitioned trace, kind for kind."""
    bt, gm = _row("ssm", "prefill")
    cut = GA.GraphCostModel(gm)
    assert cut.gm.meta["loops"]
    monkeypatch.setattr(GA, "LOOP_KINDS", ())
    full = GA.GraphCostModel(_partitioned_trace(bt))
    a, b = cut.analyze(), full.analyze()
    assert (a.collectives, a.collective_counts, a.flops) == \
        (b.collectives, b.collective_counts, b.flops)
    assert a.collective_bytes > 0


# ---------------------------------------------------------------------------
# The process group's life, the rules
# ---------------------------------------------------------------------------

def test_group_torn_down_after_a_trace_that_raises():
    def broken(x):
        raise RuntimeError("broken step")

    with pytest.raises(RuntimeError, match="broken step"):
        with MESH_24.open("cpu") as dm:
            assert dist.is_initialized() and dm.size() == 8
            fn = PT.partitioned(broken, dm, (("data",),), ("data",),
                                (torch.empty(4, device="meta"),))
            GA.trace_step(fn, (torch.empty(2, device="meta"),), "cpu")
    assert not dist.is_initialized()
    with MESH_24.open("cpu"):
        with pytest.raises(RuntimeError, match="already open"):
            with MESH_24.open("cpu"):
                pass
    assert not dist.is_initialized()


@torch.library.custom_op("repro_torch::sharding_rule_probe", mutates_args=())
def _probe(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_probe.register_fake
def _(x):
    return torch.empty_like(x)


def test_custom_op_without_rule_raises_with_its_name():
    spec = (torch.empty(8, 4, device="meta"),)
    with MESH_24.open("cpu") as dm:
        fn = PT.partitioned(lambda x: torch.ops.repro_torch.
                            sharding_rule_probe(x), dm, (("data", None),),
                            ("data", None), spec)
        with pytest.raises(NotImplementedError,
                           match="sharding_rule_probe"):
            GA.trace_step(fn, PT.local_specs(dm, (("data", None),), spec),
                          "cpu")
    assert not dist.is_initialized()


def test_uneven_heads_are_padded_not_run_whole():
    """6 query heads over 2 KV heads, split over a model axis of 4: K4
    takes q padded to 8 heads, 2 a rank, and on each rank the KV heads of
    its own query heads (rank 0: KV head 0 twice), as GSPMD pads; its
    result is q's 6 heads again.  No rank runs every head."""
    from repro_torch.kernels import flash_attention

    spec = tuple(torch.empty(2, 16, h, 8, dtype=torch.bfloat16,
                             device="meta") for h in (6, 2, 2))
    heads = (("data", None, "model", None),) * 3
    with MESH_24.open("cpu") as dm:
        fn = PT.partitioned(lambda q, k, v: flash_attention(q, k, v), dm,
                            heads, ("data", None, None, None), spec)
        gm = GA.trace_step(fn, PT.local_specs(dm, heads, spec), "cpu")
    call, = [n for n in gm.graph.nodes
             if str(n.target) == "repro_torch.flash_attention.default"]
    q, k, v = (GA._value(gm, a) for a in call.args[:3])
    assert tuple(q.shape) == tuple(k.shape) == tuple(v.shape) == \
        (1, 16, 2, 8)
    out, = GA.output_leaves(gm)
    assert tuple(out.shape) == (1, 16, 6, 8)
    assert not dist.is_initialized()


def test_every_kernel_op_of_the_bundles_has_a_rule():
    """K1, K3 (and its backward), K4 and K5 carry a rule; K2 (the global
    pool's write, no bundle's) has none."""
    from repro_torch.kernels._build import SHARDING_RULES
    ops = {op.name() for op, _ in SHARDING_RULES}
    assert ops == {f"repro_torch::{k}" for k in (
        "paged_attention", "flash_attention", "gather_rows",
        "gather_rows_backward", "moe_histogram")}


def test_no_group_after_serve_train_or_local_dry_run():
    """One-card paths open no process group: a one-card dry run, a
    decode step and a train step of the reduced dense model."""
    DR.run_cell("stablelm-3b", shape=ShapeConfig("d", "decode", 128, 2),
                device="cpu", local=True, out_dir=None)
    assert not dist.is_initialized()
    ct = get_config_t("stablelm-3b").reduced()
    local = MT.make_local_mesh("cpu")
    for kind in ("decode", "train"):
        bt = STT.build_step(ct, ShapeConfig("t", kind, 32, 2), local,
                            **({"device": "cpu"} if kind == "train" else {}))
        args = _materialize(bt.in_specs)
        bt.fn(*args)
        assert not dist.is_initialized()


def _materialize(specs):
    """Zero tensors of ``specs``' shapes on the CPU (ids and lengths 0)."""
    from repro_torch.core.stepgraph import tree_flatten, tree_unflatten
    out = []
    for tree in specs:
        struct, leaves = tree_flatten(tree)
        out.append(tree_unflatten(struct, [
            torch.zeros(t.shape, dtype=t.dtype) if isinstance(
                t, torch.Tensor) else t for t in leaves]))
    return tuple(out)


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_partitioned_bundle_against_reference(family, kind, reference):
    bt, gm = _row(family, kind)
    got, ref = _costs(gm), reference[f"{family}/{kind}"]
    row = family, kind
    flops = got["flops"] / ref["flops"]
    if row in FLOPS_UNMET:
        assert abs(flops / FLOPS_UNMET[row] - 1) < 0.01, flops
    elif row in PINNED:
        assert abs(flops / PINNED[row] - 1) < 0.01, flops
    else:
        assert abs(flops - 1) < FLOPS_TOL, flops
    coll = sum(got["coll"].values()) / sum(ref["coll"].values())
    if row in DENSE_COLL_UNMET:
        assert abs(coll / DENSE_COLL_UNMET[row] - 1) < 0.01, (coll, got, ref)
    elif family == "dense":
        assert abs(coll - 1) < DENSE_COLL_TOL, (coll, got, ref)
    else:
        assert abs(coll / COLL_PINNED[row] - 1) < 0.01, (coll, got, ref)
    assert set(got["coll"]) <= set(GA._COLLECTIVES)
    temp = GA.peak_live_bytes(gm, bt.donate_argnums).temp / ref["temp"]
    assert abs(temp / TEMP_PINNED[row] - 1) < 0.01, temp
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# A hand-built tensor-parallel MLP: exact
# ---------------------------------------------------------------------------

def test_tensor_parallel_mlp_collectives_equal_reference(reference):
    """x (8, 16) by batch over data, w1 (16, 32) column-parallel and w2
    (32, 16) row-parallel over model, the result by batch: one all-reduce
    of each rank's (4, 16) partial sums, on both sides."""
    from repro_torch.distributed.partition import matmul

    mesh = MT.Mesh(("data", "model"), {"data": 2, "model": 2})
    specs = tuple(torch.empty(s, device="meta")
                  for s in ((8, 16), (16, 32), (32, 16)))
    with mesh.open("cpu") as dm:
        fn = PT.partitioned(
            lambda x, w1, w2: matmul(torch.relu(matmul(x, w1)), w2), dm,
            (("data", None), (None, "model"), ("model", None)),
            ("data", None), specs)
        gm = GA.trace_step(fn, PT.local_specs(
            dm, (("data", None), (None, "model"), ("model", None)), specs),
            "cpu")
    got, ref = _costs(gm), reference["mlp"]
    assert (got["coll"], got["counts"]) == (ref["coll"], ref["counts"])
    assert got["coll"] == {"all-reduce": 4 * 16 * 4}
    assert got["flops"] == ref["flops"]
    assert not dist.is_initialized()

"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's (``repro/launch/dryrun.py``):

* the CLI runs standalone on CPU fakes and writes every key of the
  reference's result;
* ``model_flops`` and ``params`` equal the reference's for every arch,
  and ``--all`` enumerates the reference's 32 cells;
* on both production meshes, one cell per family, partitioned (rank 0's
  program over a fake process group): argument and output bytes per
  device equal those reckoned from the reference's own placements (an
  abstract mesh, ``eval_shape``; nothing compiled), and alias bytes too,
  less the donated leaves the port hands back as new tensors (the
  per-row lengths, the optimizer's step counter); temp bytes from the
  liveness walk over the device's graph;
* the one-card mesh: the argument bytes of the specs, no collectives;
* a train step on CUDA fakes without a CUDA build raises before anything
  is traced, and is not traced on the CPU instead.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES, get_config, list_archs, \
    shape_applicable  # noqa: E402
from repro.launch import steps as STJ  # noqa: E402
from repro_torch.configs import SHAPES as SHAPES_T, ShapeConfig, \
    get_config as get_config_t  # noqa: E402
from repro_torch.core.stepgraph import tree_flatten  # noqa: E402
from repro_torch.launch import dryrun as DR, graph_analysis as GA, \
    mesh as MT, steps as STT  # noqa: E402

#: the keys of the reference's result (``repro/launch/dryrun.py``'s
#: ``run_cell``), block by block
REFERENCE_KEYS = {
    None: {"arch", "shape", "mesh", "chips", "guard", "policy", "lower_s",
           "compile_s", "memory", "cost", "collectives", "roofline",
           "params"},
    "memory": {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_live_bytes_per_device"},
    "cost": {"flops_per_device", "vector_flops_per_device",
             "bytes_per_device", "xla_flops_scan_body_once",
             "xla_bytes_scan_body_once"},
    "roofline": {"compute_s", "memory_s", "collective_s", "bottleneck",
                 "model_flops", "hlo_total_flops", "useful_ratio",
                 "roofline_fraction_mfu"},
    "params": {"total", "active"},
}


def test_cli_runs_standalone_and_writes_the_reference_keys(tmp_path):
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "decode_32k", "--device", "cpu",
         "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.abspath(src)})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout
    res = json.loads((tmp_path / "16x16" / "xlstm-350m__decode_32k.json")
                     .read_text())
    assert REFERENCE_KEYS[None] <= set(res)
    for block, keys in REFERENCE_KEYS.items():
        if block is not None:
            assert keys <= set(res[block]), block
    # the partitioned trace fills the collectives and the temp bytes
    assert res["compile_s"] is None
    assert res["collectives"]["total"] > 0
    assert res["collectives"]["total"] == sum(
        res["collectives"]["per_kind"].values())
    assert res["memory"]["temp_bytes"] > 0
    assert res["memory"]["peak_live_bytes_per_device"] == (
        res["memory"]["argument_bytes"] + res["memory"]["temp_bytes"]
        + res["memory"]["output_bytes"] - res["memory"]["alias_bytes"])
    assert res["roofline"]["collective_s"] == \
        res["collectives"]["total"] / DR.NVLINK_BW
    assert res["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert res["method"]["per_device"].startswith(
        "partitioned trace (DTensor over a fake group of 256 ranks)")
    assert res["device"] == {"fakes": "cpu", "card": "traced on CPU fakes"}
    assert res["chips"] == 256 and res["trace"]["launches"] == {
        "gather_rows": 1}
    assert res["cost"]["flops_per_device"] * 256 == \
        res["roofline"]["hlo_total_flops"]


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_and_params_equal_reference(arch):
    """The reference's ``run_cell`` reckons MODEL_FLOPS inline (6·N·T to
    train, 2·N·T to prefill, 2·N·B to decode, N the active params)."""
    cj, ct = get_config(arch), get_config_t(arch)
    assert (ct.param_count(), ct.active_param_count()) == \
        (cj.param_count(), cj.active_param_count())
    for name, shape in SHAPES.items():
        tokens = shape.global_batch * (1 if shape.kind == "decode"
                                       else shape.seq_len)
        want = (6 if shape.kind == "train" else 2) * \
            cj.active_param_count() * tokens
        assert DR.model_flops(ct, SHAPES_T[name]) == want


def test_all_enumerates_the_reference_cells():
    want = [(arch, name) for arch in list_archs() for name in SHAPES
            if shape_applicable(get_config(arch), SHAPES[name])[0]]
    assert DR.cells() == want and len(want) == 32


#: one cell per family (depth cut; the hybrid to one attention group)
CELLS = [("stablelm-3b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
         ("zamba2-7b", "prefill_32k"), ("xlstm-350m", "decode_32k"),
         ("qwen2-vl-2b", "train_4k"),
         ("seamless-m4t-medium", "prefill_32k")]
#: donated leaves the port's steps hand back as new tensors
FRESH = {"seq_lens", "src_lens", "step"}


def _depth(cfg):
    n = max(2, cfg.attn_every) if cfg.family == "hybrid" else 2
    return dataclasses.replace(cfg, n_layers=n)


def _ref_bytes(mesh, shardings, tree):
    """Per-device bytes of each leaf of ``tree`` under its NamedSharding,
    with the leaf's path."""
    out = []
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for (path, x), s in zip(flat, jax.tree.leaves(shardings)):
        shards = 1
        for a in s.spec:
            for name in () if a is None else (a if isinstance(a, tuple)
                                              else (a,)):
                shards *= mesh.shape[name]
        key = path[-1] if path else ""
        out.append((str(getattr(key, "name", getattr(key, "key", key))),
                    int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                    // shards))
    return out


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_production_memory_equals_reference_placements(arch, shape_name):
    shape = SHAPES[shape_name]
    kw = {} if shape.kind == "train" else {"kv_dtype": "bf16"}
    cj, ct = _depth(get_config(arch)), _depth(get_config_t(arch))
    for multi, dims, names in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data",
                                                    "model"))):
        am = AbstractMesh(dims, names)
        bj = STJ.build_step(cj, shape, am, moe_dispatch="einsum", **kw)
        args = sum(b for i in range(3) for _, b in _ref_bytes(
            am, bj.in_shardings[i], bj.in_specs[i]))
        outs = jax.eval_shape(bj.fn, *bj.in_specs)
        out = _ref_bytes(am, bj.out_shardings, outs)
        # the donated inputs' places among the results: the cache (serve),
        # params and moments (train)
        n_don = sum(len(jax.tree.leaves(outs[i]))
                    for i in range(2 if shape.kind == "train" else 1))
        alias = sum(b for _, b in out[:n_don])
        fresh = sum(b for k, b in out[:n_don] if k in FRESH)

        mesh = MT.make_production_mesh(multi_pod=multi)
        bt = STT.build_step(ct, SHAPES_T[shape_name], mesh,
                            moe_dispatch="einsum", **kw)
        with mesh.open("cpu") as device_mesh:
            fn, specs = bt.partitioned(device_mesh)
            gm = GA.trace_step(fn, specs, "cpu")
        got = DR._memory(bt, gm, mesh, local=False)
        assert got["argument_bytes"] == args
        assert got["output_bytes"] == sum(b for _, b in out)
        assert fresh > 0 and got["alias_bytes"] == alias - fresh
        assert got["temp_bytes"] == GA.peak_live_bytes(
            gm, bt.donate_argnums).temp > 0


def test_local_mesh_memory_and_collectives():
    """The one-card mesh: argument bytes are the specs' own, the liveness
    walk gives the rest, collectives are zeros (a cut decode shape)."""
    shape = ShapeConfig("decode_cut", "decode", 256, 2)
    res = DR.run_cell("stablelm-3b", shape=shape, device="cpu", local=True,
                      out_dir=None)
    bundle = STT.build_step(get_config_t("stablelm-3b"), shape,
                            MT.make_local_mesh("cpu"))
    specs = sum(t.numel() * t.element_size()
                for t in tree_flatten(bundle.in_specs)[1])
    mem = res["memory"]
    assert mem["argument_bytes"] == specs
    # every cache leaf but the lengths, which the step hands back anew
    cache = dataclasses.asdict(bundle.in_specs[1])
    assert mem["alias_bytes"] == sum(
        t.numel() * t.element_size() for k, t in cache.items()
        if isinstance(t, torch.Tensor) and k != "seq_lens")
    assert mem["peak_live_bytes_per_device"] == mem["argument_bytes"] + \
        mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
    assert res["collectives"] == {"per_kind": {}, "counts": {}, "total": 0}
    assert res["roofline"]["collective_s"] == 0.0
    assert res["mesh"] == "1x1" and res["chips"] == 1
    assert res["trace"]["launches"] == {
        "gather_rows": 1, "paged_attention": 32}


def test_cuda_train_refused_before_tracing(monkeypatch):
    if torch.backends.cuda.is_built():
        pytest.skip("this build of torch has CUDA: the step traces")

    def traced(*a, **k):
        raise AssertionError("traced")

    monkeypatch.setattr(GA, "trace_step", traced)
    with pytest.raises(RuntimeError, match="backward pass cannot be traced"):
        DR.run_cell("stablelm-3b", "train_4k", device="cuda", out_dir=None)

"""One-card dry run: every (arch x shape) step traced and reckoned — its
memory, cost, roofline terms, model FLOPs and useful-compute ratio — the
port's counterpart of ``repro/launch/dryrun.py``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \
        --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \
        --shape decode_32k --local            # the card's 1 x 1 mesh
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

The reference lowers and compiles each step on the 256- or 512-chip mesh,
where XLA's SPMD partitioner splits it into one program per device, and
reads XLA's memory analysis and the partitioned HLO.  The port compiles
nothing ahead of time; it traces the bundle's step into an aten graph on
fake tensors of ``--device`` (:func:`repro_torch.launch.graph_analysis.
trace_step`: nothing is allocated and no kernel is launched; ``cuda`` by
default, the CPU only when asked).  On a production mesh the step is
partitioned first, by PyTorch's SPMD partitioner: the mesh opens a
``DeviceMesh`` over a ``fake`` process group of ``mesh.size`` ranks
(:meth:`repro_torch.launch.mesh.Mesh.open`), the step runs on DTensors
placed by the bundle's shardings and its results are redistributed to
its output shardings (:meth:`repro_torch.launch.steps.StepBundle.
partitioned`), and the trace is rank 0's program: local shapes, with the
collectives the partition needs as ``_c10d_functional`` nodes.  From the
trace it reckons:

* ``cost`` — FLOPs, vector FLOPs and bytes of one device's program
  (:func:`~repro_torch.launch.graph_analysis.analyze_graph`);
* ``memory`` — argument, output and alias bytes per device from the
  placements (each leaf's bytes over its placement's mesh-axis sizes;
  on the one-card mesh the specs' own), temp bytes from a liveness walk
  over the device's graph (:func:`~repro_torch.launch.graph_analysis.
  peak_live_bytes`), and the peak as the reference sums it;
* ``collectives`` — operand bytes and counts of the device's collectives
  by the reference's kind names, zeros on one card;
* ``roofline`` — compute, memory and collective terms against the NVIDIA
  H100 SXM data sheet (:data:`CONSTANTS`), the bottleneck,
  ``model_flops`` (6·N·T to train, 2·N·T to serve), ``useful_ratio`` and
  the MFU bound, as the reference reckons them.

Each cell writes ``results/dryrun_torch/<mesh>/<arch>__<shape>[__tag].json``
with the reference's keys; the ``method`` block says how each block was
reckoned.  ``lower_s`` is the trace's seconds; ``compile_s`` is ``null``
(nothing is compiled ahead of time: a serve step's CUDA graph is captured
at its first call, :mod:`repro_torch.core.stepgraph`, and the train CLI
captures one CUDA graph per batch shape at its first step,
:func:`repro_torch.launch.steps.compile_train_step`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any, Optional

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s, HBM3 bytes/s,
# NVLink 4 bytes/s a GPU (900 GB/s, both directions together)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 900e9

#: what the roofline's constants are
CONSTANTS = ("NVIDIA H100 SXM data sheet: 989e12 dense bf16 FLOP/s, "
             "3.35e12 B/s of HBM3, 900e9 B/s of NVLink 4 a GPU (the "
             "data sheet's total of both directions); the collective term "
             "is a floor: a 16 x 16 mesh of H100s spans 32 eight-GPU "
             "nodes, whose traffic between nodes runs far slower than "
             "NVLink")


def mesh_tag(multi_pod: bool, local: bool) -> str:
    return "1x1" if local else "2x16x16" if multi_pod else "16x16"


def model_flops(cfg, shape) -> int:
    """The reference's MODEL_FLOPS: 6·N_active·T to train, 2·N_active·T to
    prefill, 2·N_active·B to decode."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * n_active * shape.global_batch * shape.seq_len
    return 2 * n_active * shape.global_batch


def placed_bytes(mesh, placements, tree) -> list:
    """Each tensor leaf's bytes per device under its placement (per dim a
    mesh axis, a tuple of them or None: the leaf split over the product of
    the named axes' sizes), in :func:`~repro_torch.core.stepgraph.
    tree_flatten` order of ``tree`` (0 for a leaf that is not a
    tensor)."""
    import torch
    from repro_torch.core.stepgraph import tree_flatten
    from repro_torch.distributed.partition import is_spec
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.steps import _axis_size

    def one(axes, t):
        if not isinstance(t, torch.Tensor):
            return 0
        shards = 1
        for a in axes:
            shards *= _axis_size(mesh, a)
        return t.numel() * t.element_size() // shards

    per = tree_map(one, placements, tree, is_leaf=is_spec)
    return [0 if v is None else v for v in tree_flatten(per)[1]]


def card_line() -> Optional[str]:
    """``nvidia-smi``'s ``name, power.limit`` of the card, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _memory(bundle, gm, mesh, local: bool) -> dict:
    """The reference's ``memory_analysis()`` block per device: on the
    one-card mesh all of it from the liveness walk over the graph; on a
    production mesh argument, output and alias bytes from the placements
    and temp bytes from the liveness walk over the device's partitioned
    graph (``gm``)."""
    from repro_torch.launch import graph_analysis as GA

    mem = GA.peak_live_bytes(gm, bundle.donate_argnums)
    if local:
        return {"argument_bytes": mem.argument, "output_bytes": mem.output,
                "temp_bytes": mem.temp, "alias_bytes": mem.alias,
                "peak_live_bytes_per_device": mem.peak}
    args = sum(b for i, spec in enumerate(bundle.in_specs)
               for b in placed_bytes(mesh, bundle.in_shardings[i], spec))
    # the results, rebuilt from the trace (the device's shards), and which
    # alias a donated input
    outs = GA.output_leaves(gm)
    per_out = [t.numel() * t.element_size() for t in outs]
    aliased = GA.aliased_outputs(gm, bundle.donate_argnums)
    alias = sum(b for k, b in enumerate(per_out) if k in aliased)
    out = sum(per_out)
    return {"argument_bytes": args, "output_bytes": out,
            "temp_bytes": mem.temp, "alias_bytes": alias,
            "peak_live_bytes_per_device": args + mem.temp + out - alias}


@dataclasses.dataclass
class Cell:
    """One traced cell: its config, shape, mesh and bundle, the traced
    graph (:func:`~repro_torch.launch.graph_analysis.trace_step`; on a
    production mesh rank 0's partitioned program), the trace's seconds
    and the fakes' device."""

    arch: str
    cfg: Any
    shape: Any
    mesh: Any
    local: bool
    multi_pod: bool
    bundle: Any
    gm: Any
    lower_s: float
    device: str
    guard: bool
    policy: str


def build_cell(arch: str, shape_name: Optional[str] = None,
               multi_pod: bool = False, guard_enabled: bool = True,
               policy_name: str = "bitwise", moe_dispatch: str = "einsum",
               remat_policy: str = "nothing", kv_dtype: str = "bf16",
               device: str = "cuda", local: bool = False, shape=None):
    """``arch``'s config, the shape, its mesh and its step bundle, as
    :func:`trace_cell` traces them; None where the shape does not apply.
    A train step on CUDA fakes without a CUDA build of torch raises
    here."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.core.fence import FencePolicy
    from repro_torch.launch import graph_analysis as GA
    from repro_torch.launch.mesh import make_local_mesh, \
        make_production_mesh
    from repro_torch.launch.steps import build_step

    cfg = get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        print(f"SKIP {arch} x {shape.name}: {why}")
        return None
    if shape.kind == "train":
        GA.refuse_cuda_backward(device)
    mesh = make_local_mesh(device) if local \
        else make_production_mesh(multi_pod=multi_pod)
    kw = {} if shape.kind == "train" else {"kv_dtype": kv_dtype}
    bundle = build_step(cfg, shape, mesh, guard_enabled=guard_enabled,
                        policy=FencePolicy(policy_name),
                        moe_dispatch=moe_dispatch,
                        remat_policy=remat_policy, **kw)
    return cfg, shape, mesh, bundle


def trace_cell(arch: str, shape_name: Optional[str] = None,
               multi_pod: bool = False, guard_enabled: bool = True,
               policy_name: str = "bitwise", moe_dispatch: str = "einsum",
               remat_policy: str = "nothing", kv_dtype: str = "bf16",
               device: str = "cuda", local: bool = False,
               shape=None) -> Optional[Cell]:
    """Build ``arch``'s bundle for the shape on its mesh
    (:func:`build_cell`) and trace its step on fakes of ``device``; on a
    production mesh as rank 0 of the partitioned step, over a fake process
    group opened for the trace and destroyed after it, also when it raises
    (:meth:`~repro_torch.launch.mesh.Mesh.open`).  None where the shape
    does not apply."""
    from repro_torch.launch import graph_analysis as GA

    built = build_cell(arch, shape_name, multi_pod, guard_enabled,
                       policy_name, moe_dispatch, remat_policy, kv_dtype,
                       device, local, shape)
    if built is None:
        return None
    cfg, shape, mesh, bundle = built
    t0 = time.time()
    if local:
        gm = GA.trace_step(bundle.step, bundle.in_specs, device)
    else:
        with mesh.open(device) as device_mesh:
            fn, specs = bundle.partitioned(device_mesh)
            gm = GA.trace_step(fn, specs, device)
    return Cell(arch, cfg, shape, mesh, local, multi_pod, bundle, gm,
                time.time() - t0, device, guard_enabled, policy_name)


def reckon(cell: Cell) -> dict:
    """The reference's result for a traced cell (its keys; every value of
    one device's program) and the port's ``device``, ``method`` and
    ``trace`` blocks."""
    from repro_torch.launch import graph_analysis as GA

    chips = cell.mesh.size
    model = GA.GraphCostModel(cell.gm)
    costs = model.analyze()
    memory = _memory(cell.bundle, cell.gm, cell.mesh, cell.local)
    local = cell.local
    flops_dev, bytes_dev = costs.flops, costs.bytes
    coll = {"per_kind": {k: v for k, v in costs.collectives.items() if v},
            "counts": {k: v for k, v in costs.collective_counts.items()
                       if v},
            "total": costs.collective_bytes}
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": costs.collective_bytes / NVLINK_BW}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())
    m_flops = model_flops(cell.cfg, cell.shape)
    hlo_total = flops_dev * chips
    useful_ratio = m_flops / hlo_total if hlo_total else 0.0
    mfu = (m_flops / chips / step_time) / PEAK_FLOPS if step_time else 0
    card = card_line() if cell.device == "cuda" else None
    return {
        "arch": cell.arch,
        "shape": cell.shape.name,
        "mesh": mesh_tag(cell.multi_pod, local),
        "chips": chips,
        "guard": cell.guard,
        "policy": cell.policy,
        "lower_s": round(cell.lower_s, 2),
        "compile_s": None,
        "memory": memory,
        "cost": {"flops_per_device": flops_dev,
                 "vector_flops_per_device": costs.vector_flops,
                 "bytes_per_device": bytes_dev,
                 "xla_flops_scan_body_once": None,
                 "xla_bytes_scan_body_once": None},
        "collectives": coll,
        "roofline": {
            **terms,
            "bottleneck": bottleneck.replace("_s", ""),
            "model_flops": m_flops,
            "hlo_total_flops": hlo_total,
            "useful_ratio": useful_ratio,
            "roofline_fraction_mfu": mfu,
        },
        "params": {"total": cell.cfg.param_count(),
                   "active": cell.cfg.active_param_count()},
        "device": {"fakes": cell.device,
                   "card": card or ("traced on CPU fakes"
                                    if cell.device == "cpu"
                                    else "nvidia-smi not available")},
        "method": {
            "trace": f"make_fx over fake tensors on {cell.device} "
                     "(graph_analysis.trace_step): nothing allocated, "
                     "compiled or launched",
            "cost": "graph_analysis.analyze_graph over the traced aten "
                    "graph of one device's program",
            "per_device": "one device" if local else
                          "partitioned trace (DTensor over a fake group of "
                          f"{chips} ranks): rank 0's program, local shapes",
            "memory": "liveness walk over the traced graph "
                      "(graph_analysis.peak_live_bytes)" if local else
                      "argument, output and alias bytes per device from "
                      "the placements; temp from a liveness walk over the "
                      "device's partitioned graph "
                      "(graph_analysis.peak_live_bytes)",
            "collectives": "one device: none" if local else
                           "the _c10d_functional ops of the partitioned "
                           "graph by the reference's kind names, operand "
                           "bytes each (as hlo_analysis counts them); a "
                           "cut loop's extrapolated",
            "roofline": CONSTANTS,
            "loops": {k: n for k, (n, _) in cell.gm.meta["loops"].items()},
            "compile": "nothing compiled ahead of time: a serve step's "
                       "CUDA graph is captured at its first call "
                       "(core/stepgraph.py), the train CLI's step at its "
                       "first step, one CUDA graph per batch shape "
                       "(launch/steps.py compile_train_step)",
        },
        "trace": {"nodes": len(cell.gm.graph.nodes), "ops": dict(model.ops),
                  "launches": dict(model.launches)},
    }


def run_cell(arch: str, shape_name: Optional[str] = None,
             multi_pod: bool = False,
             out_dir: Optional[str] = "results/dryrun_torch",
             guard_enabled: bool = True,
             policy_name: str = "bitwise",
             tag: str = "",
             moe_dispatch: str = "einsum",
             remat_policy: str = "nothing",
             kv_dtype: str = "bf16",
             device: str = "cuda",
             local: bool = False,
             shape=None) -> Optional[dict]:
    """The reference's ``run_cell``, on fakes of ``device``: ``local``
    takes the card's 1 x 1 mesh (:func:`~repro_torch.launch.mesh.
    make_local_mesh`) instead of a production mesh; ``shape`` a
    :class:`~repro_torch.configs.ShapeConfig` in place of ``shape_name``.
    Writes the result under ``out_dir`` (None: not written) and returns
    it; None where the shape does not apply.  A train step on CUDA fakes
    without a CUDA build of torch raises before anything is traced."""
    cell = trace_cell(arch, shape_name, multi_pod, guard_enabled,
                      policy_name, moe_dispatch, remat_policy, kv_dtype,
                      device, local, shape)
    if cell is None:
        return None
    result = reckon(cell)
    if out_dir is not None:
        path = cell_path(out_dir, arch, cell.shape.name, multi_pod, local,
                         tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    print(f"OK   {arch:22s} x {cell.shape.name:12s} mesh={result['mesh']} "
          f"trace={cell.lower_s:6.1f}s flops/dev="
          f"{result['cost']['flops_per_device']:.3e} "
          f"bottleneck={result['roofline']['bottleneck']} "
          f"mfu={result['roofline']['roofline_fraction_mfu']:.3f}",
          flush=True)
    return result


def cell_path(out_dir: str, arch: str, shape_name: str, multi_pod: bool,
              local: bool, tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return (f"{out_dir}/{mesh_tag(multi_pod, local)}/"
            f"{arch}__{shape_name}{suffix}.json")


def cells() -> list:
    """The reference's applicable (arch, shape) cells, in its order."""
    from repro_torch.configs import SHAPES, get_config, list_archs, \
        shape_applicable
    return [(arch, name) for arch in list_archs() for name in SHAPES
            if shape_applicable(get_config(arch), SHAPES[name])[0]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--local", action="store_true",
                    help="the card's 1 x 1 mesh (make_local_mesh)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fakes' device (the CPU only when asked)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-guard", action="store_true",
                    help="native fast-path (no fence instructions)")
    ap.add_argument("--policy", default="bitwise",
                    choices=["bitwise", "modulo", "check", "none"])
    ap.add_argument("--tag", default="", help="suffix for the result file")
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=["einsum", "scatter"])
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots"])
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["bf16", "f32", "f8"])
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        # one subprocess per cell: a fresh interpreter, bounded memory
        failures = []
        for arch, shape_name in cells():
            path = cell_path(args.out_dir, arch, shape_name, args.multi_pod,
                             args.local, args.tag)
            if args.skip_done and os.path.exists(path):
                print(f"SKIP (done) {arch} x {shape_name}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--out-dir", args.out_dir, "--device", args.device]
            for flag in ("multi_pod", "local", "no_guard"):
                if getattr(args, flag):
                    cmd.append("--" + flag.replace("_", "-"))
            for flag, default in (("policy", "bitwise"),
                                  ("moe_dispatch", "einsum"),
                                  ("kv_dtype", "bf16"),
                                  ("remat_policy", "nothing"), ("tag", "")):
                if getattr(args, flag) != default:
                    cmd += ["--" + flag.replace("_", "-"),
                            getattr(args, flag)]
            if subprocess.run(cmd).returncode != 0:
                failures.append((arch, shape_name))
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("all cells OK")
        return

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    run_cell(args.arch, args.shape, args.multi_pod, out_dir=args.out_dir,
             guard_enabled=not args.no_guard, policy_name=args.policy,
             tag=args.tag, moe_dispatch=args.moe_dispatch,
             remat_policy=args.remat_policy, kv_dtype=args.kv_dtype,
             device=args.device, local=args.local)


if __name__ == "__main__":
    main()

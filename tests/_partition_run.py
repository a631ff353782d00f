"""The partitioned step bundles run with real collectives: each case's
bundle (``test_torch_dryrun_mesh``'s shapes) runs as every rank of a gloo
group on the CPU (:meth:`repro_torch.launch.mesh.Mesh.join`, rendezvous
through a ``FileStore``: the loopback device, no network), on the local
shards of seeded inputs, and each result leaf is held against the same
shard of the unpartitioned ``bundle.step`` on the same inputs.

Imports neither JAX nor the reference: the ranks are spawned processes,
and ``chip_smoke.py`` runs the (2, 4) check on the card's host too.

:func:`run` spawns the ranks of one mesh and returns, per case, either
``{leaf path: error}`` (a float leaf's largest difference over its
largest entry, the maximum over ranks; an integer leaf's count of
differing entries) or the traceback of the rank that failed it.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time
import traceback

import numpy as np

#: every family's reduced config, as ``test_torch_graph_analysis.FAMILIES``
FAMILIES = {"dense": "stablelm-3b", "moe": "qwen3-moe-30b-a3b",
            "hybrid": "zamba2-7b", "ssm": "xlstm-350m",
            "vlm": "qwen2-vl-2b", "encdec": "seamless-m4t-medium"}
KINDS = ("train", "prefill", "decode")

#: a float leaf's bound: its largest difference over its largest entry
TOL = 1e-5

#: ids, lengths and positions are drawn below this (inside every reduced
#: vocab, every cache's length and every source's frames)
IDS = 50

#: the optimizer's step count carried in (its bias corrections nearer 1)
OPT_STEP = 20


#: a family of its own: the MoE family with 2 experts, fewer than a
#: (2, 4) mesh's model ranks (each rank's buffer block inside one expert)
FEW_EXPERTS = "moe-2-experts"


def config(family: str):
    """``family``'s reduced config (:data:`FEW_EXPERTS`: the MoE family's
    with 2 experts)."""
    from repro_torch.configs import get_config

    if family == FEW_EXPERTS:
        cfg = get_config(FAMILIES["moe"]).reduced()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=2))
    return get_config(FAMILIES[family]).reduced()


def bundle(family: str, kind: str, data: int, model: int,
           kv_dtype: str = "f32"):
    """The port's bundle of the dry run's (2, 4) rows' shapes on a (data,
    model) mesh (``test_torch_dryrun_mesh``): S = 64 (the vision family
    256), B = 2 (decode 4), the encoder-decoder's frames in float32; the
    serve bundles' pools in ``kv_dtype``, float32 here (a bf16 pool, the
    dry run's, rounds the K / V that two programs sum in different orders
    to neighbouring bf16 values, past :data:`TOL`)."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import mesh as MT, steps as STT

    mesh = MT.Mesh(("data", "model"), {"data": data, "model": model})
    S, B = (256 if family == "vlm" else 64), (4 if kind == "decode" else 2)
    bt = STT.build_step(config(family),
                        ShapeConfig("t", kind, S, B), mesh,
                        **({"device": "cpu"} if kind == "train" else
                           {"kv_dtype": kv_dtype}))
    if family == "encdec" and kind != "decode":
        src = bt.in_specs[2]["src"].shape
        bt.in_specs = (*bt.in_specs[:2], {
            **bt.in_specs[2], "src": torch.empty(src, device="meta")})
    return bt


def _walk(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)`` (dicts,
    lists, tuples, dataclasses; a path is the names and indices above)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _walk(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def _cache(bt, family: str, kind: str):
    """The bundle's cache as ``init_cache`` makes it on the CPU (page
    tables, slot ids), of the bundle's shapes."""
    import torch

    from repro_torch.core.stepgraph import tree_flatten

    B = 4 if kind == "decode" else 2
    S = 256 if family == "vlm" else 64
    if family == "ssm":
        cache = bt.api.init_cache(B, device="cpu")
    else:
        kv = tree_flatten(bt.in_specs[1])[1][0]
        cache = bt.api.init_cache(B, S, dtype=kv.dtype, device="cpu")
    got = [(tuple(t.shape), t.dtype) for t in tree_flatten(cache)[1]
           if isinstance(t, torch.Tensor)]
    assert got == [(tuple(t.shape), t.dtype) for t in
                   tree_flatten(bt.in_specs[1])[1]
                   if isinstance(t, torch.Tensor)], got
    return cache


def inputs(bt, family: str, kind: str, seed: int):
    """Whole inputs for ``bt`` from a numpy seed: every float leaf
    ``randn * 0.05`` (the second moments' magnitudes), ids and token
    positions in ``[0, IDS)``, a decode's cached lengths in ``[1, IDS)``;
    page tables and slot ids as ``init_cache`` makes them, the optimizer's
    step :data:`OPT_STEP`."""
    import torch

    rng = np.random.default_rng(seed)

    def fill(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        shape = tuple(t.shape)
        if t.dtype.is_floating_point:
            x = rng.standard_normal(shape).astype(np.float32) * 0.05
            if path[:1] == ("v",):
                x = np.abs(x)
            return torch.from_numpy(x).to(t.dtype)
        if path[-1:] == ("step",):
            return torch.full(shape, OPT_STEP, dtype=t.dtype)
        if path[-1:] in (("seq_lens",), ("src_lens",)):
            if kind != "decode":
                return torch.zeros(shape, dtype=t.dtype)
            return torch.from_numpy(rng.integers(1, IDS, shape)).to(t.dtype)
        if t.device.type == "meta":       # a batch's ids or positions
            return torch.from_numpy(rng.integers(0, IDS, shape)).to(t.dtype)
        return t.clone()                  # page tables, slot ids

    params, second, batch = bt.in_specs
    second = _cache(bt, family, kind) if kind != "train" else second
    return (_walk(fill, params, ("params",)),
            _walk(lambda p, t: fill(p[1:], t), second, ("opt",)),
            _walk(fill, batch, ("batch",)))


def _clone(tree):
    import torch
    return _walk(lambda _, t: t.clone() if isinstance(t, torch.Tensor)
                 else t, tree)


def _local(dm, placements, whole):
    """Rank ``dm``'s shard of ``whole`` under ``placements`` (a chunk of
    the replicated tensor: no collective)."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(whole, dm, [Replicate()] * dm.ndim,
                              run_check=False).redistribute(
        dm, placements).to_local()


def _pairs(out_shardings, got, want, path=()):
    """``(path, spec, got, want)`` for every tensor leaf of the results."""
    import torch

    from repro_torch.distributed.partition import is_spec

    if is_spec(out_shardings) and isinstance(want, torch.Tensor):
        return [(path, out_shardings, got, want)]
    if isinstance(want, dict):
        return [x for k in want for x in _pairs(
            out_shardings[k], got[k], want[k], path + (k,))]
    if isinstance(want, (list, tuple)):
        return [x for i, w in enumerate(want) for x in _pairs(
            out_shardings[i], got[i], w, path + (i,))]
    if dataclasses.is_dataclass(want):
        return [x for f in dataclasses.fields(want) for x in _pairs(
            getattr(out_shardings, f.name), getattr(got, f.name),
            getattr(want, f.name), path + (f.name,))]
    return []


def _errors(dm, bt, args) -> dict:
    """The partitioned step on this rank's shards of ``args`` against the
    same shards of the unpartitioned step's results."""
    import torch

    from repro_torch.distributed.partition import is_spec
    from repro_torch.distributed.sharding import to_placements, tree_map

    with torch.no_grad():
        want = bt.step(*_clone(args))
    fn, _ = bt.partitioned(dm)
    shards = tuple(
        tree_map(lambda spec, t: _local(dm, to_placements(dm, spec), t)
                 if isinstance(t, torch.Tensor) else t,
                 s, _clone(a), is_leaf=is_spec)
        for s, a in zip(bt.in_shardings, args))
    with torch.no_grad():
        got = fn(*shards)
    out = {}
    for path, spec, g, w in _pairs(bt.out_shardings, got, want):
        key = "/".join(map(str, path))
        mine = _local(dm, to_placements(dm, spec), w)
        assert tuple(g.shape) == tuple(mine.shape), (key, g.shape,
                                                     mine.shape)
        if w.dtype.is_floating_point:
            top = w.float().abs().max().item()
            diff = (g.float() - mine.float()).abs().max().item() \
                if g.numel() else 0.0
            out[key] = diff / top if top else diff
        else:
            out[key] = int((g != mine).sum())
    return out


def embed_grad(dm, seed: int = 0) -> dict:
    """One block: K3 over a (V, d) table split by vocab row over the model
    axis, the ids (B, S) split over the data axis, a loss of the rows; the
    table's gradient on this rank's shard against the unpartitioned one
    (``{"table": error}``)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import embed_tokens

    rng = np.random.default_rng(seed)
    V, d, B, S = 256, 64, 4, 16
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, V, (B, S)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))

    def loss(tab, tok, wt):
        return (embed_tokens({"table": tab}, tok) * wt).sum()

    t = table.clone().requires_grad_()
    loss(t, ids, w).backward()
    want = t.grad
    placed = [Shard(0) if n == "model" else Replicate()
              for n in dm.mesh_dim_names]
    data = [Shard(0) if n == "data" else Replicate()
            for n in dm.mesh_dim_names]
    tab = DTensor.from_local(_local(dm, placed, table), dm, placed,
                             run_check=False).requires_grad_()
    tok = DTensor.from_local(_local(dm, data, ids), dm, data,
                             run_check=False)
    wt = DTensor.from_local(_local(dm, data, w), dm, data, run_check=False)
    with implicit_replication():
        loss(tab, tok, wt).backward()
    got = tab.grad.redistribute(dm, placed).to_local()
    mine = _local(dm, placed, want)
    return {"table": (got - mine).abs().max().item()
            / want.abs().max().item()}


def _rank(rank: int, data: int, model: int, store: str, out_dir: str,
          cases, timeout: float) -> None:
    """One rank: every case in order; each case's errors (or this rank's
    traceback) and seconds written to ``out_dir/<rank>.json`` as it
    ends."""
    import logging
    import warnings

    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as MT

    # DTensor's notes on implicit replication and sequential reductions
    warnings.filterwarnings("ignore")
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    mesh = MT.Mesh(("data", "model"), {"data": data, "model": model})
    results = {}
    path = os.path.join(out_dir, f"{rank}.json")
    with mesh.join(rank, dist.FileStore(store, mesh.size),
                   timeout=datetime.timedelta(seconds=timeout)) as dm:
        for case in cases:
            name = "/".join(case)
            t0 = time.perf_counter()
            try:
                if case[0] == "embed_grad":
                    got = {"leaves": embed_grad(dm)}
                else:
                    family, kind = case
                    bt = bundle(family, kind, data, model)
                    seed = (sorted([*FAMILIES, FEW_EXPERTS]).index(family)
                            * len(KINDS) + KINDS.index(kind))
                    got = {"leaves": _errors(
                        dm, bt, inputs(bt, family, kind, seed))}
            except Exception:                       # noqa: BLE001
                got = {"error": traceback.format_exc()}
            results[name] = {**got, "seconds": time.perf_counter() - t0}
            with open(path + ".tmp", "w") as f:
                json.dump(results, f)
            os.replace(path + ".tmp", path)


def start(data: int, model: int, cases, work_dir: str,
          timeout: float = 240.0):
    """Spawn the ``data * model`` ranks of one mesh, each running every
    case of ``cases`` (``(family, kind)`` pairs and ``("embed_grad",)``)
    in ``work_dir``; :func:`finish` waits for them."""
    import torch.multiprocessing as mp

    os.makedirs(work_dir, exist_ok=True)
    store = os.path.join(work_dir, "store")
    ctx = mp.start_processes(
        _rank, args=(data, model, store, work_dir, list(cases), timeout),
        nprocs=data * model, join=False, start_method="spawn")
    return ctx, data * model, list(cases), work_dir, \
        time.monotonic() + timeout, timeout


def finish(handle) -> dict:
    """The ranks of :func:`start` waited for, and their results merged
    over the ranks: per case ``{"leaves": {leaf: error}, "seconds": s}``
    or ``{"error": traceback}``.  A rank that cannot start, that raises
    outside a case, or that still runs at the deadline fails every case
    it has not finished with its own traceback (or the timeout); every
    rank is stopped before this returns."""
    ctx, ranks, cases, work_dir, deadline, timeout = handle
    failure = None
    try:
        # ``join`` returns False while a rank still runs
        while not ctx.join(max(deadline - time.monotonic(), 0)):
            if time.monotonic() >= deadline:
                failure = f"timed out after {timeout} s"
                break
    except Exception:                               # noqa: BLE001
        failure = traceback.format_exc()
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return merge(work_dir, ranks, cases, failure)


def run(data: int, model: int, cases, work_dir: str,
        timeout: float = 240.0) -> dict:
    """:func:`start` then :func:`finish`."""
    return finish(start(data, model, cases, work_dir, timeout))


def merge(work_dir: str, ranks: int, cases, failure=None) -> dict:
    """Every rank's results merged: the largest error of a leaf over the
    ranks; a case some rank did not finish fails with ``failure``."""
    per_rank = []
    for r in range(ranks):
        path = os.path.join(work_dir, f"{r}.json")
        per_rank.append(json.load(open(path)) if os.path.exists(path)
                        else {})
    out = {}
    for case in cases:
        name = "/".join(case)
        got = [res.get(name) for res in per_rank]
        err = next((g["error"] for g in got if g and "error" in g), None)
        if err is None and any(g is None for g in got):
            err = failure or f"rank {got.index(None)} did not finish"
        out[name] = {"error": err} if err is not None else {
            "leaves": {k: max(g["leaves"][k] for g in got)
                       for k in got[0]["leaves"]},
            "seconds": max(g["seconds"] for g in got)}
    return out

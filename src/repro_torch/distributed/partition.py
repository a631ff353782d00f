"""A step as rank 0 of its partitioned program: the counterpart of the
reference's ``jax.jit(fn, in_shardings=, out_shardings=)`` on a
production mesh, which XLA's SPMD partitioner splits into one program per
device.

PyTorch's SPMD partitioner is DTensor.  :func:`partitioned` wraps a step
so that it takes and returns the *local* shards of one rank: each input
leaf is made a DTensor of its placement on the ``DeviceMesh``
(``DTensor.from_local``), the step runs on DTensors (every op split by its
sharding rule, the collectives a redistribution needs inserted as
``_c10d_functional`` ops), and each result is redistributed to its
placement and handed back as its local shard.  A tensor the step makes
itself (a constant, an ``arange``) is replicated
(``implicit_replication``).  Traced over fakes of :func:`local_specs`
(:func:`repro_torch.launch.graph_analysis.trace_step`), this is the
per-device program whose FLOPs, bytes, temporaries and collectives the
dry run reckons.  Serving and training never call it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.distributed.sharding import to_placements, tree_map

#: DTensor's class while a mesh is open (:func:`opened`), else None: off a
#: partitioned trace every helper here is its plain op after one test
_DTENSOR = None


@contextlib.contextmanager
def opened():
    """Within, DTensors may reach the helpers here
    (:meth:`repro_torch.launch.mesh.Mesh.open` enters it)."""
    global _DTENSOR
    from torch.distributed.tensor import DTensor
    _DTENSOR = DTensor
    try:
        yield
    finally:
        _DTENSOR = None


def is_dtensor(x) -> bool:
    """``x`` is a DTensor (none exists outside :func:`opened`)."""
    return _DTENSOR is not None and isinstance(x, _DTENSOR)


def is_spec(x) -> bool:
    """A placement spec: per tensor dim a mesh axis, a tuple of them or
    None (a leaf of an ``in_shardings`` / ``out_shardings`` tree)."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) or (
            isinstance(a, tuple) and all(isinstance(b, str) for b in a))
        for a in x)


def local_shape(device_mesh, placements, shape) -> tuple:
    """The shard of ``shape`` rank 0 holds under ``placements`` (each
    placement ``Shard(d)`` divides dim ``d`` by its mesh dim's size)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // device_mesh.size(m))
    return tuple(out)


class _Placed(tuple):
    """A tensor leaf's placements (a leaf of a placements tree; a list
    would be walked as a tree node)."""


def _placements_tree(device_mesh, shardings, tree):
    return tree_map(lambda spec, t: _Placed(to_placements(device_mesh, spec))
                    if isinstance(t, torch.Tensor) else None,
                    shardings, tree, is_leaf=is_spec)


def local_specs(device_mesh, shardings: Sequence, specs: Sequence) -> tuple:
    """Each argument's tree with every tensor leaf replaced by a ``meta``
    tensor of rank 0's shard of it."""
    def one(spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty(local_shape(device_mesh,
                                       to_placements(device_mesh, spec),
                                       t.shape), dtype=t.dtype,
                           device="meta")
    return tuple(tree_map(one, s, a, is_leaf=is_spec)
                 for s, a in zip(shardings, specs))


def partitioned(fn: Callable, device_mesh, in_shardings: Sequence,
                out_shardings: Any, in_specs: Sequence) -> Callable:
    """``fn`` as rank 0's program: it takes the local shards of
    ``in_specs`` (:func:`local_specs`), placed by ``in_shardings``, and
    returns the local shards of its results, each redistributed to its
    placement in ``out_shardings`` first (a result the step made whole,
    a plain tensor, split to it locally).  The function is marked
    ``partitioned`` for :func:`~repro_torch.launch.graph_analysis.
    trace_step`."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    in_pl = [_placements_tree(device_mesh, s, a)
             for s, a in zip(in_shardings, in_specs)]

    def wrap(pl, local, spec):
        if not isinstance(local, torch.Tensor):
            return local
        return DTensor.from_local(local, device_mesh, list(pl),
                                  run_check=False,
                                  shape=spec.shape, stride=spec.stride())

    def unwrap(spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        if not is_dtensor(t):
            # a result the step made itself is whole on every rank
            t = DTensor.from_local(t, device_mesh, [Replicate()] *
                                   device_mesh.ndim, run_check=False)
        pl = to_placements(device_mesh, spec)
        if list(t.placements) != pl:
            t = t.redistribute(device_mesh, pl)
        return t.to_local()

    def run(*local_args):
        args = [tree_map(wrap, pl, a, s,
                         is_leaf=lambda x: isinstance(x, _Placed))
                for pl, a, s in zip(in_pl, local_args, in_specs)]
        with implicit_replication():
            out = fn(*args)
            return tree_map(unwrap, out_shardings, out, is_leaf=is_spec)

    run.__name__ = getattr(fn, "__name__", "step")
    run.partitioned = True
    return run


def settle(x):
    """``x`` with its partial sums reduced now (each ``Partial`` placement
    made ``Replicate``: one all-reduce), where a row-parallel product
    leaves them: the all-reduce the reference's partitioner places right
    after the product (Megatron's), which DTensor would otherwise defer
    into every op that reads ``x``.  Any other tensor comes back as is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def rank_block(mesh, dims) -> int:
    """This rank's block of a tensor dim split over the mesh dims ``dims``
    (the first of them the slowest, as DTensor orders a dim split over
    two mesh dims)."""
    block = 0
    for m in dims:
        block = block * mesh.size(m) + mesh.get_local_rank(m)
    return block


def split_over(x, dim: int) -> list:
    """The mesh dims a DTensor's dim ``dim`` is split over."""
    from torch.distributed.tensor import Shard
    d = dim % x.dim()
    return [m for m, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == d]


def _ranks(mesh, dims) -> int:
    return math.prod(mesh.size(m) for m in dims)


def _gathered(x, dims):
    """``x`` with every split on the mesh dims ``dims`` gathered."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if m in dims else p for m, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh,
                                                             pl)


def fit_split(x, dim: int, n: int):
    """``x`` ready for its dim ``dim`` to be split into ``n`` groups: where
    the mesh dims sharding that dim do not divide ``n``, gathered on them
    (DTensor cannot unflatten such a split)."""
    if not is_dtensor(x):
        return x
    split = split_over(x, dim)
    if n % _ranks(x.device_mesh, split) == 0:
        return x
    return _gathered(x, split)


def split_heads(x, n: int):
    """x (..., n * p) -> (..., n, p).  On a DTensor whose last dim the
    mesh splits into blocks that do not divide ``n``, the heads are split
    unevenly instead (gathered, viewed, and each rank keeps its block:
    rank r the heads [r*c, (r+1)*c), c = ceil(n / ranks)), as the
    reference's partitioner pads the heads to a multiple of the mesh; no
    rank runs every head."""
    shape = (*x.shape[:-1], n, x.shape[-1] // n)
    if _DTENSOR is None or not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Shard
    mesh, split = x.device_mesh, split_over(x, -1)
    if n % _ranks(mesh, split) == 0:
        return x.reshape(shape)
    y = _gathered(x, split).reshape(shape)
    return y.redistribute(mesh, [Shard(y.dim() - 2) if m in split else p
                                 for m, p in enumerate(y.placements)])


class _FitGrad(torch.autograd.Function):
    """The identity; its backward fits the gradient's last dim for a split
    into ``n`` groups (:func:`fit_split`)."""

    @staticmethod
    def forward(ctx, x, n: int):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return fit_split(grad, -1, ctx.n), None


def merge_heads(x, n: int):
    """x (..., n, p) -> (..., n * p), the heads merged; on a partitioned
    trace a split of the inner dim ``p``, or an uneven split of the heads
    (:func:`split_heads`), is gathered first (only an even split of the
    heads merges into a plain split of the merged dim), and the merged
    dim's gradient is fitted before the backward splits it into the
    ``n`` heads again."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    mesh, heads = x.device_mesh, split_over(x, -2)
    x = _gathered(x, split_over(x, -1) + (
        heads if n % _ranks(mesh, heads) else []))
    flat = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _FitGrad.apply(flat, n)


def heads_split(q, dim: int):
    """``q`` (its heads in ``dim``) for a kernel split by heads: the heads
    split over every mesh dim that splits no other dim of q, padded with
    zero heads to a multiple of those ranks where they do not divide (as
    GSPMD pads them; DTensor splits no dim over more ranks than it has
    entries), so every rank runs its share of the heads and none runs
    them all.  Returns (q, the heads before the padding); a q already
    split evenly so comes back as is."""
    from torch.distributed.tensor import Shard
    mesh, H = q.device_mesh, q.shape[dim]
    dims = [m for m, p in enumerate(q.placements)
            if not (isinstance(p, Shard) and p.dim != dim)]
    ranks = _ranks(mesh, dims)
    pad = -H % ranks
    want = [Shard(dim) if m in dims else p for m, p in enumerate(q.placements)]
    if not pad:
        return (q if want == list(q.placements) else
                q.redistribute(mesh, want)), H
    q = _gathered(q, dims)
    shape = list(q.shape)
    shape[dim] = pad
    q = torch.cat([q, q.new_zeros(shape)], dim)
    return q.redistribute(mesh, want), H


def heads_like(q, kv, q_dim: int, kv_dim: int, heads: int,
               whole: bool = False):
    """``kv`` (its heads in dim ``kv_dim``) placed for attention by ``q``
    (its heads in ``q_dim``, the first ``heads`` of them real; the rest a
    padding, :func:`heads_split`) split over the mesh: where q's heads
    outnumber kv's and the ranks that split them do not divide kv's
    (grouped-query attention with fewer KV heads than ranks) or q is
    padded, kv is gathered on those ranks and each keeps the KV head of
    each of its query heads (any for a padding head), a virtual tensor of
    q's head count split as q is (its gradient a partial sum over those
    ranks).  Each rank then attends its own query heads only; elsewhere
    ``kv`` comes back as is.  With ``whole`` (a pool addressed by global
    page ids), those heads are then gathered on every other mesh dim."""
    if not (is_dtensor(q) and is_dtensor(kv)):
        return kv
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh, split = q.device_mesh, split_over(q, q_dim)
    H, KH = q.shape[q_dim], kv.shape[kv_dim]
    ranks = _ranks(mesh, split)
    if not split or KH == H or KH % ranks == 0 and H == heads:
        return kv
    full = _gathered(kv, split + split_over(kv, kv_dim))
    c = H // ranks
    first = rank_block(mesh, split) * c
    local = full.to_local(grad_placements=[
        Partial() if m in split else p for m, p in enumerate(
            full.placements)])
    ids = torch.arange(first, first + c, device=local.device)
    local = local.index_select(
        kv_dim, ids.clamp(max=heads - 1) // (heads // KH))
    shape = list(kv.shape)
    shape[kv_dim] = H
    out = DTensor.from_local(
        local, mesh, [Shard(kv_dim) if m in split else p
                      for m, p in enumerate(full.placements)],
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())
    return _gathered(out, [m for m in range(mesh.ndim) if m not in split]) \
        if whole else out


def contiguous(x):
    """``x.contiguous()``; a DTensor's local shard is made contiguous too
    (DTensor judges only its global layout, and its reshape then views a
    strided shard)."""
    if not is_dtensor(x):
        return x.contiguous()
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local().contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def along(fn: Callable, x, dim: int):
    """``fn(x)`` for an op that works along ``x``'s dim ``dim`` only (a
    cumsum, a gather of that dim): on a DTensor split elsewhere it runs on
    the local shard and keeps the placements (DTensor has no rule for
    some of these ops, or for their backwards: ``flip``); a split of
    ``dim`` itself, or a partial sum, is reduced first."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    d = dim % x.dim()
    pl = [Replicate() if p.is_partial() or isinstance(p, Shard) and
          p.dim == d else p for p in x.placements]
    local = x.redistribute(x.device_mesh, pl).to_local()
    return DTensor.from_local(fn(local), x.device_mesh, pl, run_check=False)


def whole(fn: Callable, *xs):
    """``fn(*xs)`` on every operand whole (an explicit gather of each
    DTensor), for index arithmetic DTensor cannot split (a sort, a
    scatter of ranks); the results come back replicated DTensors.  With
    no DTensor among ``xs``, plain ``fn(*xs)``."""
    mesh = next((x.device_mesh for x in xs if is_dtensor(x)), None)
    if mesh is None:
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    out = fn(*(x.redistribute(mesh, rep).to_local() if is_dtensor(x) else x
               for x in xs))
    wrap = lambda t: DTensor.from_local(t, mesh, rep, run_check=False) \
        if isinstance(t, torch.Tensor) else t  # noqa: E731
    return tuple(wrap(t) for t in out) if isinstance(out, tuple) \
        else wrap(out)


def einsum(equation: str, *operands, idle: bool = False):
    """``torch.einsum``; on DTensors, split per mesh dim by one letter, as
    the reference's partitioner splits a dot: the first operand split on
    that mesh dim names the letter, every operand holding it is split
    along it there and every other one is whole (an explicit
    redistribute each: an FSDP weight's all-gather), the einsum runs on
    the local shards, and the result is split along the letter, or a
    partial sum where the letter is contracted.  In the backward pass an
    operand without the letter gets a partial-sum gradient there (the
    all-reduce / reduce-scatter the reference's transpose makes).  With
    ``idle``, a mesh dim no operand is split on splits the result's last
    letter (unevenly where it must, as the reference pads): each rank
    computes its block of the result, none the whole product, where the
    reference's partitioner splits a product by the split its result's
    readers want (a projection whose weight is whole on the model axis).
    DTensor's own einsum flattens batch letters split over two mesh dims
    into strided shards its products cannot take, and its cost-driven
    choice for a product under a replicated gradient gathers whole
    weights."""
    if _DTENSOR is None or not any(is_dtensor(t) for t in operands):
        return torch.einsum(equation, *operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ins, out = equation.replace(" ", "").split("->")
    subs = ins.split(",")
    if "." in equation or len(subs) != len(operands):
        raise ValueError(f"partitioned einsum: {equation!r} (explicit "
                         "letters, one term per operand)")
    mesh = next(t.device_mesh for t in operands if is_dtensor(t))
    ops = [t if is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for t in operands]
    sizes = {c: n for sub, t in zip(subs, ops) for c, n in zip(sub, t.shape)}
    targets = [[] for _ in ops]
    grads = [[] for _ in ops]
    result, used = [], set()
    for m in range(mesh.ndim):
        letter = next((sub[t.placements[m].dim] for sub, t in zip(subs, ops)
                       if isinstance(t.placements[m], Shard)), None)
        if letter is not None and sizes[letter] % mesh.size(m):
            letter = None
        if letter is None and idle:
            letter = next((c for c in reversed(out) if c not in used and
                           sizes[c] >= mesh.size(m)), None)
        used.add(letter)
        for tgt, grd, sub in zip(targets, grads, subs):
            held = letter is not None and letter in sub
            tgt.append(Shard(sub.index(letter)) if held else Replicate())
            grd.append(tgt[-1] if held or letter is None else Partial())
        result.append(Replicate() if letter is None else
                      Shard(out.index(letter)) if letter in out
                      else Partial())
    local = [t.redistribute(mesh, tgt).to_local(grad_placements=grd)
             for t, tgt, grd in zip(ops, targets, grads)]
    y = torch.einsum(equation, *local)
    if all(sizes[out[p.dim]] % mesh.size(m) == 0
           for m, p in enumerate(result) if isinstance(p, Shard)):
        return DTensor.from_local(y, mesh, result, run_check=False)
    # an uneven split: the global shape cannot be read off the shard
    shape = [sizes[c] for c in out]
    return DTensor.from_local(y.contiguous(), mesh, result, run_check=False,
                              shape=torch.Size(shape), stride=torch.empty(
                                  shape, device="meta").stride())


def matmul(x, w, idle: bool = False):
    """``x @ w`` for x (..., d) and a matrix w (d, f); on DTensors the
    product :func:`einsum` splits (the tokens' split drives the data mesh
    dims, the weight's the model dim: column-parallel, or row-parallel
    with a partial-sum result; ``idle`` as there)."""
    if _DTENSOR is None or not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    lead = x.shape[:-1]
    y = einsum("td,df->tf", x.reshape(-1, x.shape[-1]), w, idle=idle)
    return y.reshape(*lead, w.shape[-1])


__all__ = ["along", "contiguous", "einsum", "fit_split", "heads_like",
           "heads_split", "is_dtensor",
           "is_spec", "local_shape", "local_specs", "matmul", "merge_heads",
           "partitioned", "rank_block", "settle", "split_heads",
           "split_over", "whole"]

"""Step builders: the engine's prefill/decode as trusted manager kernels,
the elastic relocation steps of the flat arena and of a serve engine's
slab pool, the train step (:func:`make_guard`, :func:`build_train_step`)
and its compiled form (:func:`compile_train_step`),
and the reference's step bundles (:func:`build_step`,
:func:`build_prefill_step`, :func:`build_decode_step`): a step function
with its inputs as ``meta`` tensors (``in_specs``) and every input's and
output's placement on a mesh (``in_shardings`` / ``out_shardings``, trees
of mesh-axis tuples from the sharding rules).

Steps run on the manager's device, as compiled steps (one CUDA graph per
operand signature, :mod:`repro_torch.core.stepgraph`) unless the manager's
``jit_trusted`` is off.  Where the reference threads a new pool value
through each step, the port's steps write the pool tensors in place and
hand the same tensors back, so the manager's ``PoolArena.buf`` bookkeeping
is unchanged and a replay addresses the same pool.
"""

from __future__ import annotations

import dataclasses
import gc
import math
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.fence import FenceParams, FencePolicy, \
    guarded_dynamic_slice, guarded_dynamic_update_slice
from repro_torch.core.partition import next_pow2
from repro_torch.core.stepgraph import GraphMaker, Operands, \
    StepCaptureError, StepGraph, tree_flatten, tree_unflatten
from repro_torch.distributed.sharding import ShardingRules, make_rules, \
    tree_map
from repro_torch.launch import sampling
from repro_torch.launch.mesh import describe
from repro_torch.models import kvcache as KV
from repro_torch.models.api import ModelAPI, get_model
from repro_torch.models.encdec import EncDecCache
from repro_torch.models.guard import GuardSpec
from repro_torch.models.hybrid import HybridCache
from repro_torch.optim import Optimizer, adamw, apply_updates, cosine


def split_cache_pool(cache) -> Tuple[Dict, Any]:
    """Split a serve cache into ``(pool, meta)``: ``pool`` holds the
    slot-indexed tensors (KV page pools, recurrent state pools — a
    manager-owned :class:`PoolArena` that N serve engines share), ``meta``
    is the same cache dataclass with the pool fields stripped (per-batch-row
    state only: slot ids, seq lens, page tables).  A hybrid cache recurses
    into its ``kv`` and ``state`` halves.  Inverse of
    :func:`join_cache_pool`.  An encoder-decoder cache recurses into its
    ``kv`` half and carries its cross-attention pools (``cross_k`` /
    ``cross_v``, on the same slot axis) in the pool."""
    if hasattr(cache, "kv"):          # hybrid / encdec: recurse
        kv_pool, kv_meta = split_cache_pool(cache.kv)
        pool: Dict[str, Any] = {"kv": kv_pool}
        repl: Dict[str, Any] = {"kv": kv_meta}
        if hasattr(cache, "state"):
            pool["state"], repl["state"] = split_cache_pool(cache.state)
        if hasattr(cache, "cross_k"):
            pool["cross_k"], pool["cross_v"] = cache.cross_k, cache.cross_v
            repl["cross_k"] = repl["cross_v"] = None
        return pool, dataclasses.replace(cache, **repl)
    if hasattr(cache, "pools"):
        return {"pools": cache.pools}, dataclasses.replace(cache, pools={})
    return {"k": cache.k, "v": cache.v}, \
        dataclasses.replace(cache, k=None, v=None)


def join_cache_pool(pool: Dict, meta) -> Any:
    """Rebuild the full cache from a pool dict + meta cache."""
    if hasattr(meta, "kv"):
        repl: Dict[str, Any] = {"kv": join_cache_pool(pool["kv"], meta.kv)}
        if hasattr(meta, "state"):
            repl["state"] = join_cache_pool(pool["state"], meta.state)
        if hasattr(meta, "cross_k"):
            repl["cross_k"], repl["cross_v"] = pool["cross_k"], \
                pool["cross_v"]
        return dataclasses.replace(meta, **repl)
    if hasattr(meta, "pools"):
        return dataclasses.replace(meta, pools=pool["pools"])
    return dataclasses.replace(meta, k=pool["k"], v=pool["v"])


@dataclasses.dataclass(frozen=True)
class TrustedStepBundle:
    """The serving engine's prefill/decode as *trusted manager kernels*
    (see ``GuardianManager.register_trusted_kernel``): internally fenced
    via a per-row GuardSpec, params/meta/guard passed as operands, the
    flat manager arena AND the shared KV pool arena threaded through
    (``fn(arena, pool, params, meta, x, guard) -> (arena, pool, (meta,
    next_ids))``).

    Names carry a pool fingerprint (model shape + pool geometry) so
    engines serving the *same* model shape share one symbol entry — and
    the scheduler can fuse their steps — while engines serving different
    models stay on separate entries.

    The weights (argument 1, after the arena) are declared *resident*: a
    compiled step addresses them in place, keyed by identity, and never
    copies them; the meta, the tokens and the guard are staged into the
    graph's own inputs at each dispatch (the reference declares
    ``donate_argnums`` at the same place)."""

    #: argument positions (arena = 0) a compiled step keeps resident
    RESIDENT_ARGNUMS = (1,)

    pool_name: str
    prefill_name: str
    decode_name: str
    prefill_fn: Callable
    decode_fn: Callable
    #: register both steps with the manager's extent-mode proof
    #: obligation (``register_trusted_kernel(verify=True)``)
    verify: bool = False

    def register(self, manager, pool: Dict) -> Any:
        """Adopt ``pool`` as the manager arena (idempotent — co-hosted
        engines converge on the first-registered pool) and register both
        step kernels against it.  Returns the live PoolArena."""
        arena = manager.register_pool(self.pool_name, pool)
        for name, fn in ((self.prefill_name, self.prefill_fn),
                         (self.decode_name, self.decode_fn)):
            manager.register_trusted_kernel(
                name, fn, resident_argnums=self.RESIDENT_ARGNUMS,
                pool_arena=self.pool_name, verify=self.verify)
        return arena


def build_trusted_serve_steps(api: ModelAPI, pool_key: str,
                              step_key: Optional[str] = None,
                              verify: bool = False,
                              temperature: float = 0.0,
                              top_k: int = 0) -> TrustedStepBundle:
    """Trusted prefill/decode step functions for one model API.

    The step rebuilds the cache from the manager-threaded pool + the
    engine's meta operand, runs the model (pool writes in place), and
    splits the result back; the next ids are taken on the device — the
    engine never materialises the (B, vocab) logits on the host.

    ``pool_key`` identifies the pool geometry; ``step_key`` (default:
    ``pool_key``) additionally carries the model identity.  ``verify``
    registers both steps with the manager's extent-mode proof obligation.

    ``temperature > 0`` builds the *sampled* decode step, the reference's
    ``serve.decode.sampled[...]``: its token operand is ``(toks, key)``,
    the key a (2,) int64 tensor staged like the tokens, and the next ids
    are drawn from the temperature-scaled, optionally top-k-truncated
    distribution (:func:`repro_torch.launch.sampling.sample`).  The greedy
    default (``temperature=0``, whatever ``top_k`` says) is the argmax step
    under the unsuffixed names."""
    sk = step_key or pool_key

    def prefill_step(arena, pool, params, meta, batch, guard):
        cache = join_cache_pool(pool, meta)
        cache, logits = api.prefill(params, cache, batch, guard=guard)
        new_pool, new_meta = split_cache_pool(cache)
        return arena, new_pool, (
            new_meta, torch.argmax(logits, -1).to(torch.int32))

    if temperature > 0:
        def decode_step(arena, pool, params, meta, x, guard):
            toks, key = x
            cache = join_cache_pool(pool, meta)
            cache, logits = api.decode(params, cache, toks, guard=guard)
            new_pool, new_meta = split_cache_pool(cache)
            return arena, new_pool, (
                new_meta, sampling.sample(logits, key, temperature, top_k))
        decode_name = f"serve.decode.sampled[{sk}:t{temperature}:k{top_k}]"
    else:
        def decode_step(arena, pool, params, meta, toks, guard):
            cache = join_cache_pool(pool, meta)
            cache, logits = api.decode(params, cache, toks, guard=guard)
            new_pool, new_meta = split_cache_pool(cache)
            return arena, new_pool, (
                new_meta, torch.argmax(logits, -1).to(torch.int32))
        decode_name = f"serve.decode[{sk}]"

    return TrustedStepBundle(
        pool_name=f"serve.pool[{pool_key}]",
        prefill_name=f"serve.prefill[{sk}]",
        decode_name=decode_name,
        prefill_fn=prefill_step,
        decode_fn=decode_step,
        verify=verify,
    )


def build_flat_relocation_step(moves: Tuple[Tuple[int, int, int], ...],
                               zeros: Tuple[Tuple[int, int], ...],
                               src_extent: Tuple[int, int],
                               dst_extent: Tuple[int, int]) -> Callable:
    """On-device compaction step for the flat arena — a *trusted* kernel
    (``fn(arena) -> (arena, None)``) the elastic manager registers and
    dispatches through the scheduler between drain cycles.  It is
    declared eager: one step exists per move set and runs once.

    ``moves`` are absolute ``(src, dst, len)`` slot copies applied in
    order (ascending with ``dst <= src`` per move, so in-place packing
    never reads a clobbered source); ``zeros`` scrub the vacated ranges
    afterwards.  Reads are fenced against the source extent and writes
    against the destination extent; the scrub ranges are validated here
    against the union of the two extents before the step exists."""
    src_fp = FenceParams(base=src_extent[0], size=src_extent[1])
    dst_fp = FenceParams(base=dst_extent[0], size=dst_extent[1])
    for start, ln in zeros:
        in_src = (src_extent[0] <= start
                  and start + ln <= src_extent[0] + src_extent[1])
        in_dst = (dst_extent[0] <= start
                  and start + ln <= dst_extent[0] + dst_extent[1])
        if ln < 0 or not (in_src or in_dst):
            raise ValueError(
                f"relocation scrub range [{start},{start + ln}) leaves "
                f"the moving tenant's extents {src_extent}/{dst_extent}")

    def relocate(arena):
        for src, dst, ln in moves:
            data = guarded_dynamic_slice(arena, src, ln, src_fp,
                                         FencePolicy.BITWISE)
            guarded_dynamic_update_slice(arena, dst, data, dst_fp,
                                         FencePolicy.BITWISE)
        for start, ln in zeros:
            arena[start:start + ln] = 0
        return arena, None

    return relocate


def build_pool_relocation_step(src: int, dst: int, size: int) -> Callable:
    """Slot-extent move for a manager-owned slab serve pool — a trusted
    kernel with ``pool_arena`` threading (``fn(arena, pool) -> (arena,
    pool, None)``) so a tenant's KV and state slots follow its partition
    when the elastic manager grows or relocates it.  The elastic manager
    dispatches it eagerly (one step per move).

    Every slot-indexed pool tensor of the nested pool (axis 1 — see
    ``kvcache.PagedKVCache`` / ``kvcache.StateCache``) has ``[src,
    src+size)`` copied wholesale to ``[dst, dst+size)`` and the vacated
    source range zeroed, in place (the sLSTM stabiliser too, as the
    reference's move zeroes it);
    per-row page tables live in the engines' meta halves and are
    slab-relative, so they survive the move untouched.  Distinct buddy
    extents never overlap (pow2 blocks nest or are disjoint), which makes
    copy-then-zero exact."""

    def move(arr):
        if arr.dim() < 2 or arr.shape[1] < max(src, dst) + size:
            # too short to be slot-indexed over BOTH extents: touching it
            # would clamp the copy into the wrong rows
            return arr
        data = arr[:, src:src + size].clone()
        arr[:, dst:dst + size] = data
        arr[:, src:src + size] = 0
        return arr

    def move_all(tree):
        if isinstance(tree, dict):
            return {name: move_all(v) for name, v in tree.items()}
        return move(tree)

    def relocate(arena, pool):
        return arena, move_all(pool), None

    return relocate


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def make_guard(cfg: ModelConfig, shape: ShapeConfig,
               policy: FencePolicy = FencePolicy.BITWISE,
               enabled: bool = True) -> Optional[GuardSpec]:
    """The reference's single-tenant-owns-everything guard (fences still
    compiled in — the overhead-measurement configuration): each space
    fenced into the power of two at or above its extent (the vocab's
    ``pow2(vocab)``, the experts' ``pow2(E)``).  ``enabled=False`` is the
    paper's standalone fast path (no fence at all)."""
    if not enabled:
        return None

    def fp(n):
        return FenceParams(base=0, size=n) if n else None

    slots = next_pow2(shape.global_batch)
    pages = next_pow2(max(shape.seq_len // KV.PAGE_SIZE, 1))
    expert = next_pow2(cfg.moe.num_experts) if cfg.moe else 0
    return GuardSpec(policy=policy, vocab=fp(next_pow2(cfg.vocab)),
                     kv=fp(slots), state=fp(slots), expert=fp(expert),
                     page=fp(pages))


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """A train step and what it closes over.  ``fn(params, opt_state,
    batch) -> (params, opt_state, {"loss": loss})`` updates ``params`` and
    the optimizer's moments in place (the reference donates both) and
    hands them back; ``batch["tokens"]`` is (B, S + 1) on the params'
    device."""

    fn: Callable
    opt: Optimizer
    guard: Optional[GuardSpec]
    api: ModelAPI


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, *,
                     guard_enabled: bool = True,
                     policy: FencePolicy = FencePolicy.BITWISE,
                     remat: bool = True, peak_lr: float = 3e-4,
                     moe_dispatch: str = "scatter",
                     remat_policy: str = "nothing",
                     schedule: Optional[Callable] = None,
                     device="cuda",
                     rules: Optional[ShardingRules] = None) -> TrainStep:
    """The reference's ``train_step`` (``repro/launch/steps.py``) on one
    device, without a mesh: the loss and its gradient through
    ``api.loss`` under :func:`make_guard`'s guard, AdamW under
    ``schedule`` (default: the reference's ``cosine(peak_lr, 2_000,
    100_000)``), the update applied.  ``device`` is where the step's
    params live; the step itself runs wherever its operands are.
    ``rules`` are the models' sharding pins (a bundle's; they act only on
    a partitioned trace)."""
    torch.device(device)          # an unknown device name raises here
    api = get_model(cfg)
    guard = make_guard(cfg, shape, policy, guard_enabled)
    opt = adamw(schedule or cosine(peak_lr, 2_000, 100_000))
    extra = {"dispatch": moe_dispatch,
             "remat_policy": remat_policy} if cfg.moe else {}

    def train_step(params, opt_state, batch):
        struct, leaves = tree_flatten(params)
        with torch.enable_grad():
            req = [p.detach().requires_grad_() for p in leaves]
            loss = api.loss(tree_unflatten(struct, req), batch, guard=guard,
                            rules=rules, remat=remat, **extra)
            grads = torch.autograd.grad(loss, req, materialize_grads=True)
        updates, opt_state = opt.update(tree_unflatten(struct, list(grads)),
                                        opt_state, params)
        del grads
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss.detach()}

    return TrainStep(fn=train_step, opt=opt, guard=guard, api=api)


class _CompiledTrainStep:
    """A :class:`TrainStep`'s ``fn`` compiled: one CUDA graph per key
    (:mod:`repro_torch.core.stepgraph`), the counterpart of the
    reference's ``jax.jit(train_step)`` with ``donate_argnums=(0, 1)``.

    Called as the step is: ``(params, opt_state, batch) -> (params,
    opt_state, {"loss": loss})``.  The params and the optimizer's moments
    are resident: the graph addresses them, and the step updates them in
    place and hands the same tensors back (else :class:`StepCaptureError`,
    as :meth:`GraphMaker.run` holds a manager's steps to its arena).
    The step counter and every batch tensor are staged; the loss and the
    new counter are copied out.  The key is the operands' structure, the
    staged tensors' shapes and dtypes and the resident tensors' identities
    (:meth:`Operands.key`): N steps of one batch shape replay one graph.
    Params or moments other than the ones the graphs address (a restored
    checkpoint's) drop every graph and return its pool before the new key
    is captured.

    On the card the first call of a key runs the step eagerly on a side
    stream, then captures forward, backward, clipping, the schedule and
    AdamW's update into one graph, the warm-up's cached blocks released
    first (a step's temporaries need not fit twice); later calls replay,
    with no host sync.  A step that cannot be captured raises
    :class:`StepCaptureError` naming it, on that call and on every later
    call of its key: it never runs eagerly instead (the failing call's
    warm-up has updated the params and moments once).  On the CPU the
    same object runs the step on the same staged operands."""

    def __init__(self, step: TrainStep):
        self.step = step
        self.name = getattr(step.fn, "__name__", "train_step")
        self.graphs: Dict[Hashable, StepGraph] = {}
        self._failed: Dict[Hashable, StepCaptureError] = {}
        self._resident: Optional[Tuple] = None
        self._maker: Optional[GraphMaker] = None
        self._pool = None

    def _run(self, params, moments, count, batch):
        params, state, out = self.step.fn(
            params, {"step": count, **moments}, batch)
        return params, {k: state[k] for k in moments}, state["step"], out

    def release(self) -> None:
        """Drop every graph; on the card their pool is returned."""
        cuda = any(g.device.type == "cuda" for g in self.graphs.values())
        self.graphs.clear()
        self._failed.clear()
        self._resident = None
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()

    def _graph(self, ops: Operands) -> StepGraph:
        device = ops.leaves[ops.resident[0]].device if ops.resident \
            else torch.device("cpu")
        if self._maker is None or self._maker.device != device:
            self._maker = GraphMaker(device)
        if device.type == "cuda" and not self.graphs:
            # a pool whose last graph died cannot be captured into again
            self._pool = torch.cuda.graph_pool_handle()
        return self._maker.graph(self.name, self._run, ops, self._pool,
                                 release=device.type == "cuda")

    def __call__(self, params, opt_state, batch):
        moments = {k: v for k, v in opt_state.items() if k != "step"}
        ops = Operands.of((params, moments, opt_state["step"], batch),
                          (True, True, False, False))
        resident = ops.key()
        if resident != self._resident:
            self.release()
            self._resident = resident
        skip = set(ops.resident)
        key = (ops.struct, tuple(
            (tuple(x.shape), x.dtype, x.device)
            if isinstance(x, torch.Tensor) else x
            for i, x in enumerate(ops.leaves) if i not in skip))
        if key in self._failed:
            raise self._failed[key]
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = self._graph(ops)
        try:
            params_out, moments_out, count, out = GraphMaker.run(
                graph, ops, tree_flatten((params, moments))[1],
                "its params and optimizer moments")
        except StepCaptureError as err:
            del self.graphs[key]
            self._failed[key] = err
            raise
        return params_out, {k: count if k == "step" else moments_out[k]
                            for k in opt_state}, out


def compile_train_step(step: TrainStep) -> "_CompiledTrainStep":
    """``step.fn`` as one CUDA graph per key (:class:`_CompiledTrainStep`,
    named in a capture error by the step function's name)."""
    return _CompiledTrainStep(step)



# ---------------------------------------------------------------------------
# Step bundles: a step with its abstract inputs and their placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepBundle:
    """A step and what the reference's ``pjit`` would need of it:

    * ``fn`` — the step (``fn(params, cache, batch_or_tokens) -> (cache,
      logits)`` to serve, ``fn(params, opt_state, batch) -> (params,
      opt_state, {"loss"})`` to train), on the mesh's device
      (:func:`_on_mesh`);
    * ``step`` — the same step before :func:`_on_mesh` binds it (a
      shape-only mesh's ``fn`` refuses to run; the dry run traces
      ``step`` over ``in_specs``);
    * ``in_specs`` — its inputs as ``meta`` tensors (nothing allocated);
    * ``in_shardings`` / ``out_shardings`` — each input's and output's
      placement, a tree of mesh-axis tuples (``()`` replicated);
    * ``donate_argnums`` — the inputs the step updates in place (the
      cache; params and optimizer state to train);
    * ``rules``, ``api``.

    On a ``DeviceMesh`` of the bundle's mesh (:meth:`repro_torch.launch.
    mesh.Mesh.open`), :meth:`partitioned` is ``step`` as one rank's
    program: the reference's ``jax.jit(fn, in_shardings=,
    out_shardings=)`` after its SPMD partitioner."""

    fn: Callable
    step: Callable
    in_specs: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    rules: ShardingRules
    api: ModelAPI

    def partitioned(self, device_mesh) -> Tuple[Callable, Tuple]:
        """``(fn, specs)``: ``step`` over DTensors placed by
        ``in_shardings`` on ``device_mesh``, its results redistributed to
        ``out_shardings``, taking and returning rank 0's local shards
        (:func:`repro_torch.distributed.partition.partitioned`), and its
        inputs as ``meta`` tensors of those shards' shapes.  Donation is
        the bundle's: the step writes the cache (params, moments) in
        place, so a donated shard comes back as the same storage."""
        from repro_torch.distributed.partition import local_specs, \
            partitioned
        return (partitioned(self.step, device_mesh, self.in_shardings,
                            self.out_shardings, self.in_specs),
                local_specs(device_mesh, self.in_shardings, self.in_specs))


def _axis_size(mesh, axis) -> int:
    """Devices along a mapped mesh axis (a name, a tuple of names, None)."""
    names = () if axis is None else (axis,) if isinstance(axis, str) \
        else axis
    return math.prod(mesh.shape[a] for a in names)


def _shard_tree(mesh, rules: ShardingRules, axes_tree, shape_tree):
    """Logical axes -> placements over the ``meta`` tensors of
    ``shape_tree``: a dimension whose size the mapped mesh axes do not
    divide is replicated instead (an input placement must divide
    exactly)."""
    def one(axes, shaped):
        checked = []
        for i, logical in enumerate(axes):
            mesh_axis = rules.lookup(logical) if logical else None
            if mesh_axis is not None and \
                    shaped.shape[i] % _axis_size(mesh, mesh_axis) != 0:
                mesh_axis = None
            checked.append(mesh_axis)
        return tuple(checked)

    return tree_map(one, axes_tree, shape_tree)


def _batch_axes(specs: Dict[str, torch.Tensor]) -> Dict[str, Tuple]:
    return {k: ("batch",) + (None,) * (v.dim() - 1)
            for k, v in specs.items()}


def _kv_pool_axes(mesh, n_kv_heads: int) -> Tuple:
    """(L, slots, P, page, KH, D) axes of a KV pool
    (:func:`~repro_torch.models.kvcache.kv_cache_axes`'s): KH over the
    model axis when it divides, else the head dim, so the pool is never
    replicated across TP ranks."""
    kv = KV.kv_cache_axes()["k"]
    if n_kv_heads % mesh.shape.get("model", 1) == 0:
        return kv
    return kv[:4] + (None, "heads")


def _paged_axes(mesh, n_kv_heads: int) -> KV.PagedKVCache:
    kv = _kv_pool_axes(mesh, n_kv_heads)
    return KV.PagedKVCache(**dict(KV.kv_cache_axes(), k=kv, v=kv))


def _state_axes(cache_shape: KV.StateCache) -> KV.StateCache:
    pools = {name: (None, "pages") + (None,) * (arr.dim() - 2)
             for name, arr in cache_shape.pools.items()}
    return KV.StateCache(pools=pools, slot_ids=("batch",),
                         seq_lens=("batch",))


def cache_axes(mesh, cfg: ModelConfig, cache_shape):
    """The logical axes of a cache tree (structure-matched to it), for
    every cache type: slab KV, state, hybrid, encoder-decoder.  ``mesh``
    is read for its ``shape`` only."""
    if isinstance(cache_shape, KV.PagedKVCache):
        return _paged_axes(mesh, cfg.n_kv_heads)
    if isinstance(cache_shape, KV.StateCache):
        return _state_axes(cache_shape)
    if isinstance(cache_shape, HybridCache):
        return HybridCache(kv=_paged_axes(mesh, cfg.n_kv_heads),
                           state=_state_axes(cache_shape.state))
    if isinstance(cache_shape, EncDecCache):
        kv = _paged_axes(mesh, cfg.n_kv_heads)
        # the cross pools (L, slots, S_src, KH, D): the KV pool's axes
        # without its page axis
        cross = kv.k[:2] + kv.k[3:]
        return EncDecCache(kv=kv, cross_k=cross, cross_v=cross,
                           src_lens=("batch",))
    raise TypeError(type(cache_shape))


#: the reference's ``kv_dtype`` names -> the pool's type ("f8": the
#: float8 e4m3 pool)
_KV_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
              "f8": torch.float8_e4m3fn}


def params_spec(api: ModelAPI):
    """The model's params as ``meta`` tensors (no weights drawn)."""
    return api.init(torch.Generator(), "meta")


def _on_mesh(mesh, fn: Callable) -> Callable:
    """``fn`` bound to the mesh's one device: every tensor it is given
    must lie there, else it raises (on one card every mesh axis has size
    1, so a placement splits nothing and the operands' device is where
    the step runs).  A mesh reckoned as a shape only (no device, or more
    than one) gives a step that refuses to run."""
    if len(mesh.devices) != 1:
        def shape_only(*args):
            raise ValueError(f"{describe(mesh)}: a shape only, a bundle "
                             "runs on a one-device mesh")
        return shape_only
    dev = mesh.devices[0]

    def run(*args):
        for leaf in tree_flatten(args)[1]:
            if isinstance(leaf, torch.Tensor) and (
                    leaf.device.type != dev.type
                    or dev.index not in (None, leaf.device.index)):
                raise ValueError(f"an operand on {leaf.device}, off the "
                                 f"mesh's device {dev}")
        return fn(*args)
    return run


def _cache_shape_for(api: ModelAPI, cfg: ModelConfig, shape: ShapeConfig,
                     kv_dtype: str = "bf16"):
    if cfg.family == "ssm":
        return api.init_cache(shape.global_batch, device="meta")
    return api.init_cache(shape.global_batch, shape.seq_len,
                          dtype=_KV_DTYPES[kv_dtype], device="meta")


def _serve_bundle(cfg, shape, mesh, step, inputs_spec, inputs_axes,
                  kv_dtype, rules) -> StepBundle:
    api = get_model(cfg)
    params_shape = params_spec(api)
    cache_shape = _cache_shape_for(api, cfg, shape, kv_dtype)
    p_shard = _shard_tree(mesh, rules, api.param_logical_axes(),
                          params_shape)
    c_shard = _shard_tree(mesh, rules, cache_axes(mesh, cfg, cache_shape),
                          cache_shape)
    x_shard = _shard_tree(mesh, rules, inputs_axes, inputs_spec)
    logits = torch.empty((shape.global_batch, cfg.vocab),
                         dtype=torch.float32, device="meta")
    return StepBundle(
        fn=_on_mesh(mesh, step),
        step=step,
        in_specs=(params_shape, cache_shape, inputs_spec),
        in_shardings=(p_shard, c_shard, x_shard),
        out_shardings=(c_shard, _shard_tree(mesh, rules, ("batch", "vocab"),
                                            logits)),
        donate_argnums=(1,),
        rules=rules,
        api=api,
    )


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       guard_enabled: bool = True,
                       policy: FencePolicy = FencePolicy.BITWISE,
                       kv_dtype: str = "bf16") -> StepBundle:
    """``fn(params, cache, batch) -> (cache, last_logits)``:
    ``api.prefill`` under :func:`make_guard`'s guard, writing the cache in
    place (the reference donates it); the cache is the slab layout of
    ``api.init_cache(global_batch, seq_len, dtype=kv_dtype)``."""
    api = get_model(cfg)
    rules = make_rules(mesh, fsdp=False)    # serving: weights TP-only
    guard = make_guard(cfg, shape, policy, guard_enabled)

    def prefill_step(params, cache, batch):
        return api.prefill(params, cache, batch, guard=guard, rules=rules)

    batch_specs = api.batch_specs(shape)
    return _serve_bundle(cfg, shape, mesh, prefill_step, batch_specs,
                         _batch_axes(batch_specs), kv_dtype, rules)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                      guard_enabled: bool = True,
                      policy: FencePolicy = FencePolicy.BITWISE,
                      kv_dtype: str = "bf16") -> StepBundle:
    """``fn(params, cache, tokens) -> (cache, logits)``: one
    ``api.decode`` step under :func:`make_guard`'s guard, appending to the
    cache in place."""
    api = get_model(cfg)
    rules = make_rules(mesh, fsdp=False)
    guard = make_guard(cfg, shape, policy, guard_enabled)

    def decode_step(params, cache, tokens):
        return api.decode(params, cache, tokens, guard=guard, rules=rules)

    tokens_spec = torch.empty((shape.global_batch,), dtype=torch.int32,
                              device="meta")
    return _serve_bundle(cfg, shape, mesh, decode_step, tokens_spec,
                         ("batch",), kv_dtype, rules)


def build_train_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       fsdp: bool = True, **kw) -> StepBundle:
    """:func:`build_train_step`'s step as a bundle: params, optimizer state
    and batch as ``meta`` tensors, each moment tree placed as the params
    are (the step counter, and a factored moment, replicated),
    ``donate_argnums=(0, 1)``.  ``kw`` are :func:`build_train_step`'s."""
    rules = make_rules(mesh, fsdp=fsdp)
    step = build_train_step(cfg, shape, rules=rules, **kw)
    api = step.api
    params_shape = params_spec(api)
    opt_shape = step.opt.init(params_shape)
    batch_specs = api.batch_specs(shape)
    p_shard = _shard_tree(mesh, rules, api.param_logical_axes(),
                          params_shape)
    like_params = tree_flatten(params_shape)[0]
    o_shard = {k: p_shard if tree_flatten(v)[0] == like_params else
               tree_map(lambda a: (), v,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
               for k, v in opt_shape.items()}
    b_shard = _shard_tree(mesh, rules, _batch_axes(batch_specs),
                          batch_specs)
    return StepBundle(
        fn=_on_mesh(mesh, step.fn),
        step=step.fn,
        in_specs=(params_shape, opt_shape, batch_specs),
        in_shardings=(p_shard, o_shard, b_shard),
        out_shardings=(p_shard, o_shard, {"loss": ()}),
        donate_argnums=(0, 1),
        rules=rules,
        api=api,
    )


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               **kw) -> StepBundle:
    """The bundle of ``shape.kind``: train, prefill or decode."""
    if shape.kind == "train":
        kw.pop("kv_dtype", None)
        return build_train_bundle(cfg, shape, mesh, **kw)
    kw.pop("moe_dispatch", None)
    kw.pop("remat_policy", None)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, **kw)
    return build_decode_step(cfg, shape, mesh, **kw)

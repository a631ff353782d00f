"""Step builders: the engine's prefill/decode as trusted manager kernels,
the elastic relocation steps of the flat arena and of a serve engine's
slab pool, and the train step (:func:`make_guard`,
:func:`build_train_step`).

Steps run on the manager's device, as compiled steps (one CUDA graph per
operand signature, :mod:`repro_torch.core.stepgraph`) unless the manager's
``jit_trusted`` is off.  Where the reference threads a new pool value
through each step, the port's steps write the pool tensors in place and
hand the same tensors back, so the manager's ``PoolArena.buf`` bookkeeping
is unchanged and a replay addresses the same pool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.fence import FenceParams, FencePolicy, \
    guarded_dynamic_slice, guarded_dynamic_update_slice
from repro_torch.core.partition import next_pow2
from repro_torch.core.stepgraph import tree_flatten, tree_unflatten
from repro_torch.launch import sampling
from repro_torch.models import kvcache as KV
from repro_torch.models.api import ModelAPI, get_model
from repro_torch.models.guard import GuardSpec
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
                     device="cuda") -> TrainStep:
    """The reference's ``train_step`` (``repro/launch/steps.py``) on one
    device, without a mesh: the loss and its gradient through
    ``api.loss`` under :func:`make_guard`'s guard, AdamW under
    ``schedule`` (default: the reference's ``cosine(peak_lr, 2_000,
    100_000)``), the update applied.  ``device`` is where the step's
    params live; the step itself runs wherever its operands are."""
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
                            remat=remat, **extra)
            grads = torch.autograd.grad(loss, req, materialize_grads=True)
        updates, opt_state = opt.update(tree_unflatten(struct, list(grads)),
                                        opt_state, params)
        del grads
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss.detach()}

    return TrainStep(fn=train_step, opt=opt, guard=guard, api=api)

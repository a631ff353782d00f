"""Step builders for the serving plane: the engine's prefill/decode as
trusted manager kernels, and the elastic relocation step of the flat
arena.

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

from repro_torch.core.fence import FenceParams, FencePolicy, \
    guarded_dynamic_slice, guarded_dynamic_update_slice
from repro_torch.models.api import ModelAPI


def split_cache_pool(cache) -> Tuple[Dict, Any]:
    """Split a serve cache into ``(pool, meta)``: ``pool`` holds the
    slot-indexed KV page tensors (a manager-owned :class:`PoolArena` that
    N serve engines share), ``meta`` is the same cache dataclass with the
    pool fields stripped (per-batch-row state only: page tables, seq
    lens).  Inverse of :func:`join_cache_pool`."""
    return {"k": cache.k, "v": cache.v}, \
        dataclasses.replace(cache, k=None, v=None)


def join_cache_pool(pool: Dict, meta) -> Any:
    """Rebuild the full cache from a pool dict + meta cache."""
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
                              verify: bool = False) -> TrustedStepBundle:
    """Trusted greedy prefill/decode step functions for one model API.

    The step rebuilds the cache from the manager-threaded pool + the
    engine's meta operand, runs the model (pool writes in place), and
    splits the result back; the next ids are the argmax of the logits,
    taken on the device — the engine never materialises the (B, vocab)
    logits on the host.

    ``pool_key`` identifies the pool geometry; ``step_key`` (default:
    ``pool_key``) additionally carries the model identity.  ``verify``
    registers both steps with the manager's extent-mode proof obligation.
    The sampled decode of the reference is not ported yet."""
    sk = step_key or pool_key

    def prefill_step(arena, pool, params, meta, batch, guard):
        cache = join_cache_pool(pool, meta)
        cache, logits = api.prefill(params, cache, batch, guard=guard)
        new_pool, new_meta = split_cache_pool(cache)
        return arena, new_pool, (
            new_meta, torch.argmax(logits, -1).to(torch.int32))

    def decode_step(arena, pool, params, meta, toks, guard):
        cache = join_cache_pool(pool, meta)
        cache, logits = api.decode(params, cache, toks, guard=guard)
        new_pool, new_meta = split_cache_pool(cache)
        return arena, new_pool, (
            new_meta, torch.argmax(logits, -1).to(torch.int32))

    return TrustedStepBundle(
        pool_name=f"serve.pool[{pool_key}]",
        prefill_name=f"serve.prefill[{sk}]",
        decode_name=f"serve.decode[{sk}]",
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

"""zamba2-7b — hybrid backbone: Mamba2 (SSD) layers with a *shared*
full-attention + MLP block invoked after every ``attn_every`` SSD layers.
A port of ``repro/models/hybrid.py``.

Layer layout for n_layers = 81, attn_every = 6:

    [6 mamba] attn* [6 mamba] attn* ... (13 groups) ... [3 mamba tail]

where ``attn*`` is the same parameter block every time (zamba2's weight
sharing), under the config's sliding window.

Params: ``mamba`` is one list of ``attn_every`` block dicts per group,
``mamba_tail`` (when n_layers is not a multiple of attn_every) one block
dict per tail layer, ``shared_attn`` one dict; the reference stacks the
blocks and scans, the port loops.

Training (:func:`forward` / :func:`loss_fn`) is the reference's: every
block full-sequence, the shared attention through K4 under the window,
the embedding through K3, differentiated through their registered
backwards.

Serving state per request (:class:`HybridCache`): one windowed KV slab per
shared-attention invocation in the slab pool (prefill writes the prompt's
trailing window with ``write_prefill_kv``; decode appends with
``append_token_kv`` and attends through the paged-attention kernel K1
over the slab view, under the window), and per-Mamba-layer SSM / conv
state in the state pool.  Prefill attention runs K4 under the window.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingRules, constrain
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as TF
from repro_torch.models.guard import GuardSpec

Params = Dict[str, Any]


def group_structure(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups of attn_every mamba layers each followed by the shared
    attention, n_tail mamba layers)."""
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


def n_attn_calls(cfg: ModelConfig) -> int:
    return group_structure(cfg)[0]


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    """Random weights from ``generator`` (which must live on ``device``)."""
    g, tail = group_structure(cfg)
    p: Params = {
        "embed": L.embedding_init(generator, cfg, device),
        "mamba": [[M2.block_init(generator, cfg, device)
                   for _ in range(cfg.attn_every)] for _ in range(g)],
        "shared_attn": {
            "attn": L.attention_init(generator, cfg, device),
            "mlp": L.mlp_init(generator, cfg, device),
            "norm1": L.norm_init(cfg, device),
            "norm2": L.norm_init(cfg, device),
        },
        "norm_f": L.norm_init(cfg, device),
    }
    if tail:
        p["mamba_tail"] = [M2.block_init(generator, cfg, device)
                           for _ in range(tail)]
    return p


def param_logical_axes(cfg: ModelConfig) -> Params:
    """Logical axes matching :func:`init`'s tree: the reference's
    ``(None, None, *axes)`` group leaves become ``axes`` on each block of
    each group, its ``(None, *axes)`` tail leaves ``axes`` on each tail
    block."""
    g, tail = group_structure(cfg)
    p: Params = {
        "embed": L.embedding_axes(cfg),
        "mamba": [[M2.block_axes(cfg) for _ in range(cfg.attn_every)]
                  for _ in range(g)],
        "shared_attn": {
            "attn": L.attention_axes(cfg),
            "mlp": L.mlp_axes(cfg),
            "norm1": L.norm_axes(cfg),
            "norm2": L.norm_axes(cfg),
        },
        "norm_f": L.norm_axes(cfg),
    }
    if tail:
        p["mamba_tail"] = [M2.block_axes(cfg) for _ in range(tail)]
    return p


def _shared_qkv(cfg, sa, x, positions):
    q, k, v = L.qkv_proj(cfg, sa["attn"], L.apply_norm(cfg, sa["norm1"], x))
    q, k = L.positions_rope(cfg, q, k, positions)
    return q, k, v


def _shared_out(cfg, sa, x, o):
    x = x + L.out_proj(cfg, sa["attn"], o)
    return x + L.mlp_apply(cfg, sa["mlp"], L.apply_norm(cfg, sa["norm2"], x))


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *,
            guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence logits (B, S, V).  The shared attention runs K4,
    causal, under the config's window.  ``remat`` recomputes each group
    (its ``attn_every`` Mamba2 blocks and the shared attention) in the
    backward pass, as the reference's ``jax.checkpoint(nothing_saveable)``
    over its group scan; the tail blocks are not recomputed."""
    B, S = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, guard)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None, :].expand(B, S)
    sa = params["shared_attn"]

    def group(blocks, x):
        for p in blocks:
            x = constrain(x + M2.block_apply(cfg, p, x)[0], rules,
                          ("batch", "seq", None))
        q, k, v = _shared_qkv(cfg, sa, x, positions)
        return (_shared_out(cfg, sa, x, L.prefill_attention(cfg, q, k, v)),)

    (x,) = TF.run_layers(group, params["mamba"], x, remat=remat)
    for p in params.get("mamba_tail", ()):
        x = constrain(x + M2.block_apply(cfg, p, x)[0], rules,
                      ("batch", "seq", None))
    x = L.apply_norm(cfg, params["norm_f"], x)
    return L.lm_logits(cfg, params["embed"], x)


#: mean next-token NLL (``transformer.next_token_loss``), remat on
loss_fn = functools.partial(TF.next_token_loss, forward)


# ---------------------------------------------------------------------------
# Serving — hybrid cache: windowed-KV slabs + SSM state pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HybridCache:
    kv: KV.PagedKVCache          # n_attn_calls layers, windowed
    state: KV.StateCache         # per-mamba-layer ssm + conv state


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, slots: Optional[int] = None,
               device="cuda") -> HybridCache:
    """A slab KV cache of ``min(max_len, window)`` tokens a slot for the
    shared block's invocations and zeroed ``ssm`` / ``conv`` state pools of
    ``slots`` slots (default ``pow2(batch)``)."""
    g, _ = group_structure(cfg)
    window = cfg.attn_window or max_len
    kv = KV.init_kv_cache(cfg, batch, min(max_len, window), dtype=dtype,
                          n_layers=g, slots=slots, device=device)
    shapes = M2.state_shapes(cfg)
    if slots is None:
        slots = KV._pow2_at_least(batch)
    i32 = dict(dtype=torch.int32, device=device)
    pools = {
        "ssm": torch.zeros((cfg.n_layers, slots, *shapes["ssm"]),
                           dtype=torch.float32, device=device),
        "conv": KV.zeros((cfg.n_layers, slots, *shapes["conv"]), dtype,
                         device),
    }
    state = KV.StateCache(pools=pools, slot_ids=torch.arange(batch, **i32),
                          seq_lens=torch.zeros((batch,), **i32))
    return HybridCache(kv=kv, state=state)


def _layers(cfg: ModelConfig, params: Params):
    """Every Mamba block with its layer index into the state pool, in
    order, each group's last block followed by the shared attention: yields
    (lidx, block params, group index or None)."""
    for gi, group in enumerate(params["mamba"]):
        for li, p in enumerate(group):
            yield gi * cfg.attn_every + li, p, \
                gi if li == len(group) - 1 else None
    g = len(params["mamba"])
    for li, p in enumerate(params.get("mamba_tail", ())):
        yield g * cfg.attn_every + li, p, None


def prefill(cfg: ModelConfig, params: Params, cache: HybridCache,
            tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None
            ) -> Tuple[HybridCache, torch.Tensor]:
    """Process the prompt: SSD blocks full-sequence, their final states
    written to the state pool; each shared-attention invocation's trailing
    window of KV (the slab's capacity, zero-padded) written to its slab; the
    last position's logits (B, V).  Pools are written in place."""
    B, S = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, guard)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, S)
    state, kvc = cache.state, cache.kv
    window = kvc.max_len
    plan = KV.prefill_plan(kvc, window, guard)
    sa = params["shared_attn"]
    K1 = cfg.ssm.conv_width - 1
    for lidx, p, gi in _layers(cfg, params):
        y, h_f, tail_c = M2.block_apply(cfg, p, x)
        state.write("ssm", lidx, h_f, guard)
        state.write("conv", lidx, tail_c[:, -K1:], guard)
        x = x + y
        if gi is None:
            continue
        q, k, v = _shared_qkv(cfg, sa, x, positions)
        x = _shared_out(cfg, sa, x, L.prefill_attention(cfg, q, k, v))
        # stash the trailing window of KV for decode
        kw, vw = (t[:, -window:] if S >= window else t for t in (k, v))
        pad = window - kw.shape[1]
        if pad:
            kw, vw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (kw, vw))
        KV.write_prefill_kv(kvc, gi, kw, vw, guard, plan=plan)
        x = constrain(x, rules, ("batch", "seq", None))
    kvc = dataclasses.replace(kvc, seq_lens=torch.clamp(kvc.seq_lens + S,
                                                        max=window))
    state = dataclasses.replace(state, seq_lens=state.seq_lens + S)
    x = L.apply_norm(cfg, params["norm_f"], x[:, -1:])
    logits = L.lm_logits(cfg, params["embed"], x)
    return HybridCache(kv=kvc, state=state), logits[:, 0]


def _decode_shared_attn(cfg, params, cache: KV.PagedKVCache, x, lidx,
                        positions, guard, plan):
    """The shared block at one decode invocation.  The reference's comment
    says the write position wraps modulo the window; its code clamps it to
    the slab's last slot (``max_len - 1``) and attends over ``min(seq_lens
    + 1, max_len)`` tokens — mirrored here: once the slab is full every
    step overwrites its last slot.  ``plan`` is the step's slab decode
    plan at the clamped position."""
    sa = params["shared_attn"]
    q, k, v = _shared_qkv(cfg, sa, x, positions)
    KV.append_token_kv(cache, lidx, k, v, guard, plan=plan)
    kv_len = torch.clamp(cache.seq_lens + 1, max=cache.max_len)
    o = KV.paged_decode_attention(cache, lidx, q, kv_len, guard, plan=plan,
                                  window=cfg.attn_window)
    return _shared_out(cfg, sa, x, o)


def decode(cfg: ModelConfig, params: Params, cache: HybridCache,
           tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None,
           rules: Optional[ShardingRules] = None
           ) -> Tuple[HybridCache, torch.Tensor]:
    """One decode step through the hybrid stack: tokens (B,) -> logits
    (B, V); pools written in place."""
    x = L.embed_tokens(params["embed"], tokens[:, None], guard)
    state, kvc = cache.state, cache.kv
    positions = state.seq_lens[:, None]
    # the write position clamps to the slab's last slot (see
    # _decode_shared_attn); one plan serves every invocation
    clamped = dataclasses.replace(
        kvc, seq_lens=torch.clamp(kvc.seq_lens, max=kvc.max_len - 1))
    plan = KV.decode_plan(clamped, guard)
    for lidx, p, gi in _layers(cfg, params):
        h = state.read("ssm", lidx, guard)
        tail_c = state.read("conv", lidx, guard)
        y, h_new, tail_new = M2.block_step(cfg, p, x, h, tail_c)
        state.write("ssm", lidx, h_new, guard)
        state.write("conv", lidx, tail_new, guard)
        x = x + y
        if gi is not None:
            x = _decode_shared_attn(cfg, params, kvc, x, gi, positions,
                                    guard, plan)
    kvc = KV.advance(kvc, 1)
    state = dataclasses.replace(state, seq_lens=state.seq_lens + 1)
    x = L.apply_norm(cfg, params["norm_f"], x)
    logits = L.lm_logits(cfg, params["embed"], x)
    return HybridCache(kv=kvc, state=state), logits[:, 0]

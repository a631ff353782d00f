"""Encoder-decoder backbone — seamless-m4t-medium (``repro/models/
encdec.py``).

The audio frontend is a stub: the encoder consumes precomputed frame
embeddings (B, S_src, d).  The decoder is causal self-attention over the
slab KV cache (fenced slot and page ids) plus cross-attention to the
encoder's memory, computed once per request and stashed per slot in a
cross-attention pool ``(L, slots, S_src, KH, D)`` whose slot ids are
fenced like the slab's.

Kernels: the embedding gather runs K3; the encoder's self-attention and
every cross-attention over a whole target run K4 with ``causal=False``
(cross-attention over a key length of its own, S_src); the decoder's
prefill self-attention runs K4 causal, its slab write the dense path's
(``KV.write_prefill_kv`` with a :func:`~repro_torch.models.kvcache.
prefill_plan`), and a decode step runs K1 twice a layer: over the slab's
flattened layer view (:func:`~repro_torch.models.kvcache.decode_plan`)
and over the cross pool's layer view flattened to pages (the step's
:class:`CrossPlan`).  The cross stash is an indexed store (the reference
computes it outside any Pallas kernel); rows sharing a slot resolve
last-writer-wins.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import matmul, split_heads
from repro_torch.distributed.sharding import ShardingRules, constrain
from repro_torch.kernels import paged_attention
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models.guard import GuardSpec, fence
from repro_torch.models.transformer import run_layers, train_positions

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    """Random weights from ``generator`` (which must live on ``device``),
    in the config's dtype: ``enc`` (``cfg.enc_layers`` blocks) and ``dec``
    (``cfg.n_layers`` blocks with a cross-attention each)."""
    def enc_layer():
        return {"attn": L.attention_init(generator, cfg, device),
                "mlp": L.mlp_init(generator, cfg, device),
                "norm1": L.norm_init(cfg, device),
                "norm2": L.norm_init(cfg, device)}

    def dec_layer():
        return {"attn": L.attention_init(generator, cfg, device),
                "cross": L.attention_init(generator, cfg, device),
                "mlp": L.mlp_init(generator, cfg, device),
                "norm1": L.norm_init(cfg, device),
                "norm_x": L.norm_init(cfg, device),
                "norm2": L.norm_init(cfg, device)}

    return {
        "embed": L.embedding_init(generator, cfg, device),
        "enc": [enc_layer() for _ in range(cfg.enc_layers)],
        "dec": [dec_layer() for _ in range(cfg.n_layers)],
        "norm_enc": L.norm_init(cfg, device),
        "norm_f": L.norm_init(cfg, device),
    }


def param_logical_axes(cfg: ModelConfig) -> Params:
    """Logical axes matching :func:`init`'s tree, one dict per block."""
    def enc_layer():
        return {"attn": L.attention_axes(cfg), "mlp": L.mlp_axes(cfg),
                "norm1": L.norm_axes(cfg), "norm2": L.norm_axes(cfg)}

    def dec_layer():
        return {"attn": L.attention_axes(cfg),
                "cross": L.attention_axes(cfg), "mlp": L.mlp_axes(cfg),
                "norm1": L.norm_axes(cfg), "norm_x": L.norm_axes(cfg),
                "norm2": L.norm_axes(cfg)}

    return {
        "embed": L.embedding_axes(cfg),
        "enc": [enc_layer() for _ in range(cfg.enc_layers)],
        "dec": [dec_layer() for _ in range(cfg.n_layers)],
        "norm_enc": L.norm_axes(cfg),
        "norm_f": L.norm_axes(cfg),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params: Params, src: torch.Tensor,
           remat: bool = False,
           rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """src: precomputed frame embeddings (B, S_src, d) -> memory, through
    the encoder's non-causal self-attention (K4, ``causal=False``)."""
    B, S, _ = src.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=src.device)[None, :].expand(B, S)

    def layer(p, x):
        q, k, v = L.qkv_proj(cfg, p["attn"],
                             L.apply_norm(cfg, p["norm1"], x))
        q, k = L.positions_rope(cfg, q, k, positions)
        x = x + L.out_proj(cfg, p["attn"], L.full_attention(q, k, v))
        x = x + L.mlp_apply(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))
        return (constrain(x, rules, ("batch", "seq", None)),)

    (x,) = run_layers(layer, params["enc"], src, remat=remat)
    return L.apply_norm(cfg, params["norm_enc"], x)


# ---------------------------------------------------------------------------
# Decoder (training / scoring)
# ---------------------------------------------------------------------------

def _cross_kv(cfg: ModelConfig, p: Params, memory: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention keys and values of ``memory``
    (B, S_src, d) -> (B, S_src, KH, D) each."""
    return tuple(split_heads(matmul(memory, p["cross"][w]), cfg.n_kv_heads)
                 for w in ("wk", "wv"))


def _cross_q(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xn = L.apply_norm(cfg, p["norm_x"], x)
    return split_heads(matmul(xn, p["cross"]["wq"]), cfg.n_heads)


def _cross_attn(cfg: ModelConfig, p: Params, x: torch.Tensor,
                memory: torch.Tensor) -> torch.Tensor:
    """Cross-attention: queries from x, keys / values from the encoder's
    memory, through K4 over the memory's length."""
    k, v = _cross_kv(cfg, p, memory)
    o = L.full_attention(_cross_q(cfg, p, x), k, v)
    return L.out_proj(cfg, p["cross"], o)


def decode_train(cfg: ModelConfig, params: Params, tgt: torch.Tensor,
                 memory: torch.Tensor, *, guard: Optional[GuardSpec] = None,
                 rules: Optional[ShardingRules] = None,
                 remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder: tgt (B, S) over memory (B, S_src, d) ->
    logits (B, S, V)."""
    positions = train_positions(tgt)
    x = L.embed_tokens(params["embed"], tgt, guard)

    def layer(p, x):
        q, k, v = L.qkv_proj(cfg, p["attn"],
                             L.apply_norm(cfg, p["norm1"], x))
        q, k = L.positions_rope(cfg, q, k, positions)
        x = x + L.out_proj(cfg, p["attn"], L.prefill_attention(cfg, q, k, v))
        x = x + _cross_attn(cfg, p, x, memory)
        x = x + L.mlp_apply(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))
        return (constrain(x, rules, ("batch", "seq", None)),)

    (x,) = run_layers(layer, params["dec"], x, remat=remat)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return L.lm_logits(cfg, params["embed"], x)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token NLL of ``batch["tgt"]`` (B, S + 1) given the frames
    ``batch["src"]``, masked by ``batch["mask"]`` when given."""
    memory = encode(cfg, params, batch["src"], remat, rules)
    tgt = batch["tgt"]
    logits = decode_train(cfg, params, tgt[:, :-1], memory, guard=guard,
                          rules=rules, remat=remat)
    return L.softmax_cross_entropy(logits, tgt[:, 1:], batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving — decoder KV slabs + per-slot cross-attention memory pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncDecCache:
    """The decoder's slab cache plus the cross-attention pools ``(L,
    slots, S_src, KH, D)`` on the slab's slot axis, and each row's source
    length.  ``cross_k`` / ``cross_v`` are ``None`` in a serve engine's
    meta half (:func:`repro_torch.launch.steps.split_cache_pool`)."""

    kv: KV.PagedKVCache
    cross_k: Optional[torch.Tensor]
    cross_v: Optional[torch.Tensor]
    src_lens: torch.Tensor       # (B,) int32


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int,
               dtype=torch.bfloat16, device="cuda") -> EncDecCache:
    """The slab cache of ``batch`` rows and ``max_len`` tokens and zeroed
    cross pools of ``src_len`` frames a slot, in ``dtype``."""
    kv = KV.init_kv_cache(cfg, batch, max_len, dtype=dtype, device=device)
    shape = (cfg.n_layers, kv.k.shape[1], src_len, cfg.n_kv_heads,
             cfg.head_dim)
    return EncDecCache(
        kv=kv,
        cross_k=KV.zeros(shape, dtype, device),
        cross_v=KV.zeros(shape, dtype, device),
        src_lens=torch.zeros((batch,), dtype=torch.int32, device=device))


def cross_page(src_len: int) -> int:
    """Tokens a page of the cross pool's K1 view: the slab's page size
    when it tiles ``src_len`` in a power-of-two number of pages (K1's view
    must hold a power of two of pages), else the whole source."""
    n = src_len // KV.PAGE_SIZE
    if src_len % KV.PAGE_SIZE == 0 and n & (n - 1) == 0:
        return KV.PAGE_SIZE
    return src_len


@dataclasses.dataclass(frozen=True)
class CrossPlan:
    """What every layer of one decode step's cross-attention shares,
    fenced once a step: K1's page ids into the cross pool's layer view
    flattened to ``(slots * S_src / page, page, KH, D)`` — row b's ids are
    ``fenced_slot * (S_src / page) + j``."""

    page: int
    view_pages: torch.Tensor     # (B, S_src / page) int32


def cross_plan(cache: EncDecCache,
               guard: Optional[GuardSpec] = None) -> CrossPlan:
    """The cross pool's K1 page ids, from the rows' fenced slot ids (space
    "kv"): K1's own clamp keeps every id inside the view whatever the
    fence gave."""
    src_len = cache.cross_k.shape[2]
    page = cross_page(src_len)
    n = src_len // page
    slots = fence(guard, "kv", cache.kv.slot_ids).to(torch.int32)
    j = torch.arange(n, dtype=torch.int32, device=slots.device)
    return CrossPlan(page=page, view_pages=slots[:, None] * n + j[None, :])


def cross_decode_attention(cache: EncDecCache, layer: int, q: torch.Tensor,
                           plan: CrossPlan) -> torch.Tensor:
    """A decode step's cross-attention through K1: q (B, 1, H, D) over the
    fenced slot's first ``src_lens`` frames of the cross pool at
    ``layer`` -> (B, 1, H, D)."""
    _, slots, src_len, KH, D = cache.cross_k.shape
    n = src_len // plan.page
    k_l, v_l = (pool[layer].reshape(slots * n, plan.page, KH, D)
                for pool in (cache.cross_k, cache.cross_v))
    o = paged_attention(q[:, 0].contiguous(), k_l, v_l, plan.view_pages,
                        cache.src_lens, 0, -1)
    return o[:, None]


def prefill(cfg: ModelConfig, params: Params, cache: EncDecCache,
            src: torch.Tensor, tgt: torch.Tensor, *,
            guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None
            ) -> Tuple[EncDecCache, torch.Tensor]:
    """Encode ``src``, stash every layer's cross K/V at the rows' fenced
    slots and prefill the decoder's slabs with ``tgt`` (B, S), in place;
    return the last position's logits (B, V)."""
    memory = encode(cfg, params, src, rules=rules)
    B, S_src = memory.shape[:2]
    S = tgt.shape[1]
    positions = train_positions(tgt)
    x = L.embed_tokens(params["embed"], tgt, guard)
    plan = KV.prefill_plan(cache.kv, S, guard)
    # the stash's slot per row, in range, duplicates redirected to their
    # last writer (the reference promises the store in bounds)
    slot = KV._in_range(fence(guard, "kv", cache.kv.slot_ids),
                        cache.cross_k.shape[1]).long()
    last = KV._last_writer(slot)
    for lidx, p in enumerate(params["dec"]):
        q, k, v = L.qkv_proj(cfg, p["attn"],
                             L.apply_norm(cfg, p["norm1"], x))
        q, k = L.positions_rope(cfg, q, k, positions)
        KV.write_prefill_kv(cache.kv, lidx, k, v, guard, plan=plan)
        x = x + L.out_proj(cfg, p["attn"], L.prefill_attention(cfg, q, k, v))
        ck, cv = _cross_kv(cfg, p, memory)
        KV.store(cache.cross_k[lidx], slot, ck[last])
        KV.store(cache.cross_v[lidx], slot, cv[last])
        o = L.full_attention(_cross_q(cfg, p, x), ck, cv)
        x = x + L.out_proj(cfg, p["cross"], o)
        x = x + L.mlp_apply(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))
    cache = dataclasses.replace(
        cache, kv=KV.advance(cache.kv, S),
        src_lens=torch.full((B,), S_src, dtype=torch.int32,
                            device=x.device))
    x = L.apply_norm(cfg, params["norm_f"], x[:, -1:])
    return cache, L.lm_logits(cfg, params["embed"], x)[:, 0]


def decode(cfg: ModelConfig, params: Params, cache: EncDecCache,
           tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None,
           rules: Optional[ShardingRules] = None,
           positions: Optional[torch.Tensor] = None
           ) -> Tuple[EncDecCache, torch.Tensor]:
    """One decode step: tokens (B,) -> logits (B, V); appends to the slabs
    in place.  Self-attention covers each row's ``seq_lens + 1`` tokens,
    cross-attention its ``src_lens`` frames, both through K1."""
    x = L.embed_tokens(params["embed"], tokens[:, None], guard)
    if positions is None:
        positions = cache.kv.seq_lens[:, None]
    kv_len = cache.kv.seq_lens + 1
    plan = KV.decode_plan(cache.kv, guard)
    xplan = cross_plan(cache, guard)
    for lidx, p in enumerate(params["dec"]):
        q, k, v = L.qkv_proj(cfg, p["attn"],
                             L.apply_norm(cfg, p["norm1"], x))
        q, k = L.positions_rope(cfg, q, k, positions)
        KV.append_token_kv(cache.kv, lidx, k, v, guard, plan=plan)
        o = KV.paged_decode_attention(cache.kv, lidx, q, kv_len, guard,
                                      plan=plan)
        x = x + L.out_proj(cfg, p["attn"], o)
        o = cross_decode_attention(cache, lidx, _cross_q(cfg, p, x), xplan)
        x = x + L.out_proj(cfg, p["cross"], o)
        x = x + L.mlp_apply(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))
    cache = dataclasses.replace(cache, kv=KV.advance(cache.kv, 1))
    x = L.apply_norm(cfg, params["norm_f"], x)
    return cache, L.lm_logits(cfg, params["embed"], x)[:, 0]

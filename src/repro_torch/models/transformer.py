"""Dense GQA decoder LM (the stablelm-3b / llama family) — training
forward and serving path.

Params are nested dicts with one dict per layer (``params["layers"][l]``);
the reference stacks its layers on a leading axis and scans, the port
loops over the list (see :func:`repro_torch.models.convert.params_from_jax`).
Prefill and decode run over either KV layout of
:mod:`repro_torch.models.kvcache` — the global paged pool or the slab pool
— with Guardian fencing on every data-dependent index; the hand-written
kernels carry the embedding gather (K3), prefill attention (K4), decode
attention (K1, over the slab's flattened layer view on the slab layout;
K4 and K1 under the config's sliding window when it has one) and, on the
global layout, the prefill page write (K2; the slab write is
the reference's plain formulation).  The MoE family
(:mod:`repro_torch.models.moe`) runs the same loop with its expert block
as the feed-forward (``ffn=``).  :func:`forward` / :func:`loss_fn` are the
reference's training pass: K3 and K4 on the same path as a prefill's,
differentiated through their registered backwards; ``remat`` runs each
layer under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint(nothing_saveable)``, or with :func:`run_layers`'s
``policy="dots"`` its ``dots_with_no_batch_dims_saveable``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingRules, constrain
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models.guard import GuardSpec

Params = Dict[str, Any]


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    """Random weights from ``generator`` (which must live on ``device``),
    in the config's dtype; norms start at ones/zeros."""
    return {
        "embed": L.embedding_init(generator, cfg, device),
        "layers": [{"attn": L.attention_init(generator, cfg, device),
                    "mlp": L.mlp_init(generator, cfg, device),
                    "norm1": L.norm_init(cfg, device),
                    "norm2": L.norm_init(cfg, device)}
                   for _ in range(cfg.n_layers)],
        "norm_f": L.norm_init(cfg, device),
    }


def param_logical_axes(cfg: ModelConfig) -> Params:
    """Logical axes matching :func:`init`'s tree leaf for leaf: the
    reference's stacked ``(None, *axes)`` leaves become ``axes`` on each
    layer's dict."""
    return {
        "embed": L.embedding_axes(cfg),
        "layers": [{"attn": L.attention_axes(cfg),
                    "mlp": L.mlp_axes(cfg),
                    "norm1": L.norm_axes(cfg),
                    "norm2": L.norm_axes(cfg)}
                   for _ in range(cfg.n_layers)],
        "norm_f": L.norm_axes(cfg),
    }


#: a layer's feed-forward block: ``ffn(cfg, layer_params, x, guard)`` ->
#: the residual update of ``x`` (B, S, d)
FFN = Callable[[ModelConfig, Params, torch.Tensor, Optional[GuardSpec]],
               torch.Tensor]


def mlp_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor,
            guard: Optional[GuardSpec] = None) -> torch.Tensor:
    """The dense feed-forward block (no data-dependent index: no fence)."""
    return L.mlp_apply(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))


# ---------------------------------------------------------------------------
# Forward (training / scoring) — no cache
# ---------------------------------------------------------------------------

def attn_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """A layer's attention residual update over a whole sequence: causal
    attention through K4, under the config's window."""
    q, k, v = L.qkv_proj(cfg, p["attn"], L.apply_norm(cfg, p["norm1"], x))
    q, k = L.positions_rope(cfg, q, k, positions)
    return L.out_proj(cfg, p["attn"], L.prefill_attention(cfg, q, k, v))


def train_positions(tokens: torch.Tensor, positions=None) -> torch.Tensor:
    B, S = tokens.shape
    if positions is not None:
        return positions
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None, :].expand(B, S)


def _save_plain_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The ``dots`` policy (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``): a product with no batch dimension
    — ``aten.mm`` / ``aten.addmm``, what ``(B, S, d) @ (d, f)`` lowers to
    — is saved; everything else (the expert ``bmm``s, the kernels, norms,
    elementwise ops) is recomputed."""
    return CheckpointPolicy.MUST_SAVE \
        if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) \
        else CheckpointPolicy.PREFER_RECOMPUTE


def run_layers(layer: Callable, layers, *carry, remat: bool = False,
               policy: str = "nothing"):
    """``carry = layer(p, *carry)`` over the layers' params, each layer
    recomputed in the backward pass when ``remat`` (``torch.utils.
    checkpoint``, non-reentrant).  ``policy`` is what a recomputed layer
    keeps: ``"dots"`` its plain products' outputs
    (:func:`_save_plain_products`), anything else nothing but its inputs,
    as the reference reads ``remat_policy``."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_plain_products)
    for p in layers:
        carry = checkpoint(layer, p, *carry, use_reentrant=False, **kw) \
            if remat else layer(p, *carry)
    return carry


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *,
            guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None,
            remat: bool = False,
            inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V).  ``inputs_embeds`` (B, S, d)
    stands in for the token embedding (the vision family's fused patches;
    the tokens are then not gathered again); ``positions`` (B, S) or (B,
    S, 3) default to ``arange(S)``.  ``rules`` pin the residual stream
    after each layer and the logits, as the reference's ``constrain``
    calls do (the identity off a partitioned trace)."""
    x = inputs_embeds if inputs_embeds is not None \
        else L.embed_tokens(params["embed"], tokens, guard)
    positions = train_positions(tokens, positions)

    def layer(p, x):
        x = x + attn_block(cfg, p, x, positions)
        x = x + mlp_ffn(cfg, p, x, guard)
        return (constrain(x, rules, ("batch", "seq", None)),)

    (x,) = run_layers(layer, params["layers"], x, remat=remat)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return constrain(L.lm_logits(cfg, params["embed"], x), rules,
                     ("batch", "seq", "vocab"))


def next_token_loss(forward: Callable, cfg: ModelConfig, params: Params,
                    batch: Dict[str, Any], *,
                    guard: Optional[GuardSpec] = None,
                    rules: Optional[ShardingRules] = None,
                    remat: bool = True) -> torch.Tensor:
    """Mean next-token NLL of ``batch["tokens"]`` (B, S + 1) under a
    family's ``forward``, masked by ``batch["mask"]`` when given: the
    ``loss_fn`` of the dense, hybrid and ssm families."""
    tokens = batch["tokens"]
    logits = forward(cfg, params, tokens[:, :-1], guard=guard, rules=rules,
                     remat=remat)
    return L.softmax_cross_entropy(logits, tokens[:, 1:], batch.get("mask"))


loss_fn = functools.partial(next_token_loss, forward)


# ---------------------------------------------------------------------------
# Serving — prefill + decode over the paged or slab cache
# ---------------------------------------------------------------------------

def prefill(cfg: ModelConfig, params: Params, cache: KV.PagedKVCache,
            tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None,
            ffn: FFN = mlp_ffn, positions: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[KV.PagedKVCache, torch.Tensor]:
    """Process the prompt, fill the KV pages (in place), return the
    last-position logits (B, V).  ``ffn`` is the layers' feed-forward
    block (the MoE family passes its expert block); ``positions`` and
    ``inputs_embeds`` are :func:`forward`'s."""
    B, S = tokens.shape
    x = inputs_embeds if inputs_embeds is not None \
        else L.embed_tokens(params["embed"], tokens, guard)
    positions = train_positions(tokens, positions)
    plan = KV.prefill_plan(cache, S, guard)
    for lidx, p in enumerate(params["layers"]):
        q, k, v = L.qkv_proj(cfg, p["attn"],
                             L.apply_norm(cfg, p["norm1"], x))
        q, k = L.positions_rope(cfg, q, k, positions)
        KV.write_prefill_kv(cache, lidx, k, v, guard, plan=plan)
        o = L.prefill_attention(cfg, q, k, v)
        x = x + L.out_proj(cfg, p["attn"], o)
        x = x + ffn(cfg, p, x, guard)
        x = constrain(x, rules, ("batch", "seq", None))
    cache = KV.advance(cache, S)
    x = L.apply_norm(cfg, params["norm_f"], x[:, -1:])
    return cache, L.lm_logits(cfg, params["embed"], x)[:, 0]


def decode(cfg: ModelConfig, params: Params, cache: KV.PagedKVCache,
           tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None,
           rules: Optional[ShardingRules] = None,
           ffn: FFN = mlp_ffn, positions: Optional[torch.Tensor] = None
           ) -> Tuple[KV.PagedKVCache, torch.Tensor]:
    """One decode step: tokens (B,) -> logits (B, V); appends to the pool
    in place.  Attention covers each row's ``seq_lens + 1`` tokens.  The
    new tokens' rotary ``positions`` ((B,), (B, 1) or (B, 1, 3)) default
    to ``seq_lens``."""
    x = L.embed_tokens(params["embed"], tokens[:, None], guard)
    if positions is None:
        positions = cache.seq_lens[:, None]
    elif positions.dim() == 1:
        positions = positions[:, None]
    kv_len = cache.seq_lens + 1
    plan = KV.decode_plan(cache, guard)
    for lidx, p in enumerate(params["layers"]):
        q, k, v = L.qkv_proj(cfg, p["attn"],
                             L.apply_norm(cfg, p["norm1"], x))
        q, k = L.positions_rope(cfg, q, k, positions)
        KV.append_token_kv(cache, lidx, k, v, guard, plan=plan)
        o = KV.paged_decode_attention(cache, lidx, q, kv_len, guard,
                                      plan=plan, window=cfg.attn_window)
        x = x + L.out_proj(cfg, p["attn"], o)
        x = x + ffn(cfg, p, x, guard)
    cache = KV.advance(cache, 1)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return cache, L.lm_logits(cfg, params["embed"], x)[:, 0]

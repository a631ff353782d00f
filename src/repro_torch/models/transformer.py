"""Dense GQA decoder LM (the stablelm-3b / llama family) — serving path.

Params are nested dicts with one dict per layer (``params["layers"][l]``);
the reference stacks its layers on a leading axis and scans, the port
loops over the list (see :func:`repro_torch.models.convert.params_from_jax`).
Prefill and decode run over the global paged KV pool with Guardian fencing
on every data-dependent index; the four hand-written kernels carry the
embedding gather (K3), the prefill page write (K2), prefill attention (K4)
and decode attention (K1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.mlp_apply(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))


def prefill(cfg: ModelConfig, params: Params, cache: KV.PagedKVCache,
            tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None
            ) -> Tuple[KV.PagedKVCache, torch.Tensor]:
    """Process the prompt, fill the KV pages (in place), return the
    last-position logits (B, V)."""
    B, S = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, guard)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, S)
    for lidx, p in enumerate(params["layers"]):
        q, k, v = L.qkv_proj(cfg, p["attn"],
                             L.apply_norm(cfg, p["norm1"], x))
        q, k = L.positions_rope(cfg, q, k, positions)
        KV.write_prefill_kv(cache, lidx, k, v, guard)
        o = L.prefill_attention(cfg, q, k, v)
        x = x + L.out_proj(cfg, p["attn"], o)
        x = x + _mlp(cfg, p, x)
    cache = KV.advance(cache, S)
    x = L.apply_norm(cfg, params["norm_f"], x[:, -1:])
    return cache, L.lm_logits(cfg, params["embed"], x)[:, 0]


def decode(cfg: ModelConfig, params: Params, cache: KV.PagedKVCache,
           tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None
           ) -> Tuple[KV.PagedKVCache, torch.Tensor]:
    """One decode step: tokens (B,) -> logits (B, V); appends to the pool
    in place.  Attention covers each row's ``seq_lens + 1`` tokens."""
    x = L.embed_tokens(params["embed"], tokens[:, None], guard)
    positions = cache.seq_lens[:, None]
    kv_len = cache.seq_lens + 1
    for lidx, p in enumerate(params["layers"]):
        q, k, v = L.qkv_proj(cfg, p["attn"],
                             L.apply_norm(cfg, p["norm1"], x))
        q, k = L.positions_rope(cfg, q, k, positions)
        KV.append_token_kv(cache, lidx, k, v, guard)
        if cfg.attn_window:
            if q.device.type != "cpu":
                raise NotImplementedError(
                    "windowed decode attention has no CUDA kernel yet "
                    f"(attn_window={cfg.attn_window})")
            k_hist, v_hist = KV.gather_layer_kv(cache, lidx, guard)
            o = L.decode_attention(q, k_hist.to(q.dtype),
                                   v_hist.to(q.dtype), kv_len,
                                   window=cfg.attn_window)
        else:
            o = KV.paged_decode_attention(cache, lidx, q, kv_len, guard)
        x = x + L.out_proj(cfg, p["attn"], o)
        x = x + _mlp(cfg, p, x)
    cache = KV.advance(cache, 1)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return cache, L.lm_logits(cfg, params["embed"], x)[:, 0]

"""qwen2-vl-2b backbone — the dense decoder with M-RoPE and a stubbed
vision frontend (the batch carries precomputed patch embeddings; the ViT
tower is out of scope, as in ``repro/models/vlm.py``).

Multimodal fusion: the patch embeddings replace the token embeddings at
the image positions (the first ``n_patches`` of the sequence by
convention); the M-RoPE position ids (temporal / height / width, (B, S,
3) int32) arrive with the batch.  Everything else is the dense
transformer (:mod:`repro_torch.models.transformer`): the embedding gather
runs K3 over every id, prefill attention K4, decode attention K1 over the
slab cache (the model API's default bfloat16 pool).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.guard import GuardSpec

Params = Dict[str, Any]

init = TF.init
param_logical_axes = TF.param_logical_axes


def fuse_inputs(params: Params, tokens: torch.Tensor, patches: torch.Tensor,
                guard: Optional[GuardSpec] = None) -> torch.Tensor:
    """Token embeddings (K3 over every id) with the first ``n_patches``
    positions replaced by the patches (B, n_patches, d), cast to the
    embedding's dtype."""
    x = L.embed_tokens(params["embed"], tokens, guard)
    n_patch = patches.shape[1]
    return torch.cat([patches.to(x.dtype), x[:, n_patch:]], dim=1)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            patches: torch.Tensor, positions3: torch.Tensor, *,
            guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None,
            remat: bool = False) -> torch.Tensor:
    """tokens (B, S), patches (B, n_patches, d), positions3 (B, S, 3) ->
    logits (B, S, V)."""
    x = fuse_inputs(params, tokens, patches, guard)
    return TF.forward(cfg, params, tokens, positions3, guard=guard,
                      rules=rules, remat=remat, inputs_embeds=x)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token NLL over the text positions only (a patch slot is
    an input, never a target): labels at index >= n_patches - 1."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    logits = forward(cfg, params, inputs, batch["patches"],
                     batch["positions"], guard=guard, rules=rules,
                     remat=remat)
    n_patch = batch["patches"].shape[1]
    text_mask = (torch.arange(labels.shape[1], dtype=torch.int32,
                              device=labels.device)[None, :]
                 >= n_patch - 1).float()
    mask = batch.get("mask")
    mask = text_mask if mask is None else mask * text_mask
    return L.softmax_cross_entropy(logits, labels, mask)


def prefill(cfg: ModelConfig, params: Params, cache: KV.PagedKVCache,
            tokens: torch.Tensor, patches: torch.Tensor,
            positions3: torch.Tensor, *, guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None
            ) -> Tuple[KV.PagedKVCache, torch.Tensor]:
    x = fuse_inputs(params, tokens, patches, guard)
    return TF.prefill(cfg, params, cache, tokens, guard=guard, rules=rules,
                      positions=positions3, inputs_embeds=x)


def decode(cfg: ModelConfig, params: Params, cache: KV.PagedKVCache,
           tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None,
           rules: Optional[ShardingRules] = None,
           positions: Optional[torch.Tensor] = None
           ) -> Tuple[KV.PagedKVCache, torch.Tensor]:
    """Text-only decode: the three M-RoPE components all equal the text
    position (``seq_lens`` unless given)."""
    if positions is None:
        positions = cache.seq_lens[:, None]
    if positions.dim() == 2:
        positions = positions[..., None].expand(*positions.shape, 3)
    return TF.decode(cfg, params, cache, tokens, guard=guard, rules=rules,
                     positions=positions)

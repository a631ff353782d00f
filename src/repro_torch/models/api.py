"""Model API — one surface over all six families (dense, moe, hybrid,
ssm, vlm, encdec), as ``repro/models/api.py``.

``get_model(cfg)`` returns a :class:`ModelAPI` with:

    init(generator, device)           -> params
    param_logical_axes()              -> logical-axis tree (matches params)
    loss(params, batch, *, guard=, remat=, **kw) -> scalar loss
    init_cache(batch, max_len, *, slots=, dtype=, **kw) -> slab cache
    init_global_cache(batch, max_len, total_pages, **kw) -> global paged cache
    prefill(params, cache, batch, ...) -> (cache, last_logits)
    decode(params, cache, tokens, ...) -> (cache, logits)
    batch_specs(shape)                -> the batch as ``meta`` tensors

Batches: ``{"tokens"}`` for the text families; the vision family adds
``"patches"`` (B, :data:`N_PATCHES`, d) and ``"positions"`` (B, S, 3);
the encoder-decoder family takes ``{"src", "tgt"}`` (frames (B,
:data:`SRC_FRAMES`, d) and target ids) and its ``init_cache`` a
``src_len`` (no ``slots``: the reference's, which no serve engine can
build).  Only the dense and MoE families have the global paged layout:
every other family's ``init_global_cache`` raises the reference's
``ValueError``.  Every family trains through ``loss`` (the MoE family's
also takes the reference's ``dispatch`` and ``remat_policy``; its
``prefill`` / ``decode`` take ``dispatch``).  :data:`UNPORTED` names the
families the port cannot build: none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import kvcache as KV
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF
from repro_torch.models import vlm as VLM
from repro_torch.models import xlstm as XL

#: family -> what the port lacks to build it (every family is built)
UNPORTED: dict = {}

# frontend stubs: source frames / image patches per request
SRC_FRAMES = 1_024       # seamless encoder input length (frame embeddings)
N_PATCHES = 256          # qwen2-vl patches per request


def slab_only(family: str) -> str:
    """The reference's refusal of the global paged layout for a family
    that serves on the slab layout only (``repro/launch/serve.py``)."""
    return ("paged serve mode needs the global paged KV layout "
            f"(dense/moe transformers); {family!r} engines use "
            "the slab layout")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    init_cache: Callable
    init_global_cache: Callable
    prefill: Callable
    decode: Callable
    loss: Callable
    param_logical_axes: Callable
    batch_specs: Callable


def _tok_spec(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _text_specs(shape: ShapeConfig) -> dict:
    """The text families' batch: (B, S + 1) tokens to train on, (B, S) to
    prefill, (B,) to decode."""
    b = shape.global_batch
    if shape.kind == "train":
        return {"tokens": _tok_spec(b, shape.seq_len + 1)}
    if shape.kind == "prefill":
        return {"tokens": _tok_spec(b, shape.seq_len)}
    return {"tokens": _tok_spec(b)}


def _vlm_specs(cfg: ModelConfig) -> Callable:
    def batch_specs(shape: ShapeConfig) -> dict:
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": _tok_spec(b)}
        return {
            "tokens": _tok_spec(b, s + 1 if shape.kind == "train" else s),
            "patches": torch.empty((b, N_PATCHES, cfg.d_model),
                                   dtype=torch.bfloat16, device="meta"),
            "positions": _tok_spec(b, s, 3),
        }
    return batch_specs


def _encdec_specs(cfg: ModelConfig) -> Callable:
    def batch_specs(shape: ShapeConfig) -> dict:
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": _tok_spec(b)}
        src = torch.empty((b, SRC_FRAMES, cfg.d_model),
                          dtype=torch.bfloat16, device="meta")
        return {"src": src, "tgt": _tok_spec(
            b, s + 1 if shape.kind == "train" else s)}
    return batch_specs


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "dense":
        return _dense_api(cfg)
    if cfg.family == "moe":
        return _moe_api(cfg)
    if cfg.family == "hybrid":
        return _hybrid_api(cfg)
    if cfg.family == "ssm":
        return _ssm_api(cfg)
    if cfg.family == "vlm":
        return _vlm_api(cfg)
    if cfg.family == "encdec":
        return _encdec_api(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def _dense_api(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init=lambda generator, device="cuda": TF.init(cfg, generator,
                                                      device),
        init_cache=lambda batch, max_len, **kw: KV.init_kv_cache(
            cfg, batch, max_len, **kw),
        init_global_cache=lambda batch, max_len, total_pages, **kw:
            KV.init_global_kv_cache(cfg, batch, max_len, total_pages, **kw),
        prefill=lambda params, cache, batch, **kw: TF.prefill(
            cfg, params, cache, batch["tokens"], **kw),
        decode=lambda params, cache, tokens, **kw: TF.decode(
            cfg, params, cache, tokens, **kw),
        loss=lambda params, batch, **kw: TF.loss_fn(cfg, params, batch,
                                                    **kw),
        param_logical_axes=lambda: TF.param_logical_axes(cfg),
        batch_specs=_text_specs,
    )


def _moe_api(cfg: ModelConfig) -> ModelAPI:
    """The dense cache and serving loop with the expert block swapped in
    (``repro/models/api.py``'s ``_moe_api``)."""
    return dataclasses.replace(
        _dense_api(cfg),
        init=lambda generator, device="cuda": MOE.init(cfg, generator,
                                                       device),
        prefill=lambda params, cache, batch, **kw: MOE.prefill(
            cfg, params, cache, batch["tokens"], **kw),
        decode=lambda params, cache, tokens, **kw: MOE.decode(
            cfg, params, cache, tokens, **kw),
        loss=lambda params, batch, **kw: MOE.loss_fn(cfg, params, batch,
                                                     **kw),
        param_logical_axes=lambda: MOE.param_logical_axes(cfg),
    )


def _no_global_cache(cfg: ModelConfig) -> Callable:
    def refuse(*args, **kw):
        raise ValueError(slab_only(cfg.family))
    return refuse


def _hybrid_api(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(
        cfg=cfg,
        init=lambda generator, device="cuda": HY.init(cfg, generator,
                                                      device),
        init_cache=lambda batch, max_len, **kw: HY.init_cache(
            cfg, batch, max_len, **kw),
        init_global_cache=_no_global_cache(cfg),
        prefill=lambda params, cache, batch, **kw: HY.prefill(
            cfg, params, cache, batch["tokens"], **kw),
        decode=lambda params, cache, tokens, **kw: HY.decode(
            cfg, params, cache, tokens, **kw),
        loss=lambda params, batch, **kw: HY.loss_fn(cfg, params, batch,
                                                    **kw),
        param_logical_axes=lambda: HY.param_logical_axes(cfg),
        batch_specs=_text_specs,
    )


def _ssm_api(cfg: ModelConfig) -> ModelAPI:
    """``init_cache`` ignores ``max_len``: the state is O(1) per token."""
    return ModelAPI(
        cfg=cfg,
        init=lambda generator, device="cuda": XL.init(cfg, generator,
                                                      device),
        init_cache=lambda batch, max_len=None, **kw: XL.init_cache(
            cfg, batch, **kw),
        init_global_cache=_no_global_cache(cfg),
        prefill=lambda params, cache, batch, **kw: XL.prefill(
            cfg, params, cache, batch["tokens"], **kw),
        decode=lambda params, cache, tokens, **kw: XL.decode(
            cfg, params, cache, tokens, **kw),
        loss=lambda params, batch, **kw: XL.loss_fn(cfg, params, batch,
                                                    **kw),
        param_logical_axes=lambda: XL.param_logical_axes(cfg),
        batch_specs=_text_specs,
    )


def _vlm_api(cfg: ModelConfig) -> ModelAPI:
    """The dense cache, the patches and M-RoPE positions in the batch
    (``repro/models/api.py``'s ``_vlm_api``)."""
    return ModelAPI(
        cfg=cfg,
        init=lambda generator, device="cuda": VLM.init(cfg, generator,
                                                       device),
        init_cache=lambda batch, max_len, **kw: KV.init_kv_cache(
            cfg, batch, max_len, **kw),
        init_global_cache=_no_global_cache(cfg),
        prefill=lambda params, cache, batch, **kw: VLM.prefill(
            cfg, params, cache, batch["tokens"], batch["patches"],
            batch["positions"], **kw),
        decode=lambda params, cache, tokens, **kw: VLM.decode(
            cfg, params, cache, tokens, **kw),
        loss=lambda params, batch, **kw: VLM.loss_fn(cfg, params, batch,
                                                     **kw),
        param_logical_axes=lambda: VLM.param_logical_axes(cfg),
        batch_specs=_vlm_specs(cfg),
    )


def _encdec_api(cfg: ModelConfig) -> ModelAPI:
    """The decoder's slab cache with the cross pools (``init_cache`` takes
    ``src_len``, default :data:`SRC_FRAMES`, and no ``slots``: a serve
    engine's ``init_cache(..., slots=)`` raises ``TypeError``, as the
    reference's does)."""
    return ModelAPI(
        cfg=cfg,
        init=lambda generator, device="cuda": ED.init(cfg, generator,
                                                      device),
        init_cache=lambda batch, max_len, src_len=SRC_FRAMES, **kw:
            ED.init_cache(cfg, batch, max_len, src_len, **kw),
        init_global_cache=_no_global_cache(cfg),
        prefill=lambda params, cache, batch, **kw: ED.prefill(
            cfg, params, cache, batch["src"], batch["tgt"], **kw),
        decode=lambda params, cache, tokens, **kw: ED.decode(
            cfg, params, cache, tokens, **kw),
        loss=lambda params, batch, **kw: ED.loss_fn(cfg, params, batch,
                                                    **kw),
        param_logical_axes=lambda: ED.param_logical_axes(cfg),
        batch_specs=_encdec_specs(cfg),
    )

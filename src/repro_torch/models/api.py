"""Model API — the surface of the families the port serves (dense, moe).

``get_model(cfg)`` returns a :class:`ModelAPI` with:

    init(generator, device)           -> params
    init_cache(batch, max_len, *, slots=, dtype=, **kw) -> slab cache
    init_global_cache(batch, max_len, total_pages, **kw) -> global paged cache
    prefill(params, cache, batch, ...) -> (cache, last_logits)
    decode(params, cache, tokens, ...) -> (cache, logits)

Every other family raises ``NotImplementedError`` with what it lacks
(:data:`UNPORTED`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache as KV
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF

#: family -> what the port lacks to build it
UNPORTED = {
    "vlm": "the vision family (models/vlm.py: M-RoPE and the 'patches' "
           "input) is not ported yet",
    "hybrid": "the hybrid family (models/hybrid.py over the Mamba2/SSD "
              "blocks) is not ported yet",
    "ssm": "the xLSTM family (models/xlstm.py) is not ported yet",
    "encdec": "the encoder-decoder family (models/encdec.py) is not "
              "ported yet",
}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    init_cache: Callable
    init_global_cache: Callable
    prefill: Callable
    decode: Callable


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "dense":
        return _dense_api(cfg)
    if cfg.family == "moe":
        return _moe_api(cfg)
    if cfg.family in UNPORTED:
        raise NotImplementedError(UNPORTED[cfg.family])
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
    )

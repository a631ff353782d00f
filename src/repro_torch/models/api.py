"""Model API — the dense family's surface (other families are not ported
yet).

``get_model(cfg)`` returns a :class:`ModelAPI` with:

    init(generator, device)           -> params
    init_cache(batch, max_len, total_pages, **kw) -> global paged cache
    prefill(params, cache, batch, ...) -> (cache, last_logits)
    decode(params, cache, tokens, ...) -> (cache, logits)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache as KV
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    init_cache: Callable
    prefill: Callable
    decode: Callable


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (dense only)")
    return ModelAPI(
        cfg=cfg,
        init=lambda generator, device="cuda": TF.init(cfg, generator,
                                                      device),
        init_cache=lambda batch, max_len, total_pages, **kw:
            KV.init_global_kv_cache(cfg, batch, max_len, total_pages, **kw),
        prefill=lambda params, cache, batch, **kw: TF.prefill(
            cfg, params, cache, batch["tokens"], **kw),
        decode=lambda params, cache, tokens, **kw: TF.decode(
            cfg, params, cache, tokens, **kw),
    )

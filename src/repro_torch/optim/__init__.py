from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import constant, cosine, wsd

__all__ = ["Optimizer", "adafactor", "adamw", "apply_updates",
           "clip_by_global_norm", "global_norm", "constant", "cosine",
           "wsd"]

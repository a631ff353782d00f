"""minicpm-2b — llama-like dense decoder, WSD schedule [arXiv:2404.06395; hf].

The WSD (warmup-stable-decay) schedule the paper trains with is implemented
in ``repro.optim.schedules.wsd`` and selected by this config.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2_304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5_760,
    vocab=122_753,
    head_dim=64,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
    source="arXiv:2404.06395; hf",
))

SCHEDULE = "wsd"

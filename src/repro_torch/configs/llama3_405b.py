"""llama3-405b — dense GQA decoder, 128k vocab [arXiv:2407.21783; unverified]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16_384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53_248,
    vocab=128_256,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope_theta=500_000.0,
    source="arXiv:2407.21783; unverified",
))

"""grok-1-314b — MoE decoder, 8 experts top-2 [hf:xai-org/grok-1; unverified]."""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6_144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab=131_072,
    head_dim=128,
    norm="rmsnorm",
    act="gelu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32_768),
    source="hf:xai-org/grok-1; unverified",
))

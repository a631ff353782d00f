"""qwen3-moe-30b-a3b — fine-grained MoE, 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B; hf]."""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2_048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151_936,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))

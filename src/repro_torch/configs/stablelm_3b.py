"""stablelm-3b — dense decoder [hf:stabilityai/stablelm-2-1_6b; unverified]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2_560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6_912,
    vocab=50_304,
    head_dim=80,
    norm="layernorm",
    act="silu",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
))

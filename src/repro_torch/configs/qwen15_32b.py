"""qwen1.5-32b — dense decoder with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5_120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27_392,
    vocab=152_064,
    head_dim=128,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
))

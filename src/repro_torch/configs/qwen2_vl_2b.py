"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].

Backbone only per assignment: the vision frontend is a stub —
``input_specs()`` provides precomputed patch embeddings.  M-RoPE applies
3-component rotary embeddings (temporal / height / width position ids).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1_536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8_960,
    vocab=151_936,
    head_dim=128,
    qkv_bias=True,
    mrope=True,
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
    frontend_stub=True,
    source="arXiv:2409.12191; hf",
))

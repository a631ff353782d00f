"""zamba2-7b — hybrid Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

Hybrid: most layers are Mamba2 (SSD) blocks; one *shared* full attention +
MLP block is invoked every ``attn_every`` layers (zamba2 shares its weights
across invocations — we replicate that: a single attention block's params
applied at each invocation point, with per-invocation LoRA-free reuse).
Sub-quadratic (SSM state + windowed attention) ⇒ long_500k runs.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3_584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab=32_000,
    head_dim=112,
    norm="rmsnorm",
    act="gelu",
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, chunk=64),
    attn_every=6,          # shared attention block every 6 mamba2 layers
    attn_window=4_096,     # windowed attention keeps long-context linear
    source="arXiv:2411.15242; unverified",
))

"""seamless-m4t-medium — encoder-decoder multimodal backbone
[arXiv:2308.11596; hf].

Backbone only per assignment: the audio frontend is a stub —
``input_specs()`` provides precomputed frame embeddings for the encoder.
Encoder-decoder (not encoder-only) ⇒ decode shapes run on the decoder side
with the encoder output as fixed cross-attention memory.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,               # decoder layers
    enc_layers=12,
    d_model=1_024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4_096,
    vocab=256_206,
    head_dim=64,
    norm="layernorm",
    act="gelu",
    cross_attention=True,
    frontend_stub=True,
    source="arXiv:2308.11596; hf",
))

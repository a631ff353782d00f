"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

Attention-free recurrent architecture: alternating mLSTM (matrix-memory,
parallelizable chunkwise) and sLSTM (scalar-memory, sequential gate
recurrence) blocks.  d_ff=0 per the assignment (blocks carry their own
up/down projections).  Pure recurrent state ⇒ long_500k runs.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1_024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    head_dim=256,
    norm="layernorm",
    act="gelu",
    ssm=SSMConfig(state_dim=256, conv_width=4, expand=2, chunk=64),
    source="arXiv:2405.04517; unverified",
))

"""Model / run configuration system.

Every assigned architecture is a :class:`ModelConfig` instance in its own
``configs/<id>.py`` module; the registry maps ``--arch <id>`` to it.  The
four assigned input shapes are :class:`ShapeConfig` instances shared by all
LM-family archs.

Configs are plain frozen dataclasses — hashable, printable, and safe to
close over in jitted code.  ``reduced()`` returns the CPU-smoke-test
variant of any config (same family/topology, tiny dims).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int            # per-expert FFN width
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters (zamba2) or xLSTM cell parameters."""

    state_dim: int = 64         # N: per-head SSM state size
    conv_width: int = 4
    expand: int = 2             # mamba2 inner expansion
    chunk: int = 64             # SSD chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # default d_model // n_heads
    qkv_bias: bool = False               # qwen1.5
    tie_embeddings: bool = False
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    act: str = "silu"                    # silu (SwiGLU) | gelu
    rope_theta: float = 10_000.0
    mrope: bool = False                  # qwen2-vl M-RoPE (3-part positions)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block every `attn_every` layers;
    # remaining layers are Mamba2. ssm family: alternate sLSTM/mLSTM.
    attn_every: int = 0                  # 0 = all attention (dense)
    attn_window: int = 0                 # sliding-window size; 0 = full
    # encoder-decoder (seamless-m4t)
    enc_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend_stub: bool = False
    dtype: str = "bfloat16"
    source: str = ""                     # provenance note

    def __post_init__(self):
        if self.head_dim is None:
            hd = self.d_model // max(self.n_heads, 1)
            object.__setattr__(self, "head_dim", hd)

    # -- derived -----------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def subquadratic(self) -> bool:
        """Whether the arch supports the long_500k shape (per assignment:
        SSM / hybrid / linear-attn or windowed attention only)."""
        return self.family in ("ssm", "hybrid") or (
            self.attn_window > 0 and self.family != "encdec")

    @property
    def decoder_layers(self) -> int:
        return self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6·N·D)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = self._per_layer_params()
        enc = 0
        if self.enc_layers:
            enc = self.enc_layers * self._attn_params(cross=False) \
                + self.enc_layers * self._ffn_params(self.d_ff) \
                + self.enc_layers * 2 * d
        return emb + self.n_layers * per_layer + enc

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = self.n_layers * self.moe.num_experts * 3 * d * \
            self.moe.d_ff_expert
        active = self.n_layers * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return full - all_experts + active

    def _attn_params(self, cross: bool = False) -> int:
        d = self.d_model
        n = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            n += self.q_dim + 2 * self.kv_dim
        return n

    def _ffn_params(self, d_ff: int) -> int:
        gates = 3 if self.act == "silu" else 2   # SwiGLU has gate+up+down
        return gates * self.d_model * d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_in = s.expand * d
        heads = max(d_in // max(self.head_dim, 1), 1)
        # in_proj (z,x,B,C,dt) + conv + out_proj + A,D,dt_bias
        return (d * (2 * d_in + 2 * s.state_dim * heads + heads)
                + s.conv_width * (d_in + 2 * s.state_dim * heads)
                + d_in * d + 3 * heads)

    def _per_layer_params(self) -> int:
        d = self.d_model
        norms = 2 * d
        if self.family == "moe":
            router = d * self.moe.num_experts
            experts = self.moe.num_experts * 3 * d * self.moe.d_ff_expert
            return self._attn_params() + router + experts + norms
        if self.family == "hybrid":
            # per-layer average: mamba2 block + amortized shared attn block
            shared = (self._attn_params() + self._ffn_params(self.d_ff)) \
                / max(self.n_layers // max(self.attn_every, 1), 1) \
                if self.attn_every else 0
            return int(self._ssm_params() + norms + shared)
        if self.family == "ssm":
            # xLSTM: mLSTM block (qkv + gates) — approximate with ssm params
            return self._ssm_params() + norms
        ffn = self._ffn_params(self.d_ff) if self.d_ff else 0
        return self._attn_params() + ffn + norms

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: Dict = dict(
            name=self.name + "-smoke",
            family=self.family,
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 2,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            qkv_bias=self.qkv_bias,
            tie_embeddings=self.tie_embeddings,
            norm=self.norm,
            act=self.act,
            rope_theta=self.rope_theta,
            mrope=self.mrope,
            attn_every=min(self.attn_every, 2),
            attn_window=min(self.attn_window, 32) if self.attn_window else 0,
            enc_layers=min(self.enc_layers, 2),
            cross_attention=self.cross_attention,
            frontend_stub=self.frontend_stub,
            dtype="float32",
            source=self.source,
        )
        if self.moe:
            kw["moe"] = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32)
        if self.ssm:
            kw["ssm"] = SSMConfig(state_dim=8, conv_width=4, expand=2,
                                  chunk=8)
        return ModelConfig(**kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned — 4 per LM arch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k needs sub-quadratic attention;
    encoder-only archs skip decode (none assigned are encoder-only)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch — long_500k needs "
                       "sub-quadratic attention (skip noted in DESIGN.md)")
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import the per-arch modules exactly once
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        grok_1_314b,
        llama3_405b,
        minicpm_2b,
        qwen15_32b,
        qwen2_vl_2b,
        qwen3_moe_30b_a3b,
        seamless_m4t_medium,
        stablelm_3b,
        xlstm_350m,
        zamba2_7b,
    )

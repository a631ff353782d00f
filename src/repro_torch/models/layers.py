"""Shared model building blocks — plain functions on tensors, dict params.

Conventions (as in the JAX reference):
* params are nested dicts of tensors;
* activations: (batch, seq, d_model); attention internals
  (batch, seq, heads, head_dim);
* every data-dependent index op takes the optional ``guard`` spec
  (:mod:`repro_torch.models.guard`), so Guardian fencing is a first-class
  switch.

The embedding gather runs through the fenced-gather kernel (K3) and
prefill attention through the flash-attention kernel (K4); on CPU tensors
both wrappers take their plain versions.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fence import FencePolicy
from repro_torch.kernels import flash_attention, gather_rows
from repro_torch.models.guard import GuardSpec, fence

Params = Dict[str, Any]

NEG_INF = -1e30


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Init helpers (random weights from an explicit generator)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    w.normal_(0.0, scale / math.sqrt(d_in), generator=gen)
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=gen)
    return w.to(dtype)


def norm_init(cfg: ModelConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def attention_init(gen, cfg: ModelConfig, device) -> Params:
    dt, d = dtype_of(cfg), cfg.d_model
    p: Params = {
        "wq": dense_init(gen, d, cfg.q_dim, dt, device),
        "wk": dense_init(gen, d, cfg.kv_dim, dt, device),
        "wv": dense_init(gen, d, cfg.kv_dim, dt, device),
        "wo": dense_init(gen, cfg.q_dim, d, dt, device,
                         scale=1.0 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    return p


def mlp_init(gen, cfg: ModelConfig, device) -> Params:
    dt, d, f = dtype_of(cfg), cfg.d_model, cfg.d_ff
    down = 1.0 / math.sqrt(2 * cfg.n_layers)
    if cfg.act == "silu":
        return {"wg": dense_init(gen, d, f, dt, device),
                "wu": dense_init(gen, d, f, dt, device),
                "wd": dense_init(gen, f, d, dt, device, scale=down)}
    return {"wu": dense_init(gen, d, f, dt, device),
            "wd": dense_init(gen, f, d, dt, device, scale=down)}


def embedding_init(gen, cfg: ModelConfig, device) -> Params:
    dt = dtype_of(cfg)
    p: Params = {"table": embed_init(gen, cfg.vocab, cfg.d_model, dt,
                                     device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dt, device)
    return p


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` as float32 on ``device``, uploaded once: a step
    captured into a CUDA graph cannot copy from the host.  Callers only
    read it."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32.  A trace on fake tensors
    (the verifier's) records the table's shape only: it uploads nothing
    from the host and caches nothing (a cached fake would reach later real
    calls)."""
    if is_fake(x):
        freqs = x.new_empty((x.shape[-1] // 2,), dtype=torch.float32)
    else:
        freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_rope(cfg: ModelConfig, q, k, positions):
    if cfg.mrope:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
    if positions.dim() == 3:
        positions = positions[..., 0]
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, KH, G, D)  k: (B, Skv, KH, D) -> (B, KH, G, Sq, Skv),
    float32 accumulation."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 1024) -> torch.Tensor:
    """Attention forward over a prompt, in query chunks (never an (S, S)
    score matrix beyond one chunk), with causal / sliding-window masks.
    GQA: H = KH * G.  Returns (B, Sq, H, D) in q's dtype.  The plain
    path for configurations the prefill kernel does not cover (windows)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=dev)
    outs = []
    for c0 in range(0, Sq, q_chunk):
        qc = q[:, c0:c0 + q_chunk]
        n = qc.shape[1]
        s = _gqa_scores(qc.reshape(B, n, KH, G, D), k) * scale
        q_pos = c0 + torch.arange(n, dtype=torch.int32, device=dev)
        mask = torch.ones((n, k.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                         v.float())
        outs.append(o.reshape(B, n, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def prefill_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Causal prefill attention.  Full attention runs the flash-attention
    kernel (K4; its plain version for CPU tensors).  A sliding window has
    no kernel yet: it runs :func:`chunked_attention` on the CPU and raises
    on the card rather than leave the kernel path silently."""
    if not cfg.attn_window:
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    if q.device.type != "cpu":
        raise NotImplementedError(
            "windowed attention has no CUDA kernel yet "
            f"(attn_window={cfg.attn_window})")
    return chunked_attention(q, k, v, causal=True, window=cfg.attn_window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, window: int = 0
                     ) -> torch.Tensor:
    """Single-token attention over a gathered KV history: q (B,1,H,D),
    k/v (B,Skv,KH,D), kv_len (B,) -> (B,1,H,D)."""
    B, _, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    s = _gqa_scores(q.reshape(B, 1, KH, G, D), k) * (1.0 / math.sqrt(D))
    pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    kv_len = kv_len.to(torch.int32)
    mask = pos[None, :] < kv_len[:, None]
    if window:
        mask = mask & (pos[None, :] > kv_len[:, None] - 1 - window)
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Projections, MLP, embedding, LM head
# ---------------------------------------------------------------------------

def qkv_proj(cfg: ModelConfig, p: Params, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> q (B,S,H,D), k/v (B,S,KH,D)."""
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def out_proj(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.q_dim) @ p["wo"]


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return F.gelu(x @ p["wu"], approximate="tanh") @ p["wd"]


def embed_tokens(p: Params, tokens: torch.Tensor,
                 guard: Optional[GuardSpec] = None) -> torch.Tensor:
    """Token-id gather through the fenced-gather kernel (K3).  A BITWISE
    vocab guard hands its ``(base, size - 1)`` to the kernel, which fences
    on the load address; other policies fence here first and the kernel
    gets the identity fence.  A fenced id past the table yields a NaN row,
    never an out-of-table read."""
    ids = tokens.to(torch.int32).reshape(-1)
    vocab = guard.vocab if guard is not None else None
    if vocab is not None and guard.policy is FencePolicy.BITWISE:
        base, mask = vocab.base, vocab.size - 1
    else:
        ids, base, mask = fence(guard, "vocab", ids), 0, -1
    rows = gather_rows(p["table"], ids.contiguous(), base, mask)
    return rows.reshape(*tokens.shape, rows.shape[-1])


def lm_logits(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["table"].T
    return x @ p["head"]

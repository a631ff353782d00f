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
both wrappers take their plain versions.  Both are differentiable (their
backwards are written in PyTorch), so the training forward takes the
same path.
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
from repro_torch.distributed.partition import along, einsum, \
    is_dtensor, matmul, merge_heads, rank_block, settle, split_heads, \
    split_over
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


def norm_axes(cfg: ModelConfig) -> Params:
    """Logical axes of :func:`norm_init`'s leaves (replicated)."""
    if cfg.norm == "layernorm":
        return {"scale": (None,), "bias": (None,)}
    return {"scale": (None,)}


def attention_axes(cfg: ModelConfig) -> Params:
    p: Params = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("heads",)
        p["bk"] = ("kv_heads",)
        p["bv"] = ("kv_heads",)
    return p


def mlp_axes(cfg: ModelConfig) -> Params:
    if cfg.act == "silu":
        return {"wg": ("embed", "ffn"), "wu": ("embed", "ffn"),
                "wd": ("ffn", "embed")}
    return {"wu": ("embed", "ffn"), "wd": ("ffn", "embed")}


def embedding_axes(cfg: ModelConfig) -> Params:
    p: Params = {"table": ("vocab", "embed_nofsdp")}
    if not cfg.tie_embeddings:
        p["head"] = ("embed_nofsdp", "vocab")
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
    var = settle(xf.square().mean(dim=-1, keepdim=True))
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = settle(xf.mean(dim=-1, keepdim=True))
    var = settle((xf - mu).square().mean(dim=-1, keepdim=True))
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


def _fake(x) -> bool:
    """A fake tensor, or a DTensor over one (a partitioned trace): no
    table may be cached for it."""
    return is_fake(x.to_local() if is_dtensor(x) else x)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32.  A trace on fake tensors
    (the verifier's) records the table's shape only: it uploads nothing
    from the host and caches nothing (a cached fake would reach later real
    calls)."""
    if _fake(x):
        freqs = x.new_empty((x.shape[-1] // 2,), dtype=torch.float32)
    else:
        freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    return _rotate(x, positions.float()[..., None] * freqs)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by the angles ``ang`` (B, S, D/2), in
    float32, cast back to x's dtype."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """M-RoPE (qwen2-vl): x (B, S, H, D); positions3 (B, S, 3) int32, the
    temporal / height / width ids.  The D/2 frequency slots are split into
    ``sections``; each section rotates by its own position component."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    if _fake(x):
        freqs = x.new_empty((half,), dtype=torch.float32)
        sec = x.new_empty((half,), dtype=torch.long)
    else:
        freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
        sec = _mrope_section_ids_on(tuple(sections), x.device)
    pos = along(lambda p: p.float().index_select(
        -1, sec.to_local() if is_dtensor(sec) else sec), positions3, -1)
    return _rotate(x, pos * freqs)


@functools.lru_cache(maxsize=None)
def _mrope_section_ids_on(sections: Tuple[int, int, int],
                          device: torch.device) -> torch.Tensor:
    """Each frequency slot's position component, on ``device``, uploaded
    once (as :func:`_rope_freqs_on`).  Callers only read it."""
    ids = np.concatenate([np.full((n,), i) for i, n in enumerate(sections)])
    return torch.as_tensor(ids, dtype=torch.long, device=device)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """qwen2-vl's split of the D/2 slots: 1/4 temporal, 3/8, 3/8."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def positions_rope(cfg: ModelConfig, q, k, positions):
    """(M-)RoPE on q and k at ``positions`` ((B, S) or (B, S, 3)): M-RoPE
    for an M-RoPE config (a (B, S) position gives all three components),
    else RoPE at the first component."""
    if cfg.mrope:
        secs = mrope_sections(cfg.head_dim)
        if positions.dim() == 2:      # text only: all three components
            positions = positions[..., None].expand(*positions.shape, 3)
        return (apply_mrope(q, positions, cfg.rope_theta, secs),
                apply_mrope(k, positions, cfg.rope_theta, secs))
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
    return einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 1024) -> torch.Tensor:
    """Attention forward over a prompt, in query chunks (never an (S, S)
    score matrix beyond one chunk), with causal / sliding-window masks.
    GQA: H = KH * G.  Returns (B, Sq, H, D) in q's dtype.  The
    reference's formulation of the masks K4 applies (the tests hold one
    against the other)."""
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
        o = einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
        outs.append(o.reshape(B, n, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def prefill_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Causal prefill attention, under the config's sliding window when it
    has one, through the flash-attention kernel (K4; its plain version for
    CPU tensors).  :func:`chunked_attention` is the reference's
    formulation of the same masks."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True, window=cfg.attn_window)


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention of q (B, Sq, H, D) over k / v (B, Skv, KH, D),
    Skv free (the encoder's self-attention, Skv = Sq; cross-attention over
    the encoder's frames), through the flash-attention kernel (K4; its
    plain version for CPU tensors) — the reference's
    ``chunked_attention(causal=False)``."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=False)


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
    o = einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Projections, MLP, embedding, LM head
# ---------------------------------------------------------------------------

def qkv_proj(cfg: ModelConfig, p: Params, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> q (B,S,H,D), k/v (B,S,KH,D)."""
    B, S, _ = x.shape
    q, k, v = matmul(x, p["wq"]), matmul(x, p["wk"]), matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (split_heads(q, cfg.n_heads), split_heads(k, cfg.n_kv_heads),
            split_heads(v, cfg.n_kv_heads))


def out_proj(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    """The output projection; on a partitioned trace its row-parallel
    partial sums are reduced at once (:func:`~repro_torch.distributed.
    partition.settle`)."""
    return settle(matmul(merge_heads(o, cfg.n_heads), p["wo"]))


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The MLP; its down projection's partial sums reduced at once on a
    partitioned trace, as :func:`out_proj`'s."""
    if cfg.act == "silu":
        h = F.silu(matmul(x, p["wg"])) * matmul(x, p["wu"])
    else:
        h = F.gelu(matmul(x, p["wu"]), approximate="tanh")
    return settle(matmul(h, p["wd"]))


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
    if is_dtensor(p["table"]) and split_over(p["table"], 0):
        rows = _gather_vocab_split(p["table"], ids, base, mask)
    else:
        rows = gather_rows(p["table"], ids.contiguous(), base, mask)
    return rows.reshape(*tokens.shape, rows.shape[-1])


def _gather_vocab_split(table, ids, base: int, mask: int):
    """K3 over a table split by vocab row, as the reference's partitioned
    ``take`` runs it: the ids fenced on every rank, each rank gathering
    the rows it holds by local id (the identity fence) and zeroing the
    rest, then the rows summed over the table's vocab mesh dims (one
    all-reduce)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, split = table.device_mesh, split_over(table, 0)
    ids = (ids & mask) | base
    keep = [Replicate() if m in split else pl
            for m, pl in enumerate(ids.placements)]
    ids = ids.redistribute(mesh, keep) if keep != list(ids.placements) \
        else ids
    local = table.to_local()
    rows = local.shape[0]
    lid = ids.to_local() - rank_block(mesh, split) * rows
    inside = (lid >= 0) & (lid < rows)
    got = gather_rows(local, torch.where(inside, lid, 0).contiguous(), 0,
                      -1)
    got = torch.where(inside[:, None], got, torch.zeros((), dtype=got.dtype))
    out = [Partial() if m in split else pl for m, pl in enumerate(keep)]
    return DTensor.from_local(got, mesh, out, run_check=False).redistribute(
        mesh, keep)


def _vocab_split_terms(logits, lab):
    """The log-sum-exp and the gold logit of logits split by vocab column
    (a partitioned trace), as the reference's partitioner reckons them:
    the row max and the exponentials' sum reduced over the vocab mesh dims
    (an all-reduce each), the gold logit gathered from the rank holding
    it by local column, zeros elsewhere, summed (one all-reduce)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, split = logits.device_mesh, split_over(logits, -1)
    top = settle(logits.amax(dim=-1, keepdim=True)).detach()
    lse = settle((logits - top).exp().sum(dim=-1)).log() + top[..., 0]
    keep = [Replicate() if m in split else pl
            for m, pl in enumerate(logits.placements)]
    lab = lab.redistribute(mesh, keep) if is_dtensor(lab) else \
        DTensor.from_local(lab, mesh, [Replicate()] * mesh.ndim,
                           run_check=False).redistribute(mesh, keep)
    local = logits.to_local()
    cols = local.shape[-1]
    lid = lab.to_local() - rank_block(mesh, split) * cols
    inside = (lid >= 0) & (lid < cols)
    got = torch.gather(local, -1, torch.where(inside, lid, 0)[..., None]
                       )[..., 0]
    got = torch.where(inside, got, torch.zeros((), dtype=got.dtype))
    part = [Partial() if m in split else pl for m, pl in enumerate(keep)]
    return lse, DTensor.from_local(got, mesh, part, run_check=False
                                   ).redistribute(mesh, keep)


def lm_logits(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return matmul(x, p["table"].T)
    return matmul(x, p["head"])


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean token NLL, ``repro/models/layers.py``'s: logits (B,S,V) any
    float dtype, taken in float32; labels (B,S).  A label outside the
    vocabulary reads no logit: its gold logit is NaN, as jnp's fill-mode
    ``take_along_axis`` gives (a negative one wraps once)."""
    logits = logits.float()
    V = logits.shape[-1]
    lab = labels.long()
    lab = torch.where(lab < 0, lab + V, lab)
    ok = (lab >= 0) & (lab < V)
    if is_dtensor(logits) and split_over(logits, -1):
        lse, gold = _vocab_split_terms(logits, lab.clamp(0, V - 1))
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            lab.clamp(0, V - 1)[..., None])[..., 0]
    nll = lse - torch.where(ok, gold, torch.full_like(gold, float("nan")))
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

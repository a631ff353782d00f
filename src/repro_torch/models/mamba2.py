"""Mamba2 block (SSD) — the zamba2-7b backbone layer.  A port of
``repro/models/mamba2.py``.

Block: in_proj -> [z | x | B | C | dt], causal conv1d over (x, B, C), SiLU,
chunked SSD scan, D skip, gated RMSNorm, out_proj.

Serving state per (layer, request): the SSM state (H, N, P) and the conv
tail (conv_width - 1, conv_dim) — both live in the Guardian-partitioned
state pool (fenced slot ids, space "state").
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import gathered, heads_split, \
    is_dtensor, matmul, merge_heads, settle, split_heads, split_like
from repro_torch.models import layers as L
from repro_torch.models.ssd import ssd_chunked, ssd_step

Params = Dict[str, Any]

P_HEAD = 64  # SSD head size (Mamba2 default)


def dims(cfg: ModelConfig) -> Dict[str, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    heads = max(d_in // P_HEAD, 1)
    n = s.state_dim
    conv_dim = d_in + 2 * n * 1  # single B/C group
    return {"d_in": d_in, "heads": heads, "n": n, "conv_dim": conv_dim,
            "p": d_in // heads}


def block_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random weights from ``gen`` in the config's dtype; the decay, skip,
    bias and norm parameters start where the reference's do."""
    dm = dims(cfg)
    d, d_in, heads, n = cfg.d_model, dm["d_in"], dm["heads"], dm["n"]
    dt = L.dtype_of(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    K = cfg.ssm.conv_width
    conv_w = torch.empty((K, dm["conv_dim"]), **f32)
    conv_w.normal_(0.0, 1.0 / math.sqrt(K), generator=gen)
    return {
        "in_proj": L.dense_init(gen, d, 2 * d_in + 2 * n + heads, dt,
                                device),   # z | x | B | C | dt
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((dm["conv_dim"],), dtype=dt, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, heads, **f32)),
        "d_skip": torch.ones((heads,), **f32),
        "dt_bias": torch.zeros((heads,), **f32),
        "norm_g": torch.ones((d_in,), **f32),
        "out_proj": L.dense_init(gen, d_in, d, dt, device,
                                 scale=1.0 / math.sqrt(2 * cfg.n_layers)),
    }


def block_axes(cfg: ModelConfig) -> Params:
    """Logical axes of :func:`block_init`'s leaves."""
    return {
        "in_proj": ("embed", "ffn"),
        "conv_w": (None, "ffn"),
        "conv_b": ("ffn",),
        "a_log": (None,),
        "d_skip": (None,),
        "dt_bias": (None,),
        "norm_g": ("ffn",),
        "out_proj": ("ffn", "embed"),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    dm = dims(cfg)
    d_in = dm["d_in"]
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + dm["conv_dim"]]
    dt_raw = proj[..., d_in + dm["conv_dim"]:]
    return z, xbc, dt_raw


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  xbc (B,S,C), w (K,C).  ``tail`` is the
    previous (K-1, C) inputs (decode); returns (out, new_tail)."""
    K = w.shape[0]
    B, S, C = xbc.shape
    # on a partitioned trace the inputs' channels are split as the
    # weights' are (a local chunk) and the zeros placed as xbc (a
    # factory's are whole on every rank): DTensor versions that would
    # otherwise meet them by gathering xbc's batch keep it split
    split = is_dtensor(xbc)
    xbc = split_like(xbc, -1, w, -1)
    if tail is None:
        tail_in = torch.zeros_like(xbc[:, :1]).expand(B, K - 1, C) \
            if split else xbc.new_zeros((B, K - 1, C))
    else:
        tail_in = split_like(tail.to(xbc.dtype), -1, w, -1)
    xp = torch.cat([tail_in, xbc], dim=1)             # (B, S+K-1, C)
    out = torch.zeros_like(xbc, dtype=torch.float32) if split else \
        torch.zeros((B, S, C), dtype=torch.float32, device=xbc.device)
    for i in range(K):
        out = out + xp[:, i:i + S].float() * w[i].float()
    out = out + b.float()
    return out.to(xbc.dtype), xp[:, S:]                # last K-1 inputs


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """On a partitioned trace the norm's scale is gathered whole first,
    so the norm keeps y's batch split on every DTensor version."""
    y = y * F.silu(z.float()).to(y.dtype)
    return L.rmsnorm(y, gathered(g, 0))


def _gates(p: Params, dt_raw: torch.Tensor):
    """(dt, log decay) from the raw dt projection: softplus(dt + bias) and
    dt * -exp(a_log)."""
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    return dt, dt * -torch.exp(p["a_log"])


def _padded_heads(u: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, h: Optional[torch.Tensor]):
    """The chunked SSD's DTensor operands u (B, S, H, P), a (B, S, H), b / c
    (B, S, H, N) and the state h (B, H, N, P) or None with their heads
    padded with zero heads to a multiple of the ranks that split them and
    split there, every operand placed as u (:func:`~repro_torch.
    distributed.partition.heads_split`, as the reference's partitioner
    pads them): a padded head has zero input, zero b / c, zero log decay
    and zero state, so its output and state stay zero, and each rank runs
    ``ceil(H / ranks)`` heads, none all of them."""
    from torch.distributed.tensor import Replicate, Shard

    u = heads_split(u, 2)[0]
    pl, n = u.placements, u.shape[2]
    a, b, c = (_padded(t, 2, n, pl) for t in (a, b, c))
    if h is not None:
        h = _padded(h, 1, n, [Shard(1) if p == Shard(2) else p if p ==
                              Shard(0) else Replicate() for p in pl])
    return u, a, b, c, h


def _padded(x: torch.Tensor, dim: int, n: int, placements) -> torch.Tensor:
    """DTensor ``x`` with zeros appended to its dim ``dim`` up to ``n``,
    placed by ``placements``."""
    if x.shape[dim] < n:
        shape = list(x.shape)
        shape[dim] = n - x.shape[dim]
        x = torch.cat([x, x.new_zeros(shape)], dim)
    return x.redistribute(x.device_mesh, list(placements))


def block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None,
                conv_tail: Optional[torch.Tensor] = None,
                pad_heads: bool = False,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence SSD block.  x (B,S,d) -> (y (B,S,d), h_final,
    conv_tail).  ``pad_heads`` (the prefill's) pads the SSD's heads on a
    partitioned trace (:func:`_padded_heads`), as the reference's
    partitioner splits its prefill; its train step runs every head on
    every model rank, and so does the port's (the default)."""
    dm = dims(cfg)
    heads, n, pdim = dm["heads"], dm["n"], dm["p"]
    B, S, _ = x.shape
    z, xbc, dt_raw = _split_proj(cfg, matmul(x, p["in_proj"], idle=True))
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_tail)
    xbc = F.silu(xbc.float())
    xs = split_heads(xbc[..., :dm["d_in"]], heads)
    b_in = xbc[..., dm["d_in"]:dm["d_in"] + n]        # (B,S,N)
    c_in = xbc[..., dm["d_in"] + n:]                  # (B,S,N)
    dt, log_decay = _gates(p, dt_raw)                  # (B,S,H)
    u = xs * dt[..., None]                             # dt-scaled input
    bb = b_in[:, :, None, :].expand(B, S, heads, n)
    cc = c_in[:, :, None, :].expand(B, S, heads, n)
    pad = pad_heads and is_dtensor(u)
    if pad:
        u, log_decay, bb, cc, h0 = _padded_heads(u, log_decay, bb, cc, h0)
    y, h_final = ssd_chunked(u, log_decay, bb, cc, h0=h0,
                             chunk=cfg.ssm.chunk)
    if pad:         # the padded heads dropped
        y, h_final = y.narrow(2, 0, heads), h_final.narrow(1, 0, heads)
    y = y + p["d_skip"][None, None, :, None] * xs
    y = merge_heads(y, heads).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_g"])
    return settle(matmul(y, p["out_proj"])), h_final, new_tail


def block_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
               h: torch.Tensor, conv_tail: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode step.  x (B,1,d), h (B,H,N,P), conv_tail
    (B,K-1,conv_dim)."""
    dm = dims(cfg)
    heads, n, pdim = dm["heads"], dm["n"], dm["p"]
    B = x.shape[0]
    z, xbc, dt_raw = _split_proj(cfg, matmul(x, p["in_proj"], idle=True))
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_tail)
    xbc = F.silu(xbc.float())
    xs = split_heads(xbc[:, 0, :dm["d_in"]], heads)
    b_in = xbc[:, 0, dm["d_in"]:dm["d_in"] + n]
    c_in = xbc[:, 0, dm["d_in"] + n:]
    dt, log_decay = _gates(p, dt_raw[:, 0])            # (B,H)
    u = xs * dt[..., None]
    # the state split over the model axis by its N dim, as the reference
    # keeps it (a local chunk where a DTensor version reads it whole)
    h = split_like(h, 2, u, None)
    bb = b_in[:, None, :].expand(B, heads, n)
    cc = c_in[:, None, :].expand(B, heads, n)
    y, h_new = ssd_step(u, log_decay, bb, cc, h)
    y = y + p["d_skip"][None, :, None] * xs
    y = merge_heads(y, heads)[:, None].to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_g"])
    return settle(matmul(y, p["out_proj"])), h_new, new_tail


def state_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-request state entry shapes for the Guardian state pool."""
    dm = dims(cfg)
    return {
        "ssm": (dm["heads"], dm["n"], dm["p"]),
        "conv": (cfg.ssm.conv_width - 1, dm["conv_dim"]),
    }

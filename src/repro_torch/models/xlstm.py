"""xLSTM — alternating mLSTM / sLSTM blocks (xlstm-350m).  A port of
``repro/models/xlstm.py``.

* **mLSTM** (even layers): matrix memory C_t = f_t C_{t-1} + i_t v_t k_tᵀ,
  read y_t = (q_t·C_t) / max(|q_t·n_t|, 1), computed chunkwise on the
  shared SSD scan (the same recurrence with scalar gates), with the
  reference's sigmoid input gate.
* **sLSTM** (odd layers): scalar memory with recurrent gate connections —
  strictly sequential, a loop over time with exp-gate stabilization.

Params: ``mlstm`` and ``slstm`` are one block dict per (mLSTM, sLSTM)
pair; the reference stacks them and scans, the port loops.

Attention-free: the Guardian-guarded resource is the recurrent **state
pool** (:class:`repro_torch.models.kvcache.StateCache`, fenced slot ids,
space "state").  The only hand-written kernel on the path is the embedding
gather (K3), in training too (:func:`forward` / :func:`loss_fn`, the
sLSTM a loop over positions under autograd).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import einsum, fit_split, \
    is_dtensor, matmul, merge_heads, settle, split_heads
from repro_torch.distributed.sharding import ShardingRules, constrain
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.guard import GuardSpec
from repro_torch.models.ssd import loop_trips, ssd_chunked, ssd_step, \
    stack_steps

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, H, D = cfg.d_model, cfg.n_heads, cfg.head_dim
    dt = L.dtype_of(cfg)
    return {
        "wq": L.dense_init(gen, d, H * D, dt, device),
        "wk": L.dense_init(gen, d, H * D, dt, device),
        "wv": L.dense_init(gen, d, H * D, dt, device),
        "w_if": L.dense_init(gen, d, 2 * H, dt, device),  # input & forget
        "wo_gate": L.dense_init(gen, d, H * D, dt, device),
        "wo": L.dense_init(gen, H * D, d, dt, device,
                           scale=1.0 / math.sqrt(2 * cfg.n_layers)),
        "norm": L.norm_init(cfg, device),
    }


def mlstm_axes(cfg: ModelConfig) -> Params:
    return {
        "wq": ("embed", "heads"), "wk": ("embed", "heads"),
        "wv": ("embed", "heads"), "w_if": ("embed", None),
        "wo_gate": ("embed", "heads"), "wo": ("heads", "embed"),
        "norm": L.norm_axes(cfg),
    }


def _mlstm_gates(p, xn):
    gates = matmul(xn, p["w_if"])
    H2 = gates.shape[-1] // 2
    i_raw, f_raw = gates[..., :H2], gates[..., H2:]
    f = f_raw.float()
    # DTensor has no rule for log_sigmoid (its CPU op hands back a
    # workspace): on a partitioned trace the same value as -softplus(-f)
    log_f = -torch.nn.functional.softplus(-f) if is_dtensor(f) \
        else torch.nn.functional.logsigmoid(f)
    return torch.sigmoid(i_raw.float()), log_f


def _mlstm_qkv(cfg, p, xn):
    H = cfg.n_heads
    q = split_heads(matmul(xn, p["wq"]), H)
    k = split_heads(matmul(xn, p["wk"]), H) / math.sqrt(cfg.head_dim)
    v = split_heads(matmul(xn, p["wv"]), H)
    return q, k, v


def _chunk(cfg: ModelConfig) -> int:
    return cfg.ssm.chunk if cfg.ssm else 64


def mlstm_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                h0: Optional[torch.Tensor] = None,
                n0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y, h_final (B,H,D,D), n_final (B,H,D,1))."""
    B, S, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    xn = L.apply_norm(cfg, p["norm"], x)
    q, k, v = _mlstm_qkv(cfg, p, xn)
    i_gate, log_f = _mlstm_gates(p, xn)                  # (B,S,H)
    b = k.float() * i_gate[..., None]                    # i-scaled keys
    y_num, h_f = ssd_chunked(v.float(), log_f, b, q.float(), h0=h0,
                             chunk=_chunk(cfg))
    ones = torch.ones((B, S, H, 1), dtype=torch.float32, device=x.device)
    y_den, n_f = ssd_chunked(ones, log_f, b, q.float(), h0=n0,
                             chunk=_chunk(cfg))
    y = y_num / torch.clamp(torch.abs(y_den), min=1.0)
    o_gate = torch.sigmoid(matmul(xn, p["wo_gate"]).float())
    y = (merge_heads(y, H) * o_gate).to(x.dtype)
    return settle(matmul(y, p["wo"])), h_f, n_f


def mlstm_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
               h: torch.Tensor, n: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,1,d); h (B,H,D,D); n (B,H,D,1)."""
    B = x.shape[0]
    H, D = cfg.n_heads, cfg.head_dim
    xn = L.apply_norm(cfg, p["norm"], x)
    q, k, v = _mlstm_qkv(cfg, p, xn)
    i_gate, log_f = _mlstm_gates(p, xn)
    b = k[:, 0].float() * i_gate[:, 0, :, None]
    y_num, h_new = ssd_step(v[:, 0].float(), log_f[:, 0], b,
                            q[:, 0].float(), h)
    ones = torch.ones((B, H, 1), dtype=torch.float32, device=x.device)
    y_den, n_new = ssd_step(ones, log_f[:, 0], b, q[:, 0].float(), n)
    y = y_num / torch.clamp(torch.abs(y_den), min=1.0)
    o_gate = torch.sigmoid(matmul(xn, p["wo_gate"]).float())
    y = (merge_heads(y, H)[:, None] * o_gate).to(x.dtype)
    return settle(matmul(y, p["wo"])), h_new, n_new


# ---------------------------------------------------------------------------
# sLSTM block — sequential scalar memory with recurrent connections
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    dt = L.dtype_of(cfg)
    r = torch.empty((H, hd, 4 * hd), dtype=torch.float32, device=device)
    r.normal_(0.0, 1.0 / math.sqrt(hd), generator=gen)
    return {
        "w_in": L.dense_init(gen, d, 4 * d, dt, device),  # z,i,f,o
        "r": r.to(dt),                                   # block-diag
        "wo": L.dense_init(gen, d, d, dt, device,
                           scale=1.0 / math.sqrt(2 * cfg.n_layers)),
        "norm": L.norm_init(cfg, device),
    }


def slstm_axes(cfg: ModelConfig) -> Params:
    return {"w_in": ("embed", None), "r": (None, None, None),
            "wo": ("embed", "embed_nofsdp"), "norm": L.norm_axes(cfg)}


def _slstm_cell(cfg, p, pre, state):
    """One time step.  pre: (B, 4d) input pre-activations; state = (c, n,
    h, m): c, n, h (B, d); m (B, H)."""
    H = cfg.n_heads
    B = pre.shape[0]
    d = pre.shape[-1] // 4
    hd = d // H
    c, n, h, m = state
    rec = einsum("bhx,hxy->bhy", fit_split(h, -1, H).reshape(B, H, hd)
                 .float(), p["r"].float()).reshape(B, 4 * d)
    z_r, i_r, f_r, o_r = (pre.float() + rec).chunk(4, dim=-1)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    i_h = fit_split(i_r, -1, H).reshape(B, H, hd)
    f_h = fit_split(f_r, -1, H).reshape(B, H, hd)
    # exp gates with max-state stabilization (per head: the head max)
    i_s = i_h.amax(dim=-1)
    f_s = f_h.amax(dim=-1)
    m_new = torch.maximum(f_s + m, i_s)                     # (B,H)
    i_gate = torch.exp(i_h - m_new[..., None]).reshape(B, d)
    f_gate = torch.exp(f_h + (m - m_new)[..., None]).reshape(B, d)
    c_new = f_gate * c + i_gate * z
    n_new = f_gate * n + i_gate
    h_new = o * (c_new / torch.clamp(torch.abs(n_new), min=1e-6))
    return (c_new, n_new, h_new, m_new)


def slstm_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state0=None) -> Tuple[torch.Tensor, Tuple]:
    B, S, d = x.shape
    xn = L.apply_norm(cfg, p["norm"], x)
    pre = matmul(xn, p["w_in"])                             # (B,S,4d)
    state = slstm_zero_state(cfg, B, x.device) if state0 is None \
        else state0
    hs = []
    for t in range(loop_trips("slstm", S)):
        state = _slstm_cell(cfg, p, pre[:, t], state)
        hs.append(state[2])
    y = stack_steps(hs, S, 1).to(x.dtype)                   # (B,S,d)
    return settle(matmul(y, p["wo"])), state


def slstm_zero_state(cfg: ModelConfig, B: int, device="cuda"):
    """(c, n, h, m) of a fresh sequence; the stabiliser starts at -1e30."""
    d, H = cfg.d_model, cfg.n_heads
    z = torch.zeros((B, d), dtype=torch.float32, device=device)
    return (z, z, z, torch.full((B, H), -1e30, dtype=torch.float32,
                                device=device))


# ---------------------------------------------------------------------------
# Full model — (mLSTM, sLSTM) pairs
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    """Random weights from ``generator`` (which must live on ``device``)."""
    n_pairs = cfg.n_layers // 2
    return {
        "embed": L.embedding_init(generator, cfg, device),
        "mlstm": [mlstm_init(generator, cfg, device)
                  for _ in range(n_pairs)],
        "slstm": [slstm_init(generator, cfg, device)
                  for _ in range(n_pairs)],
        "norm_f": L.norm_init(cfg, device),
    }


def param_logical_axes(cfg: ModelConfig) -> Params:
    """Logical axes matching :func:`init`'s tree, one dict per pair."""
    n_pairs = cfg.n_layers // 2
    return {
        "embed": L.embedding_axes(cfg),
        "mlstm": [mlstm_axes(cfg) for _ in range(n_pairs)],
        "slstm": [slstm_axes(cfg) for _ in range(n_pairs)],
        "norm_f": L.norm_axes(cfg),
    }


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *,
            guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None,
            remat: bool = False) -> torch.Tensor:
    """Full-sequence logits (B, S, V).  ``remat`` recomputes each
    (mLSTM, sLSTM) pair in the backward pass, as the reference's
    ``jax.checkpoint(nothing_saveable)`` over its pair scan."""
    x = L.embed_tokens(params["embed"], tokens, guard)

    def pair(ps, x):
        pm, psl = ps
        x = x + mlstm_apply(cfg, pm, x)[0]
        x = x + slstm_apply(cfg, psl, x)[0]
        return (constrain(x, rules, ("batch", "seq", None)),)

    (x,) = TF.run_layers(pair, list(zip(params["mlstm"], params["slstm"])),
                         x, remat=remat)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return L.lm_logits(cfg, params["embed"], x)


#: mean next-token NLL (``transformer.next_token_loss``), remat on
loss_fn = functools.partial(TF.next_token_loss, forward)


# ---------------------------------------------------------------------------
# Serving — recurrent state pool only (no KV)
# ---------------------------------------------------------------------------

#: the sLSTM state pools, in the order of ``_slstm_cell``'s state tuple
SLSTM_STATE = ("slstm_c", "slstm_n", "slstm_h", "slstm_m")


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
               slots: Optional[int] = None,
               device="cuda") -> KV.StateCache:
    """The state pools of ``slots`` slots (default ``pow2(batch)``), all
    float32 whatever ``dtype`` (as the reference's), the sLSTM stabiliser
    at -1e30."""
    n_pairs = cfg.n_layers // 2
    H, D, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    if slots is None:
        slots = KV._pow2_at_least(batch)
    f32 = dict(dtype=torch.float32, device=device)
    pools = {
        "mlstm_h": torch.zeros((n_pairs, slots, H, D, D), **f32),
        "mlstm_n": torch.zeros((n_pairs, slots, H, D, 1), **f32),
        "slstm_c": torch.zeros((n_pairs, slots, d), **f32),
        "slstm_n": torch.zeros((n_pairs, slots, d), **f32),
        "slstm_h": torch.zeros((n_pairs, slots, d), **f32),
        "slstm_m": torch.full((n_pairs, slots, H), -1e30, **f32),
    }
    i32 = dict(dtype=torch.int32, device=device)
    return KV.StateCache(pools=pools, slot_ids=torch.arange(batch, **i32),
                         seq_lens=torch.zeros((batch,), **i32))


def prefill(cfg: ModelConfig, params: Params, cache: KV.StateCache,
            tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None
            ) -> Tuple[KV.StateCache, torch.Tensor]:
    """Process the prompt full-sequence, write each layer's final
    recurrent state into the (fenced) state pool in place, return the
    last position's logits (B, V)."""
    S = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens, guard)
    for li, (pm, psl) in enumerate(zip(params["mlstm"], params["slstm"])):
        y, h_f, n_f = mlstm_apply(cfg, pm, x)
        cache.write("mlstm_h", li, h_f, guard)
        cache.write("mlstm_n", li, n_f, guard)
        x = x + y
        y, st = slstm_apply(cfg, psl, x)
        for name, value in zip(SLSTM_STATE, st):
            cache.write(name, li, value, guard)
        x = constrain(x + y, rules, ("batch", "seq", None))
    cache = dataclasses.replace(cache, seq_lens=cache.seq_lens + S)
    x = L.apply_norm(cfg, params["norm_f"], x[:, -1:])
    return cache, L.lm_logits(cfg, params["embed"], x)[:, 0]


def decode(cfg: ModelConfig, params: Params, cache: KV.StateCache,
           tokens: torch.Tensor, *, guard: Optional[GuardSpec] = None,
           rules: Optional[ShardingRules] = None
           ) -> Tuple[KV.StateCache, torch.Tensor]:
    """One decode step: tokens (B,) -> logits (B, V); the state pools are
    read and written in place."""
    x = L.embed_tokens(params["embed"], tokens[:, None], guard)
    for li, (pm, psl) in enumerate(zip(params["mlstm"], params["slstm"])):
        h = cache.read("mlstm_h", li, guard)
        n = cache.read("mlstm_n", li, guard)
        y, h, n = mlstm_step(cfg, pm, x, h, n)
        cache.write("mlstm_h", li, h, guard)
        cache.write("mlstm_n", li, n, guard)
        x = x + y
        st = tuple(cache.read(name, li, guard) for name in SLSTM_STATE)
        xn = L.apply_norm(cfg, psl["norm"], x)
        st = _slstm_cell(cfg, psl, matmul(xn, psl["w_in"])[:, 0], st)
        for name, value in zip(SLSTM_STATE, st):
            cache.write(name, li, value, guard)
        x = x + settle(matmul(st[2].to(x.dtype)[:, None, :], psl["wo"]))
    cache = dataclasses.replace(cache, seq_lens=cache.seq_lens + 1)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return cache, L.lm_logits(cfg, params["embed"], x)[:, 0]

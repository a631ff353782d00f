"""Chunked SSD (state-space dual) scan — the Mamba2 primitive, shared by
the zamba2 Mamba2 blocks and the xLSTM mLSTM blocks (the same recurrence
with scalar gates).  A port of ``repro/models/ssd.py``.

Recurrence (per batch, head):

    h_t = exp(a_t) * h_{t-1} + b_t ⊗ u_t          h: (N, P) state
    y_t = c_t · h_t                                y: (P,)

with a_t a scalar log-decay, b_t, c_t: (N,), u_t: (P,).  The chunked
algorithm (Mamba2 §6) splits S into chunks of length Q: intra-chunk
contributions through a (Q, Q) masked decay matrix, inter-chunk ones
through a short loop over the chunk states (the reference's ``lax.scan``;
the chunk count is a host int from the shapes, so a captured step never
syncs).

Everything is float32 inside (the decays are exps of sums).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) per-step log decays -> (..., Q, Q) lower-triangular
    L[t, s] = sum_{s < r <= t} a[r] (t >= s), -1e30 above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, torch.full((), NEG_INF, device=a.device))


def ssd_chunked(u: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, h0: Optional[torch.Tensor] = None,
                chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B,S,H,P) dt-scaled inputs, a (B,S,H) log decays, b/c (B,S,H,N)
    input/output maps, h0 (B,H,N,P) -> (y (B,S,H,P), h_final (B,H,N,P)),
    float32."""
    B, S, H, P = u.shape
    N = b.shape[-1]
    pad = (-S) % chunk
    if pad:
        u = F.pad(u, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // chunk
    u = u.reshape(B, nc, chunk, H, P).float()
    a = a.reshape(B, nc, chunk, H).float()
    b = b.reshape(B, nc, chunk, H, N).float()
    c = c.reshape(B, nc, chunk, H, N).float()

    a_hq = a.movedim(-1, -2)                          # (B,nc,H,Q)
    L = torch.exp(segsum(a_hq))                       # (B,nc,H,Q,Q)

    # intra-chunk: y[t] = sum_{s<=t} (c_t·b_s) L[t,s] u_s
    cb = torch.einsum("bcqhn,bcshn->bchqs", c, b)
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", cb * L, u)

    # chunk states: h_c = sum_s exp(A_end - A_s) b_s ⊗ u_s
    cs = torch.cumsum(a_hq, dim=-1)                   # (B,nc,H,Q)
    d2e = torch.exp(cs[..., -1:] - cs).movedim(-1, -2)  # (B,nc,Q,H)
    states = torch.einsum("bcshn,bcshp->bchnp", b * d2e[..., None], u)

    # inter-chunk recurrence over the nc chunks: each chunk reads the
    # state before it
    chunk_decay = torch.exp(cs[..., -1])              # (B,nc,H)
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    prev = []
    for ci in range(nc):
        prev.append(h)
        h = chunk_decay[:, ci, :, None, None] * h + states[:, ci]
    prev_states = torch.stack(prev, dim=1)            # (B,nc,H,N,P)

    # inter-chunk: y[t] += (c_t · H_{c-1}) * exp(A_t)
    state_decay_in = torch.exp(cs.movedim(-1, -2))    # (B,nc,Q,H)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", c, prev_states) \
        * state_decay_in[..., None]

    y = (y_intra + y_inter).reshape(B, Sp, H, P)[:, :S]
    return y, h


def ssd_step(u: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode token: u (B,H,P), a (B,H), b/c (B,H,N), h (B,H,N,P) ->
    (y (B,H,P), h')."""
    h = h.float()
    h_new = (torch.exp(a.float())[..., None, None] * h
             + torch.einsum("bhn,bhp->bhnp", b.float(), u.float()))
    y = torch.einsum("bhn,bhnp->bhp", c.float(), h_new)
    return y, h_new


def ssd_reference(u, a, b, c, h0=None):
    """The O(S) sequential oracle: :func:`ssd_chunked`'s semantics, step by
    step."""
    B, S, H, P = u.shape
    N = b.shape[-1]
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        y, h = ssd_step(u[:, t], a[:, t], b[:, t], c[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h

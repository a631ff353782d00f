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

The reference runs this loop and the sLSTM's loop over positions as
``lax.scan``, which lowers to one ``while``.  The port's Python loops
unroll in a trace instead (32,768 sLSTM cells a layer at 32k), so a trace
may cut them: within :func:`cut_loops` a loop of kind ``k`` runs
:func:`loop_trips` steps, not its ``n``, and :func:`stack_steps` pads the
steps it skipped with an allocation that moves no data.  Every step of
such a loop has the same shapes, and every step but the first and the
last does the same work (forward and backward), so two cut traces, of 2
and 3 steps, give a trace's work at ``n``
(:func:`repro_torch.launch.graph_analysis.trace_step`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.partition import along, contiguous, einsum

NEG_INF = -1e30

#: the loops a trace cuts: kind -> steps run, and kind -> the steps the
#: loop has (recorded as the trace meets it); None outside :func:`cut_loops`
_CUT: List[Optional[Tuple[Dict[str, int], Dict[str, int]]]] = [None]


@contextlib.contextmanager
def cut_loops(trips: Dict[str, int]):
    """Within ``with``: each loop of a kind in ``trips`` (``"ssd"``, the
    inter-chunk state; ``"slstm"``, the sLSTM's positions) runs at most
    ``trips[kind]`` steps where it has more than 3.  Yields the steps each
    cut kind has (kind -> n), filled in as the loops run; a kind met with
    two different step counts raises."""
    before = _CUT[0]
    _CUT[0] = (dict(trips), {})
    try:
        yield _CUT[0][1]
    finally:
        _CUT[0] = before


def loop_trips(kind: str, n: int) -> int:
    """The steps a loop of ``kind`` over ``n`` runs: ``n``, or the cut's
    (:func:`cut_loops`)."""
    cut = _CUT[0]
    if cut is None or kind not in cut[0] or n <= 3:
        return n
    seen = cut[1].setdefault(kind, n)
    if seen != n:
        raise ValueError(f"a cut {kind!r} loop over {n} steps after one "
                         f"over {seen}: the trace cannot be extrapolated")
    return min(n, cut[0][kind])


def stack_steps(ys: List[torch.Tensor], n: int, dim: int) -> torch.Tensor:
    """``torch.stack(ys, dim)`` of a loop's ``n`` step results; for a cut
    loop (fewer than ``n``), the same shape, the skipped steps an
    uninitialised allocation (a trace's placeholder: no data moves)."""
    if len(ys) == n:
        return torch.stack(ys, dim=dim)
    pad = list(ys[0].unsqueeze(dim).shape)
    pad[dim] = n - len(ys)
    return torch.cat([y.unsqueeze(dim) for y in ys]
                     + [ys[0].new_empty(pad)], dim=dim)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) per-step log decays -> (..., Q, Q) lower-triangular
    L[t, s] = sum_{s < r <= t} a[r] (t >= s), -1e30 above the diagonal."""
    Q = a.shape[-1]
    cs = along(lambda t: torch.cumsum(t, dim=-1), a, -1)
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
    cb = einsum("bcqhn,bcshn->bchqs", c, b)
    y_intra = einsum("bchqs,bcshp->bcqhp", cb * L, u)

    # chunk states: h_c = sum_s exp(A_end - A_s) b_s ⊗ u_s
    cs = along(lambda t: torch.cumsum(t, dim=-1), a_hq, -1)  # (B,nc,H,Q)
    d2e = torch.exp(cs[..., -1:] - cs).movedim(-1, -2)  # (B,nc,Q,H)
    states = einsum("bcshn,bcshp->bchnp", b * d2e[..., None], u)

    # inter-chunk recurrence over the nc chunks: each chunk reads the
    # state before it
    chunk_decay = torch.exp(cs[..., -1])              # (B,nc,H)
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    prev = []
    for ci in range(loop_trips("ssd", nc)):
        prev.append(h)
        h = chunk_decay[:, ci, :, None, None] * h + states[:, ci]
    prev_states = stack_steps(prev, nc, 1)            # (B,nc,H,N,P)

    # inter-chunk: y[t] += (c_t · H_{c-1}) * exp(A_t)
    state_decay_in = torch.exp(cs.movedim(-1, -2))    # (B,nc,Q,H)
    y_inter = einsum("bcqhn,bchnp->bcqhp", c, prev_states) \
        * state_decay_in[..., None]

    y = contiguous(y_intra + y_inter).reshape(B, Sp, H, P)[:, :S]
    return y, h


def ssd_step(u: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode token: u (B,H,P), a (B,H), b/c (B,H,N), h (B,H,N,P) ->
    (y (B,H,P), h')."""
    h = h.float()
    h_new = (torch.exp(a.float())[..., None, None] * h
             + einsum("bhn,bhp->bhnp", b.float(), u.float()))
    y = einsum("bhn,bhnp->bhp", c.float(), h_new)
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

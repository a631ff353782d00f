"""Gradient compression for a cross-group reduction — blockwise int8
quantization with error feedback, as ``repro/distributed/compress.py``.

Each tensor is cut into blocks of 256 values, one float32 scale a block
(``amax / 127``); values are divided by their scale, rounded half to even
and clipped to [-127, 127] — true divisions, so the codes are the same
bits on the CPU and the card.  The residual ``x - deQ(Q(x))`` is carried to
the next step (error feedback).  :func:`tree_compress_psum` averages a
gradient tree over a ``torch.distributed`` process group with only the
int8 codes and the float32 scales on the wire (the reference's payload,
~4x fewer bytes than a float32 all-reduce).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.stepgraph import tree_flatten, tree_unflatten

_BLOCK = 256  # quantization block (lanes) — one scale per block


def _pad_to(x: torch.Tensor, mult: int) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    flat = x.reshape(-1)
    rem = (-n) % mult
    if rem:
        flat = torch.cat([flat, flat.new_zeros((rem,))])
    return flat, n


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise symmetric int8: ``(q (blocks, 256) int8, scales (blocks,
    1) float32, n)``."""
    flat, n = _pad_to(x.to(torch.float32), _BLOCK)
    blocks = flat.reshape(-1, _BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # a true division on every device: CUDA divides by a Python scalar as
    # a product with its rounded reciprocal
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int,
                    shape, dtype) -> torch.Tensor:
    x = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return x.reshape(shape).to(dtype)


def compress_roundtrip(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize then dequantize: ``(approx, residual)``; the residual is the
    error-feedback term added to the next step's gradient."""
    q, s, n = quantize_int8(x)
    approx = dequantize_int8(q, s, n, x.shape, x.dtype)
    return approx, (x - approx).to(x.dtype)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every rank of ``group``, stacked on a new leading axis in
    rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def tree_compress_psum(grads: Any, err: Any, group) -> Tuple[Any, Any]:
    """Error-feedback int8 mean of a gradient tree over the process group
    ``group`` (a one-rank group is a group like any other).

    ``g_eff = g + err``; ``q, s = Q(g_eff)``; the int8 codes and the
    scales of every rank are all-gathered, dequantized locally and
    averaged; ``err' = g_eff - deQ(q, s)``.  Returns ``(mean, err')``, each
    a tree like ``grads``."""
    size = dist.get_world_size(group)

    def one(g, e):
        g_eff = g + e.to(g.dtype)
        q, s, n = quantize_int8(g_eff)
        # int8 codes + scales cross the link — not float32 tensors
        q_all, s_all = _all_gather(q, group), _all_gather(s, group)
        local = dequantize_int8(q, s, n, g_eff.shape, torch.float32)
        resid = (g_eff.to(torch.float32) - local).to(g.dtype)
        total = (q_all.to(torch.float32) * s_all).sum(dim=0)
        red = total.reshape(-1)[:n].reshape(g_eff.shape)
        red = red / torch.full_like(red, size)
        return red.to(g.dtype), resid

    struct, flat_g = tree_flatten(grads)
    flat_e = tree_flatten(err)[1]
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(struct, [o[0] for o in outs]),
            tree_unflatten(struct, [o[1] for o in outs]))


def init_error_feedback(grads: Any) -> Any:
    struct, leaves = tree_flatten(grads)
    return tree_unflatten(struct, [torch.zeros_like(g) for g in leaves])

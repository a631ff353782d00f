"""Optimizers — AdamW and Adafactor on trees (dicts / lists) of tensors,
the math of ``repro/optim/optimizers.py``.

API (optax-like, as the reference's):

    opt = adamw(schedule, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The reference's step donates its params and optimizer state
(``donate_argnums=(0, 1)``); here the moments are updated in place (the
state handed back holds the same ``m`` / ``v`` tensors and a new step
counter) and :func:`apply_updates` adds to the params in place.  Moments
are float32 beside any param dtype and every update is computed in
float32, then cast to the param's dtype when it is added — unlike
``torch.optim.AdamW``, which keeps its state in the param's dtype.  The
step counter, the learning rate and the bias corrections are 0-d tensors
on the params' device: an update never syncs with the host.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.stepgraph import tree_flatten, tree_unflatten

#: float32 elements of one group of leaves updated together: bounds the
#: update's float32 temporaries (a group's gradients, corrected moments
#: and params) to a few hundred MB whatever the model's size
_GROUP_NUMEL = 1 << 26


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (dicts, lists, tuples),
    with the values at the same place in each of ``rest`` (which may hold
    a whole sub-tree there, e.g. Adafactor's per-leaf state dict)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates`` cast to each param's dtype, in place (the
    reference donates its params); returns ``params``."""
    _, ps = tree_flatten(params)
    _, us = tree_flatten(updates)
    for p, u in zip(ps, us):
        p.add_(u.to(p.dtype))
    return params


def _sq_norms(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum over ``leaves`` of the sum of squares, in float32."""
    norms = torch._foreach_norm(list(leaves), 2, dtype=torch.float32)
    return torch.stack(norms).square().sum()


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(_sq_norms(tree_flatten(tree)[1]))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """``(grads * scale, norm)`` with ``scale = min(1, max_norm / norm)``
    cast to each gradient's dtype first, as the reference multiplies."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda g: g * scale.to(g.dtype), grads), norm


def _groups(leaves: Sequence[torch.Tensor]) -> List[List[int]]:
    out: List[List[int]] = [[]]
    n = 0
    for i, t in enumerate(leaves):
        if out[-1] and n + t.numel() > _GROUP_NUMEL:
            out.append([])
            n = 0
        out[-1].append(i)
        n += t.numel()
    return out if out[0] else []


def _step_device(params) -> Optional[torch.device]:
    leaves = tree_flatten(params)[1]
    return leaves[0].device if leaves else None


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(schedule: Callable, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                      device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_step_device(params)),
                "m": _map(zeros, params),
                "v": _map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        struct, gs = tree_flatten(grads)
        ms, vs = tree_flatten(state["m"])[1], tree_flatten(state["v"])[1]
        ps = tree_flatten(params)[1]
        scale = _clip_scale(torch.sqrt(_sq_norms(gs)), clip_norm) \
            if clip_norm is not None else None
        lr = schedule(step)
        stepf = step.to(torch.float32)
        b1t = 1.0 - torch.pow(b1, stepf)
        b2t = 1.0 - torch.pow(b2, stepf)
        neg_lr = -lr
        updates: List[torch.Tensor] = [None] * len(gs)
        for idx in _groups(gs):
            g = [gs[i] if scale is None else gs[i] * scale.to(gs[i].dtype)
                 for i in idx]
            g = [t.to(torch.float32) for t in g]
            m, v = [ms[i] for i in idx], [vs[i] for i in idx]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, g, g, value=1 - b2)
            del g
            denom = torch._foreach_div(v, b2t)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            u = torch._foreach_div(m, b1t)
            torch._foreach_div_(u, denom)
            del denom
            if weight_decay:
                torch._foreach_add_(
                    u, [ps[i].to(torch.float32) for i in idx],
                    alpha=weight_decay)
            torch._foreach_mul_(u, neg_lr)
            for i, t in zip(idx, u):
                updates[i] = t
        return tree_unflatten(struct, updates), \
            {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment — O(n+m) state for (n,m) weights)
# ---------------------------------------------------------------------------

def adafactor(schedule: Callable, *, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros((*p.shape[:-2], p.shape[-1]),
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_step_device(params)),
                "v": _map(one, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr = schedule(step)
        beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-decay)

        def upd(g, v, p):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if _factored(g.shape):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                rfac = torch.rsqrt(
                    vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                    + eps)
                cfac = torch.rsqrt(vc + eps)
                u = g * rfac[..., None] * cfac[..., None, :]
                v_new = {"vr": vr, "vc": vc}
            else:
                v_new_ = beta * v["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v_new_ + eps)
                v_new = {"v": v_new_}
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            u = -lr * (u + weight_decay * p.to(torch.float32))
            return u, v_new

        new_v = []

        def leaf(g, v, p):
            u, v_new = upd(g, v, p)
            new_v.append(v_new)
            return u

        updates = _map(leaf, grads, state["v"], params)
        it = iter(new_v)
        return updates, {"step": step, "v": _map(lambda g: next(it), grads)}

    return Optimizer(init=init, update=update)

"""GuardSpec — how Guardian fencing threads through model data paths.

The dynamically computed addresses of the model stack are:

    vocab    token ids            -> embedding-row gather
    kv       sequence-slot ids /  -> paged-KV pool reads/writes
             virtual page ids
    state    state-slot ids       -> recurrent state pool reads/writes
    expert   expert ids           -> MoE dispatch offsets

A :class:`GuardSpec` carries one :class:`FenceParams` per index space plus
the :class:`FencePolicy`; ``fence(spec, which, idx)`` applies the
configured fence.  ``spec=None`` (or a missing space) is the paper's
standalone fast path: the index passes through untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.fence import (
    FenceParams,
    FencePolicy,
    apply_fence,
    apply_fence_mixed,
)

#: Index spaces whose params are *per-batch-row* (gathered through a
#: tenant-id column) — the spaces row-mixed policies apply to.
ROW_SPACES = ("kv", "state")


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    policy: FencePolicy = FencePolicy.BITWISE
    vocab: Optional[FenceParams] = None
    kv: Optional[FenceParams] = None
    state: Optional[FenceParams] = None
    expert: Optional[FenceParams] = None
    page: Optional[FenceParams] = None
    #: per-batch-row policy codes (FencePolicy.code) for row-mixed batches;
    #: applies to ROW_SPACES only.  None -> ``policy`` everywhere.
    row_policy: Optional[torch.Tensor] = None
    #: virtual->physical page translation for the global paged pool
    #: (``(n_virt,)`` int32, manager-owned).
    page_map: Optional[torch.Tensor] = None

    def params_for(self, which: str) -> Optional[FenceParams]:
        return getattr(self, which)


def _broadcast_params(params: FenceParams, idx: torch.Tensor
                      ) -> FenceParams:
    """Per-row (B,) bound tensors against a (B, ...) index: append trailing
    singleton axes so the fence broadcasts row-wise."""
    base = params.base
    if not isinstance(base, torch.Tensor) or base.dim() == 0 \
            or base.dim() >= idx.dim():
        return params

    def expand(v):
        if isinstance(v, torch.Tensor) and v.dim():
            return v.reshape(tuple(v.shape) + (1,) * (idx.dim() - v.dim()))
        return v

    return FenceParams(base=expand(params.base), size=expand(params.size),
                       magic_m=expand(params.magic_m),
                       magic_s=expand(params.magic_s))


def fence(spec: Optional[GuardSpec], which: str,
          idx: torch.Tensor) -> torch.Tensor:
    """Fence ``idx`` into the partition for index-space ``which``.

    No-op when spec is None or the space is unguarded.  CHECK degrades to
    clamping here (detection for the serving plane is host-side from the
    same bounds)."""
    if spec is None:
        return idx
    params = spec.params_for(which)
    if params is None:
        return idx
    params = _broadcast_params(params, idx)
    if spec.row_policy is not None and which in ROW_SPACES:
        row_policy = spec.row_policy
        if row_policy.dim() < idx.dim():
            row_policy = row_policy.reshape(
                tuple(row_policy.shape)
                + (1,) * (idx.dim() - row_policy.dim()))
        fenced, _ok = apply_fence_mixed(row_policy, idx, params)
    else:
        fenced, _ok = apply_fence(spec.policy, idx, params)
    return fenced.to(idx.dtype)


def fence_pages(spec: Optional[GuardSpec],
                virt: torch.Tensor) -> torch.Tensor:
    """Resolve already-fenced *virtual* page ids to physical pages of the
    global paged pool: translate through ``page_map`` (an id outside the
    map resolves to page 0), then clamp into the pool extent (space
    "page").  Without a ``page_map`` this is the "page" fence alone."""
    if spec is None:
        return virt
    if spec.page_map is not None:
        pm = spec.page_map
        ok = (virt >= 0) & (virt < pm.shape[0])
        mapped = pm[virt.clamp(0, pm.shape[0] - 1).long()].to(virt.dtype)
        virt = torch.where(ok, mapped, torch.zeros_like(mapped))
    return fence(spec, "page", virt)


def kernel_fence(spec: Optional[GuardSpec], ids: torch.Tensor):
    """How the fenced-page kernels (K1, K2) take a page-id operand under
    ``spec``: returns ``(ids, base, mask, page_map)`` such that the
    kernel's ``resolve_page((ids & mask) | base)`` equals
    ``fence_pages(spec, fence(spec, "kv", ids))``.

    A BITWISE guard hands its per-row ``(base, size - 1)`` straight to the
    kernel, which fences on the address; ``size - 1`` is the params'
    cached :attr:`FenceParams.mask`, computed once per guard (per serve
    step), not once per layer.  Any other policy (MODULO, CHECK,
    row-mixed) is fenced here in torch first and the kernel gets the
    identity fence ``base = 0, mask = -1``; it still translates through
    the page map and clamps to the pool."""
    if spec is None:
        return ids, 0, -1, None
    kv = spec.kv
    if spec.page_map is None and spec.page is not None:
        return fence_pages(spec, fence(spec, "kv", ids)), 0, -1, None
    if kv is not None and spec.policy is FencePolicy.BITWISE \
            and spec.row_policy is None:
        return ids, kv.base, kv.mask, spec.page_map
    return fence(spec, "kv", ids), 0, -1, spec.page_map

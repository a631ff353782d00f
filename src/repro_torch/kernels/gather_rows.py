"""K3 wrapper: fenced embedding-row gather (``csrc/gather_rows.cu``).

Replaces ``repro/kernels/fenced_gather.py``'s ``fenced_gather``.  A CPU
table takes the plain version
(:func:`repro_torch.kernels.ref.gather_rows_ref`); a CUDA table launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, dtype_code, \
    per_id, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("gather_rows", "gather_rows.cu",
                [_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P])


def gather_rows(table: torch.Tensor, idx: torch.Tensor, fence_base,
                fence_mask) -> torch.Tensor:
    """table (V, D); idx (N,) int32; base/mask ints or (N,) tensors ->
    (N, D) rows at ``(idx & mask) | base`` (NaN rows past the table).

    An int fence reaches the kernel by value (one launch, nothing
    allocated but the output); a tensor fence is broadcast to one int32
    operand per id."""
    N = idx.shape[0]
    base, mask = (per_id(v, N, table.device)
                  if isinstance(v, torch.Tensor) else int(v)
                  for v in (fence_base, fence_mask))
    if table.device.type == "cpu":
        KERNEL.plain_calls += 1
        return ref.gather_rows_ref(table, idx, base, mask)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    idx = idx.to(torch.int32).contiguous()
    per = [t for t in (base, mask) if isinstance(t, torch.Tensor)]
    check_cuda("gather_rows", table, idx, *per)
    V, D = table.shape
    out = torch.empty((N, D), dtype=table.dtype, device=table.device)
    if N:
        def split(v):   # (per-id pointer or NULL, scalar)
            return (ptr(v), 0) if isinstance(v, torch.Tensor) \
                else (ctypes.c_void_p(None), v)
        (base_ids, base_val), (mask_ids, mask_val) = split(base), split(mask)
        KERNEL.launch(ptr(table), ptr(idx), base_ids, mask_ids, base_val,
                      mask_val, ptr(out), N, V, D, dtype_code(table.dtype),
                      stream_of(table))
    return out

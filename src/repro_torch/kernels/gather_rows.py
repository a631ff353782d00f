"""K3 wrapper: fenced embedding-row gather (``csrc/gather_rows.cu``).

Replaces ``repro/kernels/fenced_gather.py``'s ``fenced_gather``.  The
wrapper calls the custom op ``repro_torch::gather_rows``, which the
dispatcher sends by device: a CPU table runs the plain version
(:func:`repro_torch.kernels.ref.gather_rows_ref`), a CUDA table launches
the kernel or raises, and a fake table (a trace) gets the output's shape
only.  What the kernel addresses is declared in
:mod:`repro_torch.kernels.access`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, check_device, \
    dtype_code, fence_args, fence_operand, join_fence, ptr, split_fence, \
    stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("gather_rows", "gather_rows.cu",
                [_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P])


@torch.library.custom_op("repro_torch::gather_rows", mutates_args=(),
                         device_types="cpu")
def gather_rows_op(table: torch.Tensor, idx: torch.Tensor,
                   base_ids: Optional[torch.Tensor],
                   mask_ids: Optional[torch.Tensor], base: int,
                   mask: int) -> torch.Tensor:
    """The plain version, for CPU tensors."""
    KERNEL.plain_calls += 1
    return ref.gather_rows_ref(table, idx, join_fence(base_ids, base),
                               join_fence(mask_ids, mask))


@gather_rows_op.register_kernel("cuda")
def _cuda(table, idx, base_ids, mask_ids, base, mask):
    idx = idx.to(torch.int32).contiguous()
    per = [t for t in (base_ids, mask_ids) if t is not None]
    check_cuda("gather_rows", table, idx, *per)
    N = idx.shape[0]
    V, D = table.shape
    out = torch.empty((N, D), dtype=table.dtype, device=table.device)
    if N:
        (b_ptr, b_val), (m_ptr, m_val) = \
            fence_args(join_fence(base_ids, base)), \
            fence_args(join_fence(mask_ids, mask))
        KERNEL.launch(ptr(table), ptr(idx), b_ptr, m_ptr, b_val, m_val,
                      ptr(out), N, V, D, dtype_code(table.dtype),
                      stream_of(table))
    return out


@gather_rows_op.register_fake
def _fake(table, idx, base_ids, mask_ids, base, mask):
    return table.new_empty((idx.shape[0], table.shape[1]))


def gather_rows(table: torch.Tensor, idx: torch.Tensor, fence_base,
                fence_mask) -> torch.Tensor:
    """table (V, D); idx (N,) int32; base/mask ints or (N,) tensors ->
    (N, D) rows at ``(idx & mask) | base`` (NaN rows past the table).

    An int fence reaches the kernel by value (one launch, nothing
    allocated but the output); a tensor fence is broadcast to one int32
    operand per id."""
    check_device("gather_rows", table)
    N = idx.shape[0]
    (base_ids, base), (mask_ids, mask) = (
        split_fence(fence_operand(v, N, table.device))
        for v in (fence_base, fence_mask))
    return gather_rows_op(table, idx, base_ids, mask_ids, base, mask)

"""K5 wrapper: fenced MoE expert histogram (``csrc/moe_histogram.cu``).

Replaces ``repro/kernels/moe_dispatch.py``'s ``moe_histogram``.  CPU ids
take the plain version (:func:`repro_torch.kernels.ref.moe_histogram_ref`);
CUDA ids launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("moe_histogram", "moe_histogram.cu",
                [_P, _I, _I, _I, _I, _P, _P])


def moe_histogram(expert_ids: torch.Tensor, num_experts: int,
                  fence_base: int, fence_mask: int) -> torch.Tensor:
    """expert_ids (T, K) int32; scalar fence ``(base, mask)`` -> counts
    (num_experts,) int32 of ``(id & mask) | base``, ids fenced outside
    ``[0, num_experts)`` dropped.  The kernel keeps one int32 bin per
    expert in shared memory and refuses more than 12,288 experts."""
    base, mask = int(fence_base), int(fence_mask)
    if expert_ids.device.type == "cpu":
        KERNEL.plain_calls += 1
        return ref.moe_histogram_ref(expert_ids, num_experts, base, mask)
    if expert_ids.device.type != "cuda":
        raise ValueError(
            f"moe_histogram: unsupported device {expert_ids.device}")
    ids = expert_ids.to(torch.int32).contiguous()
    check_cuda("moe_histogram", ids)
    counts = torch.empty((num_experts,), dtype=torch.int32, device=ids.device)
    KERNEL.launch(ptr(ids), ids.numel(), base, mask, num_experts,
                  ptr(counts), stream_of(ids))
    return counts

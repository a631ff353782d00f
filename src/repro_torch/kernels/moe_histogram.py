"""K5 wrapper: fenced MoE expert histogram (``csrc/moe_histogram.cu``).

Replaces ``repro/kernels/moe_dispatch.py``'s ``moe_histogram``.  The
wrapper calls the custom op ``repro_torch::moe_histogram``: CPU ids run
the plain version (:func:`repro_torch.kernels.ref.moe_histogram_ref`), CUDA
ids launch the kernel or raise, and fake ids (a trace) get the output's
shape only.  The kernel's only data-dependent address is a bin of its own
shared memory (:mod:`repro_torch.kernels.access` declares no access into an
operand).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, check_device, \
    placements, ptr, sharding_rule, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("moe_histogram", "moe_histogram.cu",
                [_P, _I, _I, _I, _I, _P, _I, _P])

#: threads of one CTA (``kThreads`` in the source)
THREADS = 1024
#: ids one CTA takes before the launch becomes a cluster
IDS_PER_CTA = 8192
#: the largest cluster (``kMaxCluster``, the portable size)
MAX_CLUSTER = 8


def cluster_ctas(n: int) -> int:
    """CTAs of the one launch for ``n`` ids: 1 up to :data:`IDS_PER_CTA`
    (every serve-path call: T * K <= 4,096), then one for each further
    :data:`IDS_PER_CTA`, at most :data:`MAX_CLUSTER`; rank r of the
    cluster takes ids ``i`` with ``(i // THREADS) % ctas == r``."""
    return min(MAX_CLUSTER, max(1, -(-n // IDS_PER_CTA)))


@torch.library.custom_op("repro_torch::moe_histogram", mutates_args=(),
                         device_types="cpu")
def moe_histogram_op(expert_ids: torch.Tensor, num_experts: int, base: int,
                     mask: int) -> torch.Tensor:
    """The plain version, for CPU tensors."""
    KERNEL.plain_calls += 1
    return ref.moe_histogram_ref(expert_ids, num_experts, base, mask)


@moe_histogram_op.register_kernel("cuda")
def _cuda(expert_ids, num_experts, base, mask):
    ids = expert_ids.to(torch.int32).contiguous()
    check_cuda("moe_histogram", ids)
    counts = torch.empty((num_experts,), dtype=torch.int32, device=ids.device)
    KERNEL.launch(ptr(ids), ids.numel(), base, mask, num_experts,
                  ptr(counts), cluster_ctas(ids.numel()), stream_of(ids))
    return counts


@moe_histogram_op.register_fake
def _fake(expert_ids, num_experts, base, mask):
    return expert_ids.new_empty((num_experts,), dtype=torch.int32)


@sharding_rule(torch.ops.repro_torch.moe_histogram.default)
def _sharding(expert_ids, num_experts, base, mask):
    """Replicated; or the ids over a mesh dimension, each rank's counts a
    partial sum of the bins."""
    return [(placements("R"), placements("R", None, None, None)),
            (placements("P"), placements("S0", None, None, None))]


def moe_histogram(expert_ids: torch.Tensor, num_experts: int,
                  fence_base: int, fence_mask: int) -> torch.Tensor:
    """expert_ids (T, K) int32; scalar fence ``(base, mask)`` -> counts
    (num_experts,) int32 of ``(id & mask) | base``, ids fenced outside
    ``[0, num_experts)`` dropped.  The kernel keeps one int32 bin per
    expert in shared memory and refuses more than 12,288 experts."""
    check_device("moe_histogram", expert_ids)
    return moe_histogram_op(expert_ids, int(num_experts), int(fence_base),
                            int(fence_mask))

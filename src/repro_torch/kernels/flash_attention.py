"""K4 wrapper: blocked causal prefill attention (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py``'s ``flash_attention``.  The
wrapper calls the custom op ``repro_torch::flash_attention``: a CPU query
runs the plain version (:func:`repro_torch.kernels.ref.flash_attention_ref`),
a CUDA query launches the kernel or raises, and a fake query (a trace) gets
the output's shape only.  On the card a bfloat16 query runs the tensor-core
(``wgmma``) kernel and a float32 query the CUDA-core one; both take a head
dim that is a multiple of 16 up to 128 and whole GQA groups.  The kernel
has no data-dependent address (:mod:`repro_torch.kernels.access` declares
none).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, check_device, \
    dtype_code, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("flash_attention", "flash_attention.cu",
                [_P] * 4 + [_I] * 6 + [_P])


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """The plain version, for CPU tensors."""
    KERNEL.plain_calls += 1
    return ref.flash_attention_ref(q, k, v)


@flash_attention_op.register_kernel("cuda")
def _cuda(q, k, v):
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k and v dtypes differ")
    check_cuda("flash_attention", q, k, v)
    B, S, H, D = q.shape
    KH = k.shape[2]
    if k.shape != (B, S, KH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if D % 16 or D > 128 or KH == 0 or H % KH:
        raise ValueError(f"flash_attention: head dim {D} (a multiple of 16,"
                         f" at most 128) or {H} heads over {KH} KV heads "
                         "not supported")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if B and S:
        KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), B, S, H, KH, D,
                      dtype_code(q.dtype), stream_of(q))
    return out


@flash_attention_op.register_fake
def _fake(q, k, v):
    return torch.empty_like(q)


def flash_attention(q, k, v):
    """Causal attention: q (B,S,H,D), k/v (B,S,KH,D) -> (B,S,H,D) in q's
    dtype; any S (the ragged edge is masked in the kernel)."""
    check_device("flash_attention", q)
    return flash_attention_op(q, k, v)

"""K4 wrapper: blocked causal prefill attention (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py``'s ``flash_attention``.  A CPU
query takes the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); a CUDA query launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, dtype_code, \
    ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("flash_attention", "flash_attention.cu",
                [_P] * 4 + [_I] * 6 + [_P])


def flash_attention(q, k, v):
    """Causal attention: q (B,S,H,D), k/v (B,S,KH,D) -> (B,S,H,D) in q's
    dtype; any S (the ragged edge is masked in the kernel)."""
    if q.device.type == "cpu":
        KERNEL.plain_calls += 1
        return ref.flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k and v dtypes differ")
    check_cuda("flash_attention", q, k, v)
    B, S, H, D = q.shape
    KH = k.shape[2]
    out = torch.empty_like(q)
    if B and S:
        KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), B, S, H, KH, D,
                      dtype_code(q.dtype), stream_of(q))
    return out

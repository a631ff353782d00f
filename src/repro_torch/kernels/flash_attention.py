"""K4 wrapper: blocked prefill attention, causal or not, optionally under a
sliding window (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py``'s ``flash_attention``.  The
wrapper calls the custom op ``repro_torch::flash_attention``: a CPU query
runs the plain version (:func:`repro_torch.kernels.ref.flash_attention_ref`),
a CUDA query launches the kernel or raises, and a fake query (a trace) gets
the output's shape only.  On the card a bfloat16 query runs the tensor-core
(``wgmma``) kernel and a float32 query the CUDA-core one; both take a head
dim that is a multiple of 16 up to 128 and whole GQA groups.  The kernel
has no data-dependent address (:mod:`repro_torch.kernels.access` declares
none).

Queries and keys may differ in length (Sq != Skv) when the attention is
not causal: the encoder-decoder family's cross-attention.

The op is differentiable in q, k and v.  The reference's Pallas kernel is
forward-only (its training path is XLA's autodiff of jnp), so the
backward is written in PyTorch for every device: it recomputes the
float32 softmax from the saved q, k and v
(:func:`repro_torch.kernels.ref.flash_attention_grad_ref`), holding
B * H * Sq * Skv float32 scores a call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, check_cuda, check_device, \
    dtype_code, heads_pair, placements, ptr, sharding_rule, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = Kernel("flash_attention", "flash_attention.cu",
                [_P] * 4 + [_I] * 9 + [_P])


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int) -> torch.Tensor:
    """The plain version, for CPU tensors."""
    KERNEL.plain_calls += 1
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


@flash_attention_op.register_kernel("cuda")
def _cuda(q, k, v, causal, window):
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k and v dtypes differ")
    check_cuda("flash_attention", q, k, v)
    B, S, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    check_shapes(q, k, v, causal)
    if D % 16 or D > 128 or KH == 0 or H % KH:
        raise ValueError(f"flash_attention: head dim {D} (a multiple of 16,"
                         f" at most 128) or {H} heads over {KH} KV heads "
                         "not supported")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if B and S and Skv:
        KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), B, S, Skv, H, KH, D,
                      int(causal), max(int(window), 0), dtype_code(q.dtype),
                      stream_of(q))
    return out


def check_shapes(q, k, v, causal: bool) -> None:
    """k and v (B, Skv, KH, D) fit q (B, Sq, H, D); causal attention
    needs Skv = Sq (its diagonal is undefined otherwise)."""
    B, S, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, KH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if causal and Skv != S:
        raise ValueError(f"flash_attention: causal attention needs as many "
                         f"keys as queries, got Sq={S}, Skv={Skv}")


@flash_attention_op.register_fake
def _fake(q, k, v, causal, window):
    return torch.empty_like(q)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.mask = (causal, window)


def _backward(ctx, grad):
    from repro_torch.distributed.partition import is_dtensor

    q, k, v = ctx.saved_tensors
    if is_dtensor(q):
        return (*_local_backward(q, k, v, grad, *ctx.mask), None, None)
    return (*ref.flash_attention_grad_ref(q, k, v, grad, *ctx.mask), None,
            None)


def _local_backward(q, k, v, grad, causal, window):
    """The backward on a partitioned trace: with q, k, v and the output's
    gradient placed alike by batch or heads (the forward's rule, per mesh
    dim), attention's gradient is each shard's own, so the PyTorch
    backward runs on the local shards (DTensor would flatten the split
    batch and head dims into strided shards it cannot multiply)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    heads = heads_pair(q, q.shape[2], k.shape[2])
    pl = [p if isinstance(p, Shard) and (p.dim == 0 or p.dim == 2 and heads)
          else Replicate() for p in q.placements]
    local = [t.redistribute(mesh, pl).to_local() for t in (q, k, v, grad)]
    grads = ref.flash_attention_grad_ref(*local, causal, window)
    # the global shapes given: heads may split unevenly
    return tuple(DTensor.from_local(g.contiguous(), mesh, pl,
                                    run_check=False, shape=t.shape,
                                    stride=t.stride())
                 for g, t in zip(grads, (q, k, v)))


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


@sharding_rule(torch.ops.repro_torch.flash_attention.default)
def _sharding(q, k, v, causal, window):
    """Replicated; batch over a mesh dimension; or heads, q's and k / v's
    split alike (:func:`~repro_torch.kernels._build.heads_pair`).  The
    op's backward runs on the local shards, placed the same way
    (:func:`_local_backward`).  This rule
    takes the place of the reference's pins on its Pallas-free flash
    loop's carries (``layers._c``): the port's loop is inside the one
    op, so its operands' placements are the only ones to pin."""
    out = [(placements("R"), placements("R", "R", "R", None, None)),
           (placements("S0"), placements("S0", "S0", "S0", None, None))]
    if heads_pair(q, q.shape[2], k.shape[2]):
        out.append((placements("S2"), placements("S2", "S2", "S2", None,
                                                 None)))
    return out


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Attention over a prompt: q (B,Sq,H,D), k/v (B,Skv,KH,D) ->
    (B,Sq,H,D) in q's dtype; any Sq and Skv (the ragged edges are masked in
    the kernel), Skv = Sq when ``causal``.  Query row i attends to keys j
    <= i when ``causal`` and j > i - ``window`` when ``window`` > 0 (0: no
    window), the reference's masks; a non-causal call over Skv != Sq is
    cross-attention (the reference's ``chunked_attention(causal=False)``)."""
    check_device("flash_attention", q)
    check_shapes(q, k, v, causal)
    from repro_torch.distributed.partition import heads_like, \
        heads_split, is_dtensor
    if is_dtensor(q):
        # a partitioned trace: each rank runs its share of the heads
        q, H = heads_split(q, 2)
        k, v = (heads_like(q, t, 2, 2, H) for t in (k, v))
        out = flash_attention_op(q, k, v, bool(causal), int(window))
        return out if out.shape[2] == H else out[:, :, :H]
    return flash_attention_op(q, k, v, bool(causal), int(window))

"""Sampled decode: the next ids drawn from the temperature-scaled,
optionally top-k-truncated distribution of the logits, as the reference's
``jax.random.categorical`` draws them — ``argmax(logits / T + G)`` with
``G`` standard Gumbel noise.

The noise comes from a counter-based hash, Threefry-2x32 with 20 rounds
(the block cipher JAX's default PRNG is built on), computed in int64
torch ops whose values stay below ``2**32``: the key is a staged (2,)
int64 tensor, the counter of each logit its (row, column).  The same key
gives the same draw on the CPU and on the card, eagerly and in a CUDA
graph's replay, with no generator state and no host sync.  The stream is
not JAX's (which would need its exact key derivation and bit layout): a
draw has the reference's distribution, not its tokens.

A key is a pair of 32-bit words.  :func:`key` makes one from a seed, as
``jax.random.PRNGKey`` does; :func:`split` derives two from one on the
host (the engine splits its key per decode, never reading the device).
"""

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on 32-bit words held in Python ints or in
    int64 tensors (every intermediate below ``2**33``, so nothing wraps
    in int64).  Returns the two output words."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int) -> Key:
    """The key of ``seed`` (``jax.random.PRNGKey``'s words)."""
    return (seed >> 32) & M32, seed & M32


def split(k: Key) -> Tuple[Key, Key]:
    """Two keys derived from ``k``: the next key and a subkey (the
    reference's ``jax.random.split`` at the same place)."""
    return threefry2x32(k[0], k[1], 0, 0), threefry2x32(k[0], k[1], 0, 1)


def key_tensor(k: Key, device) -> torch.Tensor:
    """``k`` as the (2,) int64 tensor a sampled step takes."""
    return torch.tensor(k, dtype=torch.int64, device=device)


def gumbel(k: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` (rows, columns) for the (2,)
    int64 key ``k``: Threefry of each element's (row, column) counter, 24
    bits of it as a uniform in (0, 1), ``-log(-log(u))`` in float64, then
    float32."""
    rows, cols = shape
    dev = k.device
    r = torch.arange(rows, dtype=torch.int64, device=dev).view(-1, 1)
    c = torch.arange(cols, dtype=torch.int64, device=dev).view(1, -1)
    bits, _ = threefry2x32(k[0], k[1], r.expand(rows, cols),
                           c.expand(rows, cols))
    u = ((bits >> 8).to(torch.float64) + 0.5) * (1.0 / (1 << 24))
    return (-torch.log(-torch.log(u))).to(torch.float32)


def sample(logits: torch.Tensor, k: torch.Tensor, temperature: float,
           top_k: int = 0) -> torch.Tensor:
    """Next ids (int32) drawn from ``logits`` (rows, vocab), the
    reference's sampled step: the logits in float32; with ``top_k`` every
    logit below the k-th largest of its row set to −∞ (ties at the k-th
    kept); ``argmax(logits / temperature + G)``."""
    logits = logits.to(torch.float32)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    noisy = logits / temperature + gumbel(k, tuple(logits.shape))
    return torch.argmax(noisy, dim=-1).to(torch.int32)

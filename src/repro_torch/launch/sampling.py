"""Sampled decode: the next ids drawn from the temperature-scaled,
optionally top-k-truncated distribution of the logits, as the reference's
``jax.random.categorical`` draws them — ``argmax(logits / T + G)`` with
``G`` standard Gumbel noise.

The noise is JAX's own stream.  Threefry-2x32 with 20 rounds (the block
cipher JAX's default PRNG is built on) hashes each element's flat index
``row * cols + col``, split into its high and low 32-bit words, as JAX's
partitionable ``random_bits`` does; the two output words XORed are the
element's 32 bits.  As ``jax.random.uniform(key, shape, minval=tiny)``
does for float32, 23 of them become a mantissa in [1, 2), less one,
scaled and floored at the smallest normal; the noise is
``-log(-log(u))`` in float32 (JAX's ``gumbel`` in its default "low"
mode).  Everything up to the float bits is int64 torch ops whose values
stay below ``2**33``: the key is a staged (2,) int64 tensor, so the same
key gives the same draw on the CPU and on the card, eagerly and in a CUDA
graph's replay, with no generator state and no host sync.

The uniforms are JAX's bit for bit; ``log`` may differ from XLA's in its
last ulp, which moves a token only where it decides an exact tie between
two noisy logits.  The temperature scales the logits as the reference's
jitted step does: times the float32 reciprocal of ``T`` (XLA folds the
division by a constant into that product).

A key is a pair of 32-bit words.  :func:`key` makes one from a seed, as
``jax.random.PRNGKey`` does; :func:`split` derives two from one on the
host as ``jax.random.split`` does (the engine splits its key per decode,
never reading the device).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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
    """The key of ``seed``: ``jax.random.PRNGKey``'s words with 64-bit
    types off, as the reference runs — the seed's low 32 bits, the high
    word 0."""
    return 0, seed & M32


def split(k: Key) -> Tuple[Key, Key]:
    """Two keys derived from ``k``: the next key and a subkey (the
    reference's ``jax.random.split`` at the same place)."""
    return threefry2x32(k[0], k[1], 0, 0), threefry2x32(k[0], k[1], 0, 1)


def key_tensor(k: Key, device) -> torch.Tensor:
    """``k`` as the (2,) int64 tensor a sampled step takes."""
    return torch.tensor(k, dtype=torch.int64, device=device)


def uniform(k: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """float32 uniforms in [tiny, 1) of ``shape`` for the (2,) int64 key
    ``k``: ``jax.random.uniform(key, shape, minval=tiny)`` bit for bit.
    Each element's 32 bits are JAX's partitionable ``random_bits``:
    Threefry of its flat index's (high, low) words, the two output words
    XORed; 23 of them make a float in [1, 2), less one."""
    rows, cols = shape
    n = torch.arange(rows * cols, dtype=torch.int64,
                     device=k.device).view(rows, cols)
    b1, b2 = threefry2x32(k[0], k[1], n >> 32, n & M32)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    return torch.clamp_min(f * (1.0 - tiny) + tiny, tiny)


def gumbel(k: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` (rows, columns) for the (2,)
    int64 key ``k``: ``-log(-log(u))`` of :func:`uniform` in float32, as
    ``jax.random.gumbel(key, shape)`` computes it."""
    return -torch.log(-torch.log(uniform(k, shape)))


def sample(logits: torch.Tensor, k: torch.Tensor, temperature: float,
           top_k: int = 0) -> torch.Tensor:
    """Next ids (int32) drawn from ``logits`` (rows, vocab), the
    reference's sampled step: the logits in float32; with ``top_k`` every
    logit below the k-th largest of its row set to −∞ (ties at the k-th
    kept); ``argmax(logits / temperature + G)``, the division a product
    with the float32 reciprocal of ``temperature``, as XLA computes the
    jitted step (and as exact on the card as on the CPU)."""
    logits = logits.to(torch.float32)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    inv = float(np.float32(1.0) / np.float32(temperature))
    noisy = logits * inv + gumbel(k, tuple(logits.shape))
    return torch.argmax(noisy, dim=-1).to(torch.int32)

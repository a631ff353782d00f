"""Deterministic sharded data pipeline — a numpy copy of
``repro/data/pipeline.py``: the same batches, bit for bit, for the same
(seed, step, host).  Batches are numpy arrays; the caller moves them to
its device.

Restart-exact: batch contents are a pure function of (seed, step,
shard_index), so an elastic restart at step k reproduces the exact token
stream without any iterator state in the checkpoint.  Two sources:

* :class:`SyntheticLM` — seeded token stream (zipfian unigram + markov
  bigram mixture so the loss actually decreases during the examples).
* :class:`FileTokens` — memory-mapped token file (one uint16/uint32 array),
  deterministic strided windows.

Per-host sharding: each host materializes only its ``(host_index,
host_count)`` slice of the global batch — the standard multi-pod input
pattern (no host ever holds the global batch).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.host_count:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {self.host_count} hosts")
        return self.global_batch // self.host_count


class SyntheticLM:
    """Seeded synthetic LM stream with learnable structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # zipfian unigram + a deterministic "grammar": each token prefers
        # a fixed successor, so a model can learn p(next|cur).
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._succ = rng.permutation(v).astype(np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4_096 + cfg.host_index)
        B, S = cfg.local_batch, cfg.seq_len
        out = np.empty((B, S + 1), np.int32)
        cur = rng.choice(cfg.vocab, size=B, p=self._unigram)
        out[:, 0] = cur
        follow = rng.random((B, S)) < 0.7   # 70% grammar, 30% noise
        noise = rng.choice(cfg.vocab, size=(B, S), p=self._unigram)
        for t in range(S):
            cur = np.where(follow[:, t], self._succ[cur], noise[:, t])
            out[:, t + 1] = cur
        return {"tokens": out}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class FileTokens:
    """Deterministic windows over a memory-mapped token array."""

    def __init__(self, cfg: DataConfig, path: str, dtype=np.uint16):
        self.cfg = cfg
        self._data = np.memmap(path, dtype=dtype, mode="r")
        self._n_windows = (len(self._data) - 1) // cfg.seq_len

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = cfg.local_batch, cfg.seq_len
        base = (step * cfg.global_batch + cfg.host_index * B)
        idx = (base + np.arange(B)) % max(self._n_windows, 1)
        out = np.empty((B, S + 1), np.int32)
        for i, w in enumerate(idx):
            start = w * S
            out[i] = self._data[start:start + S + 1]
        return {"tokens": out}


def make_source(cfg: DataConfig, path: Optional[str] = None):
    return FileTokens(cfg, path) if path else SyntheticLM(cfg)

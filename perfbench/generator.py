"""The one traffic generator: a traffic file's parameters and a seed in,
requests out.

Every chunk of a mix holds the same prompt lengths, output budgets,
tenants and inter-arrival gaps, in the same order, fixed by the file's
``shape_seed``: the window replays one recorded trace, chunk after chunk,
so a chunk more or less in the window leaves the mix it measures as it
was.  The run seed and the chunk's index draw the token ids (and the run
seed, in the driver, the weights).  So every seed gives the same work,
and a run's spread measures the system, not the draw.  Arrivals are drain
cycles of the continuous driver (``serve_continuous`` takes ``arrive=``
as a cycle number): an open loop on the drain clock.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class Req:
    tenant: str
    prompt: np.ndarray          # int32 token ids, the real prompt
    max_new: int                # tokens to generate (the budget)
    arrive: int                 # drain cycle of the chunk it may join at


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *stream])


def apportion(n: int, weights: Sequence[float]) -> List[int]:
    """``n`` split by ``weights`` into whole counts (largest remainder,
    ties to the earlier entry)."""
    total = float(sum(weights))
    raw = [n * w / total for w in weights]
    out = [math.floor(r) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: (out[i] - raw[i], i))
    for i in order[:n - sum(out)]:
        out[i] += 1
    return out


def _spread_values(spec: dict, n: int) -> List[int]:
    """The ``n`` output budgets of a chunk: evenly spaced quantiles of the
    stated distribution, clipped to ``[min, max]``."""
    lo, hi = spec["min"], spec["max"]
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        nd = statistics.NormalDist(math.log(spec["median"]), spec["sigma"])
        vals = [math.exp(nd.inv_cdf(q)) for q in qs]
    elif spec["dist"] == "uniform":
        vals = [lo + (hi - lo) * q for q in qs]
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return [int(min(max(round(v), lo), hi)) for v in vals]


def _gaps(spec: dict, n: int) -> np.ndarray:
    """A chunk's ``n`` inter-arrival gaps in drain cycles: one fixed draw
    (from the file's ``shape_seed``, the same for every run seed) of the
    stated distribution, rescaled to the stated mean rate."""
    rate = spec["rate_per_drain"]
    g = np.random.default_rng(spec["shape_seed"])
    if spec["dist"] != "gamma":
        raise ValueError(f"unknown arrivals {spec['dist']!r}")
    k = 1.0 / spec["cv"] ** 2
    gaps = g.gamma(k, 1.0 / (rate * k), n)
    return gaps * ((n / rate) / gaps.sum())


def tenant_names(traffic: dict) -> List[str]:
    return [t["name"] for t in traffic["tenants"]]


def chunk(traffic: dict, seed: int, index: int, vocab: int,
          rate: float = None) -> List[Req]:
    """Chunk ``index`` of the mix for run seed ``seed``: its requests in
    submission order.  ``rate`` overrides the file's arrival rate (the
    knee sweep)."""
    n = traffic["chunk_requests"]
    rng = _rng(seed, 1, index)
    order = _rng(traffic["arrivals"]["shape_seed"], 1, 0)
    tenants = traffic["tenants"]
    names = [t["name"] for t, c in zip(
        tenants, apportion(n, [t["share"] for t in tenants]))
        for _ in range(c)]
    prompts = [b for b, c in zip(traffic["prompt_buckets"],
                                 apportion(n, traffic["prompt_weights"]))
               for _ in range(c)]
    outs = _spread_values(traffic["output"], n)
    arr = dict(traffic["arrivals"])
    if rate is not None:
        arr["rate_per_drain"] = rate
    gaps = _gaps(arr, n)
    names = [names[i] for i in order.permutation(n)]
    prompts = [prompts[i] for i in order.permutation(n)]
    outs = [outs[i] for i in order.permutation(n)]
    gaps = gaps[order.permutation(n)]
    starts = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    # a prompt padded to the longest bucket still fits its budget
    room = traffic["max_len"] - max(traffic["prompt_buckets"])
    reqs = []
    for i in range(n):
        p = prompts[i]
        new = min(outs[i], room)
        reqs.append(Req(tenant=names[i],
                        prompt=rng.integers(0, vocab, size=p,
                                            dtype=np.int64).astype(np.int32),
                        max_new=int(new), arrive=int(starts[i])))
    return reqs


def warmup_chunk(traffic: dict, seed: int, vocab: int) -> List[Req]:
    """One request per prompt bucket, each joining alone, the next
    arriving while the last decodes: every prefill shape of the mix, the
    decode step, and a drain running both, before the window."""
    w = traffic["warmup"]
    rng = _rng(seed, 2)
    names = tenant_names(traffic)
    return [Req(tenant=names[i % len(names)],
                prompt=rng.integers(0, vocab, size=b,
                                    dtype=np.int64).astype(np.int32),
                max_new=w["max_new"], arrive=i * w["spacing"])
            for i, b in enumerate(traffic["prompt_buckets"])]

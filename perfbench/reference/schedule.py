"""The continuous driver's admission, worked out again from the trace
alone: which requests join in which drain cycle, how long their padded
prompt is, and which rows decode at what length in every drain.

The rules are the ones the serving plane states for paged continuous
batching: at each cycle boundary rows whose budget is spent leave, then
idle rows refill in row order from the requests that have arrived, first
come first served; a request whose tenant already holds as many rows as
its extent has room for is passed over for that cycle.  The joiners of a
cycle prefill together, padded at the end to the longest of their
prompts, and the pads are cached and attended; every row emits one token
per drain from the drain it joins.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence


@dataclasses.dataclass
class Drain:
    joiners: List[int]          # request indices that prefill here
    plen: int                   # their padded prompt length (0: none)
    decodes: List[int]          # request indices that decode here
    kv_lens: List[int]          # each decoding row's attended length


@dataclasses.dataclass
class Schedule:
    join: List[int]             # per request: the drain it joins
    plen: List[int]             # per request: its padded prompt length
    drains: List[Drain]


def simulate(reqs: Sequence, rows: int, caps: Dict[str, int]) -> Schedule:
    """``reqs`` in submission order (``tenant``, ``prompt``, ``max_new``,
    ``arrive``); ``caps`` the rows each tenant's extent can hold."""
    n = len(reqs)
    join = [-1] * n
    plen = [0] * n
    slot: List[int] = [-1] * rows           # request index per row
    left = [0] * rows
    lens = [0] * rows
    held = {t: 0 for t in caps}
    drains: List[Drain] = []
    cycle = 0
    while True:
        for i in range(rows):
            r = slot[i]
            if r >= 0 and left[i] <= 0:
                held[reqs[r].tenant] -= 1
                slot[i] = -1
        waiting = [r for r in range(n) if join[r] < 0
                   and reqs[r].arrive <= cycle]
        wi = 0
        joiners: List[int] = []
        for i in range(rows):
            if slot[i] >= 0:
                continue
            while wi < len(waiting):
                r = waiting[wi]
                wi += 1
                t = reqs[r].tenant
                if held[t] >= caps[t]:
                    continue
                held[t] += 1
                slot[i] = r
                join[r] = cycle
                left[i] = reqs[r].max_new
                joiners.append(i)
                break
        if all(s < 0 for s in slot) and all(join[r] >= 0 for r in range(n)):
            break
        p = max((len(reqs[slot[i]].prompt) for i in joiners), default=0)
        dec = [i for i in range(rows) if slot[i] >= 0 and i not in joiners]
        drains.append(Drain(joiners=[slot[i] for i in joiners], plen=p,
                            decodes=[slot[i] for i in dec],
                            kv_lens=[lens[i] + 1 for i in dec]))
        for i in joiners:
            plen[slot[i]] = p
            lens[i] = p
            left[i] -= 1
        for i in dec:
            lens[i] += 1
            left[i] -= 1
        cycle += 1
    return Schedule(join=join, plen=plen, drains=drains)

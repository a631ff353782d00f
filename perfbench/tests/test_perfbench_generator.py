"""The traffic generator: the same seed gives the same trace, every seed
and every chunk the same work in the same order, and every budget fits
its row."""

import json

import pytest

from perfbench import generator as G
from perfbench.harness import ROOT

MIXES = ["chat", "docqa"]


def _mix(name):
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def _key(reqs):
    return [(r.tenant, r.prompt.tobytes(), r.max_new, r.arrive)
            for r in reqs]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_trace(name):
    tr = _mix(name)
    seed = 2**31 + 123
    assert _key(G.chunk(tr, seed, 3, 50304)) == \
        _key(G.chunk(tr, seed, 3, 50304))
    assert _key(G.warmup_chunk(tr, seed, 50304)) == \
        _key(G.warmup_chunk(tr, seed, 50304))
    assert _key(G.chunk(tr, seed, 3, 50304)) != \
        _key(G.chunk(tr, seed + 1, 3, 50304))


def _shape(reqs):
    return [(r.tenant, len(r.prompt), r.max_new, r.arrive) for r in reqs]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_same_work(name):
    tr = _mix(name)
    # a chunk's shape is the recorded trace's: the seed draws tokens only
    assert _shape(G.chunk(tr, 5, 2, 1000)) == \
        _shape(G.chunk(tr, 2**33 + 9, 2, 1000))
    # every chunk the same work in the same order, so the window's mix
    # does not hang on how many chunks it holds; only the tokens differ
    a, b = G.chunk(tr, 5, 0, 1000), G.chunk(tr, 5, 4, 1000)
    assert _shape(a) == _shape(b)
    assert _key(a) != _key(b)


@pytest.mark.parametrize("name", MIXES)
def test_shares_buckets_and_room(name):
    tr = _mix(name)
    reqs = G.chunk(tr, 11, 0, 1000)
    n = tr["chunk_requests"]
    assert len(reqs) == n
    for t in tr["tenants"]:
        got = sum(r.tenant == t["name"] for r in reqs)
        assert abs(got - t["share"] * n) <= 1
    assert {len(r.prompt) for r in reqs} <= set(tr["prompt_buckets"])
    longest = max(tr["prompt_buckets"])
    assert all(longest + r.max_new <= tr["max_len"] for r in reqs)
    assert all(tr["output"]["min"] <= r.max_new <= tr["output"]["max"]
               for r in reqs)
    assert reqs[0].arrive == 0
    assert all(a.arrive <= b.arrive for a, b in zip(reqs, reqs[1:]))


def test_apportion_is_exact():
    assert G.apportion(128, [0.3, 0.3, 0.25, 0.15]) == [39, 38, 32, 19]
    for n in (1, 7, 64, 1000):
        assert sum(G.apportion(n, [0.4, 0.3, 0.2, 0.1])) == n

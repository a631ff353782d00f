"""The admission schedule the reference works out against the program's
own drains, on the reduced config on the CPU: every request joins in the
drain the schedule says, with the padded length it says, and the knee
sweep's drain counts are the program's."""

import pytest

from perfbench import generator as G
from perfbench import harness
from perfbench.reference import schedule as S
from perfbench.tests.cells import small_context


@pytest.mark.parametrize("rate", [0.15, 0.6, 5.0])
def test_program_joins_where_the_schedule_says(rate):
    bench, ctx = small_context(rate=rate, chunk=14)
    rec = harness.run(ctx)
    assert rec.checks["schedule_mismatches"]["value"] == 0
    assert rec.failed == 0
    tr = ctx.traffic
    reqs = G.chunk(tr, ctx.seed, 0, ctx.spec["vocab_size"])
    sched = S.simulate(reqs, tr["rows"],
                       {t["name"]: t["rows"] for t in tr["tenants"]})
    mine = [d for d in rec.drains if d.chunk == 0]
    assert len(mine) == len(sched.drains)
    for d, s in zip(mine, sched.drains):
        assert d.plen == s.plen
        assert sorted(d.kv_lens) == sorted(s.kv_lens)
    out = harness.result(bench, ctx, rec, {})
    assert out["correct"] is True
    assert list(out)[-1] == "checks"


def test_tenant_caps_hold_rows_back():
    class R:
        def __init__(self, tenant, arrive, new=3, p=4):
            self.tenant, self.arrive, self.max_new = tenant, arrive, new
            self.prompt = [1] * p

    reqs = [R("a", 0), R("a", 0), R("b", 0, p=6)]
    s = S.simulate(reqs, rows=4, caps={"a": 1, "b": 4})
    assert s.join == [0, 3, 0]          # the second "a" waits for the first
    assert s.plen == [6, 4, 6]          # padded to the longest joiner
    assert len(s.drains) == 6
    assert s.drains[1].kv_lens == [7, 7]


def test_knee_saturated_service_rate():
    # everything due at once: the rate the rows sustain, requests a drain
    tr = small_context()[1].traffic
    reqs = G.chunk(dict(tr, chunk_requests=64), 1, 0, 256)
    for r in reqs:
        r.arrive = 0
    s = S.simulate(reqs, tr["rows"],
                   {t["name"]: t["rows"] for t in tr["tenants"]})
    mean_new = sum(r.max_new for r in reqs) / len(reqs)
    knee = len(reqs) / len(s.drains)
    assert knee <= tr["rows"] / mean_new + 1e-9
    assert knee > 0.5 * tr["rows"] / mean_new


@pytest.mark.parametrize("elapsed,chunks,more", [
    (15.8, 1, True), (38.4, 3, True), (47.4, 3, False), (51.2, 4, False),
    (60.0, 1, False)])
def test_window_ends_at_the_chunk_end_nearest_its_seconds(elapsed, chunks,
                                                          more):
    from perfbench.drivers.continuous import _one_more
    assert _one_more(elapsed, chunks, 51.0) is more

"""The span metrics by hand: the idle split over synthetic spans and
device operations, the host times, the counter, a run that lost spans;
the readers that were there before read the same with spans as without;
the collector on the program's own trace; and the span run's wiring on
the reduced cell on the CPU (the host metrics read, the idle shares need
the card's trace)."""

import gc
import json
import subprocess
import sys

import pytest

from perfbench import harness, spans as S, trace as TR
from perfbench.harness import read_metric
from perfbench.tests.cells import CHECKOUT, small_context
from perfbench.tests.test_perfbench_yardstick import Ev, _record

SEVEN = ("driver_host_ms", "requests_scanned", "driver_idle_share",
         "control_host_ms", "control_idle_share", "step_host_ms",
         "step_idle_share")


def _span(name, sid, parent, start, end):
    return S.Span(name, sid, parent, start, end, {})


# two serve cycles over a window of [0, 2000) ns
SPANS = [
    _span("serve.cycle", 1, 0, 0, 1000),
    _span("serve.join", 2, 1, 100, 300),
    _span("manager.drain", 3, 1, 300, 900),
    _span("sched.flush", 4, 3, 350, 800),
    _span("host.gc", 7, 4, 400, 450),
    _span("step.run", 5, 4, 500, 700),
    _span("step.replay", 6, 5, 550, 650),
    _span("serve.finish", 8, 1, 900, 1000),
    _span("serve.cycle", 9, 0, 1200, 1800),
    _span("manager.drain", 10, 9, 1300, 1700),
    _span("step.run", 11, 10, 1400, 1600),
]
# busy [0, 120), [600, 1300), [1500, 1550): idle [120, 600) (one gap
# over serve.join, the drain, the flush, a collection and the step),
# [1300, 1500) and [1550, 2000) (its last 200 ns under no span)
OPS = [TR.DeviceOp("k", 0, 120, 0), TR.DeviceOp("k", 600, 1300, 0),
       TR.DeviceOp("k", 1500, 1550, 1)]


def _traced(spans=SPANS, complete=True):
    rec = _record()
    rec.trace = TR.Reduced(window_s=2000e-9, busy_s=870e-9, drains=2,
                           ops=list(OPS), drain_busy_s=[820e-9, 50e-9],
                           gaps=[])
    rec.spans = S.SpanRecord(spans=list(spans), complete=complete,
                             scanned=10, bounds=(0, 2000))
    return rec


def test_idle_split_by_hand():
    split = S.split_of(_traced())
    ns = {k: round(v * 1e9) for k, v in split.by_name.items()}
    assert ns == {"serve.join": 180, "manager.drain": 250,
                  "sched.flush": 150, "step.run": 200, "step.replay": 50,
                  "serve.cycle": 100, None: 200}
    assert round(split.gc_s * 1e9) == 50          # counted to the flush
    assert round(split.idle_s * 1e9) == 1130
    assert {k: round(split.layer_s(k) * 1e9)
            for k in ("driver", "control", "step")} == {
        "driver": 280, "control": 400, "step": 250}


def test_span_readers_by_hand():
    rec = _traced()
    assert read_metric("driver_idle_share", rec) == pytest.approx(14.0)
    assert read_metric("control_idle_share", rec) == pytest.approx(20.0)
    assert read_metric("step_idle_share", rec) == pytest.approx(12.5)
    # with the 10 % under no span, the device's idle share
    assert sum(read_metric(n, rec) for n in (
        "driver_idle_share", "control_idle_share", "step_idle_share")) \
        + 10.0 == pytest.approx(read_metric("device_idle_share", rec))
    # cycles 1000 - 600 and 600 - 400 ns; drains 600 - 200, 400 - 200
    assert read_metric("driver_host_ms", rec) == pytest.approx(300e-6)
    assert read_metric("control_host_ms", rec) == pytest.approx(300e-6)
    assert read_metric("step_host_ms", rec) == pytest.approx(200e-6)
    assert read_metric("requests_scanned", rec) == pytest.approx(5.0)


@pytest.mark.parametrize("how", ["dropped", "none", "empty"])
def test_span_readers_read_nothing_without_every_span(how):
    rec = _traced(complete=how != "dropped")
    if how == "none":
        del rec.spans
    elif how == "empty":
        rec.spans.spans = []
    assert all(read_metric(n, rec) is None for n in SEVEN)


def test_idle_shares_need_the_device_trace():
    rec = _traced()
    rec.trace = None
    assert read_metric("driver_idle_share", rec) is None
    assert read_metric("driver_host_ms", rec) == pytest.approx(300e-6)


def test_host_times_leave_out_the_profilers_start_and_stop():
    spans = SPANS + [_span(S.PROFILER, 12, 9, 1210, 1290)]
    rec = _traced(spans)
    # the second cycle: 600 - 400 (its drain) - 80 (the profiler)
    assert read_metric("driver_host_ms", rec) == pytest.approx(260e-6)
    assert read_metric("control_host_ms", rec) == pytest.approx(300e-6)
    assert S.layer_of(S.PROFILER) is None


def test_longest_gaps_by_hand():
    busy = [(op.start, op.end) for op in OPS]
    gaps = S.longest_gaps(busy, 0, 2000, SPANS, n=2)
    assert [round(g * 1e9) for g, _ in gaps] == [480, 450]
    assert [(k, round(v * 1e9)) for k, v in gaps[0][1]] == [
        ("serve.join", 180), ("sched.flush", 100), ("manager.drain", 50),
        ("host.gc", 50), ("step.run", 50), ("step.replay", 50)]
    assert [(k, round(v * 1e9)) for k, v in gaps[1][1]] == [
        (None, 200), ("manager.drain", 100), ("serve.cycle", 100),
        ("step.run", 50)]


def test_gap_under_nested_collections_counts_to_the_interrupted_span():
    spans = [_span("serve.cycle", 1, 0, 0, 100),
             _span("host.gc", 2, 1, 10, 60),
             _span("serve.join", 3, 1, 60, 80),
             _span("host.gc", 4, 3, 65, 70)]
    split = S.split_idle([], 0, 120, spans)
    ns = {k: round(v * 1e9) for k, v in split.by_name.items()}
    assert ns == {"serve.cycle": 80, "serve.join": 20, None: 20}
    assert round(split.gc_s * 1e9) == 55


def test_innermost_ties_and_edges():
    # a child starting with its parent and a sibling starting as another
    # ends: the child and the sibling hold those instants
    spans = [_span("serve.cycle", 1, 0, 0, 10),
             _span("serve.leave", 2, 1, 0, 4),
             _span("serve.join", 3, 1, 4, 10)]
    assert S.innermost(spans, 0, 12) == [
        (0, 4, "serve.leave", False), (4, 10, "serve.join", False),
        (10, 12, None, False)]
    assert S.idle_intervals([(5, 7), (-3, 1), (6, 9)], 0, 12) == [
        (1, 5), (9, 12)]


def test_every_earlier_reader_reads_the_same_with_spans():
    """Each metric the benchmark had reads the same value on a record
    with spans as on the same record without."""
    bench = harness.benchmark()
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert not set(names) & set(SEVEN)
    without = _traced()
    del without.spans
    assert {n: read_metric(n, without) for n in names} == \
        {n: read_metric(n, _traced()) for n in names}


def test_launch_coverage_and_graph_launches():
    launches = S.graph_launches([
        Ev("cuda_runtime", "cudaGraphLaunch", 560, 570),
        Ev("cuda_runtime", "cudaGraphLaunch_v10000", 1420, 1430),
        Ev("cuda_runtime", "cudaLaunchKernel", 600, 610),
        Ev("kernel", "cudaGraphLaunch", 580, 590),
        Ev("cuda_runtime", "cudaGraphLaunch", 2500, 2510)], 0, 2000)
    assert launches == [(560, 570), (1420, 1430)]
    # the first inside its replay, the second in a step with no replay
    assert S.launch_coverage(SPANS, launches) == (1, 2)


def test_collector_takes_spans_on_the_wall_clock():
    import time
    from repro_torch.core.telemetry import Telemetry
    tel = Telemetry(None)
    c = S.Collector(tel)
    w0 = time.time_ns()
    c.start()
    tr = tel.trace
    a = tr.open("serve.cycle", 3)
    tr.close(tr.open("serve.join"), joiners=2)
    tel.registry.inc(S.Collector.COUNTER, 4)
    tr.close(a)
    c.take()
    tr.emit("not-a-span", "t", 0)
    c.stop()
    w1 = time.time_ns()
    assert not tr.spans
    assert [(s.name, s.parent) for s in c.spans] == [
        ("serve.join", a.sid), ("serve.cycle", 0)]
    assert all(w0 <= s.start <= s.end <= w1 for s in c.spans)
    assert c.spans[0].args == {"joiners": 2}
    assert c.record().scanned == 4 and c.complete
    # a ring that dropped an event before it was taken: not complete
    small = Telemetry(None, trace_capacity=2)
    c2 = S.Collector(small)
    c2.start()
    for _ in range(3):
        small.trace.close(small.trace.open("serve.cycle"))
    c2.stop()
    assert not c2.complete


@pytest.mark.parametrize("on", [True, False])
def test_span_run_wiring_on_the_reduced_cell(on, monkeypatch):
    """The span run's hooks on the reduced cell on the CPU: the window's
    spans (the warm-up's left out) reach the record, each drain in a
    serve cycle; the host metrics and the counter read numbers, the idle
    shares nothing (no device trace); with the switch off, none."""
    from perfbench import spans_run
    probe = spans_run.install(monkeypatch.setattr, on=on)
    bench, ctx = small_context(seed=2**31 + 21)
    ctx.trace = True
    rec = harness.run(ctx)
    out = harness.result(bench, ctx, rec, {})
    assert out["correct"] is True
    assert probe.chunks >= 2
    assert probe.collector is not None and not probe.collector.trace.spans
    got = {n for n in SEVEN if n in out["metrics"]}
    assert "output_tokens_per_s" in out["metrics"]
    if not on:
        assert got == set()
        assert probe.on_gc not in gc.callbacks
        return
    assert got == {"driver_host_ms", "control_host_ms", "step_host_ms",
                   "requests_scanned"}
    sr = rec.spans
    by = {s.sid: s for s in sr.spans}
    drains = S.named(sr.spans, "manager.drain")
    assert len(drains) == len(rec.drains)
    assert all(by[d.parent].name == "serve.cycle" for d in drains)
    # the engine keeps the requests it served: a scan visits more than
    # one chunk's worth by the end
    assert out["metrics"]["requests_scanned"]["value"] > 0
    assert 0 < out["metrics"]["step_host_ms"]["value"]


def test_span_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = subprocess.run(
        [sys.executable, "perfbench/spans_run.py", "--workload",
         "stablelm-3b.chat", "--seed", "1", "--seconds", "1"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


@pytest.mark.cuda
def test_span_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "perfbench/spans_run.py", "--workload",
         "stablelm-3b.chat", "--seed", str(2**31 + 5), "--seconds", "2"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.splitlines()[-1])
    assert out["correct"] is True
    assert set(SEVEN) <= set(out["metrics"])
    assert "graph launches inside their step.replay span" in p.stderr


def test_span_run_report_by_hand(capsys):
    """The run's stderr report on the synthetic window scaled to ms: the
    idle seconds by span, the longest gaps by the spans over them, each
    span's mean inside the profiled span against the rest, collections
    by generation."""
    from perfbench import spans_run
    k = 1_000_000
    col = S.Span("host.gc", 7, 4, 400 * k, 450 * k, {"generation": 2})
    spans = [S.Span(x.name, x.sid, x.parent, x.start * k, x.end * k, {})
             if x.name != "host.gc" else col for x in SPANS]
    rec = _traced(spans)
    rec.trace.ops = [TR.DeviceOp(o.name, o.start * k, o.end * k, o.drain)
                     for o in OPS]
    rec.spans.bounds = (0, 1100 * k)
    spans_run.report(rec)
    err = capsys.readouterr().err
    assert "idle 0.180000 s under serve.join" in err
    assert "idle 0.200000 s under no span" not in err   # outside the span
    assert "gap 480.000 ms: serve.join 180.000, sched.flush 100.000" in err
    assert "serve.cycle: 1000.000 ms a span in the profiled span (1), " \
        "600.000 ms outside (1)" in err
    assert "host.gc generation 2 over the window: 1, 50.000 ms" in err
    del rec.spans
    spans_run.report(rec)
    assert "none kept" in capsys.readouterr().err

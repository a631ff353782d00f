"""One traced run of a cell with the program's host spans on, and the
seven metrics that read them.

    python3 perfbench/spans_run.py --workload <cell> --seed <n> \
        --seconds <s> [--spans 0|1]

It is ``run.py --trace 1`` with :class:`perfbench.spans.Collector` wired
into the continuous driver from outside (the driver and the harness stay
as they are): the switch goes on as the window's first chunk starts
(``--spans 0``: it stays off, to measure what the spans cost), the
program's trace takes an anchor of its clock as the profiler starts and
stops, the profiler's start and stop are a ``bench.profiler`` span, the
spans are taken after every chunk, the switch goes off before the output
check, and the profiler's graph-launch runtime calls in the profiled
span are kept.  The result line is ``run.py``'s with the seven span
metrics and ``output_tokens_per_s`` added; standard error gets the idle
seconds by span name, the unassigned rest, ``host.gc``'s share, how many
graph launches lie inside their ``step.replay`` span, and the ten
longest idle gaps by the spans open over them, and the window's garbage
collections by generation (timed by the run itself with the switch off).
Needs a card for the idle split; on the CPU the host metrics still read.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
from typing import Callable  # noqa: E402

from perfbench import harness, spans as S, trace as TR  # noqa: E402
from perfbench.drivers import continuous as C  # noqa: E402

#: the span metrics and their units
METRICS = {"driver_host_ms": "ms", "requests_scanned": "count",
           "driver_idle_share": "%", "control_host_ms": "ms",
           "control_idle_share": "%", "step_host_ms": "ms",
           "step_idle_share": "%"}


class Probe:
    """What :func:`install` wires in, and what it kept.  With the switch
    off it times the window's garbage collections itself (``gcs``:
    generation and ns each), which the program's ``host.gc`` spans give
    with it on."""

    def __init__(self, on: bool):
        self.on = on
        self.chunks = 0
        self.collector = None
        self.bounds = None
        self.launches = []
        self.gcs = []
        self._gc0 = None

    def on_gc(self, phase, info):
        if phase == "start":
            self._gc0 = time.perf_counter_ns()
        elif self._gc0 is not None:
            self.gcs.append((info["generation"],
                             time.perf_counter_ns() - self._gc0))
            self._gc0 = None


def install(setattr_: Callable, on: bool = True) -> Probe:
    """Wire a :class:`Probe` into the driver, the tracer and the harness
    through ``setattr_`` (``setattr``, or a test's
    ``monkeypatch.setattr``)."""
    probe = Probe(on)
    serve_chunk, check = C._serve_chunk, C.check
    start, stop = TR.Tracer.start, TR.Tracer.stop
    reduce_events, result = TR.reduce_events, harness.result

    def _serve_chunk(engine, clock, reqs, span=None, tracer=None):
        probe.chunks += 1
        if probe.chunks == 2:           # the window's first chunk
            probe.collector = S.Collector(engine.manager.telemetry,
                                          on=probe.on)
            probe.collector.start()
            if not probe.on:
                gc.callbacks.append(probe.on_gc)
        out = serve_chunk(engine, clock, reqs, span, tracer)
        if probe.collector is not None:
            probe.collector.take()
        return out

    def _check(*a, **kw):
        if probe.collector is not None:
            probe.collector.stop()
        if probe.on_gc in gc.callbacks:
            gc.callbacks.remove(probe.on_gc)
        return check(*a, **kw)

    def _start(self):
        tr = probe.collector.trace
        sp = tr.open(S.PROFILER) if tr.spans else None
        start(self)
        tr.anchor()
        if sp is not None:
            tr.close(sp)

    def _stop(self):
        tr = probe.collector.trace
        tr.anchor()
        sp = tr.open(S.PROFILER) if tr.spans else None
        stop(self)
        if sp is not None:
            tr.close(sp)

    def _reduce_events(events, host):
        w0, w1 = host["driver"][0]
        probe.bounds = (w0, w1)
        probe.launches = S.graph_launches(events, w0, w1)
        return reduce_events(events, host)

    def _result(bench, ctx, rec, device):
        if probe.collector is not None:
            rec.spans = probe.collector.record(probe.bounds, probe.launches)
        out = result(bench, ctx, rec, device)
        for name in ("output_tokens_per_s", *METRICS):
            v = harness.read_metric(name, rec)
            if v is not None:
                out["metrics"][name] = {
                    "value": v, "unit": METRICS.get(name, "tokens/s")}
        report(rec)
        for gen in (0, 1, 2):
            d = [ns for g, ns in probe.gcs if g == gen]
            if d:
                print(f"gc generation {gen} over the window (switch off): "
                      f"{len(d)}, {1e-6 * sum(d):.3f} ms in all, longest "
                      f"{1e-6 * max(d):.3f} ms", file=sys.stderr)
        return out

    setattr_(C, "_serve_chunk", _serve_chunk)
    setattr_(C, "check", _check)
    setattr_(TR.Tracer, "start", _start)
    setattr_(TR.Tracer, "stop", _stop)
    setattr_(TR, "reduce_events", _reduce_events)
    setattr_(harness, "result", _result)
    return probe


def report(rec) -> None:
    """The idle split by span name, and the launches' coverage, on
    standard error."""
    split = S.split_of(rec)
    sr = S.of(rec)
    if sr is None:
        print("spans: none kept (switch off, or the ring dropped some)",
              file=sys.stderr)
        return
    print(f"spans: {len(sr.spans)} in the window, "
          f"{len(S.named(sr.spans, 'serve.cycle'))} serve cycles, "
          f"{sr.scanned} request records scanned", file=sys.stderr)
    if split is None:
        return
    for name, s in sorted(split.by_name.items(), key=lambda kv: -kv[1]):
        print(f"idle {s:.6f} s under {name or 'no span'}", file=sys.stderr)
    gc = [x for x in sr.spans if x.name == S.GC
          and sr.bounds[0] <= x.start < sr.bounds[1]]
    print(f"idle of {split.idle_s:.6f} s: unassigned "
          f"{split.by_name.get(None, 0.0):.6f} s; during host.gc "
          f"{split.gc_s:.6f} s ({len(gc)} collections in the profiled "
          f"span, {1e-9 * sum(x.end - x.start for x in gc):.6f} s)",
          file=sys.stderr)
    inside, n = S.launch_coverage(sr.spans, sr.launches)
    print(f"graph launches inside their step.replay span: {inside} of {n}",
          file=sys.stderr)
    busy = [(op.start, op.end) for op in rec.trace.ops]
    for sec, by in S.longest_gaps(busy, *sr.bounds, sr.spans):
        print(f"gap {1e3 * sec:.3f} ms: " + ", ".join(
            f"{name or 'no span'} {1e3 * s:.3f}" for name, s in by),
            file=sys.stderr)
    # what the profiler does to the host: each span's mean inside the
    # profiled span against the rest of the window
    w0, w1 = sr.bounds
    for name in ("serve.cycle", "serve.stage", "serve.finish",
                 "manager.drain", "sched.execute", "step.stage",
                 "step.replay"):
        ins = [x.end - x.start for x in S.named(sr.spans, name)
               if w0 <= x.start < w1]
        out = [x.end - x.start for x in S.named(sr.spans, name)
               if not w0 <= x.start < w1]
        if ins and out:
            print(f"{name}: {1e-6 * sum(ins) / len(ins):.3f} ms a span in "
                  f"the profiled span ({len(ins)}), "
                  f"{1e-6 * sum(out) / len(out):.3f} ms outside "
                  f"({len(out)})", file=sys.stderr)
    for gen in (0, 1, 2):
        d = [x.end - x.start for x in sr.spans if x.name == S.GC
             and x.args.get("generation") == gen]
        if d:
            print(f"host.gc generation {gen} over the window: {len(d)}, "
                  f"{1e-6 * sum(d):.3f} ms in all, longest "
                  f"{1e-6 * max(d):.3f} ms", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/spans_run.py")
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args, rest = ap.parse_known_args(argv)
    from perfbench import run      # sets the caches' paths
    run.T0 = T0                    # set-up counts from this process's start
    install(setattr, on=bool(args.spans))
    return run.main([*rest, "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())

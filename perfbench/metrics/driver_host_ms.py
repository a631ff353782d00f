"""Host time of the serve driver a serve cycle: each ``serve.cycle`` span
of the window less its ``manager.drain`` child (leave, join, operand
staging, merge, gauges; less the profiler's own start and stop too,
which the window leaves out), averaged over the cycles.  From the
program's host spans (``perfbench/spans.py``)."""

from perfbench import spans as S


def read(rec):
    sr = S.of(rec)
    return None if sr is None else S.self_ms(sr.spans, "serve.cycle",
                                             "manager.drain")

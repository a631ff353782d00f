"""Host time of the compiled steps a drain: the window's ``step.run``
spans (staged copies, replay, any capture) over its ``manager.drain``
spans.  From the program's host spans (``perfbench/spans.py``)."""

from perfbench import spans as S


def read(rec):
    sr = S.of(rec)
    if sr is None:
        return None
    drains = len(S.named(sr.spans, "manager.drain"))
    if not drains:
        return None
    return 1e-6 * sum(s.end - s.start
                      for s in S.named(sr.spans, "step.run")) / drains

"""Host time of the control plane a drain: each ``manager.drain`` span of
the window less the ``step.run`` spans inside it (round-robin, flush and
batching, polls), averaged over the drains.  From the program's host
spans (``perfbench/spans.py``)."""

from perfbench import spans as S


def read(rec):
    sr = S.of(rec)
    return None if sr is None else S.self_ms(sr.spans, "manager.drain",
                                             "step.run")

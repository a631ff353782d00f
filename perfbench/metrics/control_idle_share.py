"""Share of the profiled span's wall time in which the device is idle while
the host's innermost open span is a span inside ``manager.drain`` and
outside ``step.run`` (the manager's round-robin, the scheduler, the
polls); a garbage collection counts to the span it interrupted.  The
device's idle intervals (the profiler) split over the program's host
spans in one sweep (``perfbench/spans.py``)."""

from perfbench import spans as S


def read(rec):
    split = S.split_of(rec)
    return None if split is None else split.share("control")

"""Device busy time of the traced chunk's decode-only drains (no joiner),
from the profiler, over their count."""

from perfbench.yardstick import mean


def read(rec):
    if rec.trace is None:
        return None
    busy = [rec.trace.drain_busy_s[d.traced] * 1e3 for d in rec.drains
            if d.traced >= 0 and d.kv_lens and not d.joiners
            and d.traced < len(rec.trace.drain_busy_s)]
    return mean(busy)

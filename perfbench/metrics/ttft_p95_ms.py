"""95th percentile over every request of the window: from its due time
(the device completion of the drain before its arrival cycle, or its
chunk's start) to the device completion of the drain that produced its
first token."""

from perfbench.yardstick import percentile


def read(rec):
    return percentile([x.token_ms[0] - x.due_ms for x in rec.reqs
                       if x.token_ms], 95)

"""95th percentile over every gap between consecutive tokens of every
request of the window: the time between the device completions of the two
drains that produced them."""

from perfbench.yardstick import percentile


def read(rec):
    return percentile([b - a for x in rec.reqs
                       for a, b in zip(x.token_ms, x.token_ms[1:])], 95)

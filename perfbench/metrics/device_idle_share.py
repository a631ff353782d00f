"""The share of the traced chunk's wall time (its driver call) in which no
operation ran on the device, from the profiler's trace."""


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s

"""Step graphs captured during the window (the manager's compiled-step
counters: live graphs plus evicted ones).  The warm-up leaves none."""


def read(rec):
    return float(rec.captures)

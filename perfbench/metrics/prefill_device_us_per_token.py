"""Device busy time of the traced chunk's drains that carry a prefill,
less the median decode-only drain where the drain also decodes, over the
tokens they prefilled, padding included."""

import statistics


def read(rec):
    if rec.trace is None:
        return None
    busy = rec.trace.drain_busy_s
    traced = [d for d in rec.drains
              if d.traced >= 0 and d.traced < len(busy)]
    dec = [busy[d.traced] for d in traced if d.kv_lens and not d.joiners]
    pre = [d for d in traced if d.joiners]
    tokens = sum(d.plen * len(d.joiners) for d in pre)
    if not pre or not tokens:
        return None
    base = statistics.median(dec) if dec else 0.0
    t = sum(busy[d.traced] - (base if d.kv_lens else 0.0) for d in pre)
    return 1e6 * t / tokens

"""Padding over every token prefilled for a joining request: a drain's
joiners are padded at the end to the longest of their prompts, and the
pads are cached and attended."""


def read(rec):
    total = sum(d.plen * len(d.joiners) for d in rec.drains)
    pads = sum(d.plen - p for d in rec.drains for p in d.joiners)
    return 100.0 * pads / total if total else None

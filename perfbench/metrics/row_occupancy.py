"""Rows that emit a token over the engine's rows, averaged over the
window's drains that run a decode step (the span ledger's join cycles
and each request's length)."""


def read(rec):
    rows = rec.traffic["rows"]
    occ = [(len(d.kv_lens) + len(d.joiners)) / rows for d in rec.drains
           if d.kv_lens]
    return 100.0 * sum(occ) / len(occ) if occ else None

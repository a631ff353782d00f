"""Request records the serve driver's scans visit a serve cycle: the
program's ``serve_requests_scanned`` counter over the window (the join's
waiting list, the waiting checks and every page scan) over its
``serve.cycle`` spans."""

from perfbench import spans as S


def read(rec):
    sr = S.of(rec)
    if sr is None:
        return None
    cycles = len(S.named(sr.spans, "serve.cycle"))
    return sr.scanned / cycles if cycles else None

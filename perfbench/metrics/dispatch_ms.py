"""Host wall time inside the manager's run_queued, summed over the
window's drains, over the drain count (the step graphs replay
asynchronously: this is the host's share of a drain)."""


def read(rec):
    if not rec.drains:
        return None
    return 1e3 * sum(d.host_s for d in rec.drains) / len(rec.drains)

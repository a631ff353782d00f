"""``python -m repro_torch.top`` — the Guardian operator dashboard.

Renders :meth:`GuardianManager.metrics_report` as a terminal dashboard
(:mod:`repro_torch.launch.dashboard` — plain ANSI, curses-free).  By
default it drives a small built-in multi-tenant demo (raw
``GuardianClient`` traffic: module_load / malloc / memcpy_h2d /
launch_kernel over a few drain cycles) so every panel has data; the demo
kernel is a plain PyTorch tenant kernel, sandboxed at its first launch and
compiled like every tenant launch.  The module is also the reference for
wiring the dashboard to a live manager::

    from repro_torch.launch.dashboard import format_report
    print(format_report(mgr.metrics_report(), registry=mgr.telemetry.registry))

Modes:

* ``--snapshot`` (default): drive ``--cycles`` drain cycles, render
  once, exit 0.
* ``--watch``: redraw every ``--interval`` seconds, driving one more
  drain burst per frame, until Ctrl-C.
* ``--json``: dump the raw metrics_report dict instead of rendering.
* ``--prom``: dump the Prometheus text exposition instead.
* ``--trace-out FILE``: additionally write the Chrome/Perfetto trace.

The manager lives on ``--device`` (the card unless the caller asks for the
CPU)::

    PYTHONPATH=src python -m repro_torch.top --snapshot --tenants 3
    PYTHONPATH=src python -m repro_torch.top --snapshot --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

CLEAR = "\x1b[2J\x1b[H"

#: demo arena: small enough to build instantly
DEMO_SLOTS = 1 << 12
#: per-tenant fence policies cycled across the demo tenants — one of
#: each mode, so the dashboard's policy column and the scheduler's
#: per-policy batching both show up
DEMO_POLICIES = ("bitwise", "modulo", "check")


def _demo_kernel(arena, ptr, n):
    idx = ptr + torch.arange(n, dtype=torch.int32, device=arena.device)
    vals = torch.take(arena, idx.long())
    arena[idx] = vals * 1.0001 + 1.0
    return arena, None


def build_demo(n_tenants: int, policies: Tuple[str, ...] = DEMO_POLICIES,
               device="cuda"):
    """A GuardianManager on ``device`` with ``n_tenants`` demo tenants
    submitting raw fenced launches — returns ``(mgr, clients, ptrs)``."""
    from repro_torch.core import FencePolicy, GuardianManager

    mgr = GuardianManager(total_slots=DEMO_SLOTS,
                          standalone_fast_path=False, device=device)
    clients, ptrs = [], []
    for i in range(n_tenants):
        pol = FencePolicy(policies[i % len(policies)]) if policies \
            else None
        c = mgr.register_tenant(f"tenant{i}",
                                DEMO_SLOTS // (2 * max(n_tenants, 1)),
                                policy=pol, weight=1 + i % 2)
        c.module_load("work", _demo_kernel)
        p = c.malloc(16)
        c.memcpy_h2d(p, np.zeros(16, np.float32))
        clients.append(c)
        ptrs.append(p)
    mgr.synchronize()
    return mgr, clients, ptrs


def drive(mgr, clients, ptrs, cycles: int) -> None:
    """Enqueue ``cycles`` rounds of one launch per tenant, then drain —
    each round lands in (at least) one drain cycle, so the queue-age and
    drain-time histograms fill."""
    for _ in range(max(cycles, 1)):
        for c, p in zip(clients, ptrs):
            c.launch_kernel("work", ptrs=[p], args=(16,))
        mgr.run_queued()


def render(mgr) -> str:
    from repro_torch.launch.dashboard import format_report

    return format_report(mgr.metrics_report(),
                         registry=mgr.telemetry.registry)


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.top", description="Guardian operator dashboard")
    ap.add_argument("--snapshot", action="store_true",
                    help="render once and exit (default)")
    ap.add_argument("--watch", action="store_true",
                    help="redraw every --interval seconds until Ctrl-C")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--cycles", type=int, default=8,
                    help="demo drain-cycle bursts before the first frame")
    ap.add_argument("--json", action="store_true",
                    help="dump the metrics_report dict as JSON")
    ap.add_argument("--prom", action="store_true",
                    help="dump the Prometheus text exposition")
    ap.add_argument("--trace-out", default=None,
                    help="write the Chrome/Perfetto event trace JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the demo manager runs: cuda (default) or "
                         "cpu")
    args = ap.parse_args(argv)

    mgr, clients, ptrs = build_demo(args.tenants, device=args.device)
    drive(mgr, clients, ptrs, args.cycles)

    def frame() -> str:
        if args.json:
            return json.dumps(mgr.metrics_report(), indent=1,
                              default=str, sort_keys=True)
        if args.prom:
            return mgr.telemetry.registry.to_prometheus()
        return render(mgr)

    if args.watch:
        try:
            while True:
                sys.stdout.write(CLEAR + frame() + "\n")
                sys.stdout.flush()
                time.sleep(args.interval)
                drive(mgr, clients, ptrs, 1)
        except KeyboardInterrupt:
            pass
    else:
        print(frame())
    if args.trace_out:
        with open(args.trace_out, "w") as fh:
            fh.write(mgr.telemetry.trace.to_json())
        print(f"trace: {args.trace_out} "
              f"({len(mgr.telemetry.trace)} events)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

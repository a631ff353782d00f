"""Tenant failover demo, on the port — a rogue tenant detected,
quarantined, evicted, and its partition reclaimed for a new tenant, while
co-tenants never miss a launch.

1. three tenants share a CHECK-policy manager; launches fuse into one
   batch per drain cycle with per-row ok attribution,
2. tenant "rogue" issues out-of-bounds writes — its rows are rolled back
   on the device and per-kind counts fold into the ViolationLog, co-tenant
   rows keep landing,
3. the QuarantineManager's cycle-boundary poll crosses the threshold:
   rogue is QUARANTINED (queued ops dropped, new calls rejected),
4. the operator evicts it: partition scrubbed (verified zeroed) and
   returned to the buddy allocator, planned programs purged,
5. a new tenant registers and is admitted into the freed block.

    PYTHONPATH=src python -m repro_torch.examples.failover              # card
    PYTHONPATH=src python -m repro_torch.examples.failover --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (
    FencePolicy,
    GuardianManager,
    QuarantineError,
    TenantQuarantined,
    TenantState,
    ThresholdPolicy,
)

TOTAL = 1 << 10


def work(arena, ptr, n):
    idx = ptr + torch.arange(n, dtype=torch.int32, device=arena.device)
    arena[idx] = torch.take(arena, idx.long()) + 1.0
    return arena, None


def oob_write(arena, target, n):
    idx = target + torch.arange(n, dtype=torch.int32, device=arena.device)
    arena[idx] = 666.0
    return arena, None


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mgr = GuardianManager(
        total_slots=TOTAL, policy=FencePolicy.CHECK,
        quarantine_policy=ThresholdPolicy(quarantine_after=12),
        device=args.device)

    print("1) three tenants share the arena (CHECK policy, fused drains)")
    names = ["alice", "bob", "rogue"]
    clients, ptrs = {}, {}
    for name in names:
        c = mgr.register_tenant(name, TOTAL // 8)
        c.module_load("work", work)
        c.module_load("oob", oob_write)
        p = c.malloc(8)
        c.memcpy_h2d(p, np.zeros(8, np.float32))
        clients[name], ptrs[name] = c, p
    mgr.synchronize()
    for name in names:
        part = mgr.bounds.lookup(name)
        print(f"   {name:6s} slots [{part.base}, {part.end})")
    rogue_part = mgr.bounds.lookup("rogue")

    print("2) rogue goes out of bounds; co-tenants keep launching")
    victim = torch.tensor(mgr.bounds.lookup("alice").base, dtype=torch.int32)
    for _ in range(6):
        for name in ("alice", "bob"):
            clients[name].launch_kernel("work", ptrs=[ptrs[name]], args=(8,))
        if mgr.quarantine.state_of("rogue").admissible:
            clients["rogue"].launch_kernel("oob", args=(victim, 8))
    mgr.synchronize()

    report = mgr.violation_report()
    print(f"   violation report: {report['tenants']}")
    assert report["tenants"]["rogue"]["scatter"] >= 12
    assert report["tenants"]["alice"]["total"] == 0
    alice_data = clients["alice"].memcpy_d2h(ptrs["alice"], 8)
    assert (alice_data == 6.0).all(), alice_data   # all 6 cycles landed
    print(f"   alice's writes all landed: {alice_data[:4]}...")

    print("3) rogue was quarantined at the cycle boundary")
    assert mgr.quarantine.state_of("rogue") is TenantState.QUARANTINED
    try:
        clients["rogue"].launch_kernel("work", ptrs=[ptrs["rogue"]],
                                       args=(8,))
        raise AssertionError("quarantined launch was admitted")
    except TenantQuarantined as e:
        print(f"   new launch rejected: {e}")

    print("4) evict: partition scrubbed + reclaimed, caches purged")
    free_before = mgr.bounds.free_slots()
    mgr.quarantine.evict("rogue")
    scrubbed = mgr.arena.unsafe_read_range(rogue_part.base,
                                           rogue_part.size).cpu()
    assert (scrubbed == 0).all()
    print(f"   slots [{rogue_part.base}, {rogue_part.end}) zeroed, "
          f"free {free_before} -> {mgr.bounds.free_slots()}")
    try:
        mgr.register_tenant("rogue", TOTAL // 8)
    except QuarantineError as e:
        print(f"   re-registration refused: {e}")
    else:
        raise AssertionError("EVICTED id re-registered without readmit")

    print("5) new tenant admitted into the freed block")
    c_new = mgr.register_tenant("carol", TOTAL // 8)
    new_part = mgr.bounds.lookup("carol")
    assert new_part.base == rogue_part.base, (new_part, rogue_part)
    p_new = c_new.malloc(8)
    c_new.memcpy_h2d(p_new, np.full(8, 3.0, np.float32))
    c_new.launch_kernel("work", ptrs=[p_new], args=(8,))
    mgr.synchronize()
    np.testing.assert_array_equal(c_new.memcpy_d2h(p_new, 8),
                                  np.full(8, 4.0, np.float32))
    print(f"   carol reuses slots [{new_part.base}, {new_part.end}); "
          "co-tenant service never stopped.\nall good.")


if __name__ == "__main__":
    main()

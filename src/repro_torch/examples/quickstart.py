"""Quickstart — Guardian in 60 seconds, on the port.

Two mutually-untrusting tenants share one device arena.  Tenant B loads a
plain PyTorch kernel that writes at an address it chose — aimed straight
at tenant A's buffer; the sandbox fences the store and the attack wraps
into B's own partition.  Then an honest kernel runs under all four bounds
modes to show the cost ladder.

    PYTHONPATH=src python -m repro_torch.examples.quickstart             # card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (
    FencePolicy,
    GuardianManager,
    GuardianViolation,
    SharingMode,
)


def evil(arena, target, n):
    idx = target + torch.arange(n, dtype=torch.int32, device=arena.device)
    arena[idx] = 666.0
    return arena, None


def saxpy(arena, x_ptr, y_ptr, n):
    ii = torch.arange(n, dtype=torch.int32, device=arena.device)
    x = torch.take(arena, (x_ptr + ii).long())
    y = torch.take(arena, (y_ptr + ii).long())
    arena[y_ptr + ii] = 2.0 * x + y
    return arena, None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--launches", type=int, default=50,
                    help="timed launches per bounds mode")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    print("=" * 64)
    print("1. Two tenants, one device arena, bitwise fencing")
    print("=" * 64)
    mgr = GuardianManager(total_slots=4096, policy=FencePolicy.BITWISE,
                          mode=SharingMode.TIME_SHARE, device=device)
    alice = mgr.register_tenant("alice", 1024)
    bob = mgr.register_tenant("bob", 1024)
    secret = alice.malloc(16)
    alice.memcpy_h2d(secret, np.full(16, 42.0, np.float32))
    alice.synchronize()

    bob.module_load("evil", evil)
    print(f"bob attacks alice's buffer at slot {secret.addr} ...")
    bob.launch_kernel("evil", args=(torch.tensor(secret.addr,
                                                 dtype=torch.int32), 16))
    bob.synchronize()
    got = alice.memcpy_d2h(secret, 16)
    print(f"alice's data after the attack: {got[:4]} (unchanged: "
          f"{bool((got == 42.0).all())})")
    assert (got == 42.0).all()
    part = mgr.bounds.lookup("bob")
    bob_mem = mgr.arena.unsafe_read_range(part.base, part.size).cpu()
    print(f"the 666s wrapped into bob's own partition: "
          f"{int((bob_mem == 666.0).sum())} slots hit\n")

    # host-initiated transfers are range-checked at the manager
    forged = dataclasses.replace(secret)
    try:
        bob.memcpy_d2h(forged, 16)
    except GuardianViolation as e:
        print(f"2. forged-pointer memcpy rejected:\n   {e}\n")

    print("=" * 64)
    print("3. The bounds modes (cost ladder, honest workload)")
    print("=" * 64)
    for policy in (FencePolicy.NONE, FencePolicy.BITWISE,
                   FencePolicy.MODULO, FencePolicy.CHECK):
        m2 = GuardianManager(total_slots=4096, policy=policy,
                             mode=SharingMode.TIME_SHARE,
                             standalone_fast_path=False, device=device)
        t1 = m2.register_tenant("t1", 1024)
        m2.register_tenant("t2", 1024)
        x, y = t1.malloc(256), t1.malloc(256)
        t1.memcpy_h2d(x, np.ones(256, np.float32))
        t1.memcpy_h2d(y, np.zeros(256, np.float32))
        t1.module_load("saxpy", saxpy)
        t1.launch_kernel("saxpy", ptrs=[x, y], args=(256,))   # plan
        t1.synchronize()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(args.launches):
            t1.launch_kernel("saxpy", ptrs=[x, y], args=(256,))
        t1.synchronize()
        dt = (time.perf_counter() - t0) / max(args.launches, 1)
        y_now = t1.memcpy_d2h(y, 256)
        assert (y_now == 2.0 * (args.launches + 1)).all(), y_now[:4]
        print(f"   {policy.value:8s}: {dt * 1e6:9.1f} us/launch "
              f"(wall, {device.type})")


if __name__ == "__main__":
    main()

"""Guardian core, ported to PyTorch (trusted-kernel subset).

Layering (bottom-up):

    partition   — pow2 buddy arena allocator + partition bounds table
    fence       — the 3 bounds modes (bitwise / modulo / check) in int32
    arena       — shared device arenas (flat DRAM model, KV page pool)
    violations  — ViolationLog: device-side per-tenant per-kind counters
    interception— GuardianClient ("grdLib"): device-API shadowing + traces
    scheduler   — BatchedLaunchScheduler: coalesces compatible trusted
                  steps across engines, lookahead + tenant classes
    quarantine  — tenant lifecycle (ACTIVE→QUARANTINED→EVICTED|READMITTED)
    pressure    — host-side allocation-pressure telemetry
    elastic     — ElasticManager: admission waitlist, live grow/shrink
    telemetry   — flight recorder: metrics registry + event trace + spans
    tenantclass — SLO classes (latency_critical / best_effort)
    manager     — GuardianManager ("grdManager"): sole device owner

The sandboxer, the static verifier and the simulated libraries of the
reference wait for a later port.
"""

from repro_torch.core.arena import Arena, ArenaSpec, PagePool, PoolArena, \
    make_flat_arena
from repro_torch.core.fence import (
    FenceParams,
    FencePolicy,
    FenceTable,
    apply_fence,
    apply_fence_mixed,
    fence_bitwise,
    fence_check,
    fence_modulo,
    fence_modulo_magic,
    fence_modulo_magic_dyn,
    magic_constants,
    magic_row,
    require_pow2_sizes,
)
from repro_torch.core.interception import DevicePtr, GuardianClient
from repro_torch.core.manager import GuardianManager, GuardianViolation, \
    SharingMode
from repro_torch.core.partition import BuddyAllocator, OutOfArenaMemory, \
    Partition, PartitionBoundsTable, UnknownTenant
from repro_torch.core.scheduler import BatchedLaunchScheduler, \
    LaunchRequest, LRUCache, SchedulerStats, round_robin_interleave
from repro_torch.core.violations import ViolationLog

__all__ = [
    "Arena", "ArenaSpec", "PagePool", "PoolArena", "make_flat_arena",
    "FenceParams", "FencePolicy", "FenceTable", "apply_fence",
    "apply_fence_mixed", "fence_bitwise", "fence_check", "fence_modulo",
    "fence_modulo_magic", "fence_modulo_magic_dyn", "magic_constants",
    "magic_row", "require_pow2_sizes",
    "DevicePtr", "GuardianClient",
    "GuardianManager", "GuardianViolation", "SharingMode",
    "BuddyAllocator", "OutOfArenaMemory", "Partition",
    "PartitionBoundsTable", "UnknownTenant",
    "BatchedLaunchScheduler", "LaunchRequest", "LRUCache",
    "SchedulerStats", "round_robin_interleave",
    "ViolationLog",
]

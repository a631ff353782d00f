"""Guardian core, ported to PyTorch.

Layering (bottom-up):

    partition   — pow2 buddy arena allocator + partition bounds table
    fence       — the 3 bounds modes (bitwise / modulo / check) in int32 +
                  guarded ops
    arena       — shared device arenas (flat DRAM model, KV page pool)
    violations  — ViolationLog: device-side per-tenant per-kind counters
    verifier    — static bounds verifier (row mode) over aten graphs
    sandbox     — aten-graph kernel instrumentor (the "PTX-patcher")
    interception— GuardianClient ("grdLib"): device-API shadowing + traces
    scheduler   — BatchedLaunchScheduler: coalesces compatible launches
                  across tenants (per-row fence tables; CHECK rows commit
                  selectively) and trusted steps across engines
    quarantine  — tenant lifecycle (ACTIVE→QUARANTINED→EVICTED|READMITTED)
    pressure    — host-side allocation-pressure telemetry
    elastic     — ElasticManager: admission waitlist, live grow/shrink
    telemetry   — flight recorder: metrics registry + event trace + spans
    tenantclass — SLO classes (latency_critical / best_effort)
    manager     — GuardianManager ("grdManager"): sole device owner
    libsim      — simulated closed-source accelerated libraries (Table 6)
"""

from repro_torch.core.arena import Arena, ArenaSpec, PagePool, PoolArena, \
    make_flat_arena, make_kv_page_arena, make_state_arena
from repro_torch.core.elastic import (
    Admission,
    AdmissionStatus,
    ElasticError,
    ElasticManager,
    ElasticPolicy,
    ElasticState,
    ResizeEvent,
)
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
    guarded_add,
    guarded_dynamic_slice,
    guarded_dynamic_update_slice,
    guarded_take,
    guarded_update,
    magic_constants,
    magic_row,
    require_pow2_sizes,
)
from repro_torch.core.interception import CallTrace, DevicePtr, \
    GuardianClient
from repro_torch.core.manager import GuardianManager, GuardianViolation, \
    SharingMode
from repro_torch.core.partition import BuddyAllocator, OutOfArenaMemory, \
    Partition, PartitionBoundsTable, UnknownTenant
from repro_torch.core.pressure import Ewma, PressureTracker, \
    derive_lookahead, total_arrival_rate
from repro_torch.core.quarantine import (
    QuarantineError,
    QuarantineManager,
    QuarantinePolicy,
    QuarantineStateMachine,
    TenantQuarantined,
    TenantState,
    ThresholdPolicy,
    WeightedRatePolicy,
)
from repro_torch.core.sandbox import SandboxError, SandboxReport, UndoLog, \
    dynamic_slice, dynamic_update_slice, sandbox, sandbox_report
from repro_torch.core.scheduler import BatchedLaunchScheduler, \
    LaunchRequest, LRUCache, SchedulerStats, round_robin_interleave
from repro_torch.core.telemetry import EventTrace, Histogram, \
    MetricsRegistry, Telemetry, TraceEvent
from repro_torch.core.tenantclass import TenantClass, TenantClassPolicy, \
    as_class_policy
from repro_torch.core.verifier import (
    FENCED,
    PROVEN,
    REFUTED,
    GuardianStaticViolation,
    GuardianTaintWarning,
    SandboxProof,
    SiteRecord,
    VerifierError,
    verify,
)
from repro_torch.core.violations import KIND_NAMES, NUM_KINDS, \
    ViolationKind, ViolationLog

__all__ = [
    "Arena", "ArenaSpec", "PagePool", "PoolArena", "make_flat_arena",
    "make_kv_page_arena", "make_state_arena",
    "Admission", "AdmissionStatus", "ElasticError", "ElasticManager",
    "ElasticPolicy", "ElasticState", "ResizeEvent",
    "Ewma", "PressureTracker", "derive_lookahead", "total_arrival_rate",
    "FenceParams", "FencePolicy", "FenceTable", "apply_fence",
    "apply_fence_mixed", "fence_bitwise", "fence_check", "fence_modulo",
    "fence_modulo_magic", "fence_modulo_magic_dyn", "guarded_add",
    "guarded_dynamic_slice", "guarded_dynamic_update_slice", "guarded_take",
    "guarded_update", "magic_constants", "magic_row", "require_pow2_sizes",
    "EventTrace", "Histogram", "MetricsRegistry", "Telemetry",
    "TraceEvent",
    "CallTrace", "DevicePtr", "GuardianClient",
    "GuardianManager", "GuardianViolation", "SharingMode",
    "BuddyAllocator", "OutOfArenaMemory", "Partition",
    "PartitionBoundsTable", "UnknownTenant",
    "BatchedLaunchScheduler", "LaunchRequest", "LRUCache",
    "SchedulerStats", "round_robin_interleave",
    "QuarantineError", "QuarantineManager", "QuarantinePolicy",
    "QuarantineStateMachine", "TenantQuarantined", "TenantState",
    "ThresholdPolicy", "WeightedRatePolicy",
    "SandboxError", "SandboxReport", "UndoLog", "dynamic_slice",
    "dynamic_update_slice", "sandbox", "sandbox_report",
    "TenantClass", "TenantClassPolicy", "as_class_policy",
    "FENCED", "PROVEN", "REFUTED", "GuardianStaticViolation",
    "GuardianTaintWarning", "SandboxProof", "SiteRecord", "VerifierError",
    "verify",
    "KIND_NAMES", "NUM_KINDS", "ViolationKind", "ViolationLog",
]

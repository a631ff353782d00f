"""SLO-aware tenant classes — the per-tenant QoS + containment policy
layer (ROADMAP: performance isolation; Tally / ParvaGPU in PAPERS.md).

Guardian's fences give *memory* isolation; this module gives the
scheduler the vocabulary for *performance* isolation.  A tenant is
registered with (or without) a :class:`TenantClassPolicy`:

* ``latency_critical`` — the tenant's ops carry an SLO budget
  (``queue_age_budget``, in drain cycles).  Its cross-cycle lookahead is
  capped at that budget (an LC op is never held for fusion past its
  SLO), and when its observed EWMA queue age breaches the budget the
  scheduler starts **deferring best-effort batches** at drain-cycle
  boundaries until the signal decays (see
  ``BatchedLaunchScheduler.flush``).
* ``best_effort`` — fills residual batch width under the global (or
  per-class) lookahead and is the class that preemption defers.  With
  ``ElasticPolicy.compute_watermark`` set, a best-effort admission also
  waitlists while EWMA arrival-rate pressure would degrade a registered
  latency-critical tenant (compute-aware admission, core/elastic.py).

The same object folds in the per-tenant *containment* knobs
(``quarantine_after`` / ``evict_after`` / rate thresholds /
per-violation-kind weights): QoS and quarantine are configured in one
place and threaded through ``register_tenant`` together.  A tenant
registered without a class policy behaves bit-identically to the
pre-class scheduler (regression-tested).

Everything here is host-side configuration — no device access, no jax.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Union

from repro_torch.core.quarantine import QuarantinePolicy, WeightedRatePolicy


class TenantClass(enum.Enum):
    """The two service classes (Tally's priority split): latency-critical
    tenants hold SLO budgets; best-effort tenants absorb deferral."""

    LATENCY_CRITICAL = "latency_critical"
    BEST_EFFORT = "best_effort"


@dataclasses.dataclass
class TenantClassPolicy:
    """Per-tenant QoS + containment policy, threaded through
    ``register_tenant(..., tenant_class=...)``.

    Scheduling knobs:

    * ``queue_age_budget`` — the SLO budget in drain cycles.  For a
      latency-critical tenant this caps its fusion lookahead (its ops
      are never held past the budget) and arms best-effort preemption:
      when the tenant's EWMA queue age reaches the budget, queued
      best-effort batches defer at drain-cycle boundaries.
    * ``lookahead_cycles`` — per-class override of the scheduler-global
      lookahead (None inherits the global/adaptive budget).  The
      ``latency_critical`` factory defaults it to 0: LC ops dispatch in
      their submission cycle, best-effort traffic fills residual width.
    * ``ewma_alpha`` — smoothing of the queue-age signal preemption
      reads (same :class:`~repro_torch.core.pressure.Ewma` as everywhere).

    Containment knobs (None/empty = inherit the manager's global
    quarantine policy; any set knob builds a per-tenant
    :class:`~repro_torch.core.quarantine.WeightedRatePolicy` that *replaces*
    the global policy for this tenant):

    * ``quarantine_after`` / ``evict_after`` — absolute weighted-count
      thresholds (the classic :class:`ThresholdPolicy` knobs).
    * ``quarantine_rate`` / ``evict_rate`` — weighted violations per
      drain cycle since admission (a slow leak and a burst differ).
    * ``violation_weights`` — per-kind weights (e.g. ``{"scatter": 4}``
      makes corrupting writes count 4x a stray gather).
    """

    tenant_class: TenantClass
    queue_age_budget: int = 0
    lookahead_cycles: Optional[int] = None
    ewma_alpha: float = 0.5
    quarantine_after: Optional[float] = None
    evict_after: Optional[float] = None
    quarantine_rate: Optional[float] = None
    evict_rate: Optional[float] = None
    violation_weights: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    _qpol: Optional[QuarantinePolicy] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if isinstance(self.tenant_class, str):
            self.tenant_class = TenantClass(self.tenant_class)
        if self.queue_age_budget < 0:
            raise ValueError("queue_age_budget must be >= 0")
        if self.lookahead_cycles is not None and self.lookahead_cycles < 0:
            raise ValueError("lookahead_cycles must be >= 0 (or None)")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {self.ewma_alpha}")

    # -- factories ------------------------------------------------------ #
    @classmethod
    def latency_critical(cls, queue_age_budget: int = 2,
                         lookahead_cycles: Optional[int] = 0,
                         **kw) -> "TenantClassPolicy":
        """An SLO-holding tenant.  The default ``lookahead_cycles=0``
        dispatches its ops in their submission cycle (p99 queue age 0);
        pass a nonzero value (capped at the budget) to trade a bounded
        wait for fuller fused batches."""
        return cls(TenantClass.LATENCY_CRITICAL,
                   queue_age_budget=queue_age_budget,
                   lookahead_cycles=lookahead_cycles, **kw)

    @classmethod
    def best_effort(cls, **kw) -> "TenantClassPolicy":
        """A deferrable tenant: inherits the global/adaptive lookahead
        (fills residual batch width) and is the class preemption and
        compute-aware admission act on."""
        return cls(TenantClass.BEST_EFFORT, **kw)

    # -- scheduling ------------------------------------------------------ #
    @property
    def is_latency_critical(self) -> bool:
        return self.tenant_class is TenantClass.LATENCY_CRITICAL

    @property
    def is_best_effort(self) -> bool:
        return self.tenant_class is TenantClass.BEST_EFFORT

    def hold_budget(self, global_lookahead: int) -> int:
        """The class-resolved fusion lookahead: the per-class override
        (or the global/adaptive budget), additionally capped at the SLO
        budget for latency-critical tenants — an LC op is *never* held
        for fusion past its budget, whatever the knobs say."""
        look = self.lookahead_cycles \
            if self.lookahead_cycles is not None else global_lookahead
        if self.is_latency_critical:
            look = min(look, self.queue_age_budget)
        return look

    # -- containment ----------------------------------------------------- #
    def quarantine_policy(self) -> Optional[QuarantinePolicy]:
        """The per-tenant containment policy this class configures, or
        None when every containment knob is unset (inherit the manager's
        global policy).  Built once and cached — the quarantine poll
        resolves it per dirty cycle."""
        if (self.quarantine_after is None and self.evict_after is None
                and self.quarantine_rate is None
                and self.evict_rate is None
                and not self.violation_weights):
            return None
        if self._qpol is None:
            self._qpol = WeightedRatePolicy(
                quarantine_after=self.quarantine_after,
                evict_after=self.evict_after,
                quarantine_rate=self.quarantine_rate,
                evict_rate=self.evict_rate,
                weights=dict(self.violation_weights))
        return self._qpol


#: what ``register_tenant(..., tenant_class=...)`` accepts
ClassSpec = Union[TenantClassPolicy, TenantClass, str]


def as_class_policy(spec: Optional[ClassSpec]
                    ) -> Optional[TenantClassPolicy]:
    """Normalize a class spec: a full policy passes through; a bare
    :class:`TenantClass` (or its string value) gets that class's factory
    defaults; None stays None (the class-less, pre-class behavior)."""
    if spec is None or isinstance(spec, TenantClassPolicy):
        return spec
    if isinstance(spec, str):
        spec = TenantClass(spec)
    if spec is TenantClass.LATENCY_CRITICAL:
        return TenantClassPolicy.latency_critical()
    return TenantClassPolicy.best_effort()

"""Bounds fencing / checking primitives — Guardian §4.4 ("Bounds Checking
Tradeoffs") on PyTorch int32 index tensors.

The paper instruments every PTX load/store with one of three bounds modes.
Here the *dynamically computed address* is a data-dependent integer index
into a shared device arena (KV page ids, embedding rows, slot ids).  The
fence is applied to the index *before* it is used by a gather/scatter; the
hand-written CUDA kernels of :mod:`repro_torch.kernels` apply the same
``(idx & mask) | base`` to the address itself, before the ``ld.global`` /
``st.global``.

Three modes (paper costs in parentheses):

* ``BITWISE``  — ``idx' = (idx & mask) | base``  (2 instrs).  Requires
  pow2-sized, size-aligned partitions (``core.partition`` invariants
  I1/I2); an out-of-partition index wraps into the offender's own
  partition.
* ``MODULO``   — ``idx' = base + ((idx - base) mod size)``, arbitrary
  partition sizes; the reciprocal form (`fence_modulo_magic`) uses a
  precomputed magic multiplier instead of a divide.
* ``CHECK``    — compare + select; the only mode that *detects* OOB and
  returns an ``ok`` predicate beside a safe index (clamped to ``base``).

``NONE`` is the standalone fast path (the index passes through).

Every fence works in **int32**, including the ``idx - base`` wrap and the
``& 0x7FFFFFFF`` step, so results match a 32-bit reference bit for bit
near the int32 limits (torch's int64 default would not).  The magic
multiply-high is the one place that widens: ``off < 2**31`` times
``m < 2**32`` is formed exactly in int64 and shifted back to int32.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.partition import Partition, is_pow2


class FencePolicy(enum.Enum):
    """Which bounds mode the manager applies (§4.4)."""

    NONE = "none"          # native kernel — standalone fast-path
    BITWISE = "bitwise"    # address fencing, bitwise AND/OR (headline mode)
    MODULO = "modulo"      # address fencing, inline modulo
    CHECK = "check"        # address checking (detects OOB; debug / strict)

    @property
    def code(self) -> int:
        """Stable int32 code for per-element policy columns in row-mixed
        batches (see :func:`apply_fence_mixed`)."""
        return _POLICY_CODE[self]


_POLICY_CODE = {
    FencePolicy.NONE: 0,
    FencePolicy.BITWISE: 1,
    FencePolicy.MODULO: 2,
    FencePolicy.CHECK: 3,
}

_MAGIC_DOMAIN_BITS = 31  # indices are masked into [0, 2**31) first


def magic_constants(d: int) -> Tuple[int, int]:
    """Precompute (m, s) with ``n // d == (n * m) >> s`` for n < 2**31
    (round-up method: s = 31 + ceil(log2 d), m = ceil(2^s / d))."""
    if d <= 0:
        raise ValueError(f"divisor must be positive, got {d}")
    if d == 1:
        return 1, 0
    log2d = (d - 1).bit_length()
    s = _MAGIC_DOMAIN_BITS + log2d
    m = ((1 << s) + d - 1) // d
    if m >= (1 << 32):
        raise ValueError(f"magic multiplier overflow for divisor {d}")
    return m, s


def magic_row(d: int) -> Tuple[int, int]:
    """(m, s) for the *dynamic* magic row table: as
    :func:`magic_constants`, except the size-1 divisor stores (0, 32) —
    the dynamic fence masks its remainder to zero."""
    if d == 1:
        return 0, 32
    return magic_constants(d)


def _i32(x, like: Optional[torch.Tensor] = None):
    """int32 view of an index operand: tensors are cast (onto ``like``'s
    device when given), Python ints stay Python ints (torch keeps the
    tensor operand's int32 dtype for them)."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int32)
        if like is not None and x.device != like.device:
            x = x.to(like.device)
        return x
    return int(x)


def _idx(idx) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(torch.int32)
    return torch.as_tensor(np.asarray(idx, np.int32))


def _mulhi_shift(off: torch.Tensor, m, s) -> torch.Tensor:
    """``(off * m) >> s`` for 0 <= off < 2**31, 0 <= m < 2**32: formed
    exactly in int64 (the product is below 2**63) and returned as int32
    (the quotient is below 2**31)."""
    m64 = (m.to(torch.int64) & 0xFFFFFFFF) if isinstance(m, torch.Tensor) \
        else int(m) & 0xFFFFFFFF
    s64 = s.to(torch.int64) if isinstance(s, torch.Tensor) else int(s)
    return ((off.to(torch.int64) * m64) >> s64).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class FenceParams:
    """The per-tenant scalar row passed to kernels (paper: "two extra
    kernel parameters").  ``base``/``size`` are Python ints (static) or
    int32 tensors (dynamic, one value per batch row / element);
    ``magic_m``/``magic_s`` carry a magic row from a :class:`FenceTable`
    so MODULO fences with dynamic constants."""

    base: Any
    size: Any
    magic_m: Any = None
    magic_s: Any = None

    def __post_init__(self):
        if isinstance(self.size, int) and self.size <= 0:
            raise ValueError("partition size must be positive")

    @property
    def is_static(self) -> bool:
        """Base and size are Python ints (one binary per partition): the
        counterpart of the reference's "not traced"."""
        return isinstance(self.base, int) and isinstance(self.size, int)

    @functools.cached_property
    def mask(self):
        """``size - 1``; static sizes are checked for pow2, dynamic ones
        are validated by their builders (:func:`require_pow2_sizes`).
        Computed once per instance: a serve step builds its kv params once
        and every layer's fenced-page kernels reuse the same mask tensor."""
        if isinstance(self.size, int):
            if not is_pow2(self.size):
                raise ValueError("mask only defined for pow2 partitions")
        return self.size - 1

    @property
    def magic(self) -> Tuple[int, int]:
        if not isinstance(self.size, int):
            raise ValueError(
                "MODULO fencing needs a concrete partition size or a magic "
                "row; use static FenceParams or FenceTable(with_magic)")
        return magic_constants(self.size)

    @classmethod
    def from_partition(cls, part: Partition) -> "FenceParams":
        return cls(base=part.base, size=part.size)

    def contains(self, lo: int, hi: Optional[int] = None) -> bool:
        """Whether ``[lo, hi)`` (default ``[lo, lo + 1)``) lies inside the
        partition."""
        hi = lo + 1 if hi is None else hi
        return self.base <= lo and hi <= self.base + self.size


def require_pow2_sizes(sizes) -> None:
    """Host-side guard for building dynamic fence params: every size must
    be a positive power of two (invariant I1)."""
    arr = np.asarray(sizes)
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"require_pow2_sizes needs host-known integer sizes, got "
            f"dtype {arr.dtype}: validate before staging to device")
    flat = arr.reshape(-1).astype(np.int64)
    bad = flat[(flat <= 0) | ((flat & (flat - 1)) != 0)]
    if bad.size:
        raise ValueError(
            f"partition sizes must be positive powers of two for bitwise "
            f"fencing (invariant I1); offenders: {sorted(set(bad.tolist()))}")


@dataclasses.dataclass(frozen=True)
class FenceTable:
    """Stacked per-tenant fence rows: ``rows`` (T, 2) int32 ``(base,
    mask)`` and/or ``magic`` (T, 4) int32 ``(base, size, m, s)``, living on
    the manager's device.  A magic-only table (:meth:`modulo_from_bounds`,
    ``rows`` None) fences arbitrary (non-pow2) sizes through MODULO and
    CHECK.  A tenant-id column gathers per-element params
    (:meth:`gather`) for row-mixed batches."""

    rows: Optional[torch.Tensor] = None
    magic: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.rows is None and self.magic is None:
            raise ValueError("FenceTable needs bitwise rows, a magic "
                             "table, or both")

    @staticmethod
    def _magic_arr(bounds, device) -> torch.Tensor:
        arr = np.zeros((len(bounds), 4), np.uint32)
        for r, (base, size) in enumerate(bounds):
            arr[r] = (base, size, *magic_row(size))
        return torch.as_tensor(arr.view(np.int32)).to(device)

    @classmethod
    def from_partitions(cls, parts: Sequence[Partition],
                        with_magic: bool = False,
                        device="cuda") -> "FenceTable":
        if not parts:
            raise ValueError("FenceTable needs at least one partition")
        require_pow2_sizes([p.size for p in parts])
        rows = np.array([[p.base, p.mask] for p in parts], dtype=np.int32)
        magic = cls._magic_arr([(p.base, p.size) for p in parts], device) \
            if with_magic else None
        return cls(rows=torch.as_tensor(rows).to(device), magic=magic)

    @classmethod
    def from_bounds(cls, base, size, device="cuda") -> "FenceTable":
        """Build from host (base, size) arrays, validating pow2 sizes."""
        base = np.asarray(base, np.int32).reshape(-1)
        size = np.asarray(size, np.int64).reshape(-1)
        require_pow2_sizes(size)
        arr = np.stack([base, (size - 1).astype(np.int32)], axis=1)
        return cls(rows=torch.as_tensor(arr.astype(np.int32)).to(device))

    @classmethod
    def modulo_from_bounds(cls, base, size, device="cuda") -> "FenceTable":
        """Magic-only table for arbitrary (non-pow2 included) partition
        sizes: no bitwise rows (a non-pow2 ``size - 1`` is no wrap mask),
        so the table fences through MODULO / CHECK only."""
        base = np.asarray(base, np.int64).reshape(-1)
        size = np.asarray(size, np.int64).reshape(-1)
        if (size <= 0).any():
            raise ValueError("partition sizes must be positive")
        return cls(magic=cls._magic_arr(
            list(zip(base.tolist(), size.tolist())), device))

    def __len__(self) -> int:
        arr = self.rows if self.rows is not None else self.magic
        return int(arr.shape[0])

    def row_params(self, row) -> FenceParams:
        """Dynamic FenceParams (0-d int32 tensors) for one table row."""
        if self.rows is None:
            return self.magic_row_params(row)
        return FenceParams(base=self.rows[row, 0],
                           size=self.rows[row, 1] + 1)

    def magic_row_params(self, row) -> FenceParams:
        """Dynamic magic-carrying FenceParams for one magic-table row."""
        if self.magic is None:
            raise ValueError("table was built without a magic row table")
        return FenceParams(base=self.magic[row, 0], size=self.magic[row, 1],
                           magic_m=self.magic[row, 2],
                           magic_s=self.magic[row, 3])

    def gather(self, tenant_col) -> FenceParams:
        """Per-element FenceParams for a tenant-id column: ``(N,)``
        base/size (and magic) tensors that broadcast through the fences."""
        table = self.rows if self.rows is not None else self.magic
        col = _idx(tenant_col).to(table.device).long()
        if self.rows is not None:
            base, size = self.rows[:, 0][col], self.rows[:, 1][col] + 1
        else:
            base, size = self.magic[:, 0][col], self.magic[:, 1][col]
        if self.magic is None:
            return FenceParams(base=base, size=size)
        return FenceParams(base=base, size=size,
                           magic_m=self.magic[:, 2][col],
                           magic_s=self.magic[:, 3][col])


# ---------------------------------------------------------------------------
# The three fences.  All take/return int32 index tensors of any shape.
# ---------------------------------------------------------------------------


def fence_bitwise(idx, base, mask) -> torch.Tensor:
    """``(idx & mask) | base`` — Guardian's headline mode (Listing 1)."""
    idx = _idx(idx)
    return torch.bitwise_or(torch.bitwise_and(idx, _i32(mask, idx)),
                            _i32(base, idx))


def fence_modulo(idx, base, size) -> torch.Tensor:
    """``base + (((idx - base) & 0x7FFFFFFF) mod size)``: the plain form,
    bit-identical to the magic form."""
    idx = _idx(idx)
    base = _i32(base, idx)
    off = torch.bitwise_and(idx - base, 0x7FFFFFFF)
    return base + torch.remainder(off, _i32(size, idx))


def fence_modulo_magic(idx, base: int, size: int, m: int,
                       s: int) -> torch.Tensor:
    """Reciprocal-multiply modulo with static constants."""
    idx = _idx(idx)
    if size == 1:
        return torch.full(idx.shape, int(base), dtype=torch.int32,
                          device=idx.device)
    off = torch.bitwise_and(idx - int(base), 0x7FFFFFFF)
    q = _mulhi_shift(off, m, s)
    return int(base) + (off - q * int(size))


def fence_modulo_magic_dyn(idx, base, size, m, s) -> torch.Tensor:
    """Reciprocal modulo with dynamic (per-element) magic constants; size-1
    rows mask the remainder to zero (see :func:`magic_row`)."""
    idx = _idx(idx)
    base = _i32(base, idx)
    size = _i32(size, idx)
    off = torch.bitwise_and(idx - base, 0x7FFFFFFF)
    q = _mulhi_shift(off, _i32(m, idx), _i32(s, idx))
    rem = off - q * size
    rem = torch.where(torch.as_tensor(size == 1, device=idx.device),
                      torch.zeros((), dtype=torch.int32, device=idx.device),
                      rem)
    return base + rem


def fence_check(idx, base, size) -> Tuple[torch.Tensor, torch.Tensor]:
    """Address checking: ``(safe_idx, ok)``; out-of-partition ids clamp to
    ``base`` and report ``ok = False``."""
    idx = _idx(idx)
    lo = _i32(base, idx)
    hi = lo + _i32(size, idx)
    ok = (idx >= lo) & (idx < hi)
    lo_t = lo if isinstance(lo, torch.Tensor) else torch.full(
        (), lo, dtype=torch.int32, device=idx.device)
    return torch.where(ok, idx, lo_t), ok


def apply_fence_mixed(codes, idx, params: FenceParams
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element policy dispatch for row-mixed batches; needs
    magic-carrying params.  Returns ``(fenced, ok)``."""
    if params.magic_m is None:
        raise ValueError(
            "apply_fence_mixed needs magic-carrying FenceParams (build the "
            "FenceTable with with_magic=True)")
    idx = _idx(idx)
    codes = _idx(codes).to(idx.device)
    bitwise = fence_bitwise(idx, params.base, params.size - 1)
    modulo = fence_modulo_magic_dyn(idx, params.base, params.size,
                                    params.magic_m, params.magic_s)
    checked, ok_chk = fence_check(idx, params.base, params.size)
    fenced = torch.where(
        codes == FencePolicy.BITWISE.code, bitwise,
        torch.where(codes == FencePolicy.MODULO.code, modulo,
                    torch.where(codes == FencePolicy.CHECK.code, checked,
                                idx)))
    ok = torch.where(codes == FencePolicy.CHECK.code, ok_chk,
                     torch.ones_like(ok_chk))
    return fenced, ok


def apply_fence(policy: FencePolicy, idx, params: FenceParams
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatch on policy.  Returns ``(fenced_idx, ok_or_None)``; only
    CHECK produces ``ok``."""
    if policy is FencePolicy.NONE:
        return _idx(idx), None
    if policy is FencePolicy.BITWISE:
        return fence_bitwise(idx, params.base, params.mask), None
    if policy is FencePolicy.MODULO:
        if params.magic_m is not None:
            return fence_modulo_magic_dyn(
                idx, params.base, params.size,
                params.magic_m, params.magic_s), None
        m, s = params.magic
        return fence_modulo_magic(idx, params.base, params.size, m, s), None
    if policy is FencePolicy.CHECK:
        return fence_check(idx, params.base, params.size)
    raise ValueError(f"unknown policy {policy}")


# ---------------------------------------------------------------------------
# Guarded arena ops — the "sandboxed load/store".  Axis 0 of ``arena`` is
# the shared slot space; writes update the arena in place.  Indices are
# fenced in int32 and widened to int64 only at the access.
# ---------------------------------------------------------------------------


def guarded_take(arena: torch.Tensor, idx, params: FenceParams,
                 policy: FencePolicy = FencePolicy.BITWISE) -> torch.Tensor:
    """Fenced gather of arena rows: ``arena[fence(idx)]``."""
    fenced, _ = apply_fence(policy, idx, params)
    return arena[fenced.to(arena.device).long()]


def guarded_update(arena: torch.Tensor, idx, values: torch.Tensor,
                   params: FenceParams,
                   policy: FencePolicy = FencePolicy.BITWISE
                   ) -> torch.Tensor:
    """Fenced scatter of arena rows, in place:
    ``arena[fence(idx)] = values``."""
    fenced, _ = apply_fence(policy, idx, params)
    arena[fenced.to(arena.device).long()] = torch.as_tensor(
        values, dtype=arena.dtype, device=arena.device)
    return arena


def guarded_add(arena: torch.Tensor, idx, values: torch.Tensor,
                params: FenceParams,
                policy: FencePolicy = FencePolicy.BITWISE) -> torch.Tensor:
    """Fenced accumulate of arena rows, in place: ``arena[fence(idx)] +=
    values`` with duplicate ids summing (the reference's ``.at[].add``)."""
    fenced, _ = apply_fence(policy, idx, params)
    fenced = fenced.to(arena.device).long()
    values = torch.as_tensor(values, dtype=arena.dtype, device=arena.device)
    arena.index_put_((fenced,), values.expand(
        *fenced.shape, *arena.shape[1:]), accumulate=True)
    return arena


def _fenced_window(start, length: int, params: FenceParams,
                   policy: FencePolicy, device) -> torch.Tensor:
    """Row ids of a fenced contiguous window: the start is fenced, then
    pinned so the window stays inside the partition."""
    fenced, _ = apply_fence(policy, start, params)
    hi = max(int(params.base) + int(params.size) - length, int(params.base))
    fenced = torch.clamp(fenced.to(device), max=hi)
    return fenced.reshape(()).long() + torch.arange(length, device=device)


def guarded_dynamic_slice(arena: torch.Tensor, start, length: int,
                          params: FenceParams,
                          policy: FencePolicy = FencePolicy.BITWISE
                          ) -> torch.Tensor:
    """Fenced contiguous read of ``length`` rows starting at ``start``."""
    return arena[_fenced_window(start, length, params, policy,
                                arena.device)]


def guarded_dynamic_update_slice(arena: torch.Tensor, start,
                                 values: torch.Tensor, params: FenceParams,
                                 policy: FencePolicy = FencePolicy.BITWISE
                                 ) -> torch.Tensor:
    """Fenced contiguous write (in place), pinned inside the partition."""
    rows = _fenced_window(start, values.shape[0], params, policy,
                          arena.device)
    arena[rows] = values.to(arena.dtype)
    return arena

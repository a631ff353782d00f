"""Static bounds verifier — trace-time proof of arena-access safety over
the aten graph of a tenant kernel (row mode) or of a trusted step (extent
mode).

Guardian (§4.3) fences only *register-addressed* loads because direct
accesses are provably safe at compile time.  The sandbox
(:mod:`repro_torch.core.sandbox`) fences every tainted access; this module
is the compiler pass that proves some of them safe: an **interval abstract
interpretation** over the ``make_fx`` graph of the kernel that classifies
each tainted access site as

    PROVEN   statically inside the fence row ``[base, base + size)`` — the
             runtime fence is redundant and the sandbox elides it;
    FENCED   unprovable either way — keep the runtime fence;
    REFUTED  outside the row on *every* launch — surfaced at trace time as
             :class:`GuardianStaticViolation`.

The abstract domain — affine bounds over the row's symbols ``B`` (base)
and ``S`` (size), decided over the polytope ``{B >= 0, S >= 1, B + S <=
N}`` — is the reference's, line for line.  The transfer functions follow
the aten ops ``make_fx`` emits (``add``, ``bitwise_and``, ``remainder``,
``clamp``, ``arange``, views, ``_to_copy``, the index ops, ...); an op
without one gives ⊤, so its sites are FENCED, never PROVEN: partial
coverage is safe.  Python loops with a fixed count are unrolled by the
trace and verify as straight-line code.  The higher-order ``torch.cond``,
``while_loop`` and ``scan`` stay in the graph with their bodies as
subgraphs, interpreted structurally as the reference interprets
``lax.cond`` / ``lax.while_loop`` / ``lax.scan``: the carries' taints come
from a monotone fixpoint, their intervals from a fixpoint widened with
:func:`iwiden`, a ``cond``'s branches are joined, and one recording pass
at the fixpoint classifies each body's sites, whose paths carry the
higher-order node and the body's index (a ``cond``'s false branch 0 and
true branch 1, a ``while``'s condition 0 and body 1, a ``scan``'s body 0).
A ``while`` carry is not refined by its condition, as in the reference:
``i < ptr + 4`` leaves ``i`` unbounded above, so the body's access is
FENCED, never PROVEN.

**Extent mode** proves a trusted step (the serve steps a manager
registers with ``verify=True``): every access into the arena or the pool
is PROVEN inside the accessed operand's own extent along the addressed
dim, or inside an *admissible* range — a guard partition found among the
operands (a static :class:`FenceParams` declares ``[base, base + size)``;
one whose base or size is a tensor gets a symbol pair of its own).  Extent
mode never refutes.  The step's operands are nested (the pool dict, the
weights, the cache meta, the :class:`GuardSpec`): every tensor leaf
becomes a fake graph input, and the leaves of the arena and pool
arguments are tainted.  The hand-written kernels are custom ops
(``repro_torch::<kernel>``) whose CUDA code the trace cannot enter: each
op node becomes one site per access the kernel declares
(:mod:`repro_torch.kernels.access`), its index interval computed by this
module's transfer functions over the kernel's own fence, page map and
out-of-range rule.  An op with no transfer function that takes the arena
or pool — an unknown operator, an indexing op the table lacks — is a
FENCED site, so such a step is never fully proven.

The graph analysis shared with the sandbox — tracing on fake tensors, the
taint rule, and the table of access ops — lives here too, so the two
walkers classify every node identically.
"""

from __future__ import annotations

import contextlib
import dataclasses
import operator
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

import torch._higher_order_ops.scan  # noqa: F401  (registers the op)
import torch._higher_order_ops.while_loop  # noqa: F401
from repro_torch.core.fence import FenceParams
from repro_torch.core.stepgraph import tree_flatten, tree_unflatten
from repro_torch.core.violations import ViolationKind
from repro_torch.kernels.access import ACCESSES, Access

aten = torch.ops.aten

__all__ = [
    "FENCED", "PROVEN", "REFUTED", "GuardianStaticViolation",
    "GuardianTaintWarning", "SandboxProof", "SiteRecord", "VerifierError",
    "trace_kernel", "verify", "verify_graph",
]


class GuardianStaticViolation(Exception):
    """A tenant kernel contains an access the verifier *refuted*: provably
    out-of-bounds on every launch.  Raised at trace time with the per-site
    diagnostic — the static analogue of a CHECK-mode detection."""


class VerifierError(Exception):
    """The abstract interpretation could not complete; the sandbox turns
    this into a refusal of the kernel (fail closed)."""


class GuardianTaintWarning(UserWarning):
    """A view or copy reshaped away the arena's slot dimension (a reshape
    splitting dim 0, a permute demoting it).  Taint is *kept* — downstream
    accesses stay fenced — instead of silently dropping the arena
    lineage."""


class SandboxError(Exception):
    """Raised when a tenant kernel uses a construct the sandboxer cannot
    prove safe — the manager refuses the kernel (fail closed, like
    grdManager refusing an unknown CUDA symbol)."""


# --------------------------------------------------------------------------
# Linear expressions over bound symbols (the reference's domain)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Lin:
    """``const + Σ coef_i · sym_i`` with integer coefficients; a concrete
    bound is a ``Lin`` with no terms.  Python-int arithmetic."""

    const: int
    terms: Tuple[Tuple[int, int], ...] = ()

    def __add__(self, other: "Lin") -> "Lin":
        acc = dict(self.terms)
        for s, c in other.terms:
            acc[s] = acc.get(s, 0) + c
        return Lin(self.const + other.const,
                   tuple(sorted((s, c) for s, c in acc.items() if c)))

    def __sub__(self, other: "Lin") -> "Lin":
        return self + other.scale(-1)

    def scale(self, k: int) -> "Lin":
        if k == 0:
            return Lin(0)
        return Lin(self.const * k, tuple((s, c * k) for s, c in self.terms))

    def shift(self, k: int) -> "Lin":
        return Lin(self.const + k, self.terms)

    @property
    def is_const(self) -> bool:
        return not self.terms

    def __str__(self) -> str:
        parts = [str(self.const)] if (self.const or not self.terms) else []
        for s, c in self.terms:
            name = _SYM_NAMES.get(s, f"x{s}")
            mag = abs(c) if abs(c) != 1 else ""
            parts.append(f"{'+' if c > 0 else '-'}{mag}{name}")
        return "".join(parts).lstrip("+") or "0"


_SYM_NAMES: Dict[int, str] = {}


def lc(c: int) -> Lin:
    return Lin(int(c))


class SymCtx:
    """Allocates ``(B, S)`` symbol pairs and decides linear inequalities
    by minimizing over each pair's polytope (three vertices)."""

    def __init__(self):
        self._next = 0
        self._pair_of: Dict[int, Tuple[int, int, Optional[int]]] = {}

    def new_pair(self, extent: Optional[int] = None,
                 tag: str = "") -> Tuple[int, int]:
        b, s = self._next, self._next + 1
        self._next += 2
        self._pair_of[b] = (b, s, extent)
        self._pair_of[s] = (b, s, extent)
        _SYM_NAMES[b] = f"B{tag}"
        _SYM_NAMES[s] = f"S{tag}"
        return b, s

    def prove_nonneg(self, e: Lin) -> bool:
        by_pair: Dict[int, Tuple[int, int, Optional[int]]] = {}
        coefs: Dict[int, Dict[int, int]] = {}
        for sym, coef in e.terms:
            pair = self._pair_of.get(sym)
            if pair is None:
                return False
            by_pair[pair[0]] = pair
            coefs.setdefault(pair[0], {})[sym] = coef
        total = e.const
        for b, (pb, ps, extent) in by_pair.items():
            db = coefs[b].get(pb, 0)
            ds = coefs[b].get(ps, 0)
            if extent is None:
                if db < 0 or ds < 0:
                    return False
                total += ds
            else:
                n = int(extent)
                total += min(ds, ds * n, db * max(n - 1, 0) + ds)
        return total >= 0

    def le(self, a: Lin, b: Lin) -> bool:
        return self.prove_nonneg(b - a)

    def lt(self, a: Lin, b: Lin) -> bool:
        return self.prove_nonneg((b - a).shift(-1))


# --------------------------------------------------------------------------
# Intervals
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ival:
    """Tensor-wide interval; ``None`` bound = unbounded in that direction."""

    lo: Optional[Lin] = None
    hi: Optional[Lin] = None

    @property
    def is_top(self) -> bool:
        return self.lo is None and self.hi is None

    def __str__(self) -> str:
        lo = "-inf" if self.lo is None else str(self.lo)
        hi = "+inf" if self.hi is None else str(self.hi)
        return f"[{lo}, {hi}]"


TOP = Ival()


def iconst(lo: int, hi: Optional[int] = None) -> Ival:
    return Ival(lc(lo), lc(lo if hi is None else hi))


def _opt_add(a: Optional[Lin], b: Optional[Lin]) -> Optional[Lin]:
    return None if (a is None or b is None) else a + b


def iadd(a: Ival, b: Ival) -> Ival:
    return Ival(_opt_add(a.lo, b.lo), _opt_add(a.hi, b.hi))


def ineg(a: Ival) -> Ival:
    return Ival(None if a.hi is None else a.hi.scale(-1),
                None if a.lo is None else a.lo.scale(-1))


def isub(a: Ival, b: Ival) -> Ival:
    return iadd(a, ineg(b))


def _as_const(a: Ival) -> Optional[int]:
    if (a.lo is not None and a.hi is not None and a.lo.is_const
            and a.hi.is_const and a.lo.const == a.hi.const):
        return a.lo.const
    return None


def imul(a: Ival, b: Ival) -> Ival:
    for x, y in ((a, b), (b, a)):
        k = _as_const(x)
        if k is not None:
            if k >= 0:
                return Ival(None if y.lo is None else y.lo.scale(k),
                            None if y.hi is None else y.hi.scale(k))
            return Ival(None if y.hi is None else y.hi.scale(k),
                        None if y.lo is None else y.lo.scale(k))
    bounds = (a.lo, a.hi, b.lo, b.hi)
    if all(x is not None and x.is_const for x in bounds):
        prods = [a.lo.const * b.lo.const, a.lo.const * b.hi.const,
                 a.hi.const * b.lo.const, a.hi.const * b.hi.const]
        return iconst(min(prods), max(prods))
    return TOP


def _pick_le(ctx: SymCtx, a: Optional[Lin], b: Optional[Lin],
             prefer_first: bool = True) -> Optional[Lin]:
    if a is None or b is None:
        return None
    if ctx.le(a, b):
        return a
    if ctx.le(b, a):
        return b
    return a if prefer_first else None


def imin(ctx: SymCtx, a: Ival, b: Ival) -> Ival:
    if a.hi is None:
        hi = b.hi
    elif b.hi is None:
        hi = a.hi
    else:
        hi = a.hi if ctx.le(a.hi, b.hi) else \
            (b.hi if ctx.le(b.hi, a.hi) else a.hi)
    return Ival(_pick_le(ctx, a.lo, b.lo, prefer_first=False), hi)


def imax(ctx: SymCtx, a: Ival, b: Ival) -> Ival:
    return ineg(imin(ctx, ineg(a), ineg(b)))


def ijoin(ctx: SymCtx, a: Ival, b: Ival) -> Ival:
    lo = _pick_le(ctx, a.lo, b.lo, prefer_first=False)
    hi = None
    if a.hi is not None and b.hi is not None:
        if ctx.le(a.hi, b.hi):
            hi = b.hi
        elif ctx.le(b.hi, a.hi):
            hi = a.hi
    return Ival(lo, hi)


def iwiden(ctx: SymCtx, old: Ival, new: Ival) -> Ival:
    """Classic widening: a bound that moved outward goes to ±∞ (the
    reference's loop fixpoint, :func:`_fixpoint`)."""
    lo = old.lo if (old.lo is not None and new.lo is not None
                    and ctx.le(old.lo, new.lo)) else None
    hi = old.hi if (old.hi is not None and new.hi is not None
                    and ctx.le(new.hi, old.hi)) else None
    return Ival(lo, hi)


def ieq(a: Ival, b: Ival) -> bool:
    return a.lo == b.lo and a.hi == b.hi


def _nonneg(ctx: SymCtx, v: Ival) -> bool:
    return v.lo is not None and ctx.prove_nonneg(v.lo)


def iand(ctx: SymCtx, x: Ival, y: Ival) -> Ival:
    """``x & y``: ``x`` itself when ``y`` is a constant ``2**n - 1`` and
    ``0 <= x <= y`` (the pool clamp of an id already inside it), else
    ``[0, min hi]`` of the operands known nonnegative."""
    for v, m in ((x, y), (y, x)):
        k = _as_const(m)
        if k is not None and k >= 0 and not k & (k + 1) and \
                _nonneg(ctx, v) and v.hi is not None and ctx.le(v.hi, lc(k)):
            return v
    cands = [v.hi for v in (x, y) if _nonneg(ctx, v)]
    if not cands:
        return TOP
    hi = cands[0]
    for c in cands[1:]:
        hi = _pick_le(ctx, hi, c) if hi is not None else c
    return Ival(lc(0), hi)


def ior(ctx: SymCtx, x: Ival, y: Ival, xor: bool = False) -> Ival:
    """``x | y`` (``x ^ y``) of nonnegative operands: at most their sum,
    and an or is at least the larger operand."""
    if not (_nonneg(ctx, x) and _nonneg(ctx, y)):
        return TOP
    lo = lc(0) if xor else (x.lo if ctx.le(y.lo, x.lo) else y.lo)
    return Ival(lo, _opt_add(x.hi, y.hi))


def icompare(ctx: SymCtx, x: Ival, y: Ival, strict: bool) -> Ival:
    """``x < y`` (``x <= y`` unless ``strict``): 1 or 0 when decided."""
    if x.hi is not None and y.lo is not None and (
            ctx.lt(x.hi, y.lo) if strict else ctx.le(x.hi, y.lo)):
        return iconst(1)
    if x.lo is not None and y.hi is not None and (
            ctx.le(y.hi, x.lo) if strict else ctx.lt(y.hi, x.lo)):
        return iconst(0)
    return iconst(0, 1)


def iwhere(ctx: SymCtx, c: Ival, x: Ival, y: Ival) -> Ival:
    k = _as_const(c)
    if k == 1:
        return x
    if k == 0:
        return y
    return ijoin(ctx, x, y)


def ifit(ctx: SymCtx, iv: Ival, dtype: torch.dtype) -> Ival:
    """``iv`` when the integer ``dtype`` provably holds it, else ⊤ (the
    value wrapped)."""
    info = torch.iinfo(dtype)
    if iv.lo is not None and iv.hi is not None and not (
            ctx.le(lc(int(info.min)), iv.lo)
            and ctx.le(iv.hi, lc(int(info.max)))):
        return TOP
    return iv


# --------------------------------------------------------------------------
# Proof artifacts
# --------------------------------------------------------------------------

PROVEN = "proven"
FENCED = "fenced"
REFUTED = "refuted"


@dataclasses.dataclass(frozen=True)
class SiteRecord:
    """One tainted access site: where it is, what it does, what we know."""

    path: Tuple                      # (graph node name,)
    kind: ViolationKind              # GATHER / SCATTER / SLICE / UPDATE
    prim: str                        # aten op at the site
    verdict: str                     # PROVEN | FENCED | REFUTED
    interval: str                    # index interval at the site (display)
    target: str                      # the bound it was classified against
    why: str                         # one-line reason

    def row(self) -> str:
        return (f"{self.verdict.upper():8s} {self.kind.name.lower():8s} "
                f"{self.prim:22s} idx∈{self.interval:24s} "
                f"target {self.target:18s} {self.why}")


@dataclasses.dataclass(frozen=True)
class SandboxProof:
    """The verifier's per-site provenance for one traced kernel.
    ``symbolic=True``: computed against the symbolic row ``(B, S)`` — it
    holds for every partition of the arena."""

    sites: Tuple[SiteRecord, ...]
    mode: str
    symbolic: bool
    arg_sig: Tuple
    n_eqns: int = 0

    @property
    def n_proven(self) -> int:
        return sum(1 for s in self.sites if s.verdict == PROVEN)

    @property
    def n_fenced(self) -> int:
        return sum(1 for s in self.sites if s.verdict == FENCED)

    @property
    def n_refuted(self) -> int:
        return sum(1 for s in self.sites if s.verdict == REFUTED)

    @property
    def fully_proven(self) -> bool:
        return self.n_fenced == 0 and self.n_refuted == 0

    @property
    def proven_fraction(self) -> float:
        return self.n_proven / len(self.sites) if self.sites else 1.0

    def verdict_of(self, path: Tuple) -> Optional[str]:
        for s in self.sites:
            if s.path == path:
                return s.verdict
        return None

    def refuted_sites(self) -> Tuple[SiteRecord, ...]:
        return tuple(s for s in self.sites if s.verdict == REFUTED)

    def summary(self) -> Dict[str, Any]:
        return {
            "sites": len(self.sites),
            "proven": self.n_proven,
            "fenced": self.n_fenced,
            "refuted": self.n_refuted,
            "fully_proven": self.fully_proven,
            "proven_fraction": round(self.proven_fraction, 4),
            "symbolic": self.symbolic,
            "mode": self.mode,
        }

    def format_table(self, indent: str = "  ") -> str:
        if not self.sites:
            return indent + "(no dynamic arena access sites)"
        return "\n".join(indent + s.row() for s in self.sites)


# --------------------------------------------------------------------------
# Tracing and the shared graph analysis
# --------------------------------------------------------------------------

def _dynamic_slice_fake(x, start, length):
    return x.new_empty((length, *x.shape[1:]))


@torch.library.custom_op("repro_torch::dynamic_slice", mutates_args=())
def _dynamic_slice_op(x: torch.Tensor, start: torch.Tensor,
                      length: int) -> torch.Tensor:
    return x[_window(start, length, x.shape[0], x.device)]


_dynamic_slice_op.register_fake(_dynamic_slice_fake)


@torch.library.custom_op("repro_torch::dynamic_update_slice_",
                         mutates_args=("x",))
def _dynamic_update_slice_op(x: torch.Tensor, start: torch.Tensor,
                             values: torch.Tensor) -> None:
    x[_window(start, values.shape[0], x.shape[0], x.device)] = \
        values.to(x.dtype)


@_dynamic_update_slice_op.register_fake
def _(x, start, values):
    return None


def _window(start, length: int, extent: int, device) -> torch.Tensor:
    """Row ids of a contiguous window of ``length`` rows whose start is
    clamped into ``[0, extent - length]`` — XLA's dynamic-slice
    semantics, so an out-of-range start never faults."""
    s = torch.as_tensor(start).to(device=device, dtype=torch.int32)
    s = torch.clamp(s.reshape(()), 0, max(extent - length, 0))
    return s.long() + torch.arange(length, device=device)


def dynamic_slice(x: torch.Tensor, start, length: int) -> torch.Tensor:
    """``length`` rows of ``x`` from a tensor-valued ``start`` — the
    counterpart of ``jax.lax.dynamic_slice_in_dim(x, start, length)``
    (start clamped so the window fits).  Inside a sandboxed kernel the
    start of an arena slice is fenced (a SLICE site)."""
    return _dynamic_slice_op(x, torch.as_tensor(start), int(length))


def dynamic_update_slice(x: torch.Tensor, start,
                         values: torch.Tensor) -> torch.Tensor:
    """Write ``values`` over rows of ``x`` from a tensor-valued ``start``,
    in place — ``jax.lax.dynamic_update_slice_in_dim``'s counterpart.
    Inside a sandboxed kernel an arena update is fenced (an UPDATE
    site).  Returns ``x``."""
    _dynamic_update_slice_op(x, torch.as_tensor(start), values)
    return x


DYNAMIC_SLICE = torch.ops.repro_torch.dynamic_slice.default
DYNAMIC_UPDATE = torch.ops.repro_torch.dynamic_update_slice_.default

#: the hand-written kernels' custom ops -> the accesses each declares
KERNEL_OPS: Dict[Any, Tuple[Access, ...]] = {
    getattr(torch.ops.repro_torch, name).default: accesses
    for name, accesses in ACCESSES.items()}


@dataclasses.dataclass(frozen=True)
class AccessOp:
    """How one aten op addresses its operand (arg 0).

    ``index``: position of the index argument (``list`` ops keep it in a
    list of optional tensors).  ``dim``: position of the dim argument, or
    None (dim 0; ``take`` addresses the flattened operand).  ``native``:
    the out-of-range semantics of the reference's jnp counterpart —
    ``clamp`` (``x[i]``), ``fill`` (``jnp.take``), ``set``/``add``/
    ``mul``/``min``/``max`` (``.at[i]`` scatters, which drop), ``window``
    (``lax.dynamic_slice``).  ``rows``: the index picks whole rows (the
    ``index_*`` family) rather than elements (``gather``/``scatter``)."""

    kind: ViolationKind
    index: int
    dim: Optional[int] = None
    native: str = "clamp"
    inplace: bool = False
    listed: bool = False
    rows: bool = True
    values: Optional[int] = None


_G, _S = ViolationKind.GATHER, ViolationKind.SCATTER

ACCESS_OPS: Dict[Any, AccessOp] = {
    aten.index.Tensor: AccessOp(_G, 1, listed=True),
    aten.take.default: AccessOp(_G, 1, native="fill"),
    aten.index_select.default: AccessOp(_G, 2, dim=1, native="fill"),
    aten.gather.default: AccessOp(_G, 2, dim=1, native="fill", rows=False),
    aten.index_put_.default: AccessOp(_S, 1, native="put", inplace=True,
                                      listed=True, values=2),
    aten.index_put.default: AccessOp(_S, 1, native="put", listed=True,
                                     values=2),
    aten.index_copy_.default: AccessOp(_S, 2, dim=1, native="set",
                                       inplace=True, values=3),
    aten.index_copy.default: AccessOp(_S, 2, dim=1, native="set",
                                      values=3),
    aten.index_add_.default: AccessOp(_S, 2, dim=1, native="add",
                                      inplace=True, values=3),
    aten.index_add.default: AccessOp(_S, 2, dim=1, native="add", values=3),
    aten.scatter_.src: AccessOp(_S, 2, dim=1, native="set", inplace=True,
                                rows=False, values=3),
    aten.scatter.src: AccessOp(_S, 2, dim=1, native="set", rows=False,
                               values=3),
    aten.scatter_.value: AccessOp(_S, 2, dim=1, native="set", inplace=True,
                                  rows=False, values=3),
    aten.scatter.value: AccessOp(_S, 2, dim=1, native="set", rows=False,
                                 values=3),
    aten.scatter_add_.default: AccessOp(_S, 2, dim=1, native="add",
                                        inplace=True, rows=False, values=3),
    aten.scatter_add.default: AccessOp(_S, 2, dim=1, native="add",
                                       rows=False, values=3),
    aten.scatter_reduce_.two: AccessOp(_S, 2, dim=1, native="reduce",
                                       inplace=True, rows=False, values=3),
    aten.scatter_reduce.two: AccessOp(_S, 2, dim=1, native="reduce",
                                      rows=False, values=3),
    DYNAMIC_SLICE: AccessOp(ViolationKind.SLICE, 1, native="window"),
    DYNAMIC_UPDATE: AccessOp(ViolationKind.UPDATE, 1, native="window",
                             inplace=True, values=2),
}

#: Views and copies through which "this value IS the arena slot space"
#: propagates (the reference's convert_element_type / copy / reshape /
#: transpose family).
_VIEWS = {
    "view", "_unsafe_view", "reshape", "expand", "unsqueeze", "squeeze",
    "flatten", "view_as",
}
_PERMUTES = {"permute", "transpose", "t"}
_COPIES = {"_to_copy", "clone", "alias", "detach", "contiguous",
           "lift_fresh_copy", "_conj", "resolve_conj", "resolve_neg"}
#: ops that address a tensor through an index tensor the sandbox has no
#: rewrite for: an out-of-range index there would be a device-side
#: assert, so a kernel using one is refused whatever it indexes
_UNSUPPORTED_INDEXED = {
    "embedding", "embedding_bag", "_embedding_bag", "index_fill",
    "index_fill_", "index_reduce", "index_reduce_", "put", "put_",
    "scatter", "scatter_", "nll_loss", "nll_loss_forward",
    "nll_loss2d_forward", "multi_margin_loss",
    "multilabel_margin_loss_forward", "_unsafe_index", "_unsafe_index_put",
    "index_put", "index_put_",
}
#: ops that read only the metadata (shape/dtype/device) of their input
_METADATA = {"zeros_like", "ones_like", "empty_like", "full_like",
             "new_zeros", "new_ones", "new_empty", "new_full", "sym_size",
             "sym_numel", "sym_stride", "randn_like", "rand_like"}


def op_name(target) -> str:
    pkt = getattr(target, "_overloadpacket", None)
    return pkt.__name__ if pkt is not None else getattr(
        target, "__name__", str(target))


def _shape(node) -> Tuple[int, ...]:
    val = node.meta.get("val") if hasattr(node, "meta") else None
    return tuple(int(d) for d in val.shape) if isinstance(
        val, torch.Tensor) else ()


@dataclasses.dataclass
class Site:
    """One access node: its op, operand and index nodes, the addressed
    dim, and whether the operand is the arena (``tainted``) and keeps its
    slot axis (``exact``).  ``decl`` is the declared access of a kernel
    op; ``opaque`` marks an access the verifier has no transfer function
    for (always FENCED); ``tag`` tells apart the sites of one node."""

    node: Any
    op: AccessOp
    operand: Any
    index: Any
    dim: int
    extent: int
    length: int
    tainted: bool
    exact: bool
    list_pos: int = 0
    decl: Optional[Access] = None
    opaque: bool = False
    tag: str = ""
    #: the path of the body holding the node: ``()`` at the top, else the
    #: higher-order node's path and the body's index
    prefix: Tuple = ()

    @property
    def path(self) -> Tuple:
        key = (*self.prefix, self.node.name)
        return (*key, self.tag) if self.tag else key


@dataclasses.dataclass
class Traced:
    """A kernel traced into an aten graph: the graph module, the original
    argument positions of its placeholders, their taints, the access
    sites, and the per-node taint / slot-axis facts."""

    gm: Any
    dyn_pos: List[int]
    taints: List[bool]
    sites: Dict[str, Site]
    tainted: Dict[str, bool]
    exact: Dict[str, bool]
    arena_extent: Optional[int]
    #: every site to classify, by node: the access ops' (``sites``) and
    #: the kernel ops' declared accesses
    all_sites: Dict[str, List[Site]] = dataclasses.field(
        default_factory=dict)
    mode: str = "row"
    #: where this graph sits: ``()`` for the kernel, a body's path for a
    #: subgraph of a higher-order node
    prefix: Tuple = ()
    #: the higher-order nodes of this graph, by name
    subs: Dict[str, "Structure"] = dataclasses.field(default_factory=dict)
    #: (tainted, slot-exact) of each of the graph's results
    out_tx: List[Tuple[bool, bool]] = dataclasses.field(
        default_factory=list)

    @property
    def placeholders(self) -> List[Any]:
        return [n for n in self.gm.graph.nodes if n.op == "placeholder"]

    @property
    def arg_sig(self) -> Tuple:
        return tuple((_shape(n), str(n.meta["val"].dtype))
                     for n in self.placeholders)

    def graphs(self):
        """This graph and every body below it, depth first."""
        yield self
        for st in self.subs.values():
            for body in st.bodies:
                yield from body.graphs()


@dataclasses.dataclass
class Structure:
    """One higher-order node, parsed.  ``kind`` is ``"cond"``,
    ``"while"`` or ``"scan"``; the operand groups are graph values (nodes)
    or constants: a ``cond``'s predicate and ``carry`` (its operands), a
    loop's ``carry``, a ``scan``'s ``xs`` and a loop's ``extra`` operands
    (the values its bodies close over).  ``bodies`` are the analysed
    subgraphs in the reference's order (``cond``: false branch, true
    branch; ``while``: condition, body; ``scan``: body); ``out`` the
    (tainted, slot-exact) of each result, ``stores`` whether a body stores
    into the arena."""

    kind: str
    node: Any
    pred: Any
    carry: List[Any]
    xs: List[Any]
    extra: List[Any]
    bodies: List[Traced] = dataclasses.field(default_factory=list)
    out: List[Tuple[bool, bool]] = dataclasses.field(default_factory=list)

    @property
    def stores(self) -> bool:
        return any(site.tainted and site.op.kind in (ViolationKind.SCATTER,
                                                     ViolationKind.UPDATE)
                   for body in self.bodies for g in body.graphs()
                   for sites in g.all_sites.values() for site in sites)



def _unsupported(msg: str) -> SandboxError:
    return SandboxError(f"tenant kernel refused: {msg}")


def _trace_errors() -> Tuple[type, ...]:
    from torch._subclasses import fake_tensor as ft
    return (ft.DataDependentOutputException, ft.DynamicOutputShapeException,
            ft.UnsupportedOperatorException)


def trace_kernel(fn: Callable, example_args: Sequence[Any],
                 arena_argnums: Sequence[int] = (0,), *, mode: str = "row",
                 device: Optional[Any] = None) -> Traced:
    """Trace ``fn(*example_args)`` into an aten graph on *fake* tensors of
    the arguments' shapes, dtypes and devices (the live arena is never
    read or written) and run the taint analysis of ``mode``.  Row mode (a
    tenant kernel): tensor arguments become graph inputs, every other
    argument is baked in (a launch dimension, like a CUDA grid size).
    Extent mode (a trusted step): every tensor leaf of every argument
    (:func:`~repro_torch.core.stepgraph.tree_flatten` — dicts, lists,
    dataclasses such as a cache meta or a :class:`GuardSpec`) becomes a
    graph input, and the leaves of the ``arena_argnums`` arguments are
    tainted.  ``device`` puts every fake on one device (a meta tensor then
    stands in for a shape).  Fails closed with :class:`SandboxError` on a
    data-dependent value or shape (``.item()``, a boolean mask), a
    higher-order op other than ``cond``, ``while_loop`` and ``scan`` and,
    in row mode, on any use of the arena the walker cannot contain."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    if mode not in ("row", "extent"):
        raise ValueError(f"verifier mode {mode!r} (row or extent)")
    structs = [tree_flatten(a) if mode == "extent" else (None, [a])
               for a in example_args]
    slots = [(p, j) for p, (_, leaves) in enumerate(structs)
             for j, leaf in enumerate(leaves)
             if isinstance(leaf, torch.Tensor)]
    dyn_pos = [p for p, _ in slots]
    devices = [torch.device(device) if device is not None
               else structs[p][1][j].device for p, j in slots]
    indexing = _AtenIndexing() if any(
        d.type == "cuda" for d in devices) and \
        not torch.backends.cuda.is_built() else contextlib.nullcontext()

    def fn_dyn(*dargs):
        leaves = [list(ls) for _, ls in structs]
        for (p, j), v in zip(slots, dargs):
            leaves[p][j] = v
        with indexing:
            return fn(*(tree_unflatten(s, ls)
                        for (s, _), ls in zip(structs, leaves)))

    def trace(shape_env):
        with FakeTensorMode(shape_env=shape_env):
            # a fresh fake per leaf: two arguments that happen to be one
            # tensor must not share a graph input
            fakes = [torch.empty_strided(
                structs[p][1][j].shape, structs[p][1][j].stride(),
                dtype=structs[p][1][j].dtype, device=dev)
                for (p, j), dev in zip(slots, devices)]
            return make_fx(fn_dyn, tracing_mode="real")(*fakes)

    try:
        try:
            gm = trace(None)
        except _trace_errors():
            raise
        except Exception as first:
            # torch's while_loop traces only under a shape environment,
            # which also lets a data-dependent value through as an
            # unbacked symbol: the retry refuses every such symbol
            from torch.fx.experimental.symbolic_shapes import ShapeEnv
            try:
                gm = trace(ShapeEnv())
            except Exception:
                raise first from None
            _refuse_symbols(gm)
    except _trace_errors() as e:
        raise _unsupported(
            f"a value or shape depends on tensor data ({type(e).__name__}: "
            f"{e}); launch dimensions must be Python ints") from e
    except SandboxError:
        raise
    except Exception as e:
        if "HigherOrderOp" in type(e).__name__:
            raise _unsupported(
                "torch could not trace a higher-order op (its bodies must "
                "be functional: carry the arena and store with "
                f"`index_put`, not `index_put_`): {e}") from e
        raise
    arena_set = frozenset(arena_argnums)
    taints = [p in arena_set for p in dyn_pos]
    if mode == "extent":
        return _analyze_extent(gm, dyn_pos, taints)
    return _analyze(gm, dyn_pos, taints)


def _symbolic(val) -> bool:
    if isinstance(val, (torch.SymInt, torch.SymFloat, torch.SymBool)):
        return True
    if isinstance(val, torch.Tensor):
        return any(isinstance(d, torch.SymInt)
                   for d in (*val.shape, *val.stride()))
    if isinstance(val, (list, tuple)):
        return any(_symbolic(v) for v in val)
    return False


def _refuse_symbols(gm) -> None:
    """Fail closed on a trace that holds a symbol (a value read from
    tensor data, a shape that depends on it), in any body."""
    for mod in gm.modules():
        if not isinstance(mod, torch.fx.GraphModule):
            continue
        for node in mod.graph.nodes:
            if _symbolic(node.meta.get("val")):
                raise _unsupported(
                    f"a value or shape depends on tensor data (`{node.name}`"
                    " is a symbol of the trace); launch dimensions must be "
                    "Python ints")


def _index_steps(t: torch.Tensor, idx) -> Tuple[torch.Tensor,
                                                Dict[int, Any]]:
    """The basic indexing of ``t[idx]`` as aten views (an int selects, a
    slice slices — a whole-dim slice is skipped, as the C++ indexing skips
    it —, ``None`` unsqueezes, ``...`` skips dims) and the tensor indices
    left for ``index`` / ``index_put_``, by the dim they address."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    rest = t.dim() - sum(1 for i in idx if i is not None and i is not ...)
    out, d, tensors = t, 0, {}
    for i in idx:
        if i is None:
            out, d = torch.unsqueeze(out, d), d + 1
        elif i is ...:
            d += rest
        elif isinstance(i, slice):
            if not (i.start in (None, 0) and i.step in (None, 1) and (
                    i.stop is None or (isinstance(i.stop, int)
                                       and i.stop >= out.shape[d]))):
                out = aten.slice.Tensor(out, d, i.start, i.stop,
                                        1 if i.step is None else i.step)
            d += 1
        elif isinstance(i, torch.Tensor):
            tensors[d], d = i, d + 1
        elif isinstance(i, int) and not isinstance(i, bool):
            out = torch.select(out, d, i)
        else:
            raise _unsupported(f"an index of type {type(i).__name__}")
    return out, tensors


class _AtenIndexing(torch.overrides.TorchFunctionMode):
    """Python indexing (``t[i]``, ``t[i] = v``) spelled in aten ops, as
    the C++ indexing spells it.  A build of torch without CUDA refuses that
    C++ path for a fake CUDA tensor (it sets a device guard first), so a
    step traced on fake CUDA tensors on such a build records the same
    graph through this mode; the card's build never uses it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            out, tensors = _index_steps(*args)
            if not tensors:
                return out if out is not args[0] else aten.alias(out)
            return aten.index.Tensor(
                out, [tensors.get(k) for k in range(max(tensors) + 1)])
        if func is torch.Tensor.__setitem__:
            t, idx, value = args
            out, tensors = _index_steps(t, idx)
            if tensors:
                if not isinstance(value, torch.Tensor):
                    value = torch.tensor(value, dtype=out.dtype,
                                         device=out.device)
                aten.index_put_(
                    out, [tensors.get(k) for k in range(max(tensors) + 1)],
                    value)
            elif isinstance(value, torch.Tensor):
                out.copy_(value)
            else:
                out.fill_(value)
            return None
        return func(*args, **(kwargs or {}))


def _node_args(node) -> List[Any]:
    out: List[Any] = []

    def walk(a):
        if isinstance(a, (list, tuple)):
            for x in a:
                walk(x)
        elif isinstance(a, dict):
            for x in a.values():
                walk(x)
        elif hasattr(a, "op") and hasattr(a, "meta"):
            out.append(a)

    walk(node.args)
    walk(node.kwargs)
    return out


def _warn_taint(msg: str) -> None:
    warnings.warn(msg, GuardianTaintWarning, stacklevel=4)


def _analyze(gm, dyn_pos: List[int], taints: List[bool]) -> Traced:
    """The taint rule over the aten graph, shared by the sandbox and the
    verifier.  The arena and values derived from it by views and copies
    are tainted; a gather's output is not (values, not slot space); a
    scatter's output stays tainted (the arena flows through).  Every
    other use of a tainted value fails closed: an elementwise op or a
    reduction over the arena reads every partition, an in-place op other
    than a fenced scatter writes every partition, an access along another
    dim than the slot axis reaches every row.  The bodies of ``cond`` /
    ``while_loop`` / ``scan`` are held to the same rule (:func:`_hop_row`);
    the kernel's own results to the contract of :func:`_check_outputs`."""
    traced = _analyze_row(gm, taints, taints, ())
    traced.dyn_pos = dyn_pos
    return traced


def _analyze_row(gm, in_taints: Sequence[bool], in_exact: Sequence[bool],
                 prefix: Tuple) -> Traced:
    """The row-mode taint rule over one graph: the kernel (``prefix ==
    ()``) or a body of a higher-order node, whose placeholders carry
    ``in_taints`` / ``in_exact``."""
    tainted: Dict[str, bool] = {}
    exact: Dict[str, bool] = {}
    sites: Dict[str, Site] = {}
    all_sites: Dict[str, List[Site]] = {}
    subs: Dict[str, Structure] = {}
    out_tx: List[Tuple[bool, bool]] = []
    arena_extent, arena_val = None, None
    it = iter(zip(in_taints, in_exact))
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            t, x = next(it, (False, False))
            tainted[node.name], exact[node.name] = t, t and x
            if t and arena_val is None:
                arena_val = node.meta.get("val")
                arena_extent = _shape(node)[0] if _shape(node) else None
            continue
        if node.op == "get_attr":
            tainted[node.name] = exact[node.name] = False
            continue
        if node.op == "output":
            if not prefix:
                _check_outputs(node, tainted, exact, arena_val)
            out_tx = [_tx(tainted, exact, a) for a in _flat_out(node)]
            continue
        target = node.target
        if isinstance(target, torch._ops.HigherOrderOperator):
            st = _hop_row(gm, node, tainted, exact, prefix)
            subs[node.name] = st
            tainted[node.name] = exact[node.name] = False
            continue
        ins = _node_args(node)
        t_in = [tainted.get(a.name, False) for a in ins]
        name = op_name(target)
        acc = ACCESS_OPS.get(target)
        out_t, out_x = False, False
        if acc is None and name in _UNSUPPORTED_INDEXED:
            raise _unsupported(
                f"`{target}` addresses a tensor through an index the "
                "sandbox cannot keep in range")
        if target in KERNEL_OPS:
            declared = _kernel_sites(node, tainted, exact, row=True,
                                     prefix=prefix)
            if declared:
                all_sites[node.name] = declared
        elif acc is not None:
            site = _site_of(node, acc, tainted, exact)
            site.prefix = prefix
            sites[node.name] = site
            all_sites[node.name] = [site]
            if site.tainted:
                out_t = acc.kind in (ViolationKind.SCATTER,
                                     ViolationKind.UPDATE)
                out_x = out_t and site.exact
        elif target is operator.getitem:
            src = node.args[0]
            if getattr(src, "name", None) in subs:
                out_t, out_x = subs[src.name].out[node.args[1]]
            elif tainted.get(getattr(src, "name", None), False):
                raise _unsupported("a multi-output op over the arena")
        elif any(t_in):
            src = node.args[0] if node.args else None
            if not (hasattr(src, "name") and tainted.get(src.name)) or \
                    sum(t_in) > 1:
                raise _unsupported(
                    f"`{name}` consumes the arena other than as the "
                    "operand of a view or an access")
            out_t, out_x = _transparent(node, name, exact[src.name])
        tainted[node.name] = out_t
        exact[node.name] = out_x
    return Traced(gm=gm, dyn_pos=[], taints=list(in_taints), sites=sites,
                  tainted=tainted, exact=exact, arena_extent=arena_extent,
                  all_sites=all_sites, prefix=prefix, subs=subs,
                  out_tx=out_tx)


def _is_node(a) -> bool:
    return hasattr(a, "op") and hasattr(a, "meta")


def _tx(tainted, exact, a) -> Tuple[bool, bool]:
    """(tainted, slot-exact) of an operand: a graph value or a constant."""
    if not _is_node(a):
        return False, False
    return tainted.get(a.name, False), exact.get(a.name, False)


def _join_tx(a: Tuple[bool, bool], b: Tuple[bool, bool]
             ) -> Tuple[bool, bool]:
    """A value that is either: tainted if either is, slot-exact only if
    every tainted side is."""
    t = a[0] or b[0]
    return t, t and (a[1] or not a[0]) and (b[1] or not b[0])


def _flat_out(node) -> List[Any]:
    """The results of a graph's output node, flattened."""
    out = node.args[0]
    return list(out) if isinstance(out, (list, tuple)) else [out]


#: the higher-order ops interpreted structurally
COND = torch.ops.higher_order.cond
WHILE = torch.ops.higher_order.while_loop
SCAN = torch.ops.higher_order.scan
_MAX_TAINT_ITERS = 64


def _parse_hop(gm, node) -> Tuple[Structure, List[Any]]:
    """The operand groups and bodies of a ``cond`` / ``while_loop`` /
    ``scan`` node; any other higher-order op fails closed."""
    target, a = node.target, node.args
    if node.kwargs or target not in (COND, WHILE, SCAN):
        raise _unsupported(f"higher-order op `{target}`")

    def body(n):
        return getattr(gm, n.target)

    if target is COND and len(a) == 4:
        pred, true_g, false_g, ops = a
        st = Structure("cond", node, pred, list(ops), [], [])
        return st, [body(false_g), body(true_g)]
    if target is WHILE and len(a) == 4:
        cond_g, body_g, carried, extra = a
        st = Structure("while", node, None, list(carried), [], list(extra))
        return st, [body(cond_g), body(body_g)]
    if target is SCAN and len(a) in (4, 6):
        if len(a) == 6:
            f, init, xs, dim, reverse, extra = a
            if dim != 0 or reverse:
                raise _unsupported("a scan along another dim than 0, or "
                                   "reversed")
        else:
            f, init, xs, extra = a
        st = Structure("scan", node, None, list(init), list(xs), list(extra))
        return st, [body(f)]
    raise _unsupported(f"higher-order op `{target}` with {len(a)} operands")


def _quiet(fn, *args):
    """``fn(*args)`` with the taint warnings silenced: a fixpoint pass
    before the recording one (the reference warns once, there too)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", GuardianTaintWarning)
        return fn(*args)


def _hop_row(gm, node, tainted, exact, prefix) -> Structure:
    """Row mode over a higher-order node: each body is analysed with its
    operands' taints — a loop's carries at their monotone fixpoint — and
    held to the kernel's rule; a scan that slices the arena (its ``xs``)
    or stacks it (a ``ys``) reads or hands out every partition and fails
    closed."""
    st, gms = _parse_hop(gm, node)
    path = (*prefix, node.name)
    tx = [_tx(tainted, exact, a) for a in st.carry]
    ext = [_tx(tainted, exact, a) for a in st.extra]
    if st.kind == "cond":
        st.bodies = [_analyze_row(g, [t for t, _ in tx], [x for _, x in tx],
                                  (*path, b)) for b, g in enumerate(gms)]
        out = st.bodies[0].out_tx
        for body in st.bodies[1:]:
            out = [_join_tx(p, q) for p, q in zip(out, body.out_tx)]
        st.out = out
        return st
    xs = [_tx(tainted, exact, a) for a in st.xs]
    if any(t for t, _ in xs):
        raise _unsupported("a scan over the arena's slot axis reads every "
                           "partition")
    loop = gms[-1]
    n = len(tx)
    for _ in range(_MAX_TAINT_ITERS):
        ins = [*tx, *xs, *ext]
        outs = _quiet(_analyze_row, loop, [t for t, _ in ins],
                      [x for _, x in ins], (*path, len(gms) - 1)).out_tx
        new = [_join_tx(c, o) for c, o in zip(tx, outs[:n])]
        if new == tx:
            break
        tx = new
    else:   # pragma: no cover - booleans converge in 2n passes
        raise VerifierError(f"loop-carry taints did not converge at {path}")
    ins = [*tx, *xs, *ext]          # a while has no xs
    st.bodies = [_analyze_row(g, [t for t, _ in ins], [x for _, x in ins],
                              (*path, b)) for b, g in enumerate(gms)]
    ys = st.bodies[-1].out_tx[n:]
    if any(t for t, _ in ys):
        raise _unsupported("a scan stacks the arena into its results, "
                           "which hands every partition out")
    st.out = tx + ys
    return st


def _op_arg(node, name: str):
    """Argument ``name`` of a custom-op node, by the op's schema."""
    for i, a in enumerate(node.target._schema.arguments):
        if a.name == name:
            return node.args[i] if i < len(node.args) else \
                node.kwargs.get(name)
    raise KeyError(f"{op_name(node.target)} has no argument {name!r}")


def _kernel_sites(node, tainted, exact, row: bool,
                  prefix: Tuple = ()) -> List[Site]:
    """One site per declared access of a kernel op whose operand is the
    arena (or the pool).  In row mode the op may take the arena only as
    an operand it addresses, and store only through the slot axis."""
    name = op_name(node.target)
    out: List[Site] = []
    addressed = set()
    for acc in KERNEL_OPS[node.target]:
        operand = _op_arg(node, acc.operand)
        addressed.add(operand.name)
        if not tainted.get(operand.name, False):
            continue
        if row and acc.store and not exact.get(operand.name, False):
            raise _unsupported(
                f"`{name}` stores through a view of the arena that "
                "reshaped its slot axis")
        shape = _shape(operand)
        kind = ViolationKind.SCATTER if acc.store else ViolationKind.GATHER
        out.append(Site(
            node=node, op=AccessOp(kind, -1, native=acc.out_of_range),
            operand=operand, index=_op_arg(node, acc.index), dim=0,
            extent=shape[0] if shape else 1, length=1, tainted=True,
            exact=exact.get(operand.name, False), decl=acc,
            tag=acc.operand, prefix=prefix))
    if row:
        for other in _node_args(node):
            if tainted.get(other.name, False) and \
                    other.name not in addressed:
                raise _unsupported(
                    f"`{name}` takes the arena other than as an operand "
                    "it addresses")
    return out


#: ops whose result still addresses the memory of their first operand
_EXTENT_VIEWS = _VIEWS | _PERMUTES | _COPIES | {
    "slice", "select", "narrow", "as_strided", "unfold", "diagonal",
    "split", "split_with_sizes", "chunk", "unbind", "movedim",
    "unflatten", "view_as_real", "view_as_complex", "real", "imag"}


def _extent_sites(node, acc: AccessOp, prefix: Tuple = ()) -> List[Site]:
    """The sites of an access op over the arena or pool in extent mode:
    one per index tensor, each against the extent of the dim it
    addresses."""
    args = list(node.args)
    operand = args[0]
    shape = _shape(operand)
    if acc.listed:
        entries = [(d, e) for d, e in enumerate(args[acc.index])
                   if e is not None]
    else:
        dim = 0 if acc.dim is None else int(args[acc.dim])
        entries = [(dim % max(len(shape), 1), args[acc.index])]
    length = 1
    if acc.kind is ViolationKind.SLICE:
        length = int(args[2])
    elif acc.kind is ViolationKind.UPDATE:
        vs = _shape(args[2])
        length = vs[0] if vs else 1
    out = []
    for dim, index in entries:
        if node.target is aten.take.default:
            extent = 1
            for d in shape:
                extent *= d
        else:
            extent = shape[dim] if dim < len(shape) else 1
        out.append(Site(
            node=node, op=acc, operand=operand, index=index, dim=dim,
            extent=extent, length=length, tainted=True, exact=False,
            list_pos=dim, tag=f"dim{dim}" if len(entries) > 1 else "",
            prefix=prefix))
    return out


def _analyze_extent(gm, dyn_pos: List[int], taints: List[bool]) -> Traced:
    """The taint rule of extent mode (a trusted step): the arena and pool
    leaves, their views, static slices and copies, and what a store or
    an in-place op over them returns address their memory; a value
    computed from them does not.  Nothing fails closed here — a step is
    proven or not: each access op over a tainted operand is one site per
    index, each kernel op one site per declared access, and an op that
    takes a tainted operand without a transfer function (an unknown
    operator, an indexing op the table lacks) one opaque site, always
    FENCED.  The bodies of ``cond`` / ``while_loop`` / ``scan`` are walked
    with their operands' taints, a loop's carries at their fixpoint."""
    traced = _analyze_extent_graph(gm, taints, ())
    traced.dyn_pos = dyn_pos
    return traced


def _analyze_extent_graph(gm, in_taints: Sequence[bool],
                          prefix: Tuple) -> Traced:
    tainted: Dict[str, bool] = {}
    all_sites: Dict[str, List[Site]] = {}
    subs: Dict[str, Structure] = {}
    out_tx: List[Tuple[bool, bool]] = []
    arena_extent = None
    it = iter(in_taints)
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            t = next(it, False)
            tainted[node.name] = t
            if t and arena_extent is None and _shape(node):
                arena_extent = _shape(node)[0]
            continue
        if node.op == "output":
            out_tx = [_tx(tainted, {}, a) for a in _flat_out(node)]
            continue
        if node.op != "call_function":
            tainted[node.name] = False
            continue
        target = node.target
        if isinstance(target, torch._ops.HigherOrderOperator):
            subs[node.name] = _hop_extent(gm, node, tainted, prefix)
            tainted[node.name] = False
            continue
        ins = _node_args(node)
        any_t = any(tainted.get(a.name, False) for a in ins)
        src = node.args[0] if node.args else None
        src_t = hasattr(src, "name") and tainted.get(src.name, False)
        name = op_name(target)
        acc = ACCESS_OPS.get(target)
        sites: List[Site] = []
        out_t = False
        if target in KERNEL_OPS:
            sites = _kernel_sites(node, tainted, {}, row=False,
                                  prefix=prefix)
        elif acc is not None:
            if src_t:
                sites = _extent_sites(node, acc, prefix)
            out_t = src_t and acc.kind in (ViolationKind.SCATTER,
                                           ViolationKind.UPDATE)
        elif target is operator.getitem and \
                getattr(src, "name", None) in subs:
            out_t = subs[src.name].out[node.args[1]][0]
        elif not isinstance(target, torch._ops.OpOverload):
            out_t = any_t      # getitem of a multi-output op, a rebuilt tree
        elif any_t and (name in _UNSUPPORTED_INDEXED
                        or target.namespace not in ("aten", "prims")):
            first = next(a for a in ins if tainted.get(a.name, False))
            shape = _shape(first)
            kind = ViolationKind.SCATTER if name.endswith("_") \
                else ViolationKind.GATHER
            sites = [Site(node=node, op=AccessOp(kind, -1), operand=first,
                          index=None, dim=0,
                          extent=shape[0] if shape else 1, length=1,
                          tainted=True, exact=False, opaque=True,
                          prefix=prefix)]
            out_t = src_t
        else:
            out_t = src_t and (name in _EXTENT_VIEWS or name.endswith("_"))
        if sites:
            all_sites[node.name] = sites
        tainted[node.name] = out_t
    return Traced(gm=gm, dyn_pos=[], taints=list(in_taints), sites={},
                  tainted=tainted, exact={}, arena_extent=arena_extent,
                  all_sites=all_sites, mode="extent", prefix=prefix,
                  subs=subs, out_tx=out_tx)


def _hop_extent(gm, node, tainted, prefix) -> Structure:
    """Extent mode over a higher-order node: the bodies walked with their
    operands' taints, a loop's carries at their fixpoint; a scan's slices
    of a tainted ``xs`` address its memory, its stacked results do not."""
    st, gms = _parse_hop(gm, node)
    path = (*prefix, node.name)

    def taint(a):
        return _tx(tainted, {}, a)[0]

    ts = [taint(a) for a in st.carry]
    if st.kind == "cond":
        st.bodies = [_analyze_extent_graph(g, ts, (*path, b))
                     for b, g in enumerate(gms)]
        st.out = [(any(body.out_tx[k][0] for body in st.bodies), False)
                  for k in range(len(st.bodies[0].out_tx))]
        return st
    rest = [taint(a) for a in (*st.xs, *st.extra)]
    n = len(ts)
    for _ in range(_MAX_TAINT_ITERS):
        outs = _analyze_extent_graph(gms[-1], ts + rest,
                                     (*path, len(gms) - 1)).out_tx
        new = [c or o for c, (o, _) in zip(ts, outs[:n])]
        if new == ts:
            break
        ts = new
    else:   # pragma: no cover - booleans converge in n passes
        raise VerifierError(f"loop-carry taints did not converge at {path}")
    st.bodies = [_analyze_extent_graph(g, ts + rest, (*path, b))
                 for b, g in enumerate(gms)]
    n_ys = len(st.bodies[-1].out_tx) - n
    st.out = [(t, False) for t in ts] + [(False, False)] * n_ys
    return st


def _transparent(node, name: str, exact_in: bool) -> Tuple[bool, bool]:
    """(tainted, slot-exact) of a view / copy of a tainted operand."""
    src = node.args[0]
    in_shape, out_shape = _shape(src), _shape(node)
    if name in _METADATA:
        return False, False
    if name in _COPIES:
        return True, exact_in
    if name in _VIEWS:
        if in_shape and out_shape and in_shape[0] == out_shape[0]:
            return True, exact_in
        _warn_taint(
            f"{name} {in_shape} -> {out_shape} does not preserve the "
            "arena slot dim 0; keeping taint (downstream accesses stay "
            "fenced)")
        return True, False
    if name in _PERMUTES:
        if name == "permute":
            moved = list(node.args[1])[0] % max(len(in_shape), 1) != 0
        elif name == "transpose":
            d0, d1 = (int(d) % max(len(in_shape), 1)
                      for d in node.args[1:3])
            moved = 0 in (d0, d1) and d0 != d1
        else:
            moved = len(in_shape) > 1
        if not moved:
            return True, exact_in
        _warn_taint(
            f"{name} of {in_shape} demotes the arena slot dim 0; keeping "
            "taint (downstream accesses stay fenced)")
        return True, False
    if name in ("slice", "select"):
        dim = int(node.args[1]) if len(node.args) > 1 else 0
        if dim % max(len(in_shape), 1) != 0:
            return True, exact_in
        if name == "slice" and in_shape and out_shape == in_shape:
            return True, exact_in          # the whole slot axis
        raise _unsupported(
            f"a static {name} of the arena's slot axis (an address the "
            "fence row cannot follow)")
    raise _unsupported(
        f"`{name}` consumes the arena other than as the operand of a view "
        "or an access")


def _site_of(node, acc: AccessOp, tainted, exact) -> Site:
    args = list(node.args)
    operand = args[0]
    t_op = tainted.get(operand.name, False)
    shape = _shape(operand)
    if acc.listed:
        entries = list(args[acc.index])
        present = [i for i, e in enumerate(entries) if e is not None]
        if len(present) != 1:
            raise _unsupported(
                f"`{op_name(node.target)}` with {len(present)} index "
                "tensors (one is supported)")
        pos = present[0]
        index, dim = entries[pos], pos
    else:
        index = args[acc.index]
        dim = 0 if acc.dim is None else int(args[acc.dim])
        pos = 0
    if acc.native == "reduce":
        reduce = args[4] if len(args) > 4 else node.kwargs.get("reduce")
        include_self = args[5] if len(args) > 5 else node.kwargs.get(
            "include_self", True)
        if reduce not in ("sum", "prod", "amax", "amin") or not include_self:
            raise _unsupported(
                f"scatter_reduce with reduce={reduce!r}, "
                f"include_self={include_self}")
    if acc.native == "put":
        accumulate = args[3] if len(args) > 3 else node.kwargs.get(
            "accumulate", False)
        acc = dataclasses.replace(acc, native="add" if accumulate else "set")
    ndim = max(len(shape), 1)
    dim = dim % ndim
    if node.target is aten.take.default:
        extent = 1
        for d in shape:
            extent *= d
    else:
        extent = shape[dim] if shape else 1
    length = 1
    if acc.kind is ViolationKind.SLICE:
        length = int(args[2])
    elif acc.kind is ViolationKind.UPDATE:
        vs = _shape(args[2])
        length = vs[0] if vs else 1
    for other in _node_args(node):
        if other is not operand and tainted.get(other.name, False):
            raise _unsupported(
                f"`{op_name(node.target)}` takes an index or values "
                "straight from the arena (load them with a gather first)")
    if t_op:
        if dim != 0:
            raise _unsupported(
                f"`{op_name(node.target)}` addresses dim {dim} of the "
                "arena, which reaches every slot")
        if acc.inplace and not exact.get(operand.name, False):
            raise _unsupported(
                f"`{op_name(node.target)}` stores through a view of the "
                "arena that reshaped its slot axis")
    # a flat index into a multi-dim operand is not in slot units
    slot_exact = exact.get(operand.name, False) and not (
        node.target is aten.take.default and len(shape) > 1)
    return Site(node=node, op=acc, operand=operand, index=index, dim=dim,
                extent=extent, length=length, tainted=t_op,
                exact=slot_exact, list_pos=pos)


def _check_outputs(node, tainted, exact, arena_val) -> None:
    """The kernel contract ``(new_arena, out)``: the first result is the
    arena, updated only through fenced stores (never a value the kernel
    made up — that would overwrite every partition), and nothing else the
    kernel returns may be arena-tainted (that would hand every partition
    to the caller)."""
    outs = node.args[0]
    leaves: List[Any] = []

    def walk(a):
        if isinstance(a, (list, tuple)):
            for x in a:
                walk(x)
        elif isinstance(a, dict):
            for x in a.values():
                walk(x)
        else:
            leaves.append(a)

    walk(outs)
    for i, leaf in enumerate(leaves):
        is_node = hasattr(leaf, "name") and hasattr(leaf, "meta")
        t = is_node and tainted.get(leaf.name, False)
        if i == 0 and isinstance(outs, (list, tuple)) and len(outs) == 2:
            val = leaf.meta.get("val") if is_node else None
            if not (t and exact.get(leaf.name, False)) or (
                    arena_val is not None and (
                        val.shape != arena_val.shape
                        or val.dtype != arena_val.dtype)):
                raise _unsupported(
                    "the first result must be the arena it was given, "
                    "updated only through fenced stores")
        elif t:
            raise _unsupported(
                "a result other than the arena is the arena itself or a "
                "view of it")


# --------------------------------------------------------------------------
# Abstract interpreter over the aten graph
# --------------------------------------------------------------------------

def _const_ival(val) -> Ival:
    if isinstance(val, bool):
        return iconst(int(val))
    if isinstance(val, int):
        return iconst(val)
    if isinstance(val, torch.Tensor):
        if val.numel() == 0 or val.is_floating_point() or val.is_complex():
            return TOP
        if getattr(val, "fake_mode", None) is not None or \
                val.device.type == "meta":
            return TOP
        v = val.to(torch.int64)
        return iconst(int(v.min()), int(v.max()))
    return TOP


def _is_int(node) -> bool:
    val = node.meta.get("val") if hasattr(node, "meta") else None
    if isinstance(val, torch.Tensor):
        return not (val.is_floating_point() or val.is_complex())
    return isinstance(val, (int, bool))


class _Target:
    """What a site must land in.  Row mode: the fence row ``[row_lo,
    row_hi]`` (inclusive); a site outside it on every launch is REFUTED.
    Extent mode: the accessed operand's extent along the addressed dim, or
    one of the ``admissible`` guard ranges; never refuted (a trusted
    step's property is that every access is proven, not that a tenant
    stays in its row)."""

    def __init__(self, row_lo: Optional[Lin] = None,
                 row_hi: Optional[Lin] = None, mode: str = "row",
                 admissible: Sequence[Tuple[Lin, Lin]] = ()):
        self.row_lo, self.row_hi = row_lo, row_hi
        self.mode = mode
        self.admissible = tuple(admissible)

    def desc(self) -> str:
        return f"[{self.row_lo}, {self.row_hi}]"

    def targets_for(self, extent: int, length: int
                    ) -> List[Tuple[Lin, Lin, str]]:
        """Candidate inclusive ``[lo, hi]`` ranges of an index or a
        window's start (``length`` shrinks the hi)."""
        if self.mode == "row":
            return [(self.row_lo, self.row_hi.shift(1 - length),
                     self.desc())]
        return [(lc(0), lc(extent - length), f"extent[0, {extent - 1}]")] \
            + [(lo, hi.shift(1 - length), f"guard[{lo}, {hi}]")
               for lo, hi in self.admissible]


def _normalize_ival(ctx: SymCtx, iv: Ival, extent: int) -> Ival:
    """The interval after the negative-index wrap (``i < 0 -> i + E``)
    every jnp gather and scatter applies before it addresses: decided
    when the sign is provable, else the join of both cases."""
    if iv.lo is not None and ctx.prove_nonneg(iv.lo):
        return iv
    shifted = iadd(iv, iconst(extent))
    if iv.hi is not None and ctx.lt(iv.hi, lc(0)):
        return shifted
    return ijoin(ctx, iv, shifted)


class _AbsState:
    def __init__(self, ctx: SymCtx, target: _Target, traced: Traced):
        self.ctx = ctx
        self.target = target
        self.traced = traced
        self.sites: List[SiteRecord] = []
        self.n_eqns = 0
        #: site path -> index interval at each access, as the op is
        #: given it (before the negative-index wrap)
        self.index_ival: Dict[Tuple, Ival] = {}


def _classify(state: _AbsState, site: Site, iv: Ival) -> str:
    ctx, tgt = state.ctx, state.target
    cands = tgt.targets_for(site.extent, site.length)
    verdict, why, tdesc = FENCED, "interval not contained", cands[-1][2]
    for lo, hi, desc in cands:
        if site.opaque:
            break
        tdesc = desc
        if (iv.lo is not None and iv.hi is not None
                and ctx.le(lo, iv.lo) and ctx.le(iv.hi, hi)):
            verdict, why = PROVEN, "statically contained"
            break
    if site.opaque:
        why = f"no transfer function for `{op_name(site.node.target)}`"
    elif verdict is FENCED:
        if tgt.mode == "row" and iv.hi is not None and \
                ctx.lt(iv.hi, tgt.row_lo):
            verdict, why = REFUTED, "always below partition"
        elif tgt.mode == "row" and iv.lo is not None and \
                ctx.lt(tgt.row_hi, iv.lo):
            verdict, why = REFUTED, "always above partition"
        else:
            why = ("interval unbounded" if iv.is_top
                   else "interval straddles bound")
    state.sites.append(SiteRecord(
        path=site.path, kind=site.op.kind,
        prim=op_name(site.node.target), verdict=verdict, interval=str(iv),
        target=tdesc, why=why))
    return verdict


def _arg_ival(ival: Dict[str, Ival], a) -> Ival:
    if hasattr(a, "name") and hasattr(a, "meta"):
        return ival.get(a.name, TOP)
    return _const_ival(a)


def _int_range(val) -> Optional[Tuple[int, int]]:
    """The values an integer tensor's dtype can hold (``None`` for a
    Python int, which never wraps, and for a float)."""
    if not isinstance(val, torch.Tensor) or val.is_floating_point() \
            or val.is_complex():
        return None
    if val.dtype == torch.bool:
        return 0, 1
    info = torch.iinfo(val.dtype)
    return int(info.min), int(info.max)


#: ops whose interval is computed, not selected from their operands': the
#: result may leave the dtype's range, and then it wraps
_WRAPPING = {"add", "sub", "rsub", "neg", "mul", "abs", "arange", "full",
             "scalar_tensor", "full_like", "new_full"}


def _abs_eval(ctx: SymCtx, node, ival: Dict[str, Ival]) -> Ival:
    """Interval transfer function for one aten node (⊤ when unknown),
    sound for the node's dtype: where the interval arithmetic may have
    left the range the dtype holds (an int32 overflow, a narrowing
    ``_to_copy``), the value wrapped on the device and the result is ⊤;
    a view that reinterprets the bits as another dtype is ⊤ too."""
    iv = _abs_eval_op(ctx, node, ival)
    if iv.is_top:
        return iv
    val = node.meta.get("val")
    rng = _int_range(val)
    if rng is None:
        return iv
    name = op_name(node.target)
    src = node.args[0] if node.args else None
    src_val = src.meta.get("val") if hasattr(src, "meta") else None
    converts = (isinstance(src_val, torch.Tensor)
                and src_val.dtype != val.dtype)
    if converts and name in _VIEWS | _PERMUTES | {"slice", "select"}:
        return TOP                       # a bit reinterpretation
    if iv.lo is not None and iv.hi is not None:
        if ctx.le(lc(rng[0]), iv.lo) and ctx.le(iv.hi, lc(rng[1])):
            return iv
        return TOP
    if name in _WRAPPING:
        return TOP
    if converts:
        src_rng = _int_range(src_val)
        if src_rng is None or src_rng[0] < rng[0] or src_rng[1] > rng[1]:
            return TOP                   # a narrowing cast
    return iv


def _abs_eval_op(ctx: SymCtx, node, ival: Dict[str, Ival]) -> Ival:
    """The interval arithmetic of one aten node, before the dtype's range
    is taken into account (see :func:`_abs_eval`)."""
    name = op_name(node.target)
    args = list(node.args)
    kw = node.kwargs
    if node.target is operator.getitem or not _is_int(node):
        return TOP

    def a(i) -> Ival:
        return _arg_ival(ival, args[i]) if i < len(args) else TOP

    if name == "arange":
        nums = [x for x in args if not hasattr(x, "meta")]
        if not all(isinstance(x, int) for x in nums):
            return TOP
        start, end, step = 0, None, 1
        if len(nums) == 1:
            end = nums[0]
        elif len(nums) >= 2:
            start, end = nums[0], nums[1]
            step = nums[2] if len(nums) > 2 else 1
        n = max(0, -(-(end - start) // step)) if step else 0
        if n == 0:
            return TOP
        last = start + step * (n - 1)
        return iconst(min(start, last), max(start, last))
    if name in ("full", "scalar_tensor", "full_like", "new_full"):
        v = args[1] if name in ("full", "full_like", "new_full") else args[0]
        return _const_ival(v)
    if name in ("zeros", "zeros_like", "new_zeros"):
        return iconst(0)
    if name in ("ones", "ones_like", "new_ones"):
        return iconst(1)
    if name in _VIEWS | _PERMUTES | _COPIES | {"slice", "select"}:
        return a(0)
    if name in ("add", "sub", "rsub"):
        alpha = _const_ival(kw.get("alpha", 1))
        x, y = a(0), imul(a(1), alpha)
        if name == "add":
            return iadd(x, y)
        if name == "sub":
            return isub(x, y)
        return isub(imul(a(1), iconst(1)), imul(a(0), alpha))
    if name == "neg":
        return ineg(a(0))
    if name == "mul":
        return imul(a(0), a(1))
    if name in ("maximum", "max") and len(args) == 2:
        return imax(ctx, a(0), a(1))
    if name in ("minimum", "min") and len(args) == 2:
        return imin(ctx, a(0), a(1))
    if name in ("clamp", "clip", "clamp_min", "clamp_max"):
        lo = hi = None
        if name in ("clamp", "clip"):
            lo = args[1] if len(args) > 1 else kw.get("min")
            hi = args[2] if len(args) > 2 else kw.get("max")
        elif name == "clamp_min":
            lo = args[1]
        else:
            hi = args[1]
        out = a(0)
        if lo is not None:
            out = imax(ctx, out, _arg_ival(ival, lo))
        if hi is not None:
            out = imin(ctx, out, _arg_ival(ival, hi))
        return out
    if name == "abs":
        v = a(0)
        if v.lo is not None and ctx.prove_nonneg(v.lo):
            return v
        return Ival(lc(0), None)
    if name in ("remainder", "fmod"):
        d = _as_const(a(1))
        if d is None or d <= 0:
            return TOP
        v = a(0)
        if v.lo is not None and ctx.prove_nonneg(v.lo):
            hi = lc(d - 1)
            if v.hi is not None and ctx.le(v.hi, hi):
                hi = v.hi
            return Ival(lc(0), hi)
        if name == "remainder":          # floor mod: sign of the divisor
            return iconst(0, d - 1)
        return iconst(-(d - 1), d - 1)
    if name in ("floor_divide", "div"):
        mode = kw.get("rounding_mode", "floor" if name == "floor_divide"
                      else None)
        d, v = _as_const(a(1)), a(0)
        if (mode in ("floor", "trunc") and d is not None and d > 0
                and v.lo is not None and v.hi is not None
                and v.lo.is_const and v.hi.is_const and v.lo.const >= 0):
            return iconst(v.lo.const // d, v.hi.const // d)
        return TOP
    if name in ("bitwise_right_shift", "__rshift__"):
        k, v = _as_const(a(1)), a(0)
        if (k is not None and k >= 0 and v.lo is not None
                and v.hi is not None and v.lo.is_const and v.hi.is_const
                and v.lo.const >= 0):
            return iconst(v.lo.const >> k, v.hi.const >> k)
        return TOP
    if name in ("bitwise_and", "__and__"):
        return iand(ctx, a(0), a(1))
    if name in ("bitwise_or", "bitwise_xor", "__or__", "__xor__"):
        return ior(ctx, a(0), a(1), xor=name in ("bitwise_xor", "__xor__"))
    if name == "where":
        return iwhere(ctx, a(0), a(1), a(2))
    if name in ("lt", "le", "gt", "ge"):
        x, y = a(0), a(1)
        if name in ("gt", "ge"):
            x, y = y, x
        return icompare(ctx, x, y, strict=name in ("lt", "gt"))
    if name in ("eq", "ne", "logical_not", "logical_and", "logical_or",
                "isfinite", "isnan"):
        return iconst(0, 1)
    if name in ("argmax", "argmin"):
        shape = _shape(args[0])
        dim = args[1] if len(args) > 1 else kw.get("dim")
        n = 1
        if dim is None:
            for d in shape:
                n *= d
        elif shape:
            n = shape[int(dim) % len(shape)]
        return iconst(0, max(n - 1, 0))
    if name in ("index", "take", "index_select", "gather", "dynamic_slice"):
        return a(0)
    if name in ("index_put", "index_put_", "index_copy", "index_copy_",
                "scatter", "scatter_"):
        acc = ACCESS_OPS.get(node.target)
        return TOP if acc is None else ijoin(ctx, a(0), a(acc.values))
    if name in ("cat", "stack"):
        items = [_arg_ival(ival, x) for x in args[0]]
        out = items[0] if items else TOP
        for v in items[1:]:
            out = ijoin(ctx, out, v)
        return out
    return TOP


def _declared_ival(ctx: SymCtx, site: Site, ival: Dict[str, Ival]) -> Ival:
    """The address interval of a kernel op's declared access: the ids'
    interval through the kernel's int32 fence ``(ids & mask) | base``,
    its page map (an id outside the map resolves to page 0), its pool
    clamp ``& (extent - 1)``, and for an id out of range what the kernel
    does (``"nan"``, ``"drop"``: a negative id in ``[-V, 0)`` wraps once,
    an id outside ``[0, V)`` forms no address) — the transfer functions
    the plain version's aten graph goes through, in its order."""
    acc, node = site.decl, site.node

    def fence_part(names: Tuple[str, str]) -> Ival:
        t = _op_arg(node, names[0])
        iv = _arg_ival(ival, t) if t is not None else \
            _const_ival(_op_arg(node, names[1]))
        return ifit(ctx, iv, torch.int32)

    i32 = torch.int32
    iv = ifit(ctx, _arg_ival(ival, site.index), i32)
    iv = ifit(ctx, ior(ctx, iand(ctx, iv, fence_part(acc.mask)),
                       fence_part(acc.base)), i32)
    page_map = _op_arg(node, acc.page_map) if acc.page_map else None
    if page_map is not None:
        iv = ijoin(ctx, ifit(ctx, _arg_ival(ival, page_map), i32),
                   iconst(0))
    if acc.pool_clamp:
        iv = iand(ctx, iv, iconst(site.extent - 1))
    if acc.out_of_range in ("nan", "drop"):
        wrapped = ifit(ctx, iadd(iv, iconst(site.extent)), i32)
        iv = iwhere(ctx, icompare(ctx, iv, iconst(0), strict=True), wrapped,
                    iv)
        iv = imin(ctx, imax(ctx, iv, iconst(0)), iconst(site.extent - 1))
    return iv


def _abs_interpret(state: _AbsState, traced: Traced,
                   in_ivals: Sequence[Ival], record: bool = True
                   ) -> List[Ival]:
    """Walk one graph abstractly; returns its results' intervals.
    ``record=False`` runs the walk for its transfer functions alone (a
    loop fixpoint's passes), classifying no site and counting no node."""
    ival: Dict[str, Ival] = {}
    hops: Dict[str, List[Ival]] = {}
    gm = traced.gm
    it = iter(in_ivals)
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            ival[node.name] = next(it, TOP)
            continue
        if node.op == "get_attr":
            ival[node.name] = _const_ival(getattr(gm, node.target))
            continue
        if node.op == "output":
            return [_arg_ival(ival, a) for a in _flat_out(node)]
        if node.op != "call_function":
            continue
        if record:
            state.n_eqns += 1
        st = traced.subs.get(node.name)
        if st is not None:
            hops[node.name] = _abs_hop(state, traced, st, ival, record)
            continue
        if node.target is operator.getitem and \
                getattr(node.args[0], "name", None) in hops:
            ival[node.name] = hops[node.args[0].name][node.args[1]]
            continue
        for site in traced.all_sites.get(node.name, ()) if record else ():
            if site.opaque:
                _classify(state, site, TOP)
                continue
            if site.decl is not None:
                iv = _declared_ival(state.ctx, site, ival)
            else:
                iv = _arg_ival(ival, site.index)
                if traced.mode == "row":
                    state.index_ival[site.path] = iv
                if site.op.kind not in (ViolationKind.SLICE,
                                        ViolationKind.UPDATE):
                    iv = _normalize_ival(state.ctx, iv, site.extent)
            if site.tainted and (traced.mode == "extent" or site.dim == 0):
                _classify(state, site, iv)
        ival[node.name] = _abs_eval(state.ctx, node, ival)
    return []


def _abs_hop(state: _AbsState, traced: Traced, st: Structure,
             ival: Dict[str, Ival], record: bool) -> List[Ival]:
    """A higher-order node, abstractly (the reference's ``_abs_loop``):
    its results' intervals.  Structural only when an operand is tainted,
    as in the reference; otherwise its results are ⊤ and its bodies hold
    no arena site."""
    def tainted(a):
        return _is_node(a) and traced.tainted.get(a.name, False)

    if not any(tainted(a) for a in (*st.carry, *st.xs, *st.extra)):
        return [TOP] * len(st.out)
    ctx = state.ctx
    car = [_arg_ival(ival, a) for a in st.carry]
    if st.kind == "cond":
        out: Optional[List[Ival]] = None
        for body in st.bodies:
            got = _abs_interpret(state, body, car, record)
            out = got if out is None else [ijoin(ctx, a, b)
                                           for a, b in zip(out, got)]
        return out or []
    rest = [_arg_ival(ival, a) for a in (*st.xs, *st.extra)]
    loop = st.bodies[-1]
    car, outs = _fixpoint(state, loop, car, rest, st.node.name)
    if record:        # one recording pass at the fixpoint
        for body in st.bodies:
            outs = _abs_interpret(state, body, car + rest, True)
    # a while's results are its carries; a scan's its carries and the
    # stacked ys (a slice of each holds the body's interval)
    return car + (outs[len(car):] if st.kind == "scan" else [])


_MAX_FIX_ITERS = 16    # hard convergence guard (widening converges in ~3)


def _fixpoint(state: _AbsState, body: Traced, car: List[Ival],
              rest: List[Ival], name: str
              ) -> Tuple[List[Ival], List[Ival]]:
    """The carries' intervals at the loop fixpoint, widened from the
    second pass on (the reference's ``_fixpoint``), and the body's
    results there."""
    ctx = state.ctx
    for it in range(_MAX_FIX_ITERS):
        outs = _abs_interpret(state, body, car + rest, record=False)
        new = [ijoin(ctx, a, b) for a, b in zip(car, outs[:len(car)])]
        if it >= 1:
            new = [iwiden(ctx, old, nw) for old, nw in zip(car, new)]
        if all(ieq(a, b) for a, b in zip(new, car)):
            return car, outs
        car = new
    raise VerifierError(
        f"loop-carry interval fixpoint did not converge at `{name}` after "
        f"{_MAX_FIX_ITERS} iterations")


def verify_graph(traced: Traced, params: Optional[FenceParams] = None, *,
                 in_roles: Optional[Sequence[Optional[str]]] = None,
                 admissible: Sequence[Tuple[int, int]] = (),
                 dyn_role_pairs: Optional[Dict[int, Tuple[str, int]]] = None,
                 ) -> Tuple[SandboxProof, Dict[Tuple, Ival], SymCtx]:
    """The proof over a traced kernel, in the trace's mode.

    Row mode: static ``params`` give a concrete proof; ``None`` (or
    tensor-valued params) the symbolic-row proof, valid for every
    partition of an arena of ``arena_extent`` slots.  ``in_roles`` names
    placeholders that carry the row into the kernel (``"base"`` /
    ``"mask"`` / ``"size"``).

    Extent mode: ``admissible`` are the static guard partitions ``(base,
    size)`` found in the operands, and ``dyn_role_pairs`` maps a
    placeholder to ``(field, pair)`` — the ``"base"`` / ``"size"`` of a
    guard partition given as tensors, each pair with symbols of its own
    whose range is admissible too.

    Also returns each access's index interval (before the negative-index
    wrap) and the symbol context that decides them."""
    ctx = SymCtx()
    n_in = len(traced.dyn_pos)
    in_ivals: List[Ival] = [TOP] * n_in
    static = False
    if traced.mode == "row":
        static = (params is not None and isinstance(params.base, int)
                  and isinstance(params.size, int))
        if static:
            row_lo = lc(params.base)
            row_hi = lc(params.base + params.size - 1)
            base_iv, size_iv = iconst(params.base), iconst(params.size)
        else:
            b, s = ctx.new_pair(extent=traced.arena_extent)
            row_lo = Lin(0, ((b, 1),))
            row_hi = Lin(-1, ((b, 1), (s, 1)))
            base_iv = Ival(row_lo, row_lo)
            size_iv = Ival(Lin(0, ((s, 1),)), Lin(0, ((s, 1),)))
        roles = {"base": base_iv, "size": size_iv,
                 "mask": Ival(size_iv.lo.shift(-1), size_iv.hi.shift(-1))}
        for i, role in enumerate(in_roles or ()):
            if role in roles and i < n_in:
                in_ivals[i] = roles[role]
        target = _Target(row_lo, row_hi)
    else:
        adm = [(lc(b0), lc(b0 + s0 - 1)) for b0, s0 in admissible]
        pairs: Dict[int, Tuple[int, int]] = {}
        for pos, (field, pno) in sorted((dyn_role_pairs or {}).items()):
            if pno not in pairs:
                # a guard partition is a slot range of an int32 index
                # space: B + S <= 2**31, so its last slot is an int32
                pairs[pno] = ctx.new_pair(extent=1 << 31, tag=str(pno))
                b, s = pairs[pno]
                adm.append((Lin(0, ((b, 1),)), Lin(-1, ((b, 1), (s, 1)))))
            sym = pairs[pno][0 if field == "base" else 1]
            in_ivals[pos] = Ival(Lin(0, ((sym, 1),)), Lin(0, ((sym, 1),)))
        target = _Target(mode="extent", admissible=adm)
    state = _AbsState(ctx, target, traced)
    _abs_interpret(state, traced, in_ivals)
    proof = SandboxProof(sites=tuple(state.sites), mode=traced.mode,
                         symbolic=traced.mode == "row" and not static,
                         arg_sig=traced.arg_sig, n_eqns=state.n_eqns)
    return proof, state.index_ival, ctx


def roles_for(traced: Traced, bound_argnums: Sequence[int]
              ) -> List[Optional[str]]:
    """Placeholder roles of the ``(base, mask)`` argument positions."""
    roles: List[Optional[str]] = [None] * len(traced.dyn_pos)
    for role, argnum in zip(("base", "mask"), bound_argnums):
        if argnum in traced.dyn_pos:
            roles[traced.dyn_pos.index(argnum)] = role
    return roles


def guard_ranges(example_args: Sequence[Any]
                 ) -> Tuple[List[Tuple[int, int]], Dict[int, Tuple[str, int]]]:
    """The guard partitions among a step's operands, for extent mode:
    ``(admissible, dyn_role_pairs)`` — each static :class:`FenceParams`'s
    ``(base, size)``, and for each one whose base or size is a tensor the
    graph-input positions of those tensors (the tensor leaves in
    :func:`~repro_torch.core.stepgraph.tree_flatten` order) with the
    field and the partition's number."""
    admissible: List[Tuple[int, int]] = []
    pairs: Dict[int, Tuple[str, int]] = {}
    pos, pno = 0, 0

    def walk(x):
        nonlocal pos, pno
        if isinstance(x, FenceParams):
            fields = (("base", x.base), ("size", x.size),
                      ("magic_m", x.magic_m), ("magic_s", x.magic_s))
            dyn = any(isinstance(v, torch.Tensor) for _, v in fields[:2])
            if not dyn and isinstance(x.base, int) \
                    and isinstance(x.size, int):
                admissible.append((int(x.base), int(x.size)))
            for field, v in fields:
                if isinstance(v, torch.Tensor):
                    if field in ("base", "size"):
                        pairs[pos] = (field, pno)
                    pos += 1
            pno += dyn
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, torch.Tensor):
            pos += 1

    for a in example_args:
        walk(a)
    return admissible, pairs


def verify(fn: Callable, example_args: Sequence[Any],
           arena_argnums: Sequence[int] = (0,),
           bound_argnums: Sequence[int] = (),
           params: Optional[FenceParams] = None,
           mode: str = "row", device: Optional[Any] = None) -> SandboxProof:
    """Standalone bounds proof for ``fn(*example_args)``.

    ``mode="row"`` (a tenant kernel): ``bound_argnums`` names the two
    injected row parameters — ``(base_argnum, mask_argnum)`` — of a
    fence-aware kernel.  ``mode="extent"`` (a trusted step): the operands
    may be nested, the leaves of the ``arena_argnums`` arguments are the
    arena and the pool, and the guard partitions found among the operands
    (:func:`guard_ranges`) are admissible targets besides each operand's
    extent.  ``device`` traces every fake on that device (see
    :func:`trace_kernel`)."""
    traced = trace_kernel(fn, example_args, arena_argnums, mode=mode,
                          device=device)
    if mode == "row":
        proof, _, _ = verify_graph(traced, params,
                                   in_roles=roles_for(traced, bound_argnums))
    else:
        admissible, pairs = guard_ranges(example_args)
        proof, _, _ = verify_graph(traced, admissible=admissible,
                                   dyn_role_pairs=pairs)
    return proof


def refute_message(proof: SandboxProof, name: str = "<kernel>") -> str:
    lines = [f"kernel {name!r}: {proof.n_refuted} access site(s) are "
             "provably out-of-bounds on every launch:"]
    for s in proof.refuted_sites():
        lines.append("  " + s.row())
    lines.append("(the verifier refuses at trace time; fix the index "
                 "computation or register with verify=False to fall back "
                 "to runtime containment)")
    return "\n".join(lines)

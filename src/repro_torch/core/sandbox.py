"""Aten-graph kernel sandboxing — the "PTX-patcher" analogue (Guardian
§4.3).

The paper instruments the *virtual assembly* (PTX) of every tenant kernel,
inserting fence instructions before every load and store.  The PyTorch
analogue of the PTX is the **aten graph** of the tenant's function:
``make_fx`` traces it — library wrappers and Python helpers inlined — on
fake tensors of the arena's shape, dtype and device, so tracing never
reads or writes the live arena.  ``sandbox(fn, arena_argnums)`` walks that
graph and fences the *dim-0 index of every access to an arena-derived
operand*:

    index / take / index_select / gather ............ GATHER
    index_put(_) / index_copy(_) / index_add(_) /
    scatter(_) / scatter_add(_) / scatter_reduce(_) .. SCATTER
    dynamic_slice .................................... SLICE   (start
    dynamic_update_slice ............................. UPDATE   fenced and
                                                                 pinned)

Taint (which values are the arena's slot space) follows the reference:
the arena and its views and copies are tainted, a gather's output is not,
a scatter's output is.  A reshape or permute that splits or demotes dim 0
keeps taint and warns (:class:`GuardianTaintWarning`).  Everything the
walker cannot contain fails closed with :class:`SandboxError`: a value or
shape that depends on tensor data (``.item()``, a boolean mask, ``narrow``
with a tensor start), the higher-order ``cond`` / ``while_loop`` /
``scan``, any other op over the whole arena (it would read or write every
partition), a store through a view that moved the slot axis, and a first
result that is not the arena.

Indices are fenced in **int32**, as the reference's are with x64 off, and
widened back to the access's own index dtype (``take`` / ``gather`` /
``scatter`` want int64) only after the fence.  Every gather and scatter
first wraps negative indices (``i + extent``), as jnp does.  An access the
fence does not cover — a tenant-private tensor, the NONE policy, a
proven site on a view — keeps the out-of-range semantics of the
reference's jnp counterpart (``x[i]`` clamps, ``jnp.take`` fills with NaN,
``.at[i]`` scatters drop, ``dynamic_slice`` clamps its start), so no index
ever reaches an op out of range: on the card that would be a device-side
assert, which poisons the CUDA context of every tenant.  Those guards are
skipped wherever the verifier's interval proves the index inside the
operand.

Stores land **in place** in the live arena.  Under CHECK a caller may pass
an :class:`UndoLog`: each fenced store first saves the elements it will
overwrite, so a row whose ``ok`` is false is rolled back by restoring
exactly what it wrote — bytes in proportion to the row's stores, never an
arena-sized copy.

With ``verify=True`` the static verifier (:mod:`repro_torch.core.verifier`)
classifies every site first: PROVEN sites run unfenced, FENCED sites are
fenced, and a REFUTED site raises :class:`GuardianStaticViolation` at
trace time.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.fence import FenceParams, FencePolicy, apply_fence
from repro_torch.core.verifier import (
    PROVEN,
    GuardianStaticViolation,
    GuardianTaintWarning,
    SandboxError,
    SandboxProof,
    Site,
    Traced,
    dynamic_slice,
    dynamic_update_slice,
    lc,
    refute_message,
    roles_for,
    trace_kernel,
    verify_graph,
)
from repro_torch.core.violations import NUM_KINDS, ViolationKind

aten = torch.ops.aten

__all__ = [
    "SandboxError", "SandboxReport", "UndoLog", "sandbox", "sandbox_report",
    "GuardianStaticViolation", "GuardianTaintWarning", "dynamic_slice",
    "dynamic_update_slice",
]


@dataclasses.dataclass
class SandboxReport:
    """What the patcher did — Table 3 analogue (#loads/#stores
    safeguarded).  ``elided_*`` counts sites the static verifier PROVED
    in-bounds, so no fence was emitted (nonzero only under
    ``verify=True``)."""

    fenced_gathers: int = 0
    fenced_scatters: int = 0
    fenced_dynamic_slices: int = 0
    fenced_dynamic_updates: int = 0
    elided_gathers: int = 0
    elided_scatters: int = 0
    elided_dynamic_slices: int = 0
    elided_dynamic_updates: int = 0
    total_eqns: int = 0
    proof: Optional[SandboxProof] = None

    @property
    def fenced_total(self) -> int:
        return (self.fenced_gathers + self.fenced_scatters
                + self.fenced_dynamic_slices + self.fenced_dynamic_updates)

    @property
    def elided_total(self) -> int:
        return (self.elided_gathers + self.elided_scatters
                + self.elided_dynamic_slices + self.elided_dynamic_updates)


_REPORT_FIELD = {
    ViolationKind.GATHER: "gathers",
    ViolationKind.SCATTER: "scatters",
    ViolationKind.SLICE: "dynamic_slices",
    ViolationKind.UPDATE: "dynamic_updates",
}


class UndoLog:
    """The elements a launch's fenced arena stores overwrote, in store
    order: ``(target, index, old values, elementwise)``.  A CHECK row that
    violated is rolled back by restoring them in reverse order; the bytes
    moved are those the row wrote."""

    def __init__(self):
        self.entries: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 bool]] = []

    def save(self, target: torch.Tensor, index: torch.Tensor,
             elementwise: bool) -> None:
        old = target.gather(0, index) if elementwise else target[index]
        self.entries.append((target, index, old, elementwise))

    @staticmethod
    def _write(target, index, values, elementwise) -> None:
        if elementwise:
            target.scatter_(0, index, values)
        else:
            target.index_put_((index,), values)

    def rollback(self, ok: torch.Tensor) -> None:
        """Undo the stores where ``ok`` is false, on the device and with
        no host sync: each saved element is rewritten with its current
        value if ``ok``, its old one otherwise."""
        for target, index, old, ew in reversed(self.entries):
            cur = target.gather(0, index) if ew else target[index]
            self._write(target, index, torch.where(ok, cur, old), ew)

    @property
    def nbytes(self) -> int:
        """Bytes of arena elements the log holds (one copy of each)."""
        return sum(old.numel() * old.element_size()
                   for _, _, old, _ in self.entries)


class _OkAcc:
    """CHECK accumulator: violating elements per access kind, on the
    launch's device; ``ok`` is true when every count is zero."""

    def __init__(self, device=None):
        self.counts = torch.zeros(NUM_KINDS, dtype=torch.int32,
                                  device=device)

    def add(self, kind: ViolationKind, ok: torch.Tensor) -> None:
        self.counts[int(kind)].add_(
            torch.logical_not(ok).sum().to(torch.int32))

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.counts.sum() == 0, self.counts


#: what a fencing policy reports: it contains, it does not detect
_NO_CHECK = (torch.ones((), dtype=torch.bool),
             torch.zeros(NUM_KINDS, dtype=torch.int32))


@dataclasses.dataclass
class _Run:
    policy: FencePolicy
    params: Optional[FenceParams]
    acc: Optional[_OkAcc]
    undo: Optional[UndoLog]
    row_in_arena: bool
    pow2_row: bool           # see _row_facts


# --------------------------------------------------------------------------
# Out-of-range semantics of the reference's jnp ops (no index ever reaches
# a torch op out of range)
# --------------------------------------------------------------------------

def _fill_value(dtype: torch.dtype):
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed else \
        torch.iinfo(dtype).max


_REDUCE_IDENTITY = {"sum": 0.0, "prod": 1.0, "amax": float("-inf"),
                    "amin": float("inf")}


def _bshape(ok: torch.Tensor, ndim: int, at: int) -> torch.Tensor:
    """``ok`` viewed to broadcast over a tensor of ``ndim`` dims whose
    dims ``at .. at + ok.ndim`` are the index's."""
    return ok.view((1,) * at + tuple(ok.shape)
                   + (1,) * (ndim - at - ok.dim()))


def _identity_like(values: torch.Tensor, v) -> torch.Tensor:
    return torch.full((), v, dtype=values.dtype, device=values.device)


def _redirect_rows(i32, okm, vals, t0):
    """A "set" scatter of rows that drops out-of-range ones without a host
    sync: each dropped row rewrites the last kept row's index and value
    (so the last-writer result is unchanged), or, when none is kept,
    index 0 with the value already there."""
    n = i32.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=i32.device)
    last = torch.where(okm, pos, -1).amax().reshape(1)
    anyok = last >= 0
    lp = last.clamp(min=0)
    # index_select, not ``t[lp]``: a 0-d index would sync with the host
    tgt_i = torch.where(anyok, i32.index_select(0, lp), 0)
    shape = (1,) + (1,) * (vals.dim() - 1)
    tgt_v = torch.where(anyok.view(shape), vals.index_select(0, lp),
                        t0.unsqueeze(0))
    okb = okm.view((n,) + (1,) * (vals.dim() - 1))
    return torch.where(okm, i32, tgt_i), torch.where(okb, vals, tgt_v)


def _redirect_fibers(i32, okm, src, x, d):
    """The elementwise form of :func:`_redirect_rows` for ``scatter`` along
    dim ``d``: per fiber of the index (the elements that differ only along
    ``d``) the last kept element stands in for the dropped ones."""
    L = i32.shape[d]
    shape = [1] * i32.dim()
    shape[d] = L
    pos = torch.arange(L, device=i32.device).view(shape).expand_as(i32)
    last = torch.where(okm, pos, -1).amax(dim=d, keepdim=True)
    anyok = last >= 0
    lp = last.clamp(min=0)
    tgt_i = torch.where(anyok, i32.gather(d, lp), 0).to(i32.dtype)
    old = x.gather(d, torch.zeros_like(lp))
    tgt_v = torch.where(anyok, src.gather(d, lp), old)
    return torch.where(okm, i32, tgt_i), torch.where(okm, src, tgt_v)


# --------------------------------------------------------------------------
# The program: a traced kernel planned for one policy
# --------------------------------------------------------------------------

def _row_facts(params: Optional[FenceParams],
               extent: Optional[int]) -> Tuple[bool, bool]:
    """(the row lies inside the arena, its size is a power of two dividing
    the arena's extent).  A row given as tensors comes from the manager's
    partitions, which hold both (bitwise rows are pow2 by their builders'
    contract); static rows are checked."""
    if params is None or extent is None:
        return False, False
    base, size = params.base, params.size
    if isinstance(base, int) and isinstance(size, int):
        return (0 <= base and base + size <= extent,
                size > 0 and size & (size - 1) == 0 and extent % size == 0)
    return True, True


def _as_i32(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=like.device)


class _SiteStep:
    """One access node, planned: fence the dim-0 index of an arena access
    (unless proven), wrap negatives, and keep the reference's
    out-of-range semantics wherever the index is not known to be in
    range."""

    def __init__(self, site: Site, proven: bool, in_extent: bool,
                 nonneg: bool):
        self.site = site
        self.target = site.node.target
        self.proven = proven
        #: the index is provably inside the operand (no guard needed)
        self.in_extent = in_extent
        #: the index is provably nonnegative (no wrap needed)
        self.nonneg = nonneg

    # -- index -----------------------------------------------------------
    def _fence(self, i32, run: _Run):
        """(index, fenced?) — the fence applied to an arena index."""
        s = self.site
        if not s.tainted or self.proven or run.policy is FencePolicy.NONE:
            return i32, False
        fenced, ok = apply_fence(run.policy, i32, run.params)
        if ok is not None:
            run.acc.add(s.op.kind, ok)
        return fenced, True

    def _guarded(self, fenced: bool, run: _Run) -> bool:
        s = self.site
        if self.in_extent:
            return False
        return not ((fenced or self.proven) and s.tainted and s.exact
                    and run.row_in_arena)

    def __call__(self, args, kwargs, run: _Run):
        s = self.site
        args = list(args)
        if s.op.kind in (ViolationKind.SLICE, ViolationKind.UPDATE):
            return self._window(args, run)
        x = args[0]
        target = self.target
        fenced_site = (s.tainted and not self.proven
                       and run.policy is not FencePolicy.NONE)
        if s.op.listed:
            entries = list(args[s.op.index])
            raw = entries[s.list_pos]
        else:
            raw = args[s.op.index]
        if self.in_extent and not fenced_site:
            # provably in range: the access runs as traced, behind one
            # clamp to the operand that is a no-op unless the proof is
            # wrong (then it still keeps the device from asserting)
            self._set_index(args, entries if s.op.listed else None,
                            raw.clamp(0, s.extent - 1))
            self._save_undo(args, x, run)
            return target(*args, **kwargs)
        i32 = raw.to(torch.int32)
        # the bitwise fence of a pow2 row is blind to a wrap by the
        # arena's extent (a multiple of the row size): skip it there
        if not (self.nonneg or (fenced_site and s.exact and run.pow2_row
                                and run.policy is FencePolicy.BITWISE)):
            i32 = torch.where(i32 < 0, i32 + s.extent, i32)
        i32, fenced = self._fence(i32, run)
        guard = self._guarded(fenced, run)
        mode = s.op.native
        okm = None
        if guard:
            clamped = i32.clamp(0, s.extent - 1)
            if mode != "clamp":
                okm = clamped == i32
            if mode != "set":
                i32 = clamped
        if guard and mode == "set":
            args, target = self._redirect(args, kwargs, x, i32, okm)
        else:
            self._set_index(args, entries if s.op.listed else None,
                            i32.to(raw.dtype))
            if okm is not None and mode in ("add", "reduce"):
                args[s.op.values] = self._drop_values(args, kwargs, x, okm)
        self._save_undo(args, x, run)
        out = target(*args, **kwargs)
        if okm is not None and mode == "fill":
            out = torch.where(self._fill_mask(okm, out), out,
                              _identity_like(out, _fill_value(out.dtype)))
        return out

    def _set_index(self, args, entries, idx) -> None:
        s = self.site
        if entries is not None:
            entries[s.list_pos] = idx
            idx = entries
        args[s.op.index] = idx

    def _save_undo(self, args, x, run: _Run) -> None:
        s = self.site
        if (run.undo is not None and s.tainted and s.op.inplace
                and s.op.kind is ViolationKind.SCATTER):
            i = (args[s.op.index][s.list_pos] if s.op.listed
                 else args[s.op.index])
            run.undo.save(x, i.long(), elementwise=not s.op.rows)

    def _fill_mask(self, okm, out) -> torch.Tensor:
        s = self.site
        if self.target is aten.index_select.default:
            return _bshape(okm, out.dim(), s.dim)
        return okm

    def _drop_values(self, args, kwargs, x, okm) -> torch.Tensor:
        """Values of an accumulating scatter with the dropped elements set
        to the reduction's identity (they land on index 0 as no-ops)."""
        s = self.site
        vals = args[s.op.values]
        if s.op.native == "reduce":
            ident = _REDUCE_IDENTITY[args[4] if len(args) > 4
                                     else kwargs.get("reduce")]
        else:
            ident = 0
        vals = torch.as_tensor(vals).to(device=x.device, dtype=x.dtype)
        if s.op.rows and s.op.listed:
            full = (tuple(x.shape[:s.dim]) + tuple(okm.shape)
                    + tuple(x.shape[s.dim + 1:]))
            vals = vals.expand(full)
            okb = _bshape(okm, len(full), s.dim)
        elif s.op.rows:
            okb = _bshape(okm, vals.dim(), s.dim)
        else:
            vals = vals[tuple(slice(0, n) for n in okm.shape)]
            okb = okm
        return torch.where(okb, vals, _identity_like(vals, ident))

    def _redirect(self, args, kwargs, x, i32, okm):
        """Args of a "set" scatter whose out-of-range elements are dropped
        (see :func:`_redirect_rows`), in the op's own layout."""
        s = self.site
        d = s.dim
        raw_dtype = (args[s.op.index][s.list_pos] if s.op.listed
                     else args[s.op.index]).dtype
        if not s.op.rows:                       # scatter_(dim, index, src)
            src = torch.as_tensor(args[3]).to(device=x.device,
                                              dtype=x.dtype)
            src = src.expand(i32.shape) if src.dim() == 0 else \
                src[tuple(slice(0, n) for n in i32.shape)]
            i_new, v_new = _redirect_fibers(i32, okm, src, x, d)
            op = aten.scatter_.src if s.op.inplace else aten.scatter.src
            return [x, d, i_new.to(raw_dtype), v_new], op
        if s.op.listed:                          # index_put(_)
            vals = torch.as_tensor(args[2]).to(device=x.device,
                                               dtype=x.dtype)
            full = (tuple(x.shape[:d]) + tuple(i32.shape)
                    + tuple(x.shape[d + 1:]))
            n = i32.numel()
            moved = vals.expand(full).reshape(
                tuple(x.shape[:d]) + (n,) + tuple(x.shape[d + 1:])
            ).movedim(d, 0)
            i_new, v_new = _redirect_rows(
                i32.reshape(-1), okm.reshape(-1), moved, x.movedim(d, 0)[0])
            v_new = v_new.movedim(0, d).reshape(full)
            entries = [None] * d + [i_new.reshape(i32.shape).to(raw_dtype)]
            return [x, entries, v_new, *args[3:]], self.target
        src = args[3].movedim(d, 0)              # index_copy(_)
        i_new, v_new = _redirect_rows(i32, okm, src, x.movedim(d, 0)[0])
        return [x, d, i_new.to(raw_dtype), v_new.movedim(0, d)], self.target

    def _window(self, args, run: _Run):
        """SLICE / UPDATE: the start is fenced and pinned so the window
        stays inside the row (the reference's rewrite; the pin applies
        under every policy given a row), then clamped so it fits the
        operand (XLA's dynamic-slice semantics)."""
        s = self.site
        x, start = args[0], args[1]
        length = s.length
        s32 = start.to(torch.int32).reshape(())
        s32, _ = self._fence(s32, run)
        if s.tainted and not self.proven and run.params is not None:
            p = run.params
            hi = p.base + p.size - length
            hi = torch.maximum(_as_i32(hi, s32), _as_i32(p.base, s32))
            s32 = torch.minimum(s32, hi)
        s32 = s32.clamp(0, max(s.extent - length, 0))
        rows = s32.long() + torch.arange(length, device=x.device)
        if s.op.kind is ViolationKind.SLICE:
            return x[rows]
        if run.undo is not None and s.tainted:
            run.undo.save(x, rows, elementwise=False)
        x.index_put_((rows,), args[2].to(x.dtype))
        return None


class _Program(torch.fx.Interpreter):
    """A tenant kernel traced, verified and planned for one fence policy —
    the "sandboxed PTX" the manager caches per (kernel, mode, signature).
    :meth:`launch` interprets the aten graph on the real tensors, each
    access node through its planned :class:`_SiteStep`."""

    def __init__(self, traced: Traced, policy: FencePolicy,
                 verdicts: Optional[Dict[str, str]], proof, index_ival,
                 sym):
        super().__init__(traced.gm)
        self.extra_traceback = False
        self.traced = traced
        self.policy = policy
        self.proof = proof
        self.report = SandboxReport(proof=proof)
        self.site_steps: Dict[Any, _SiteStep] = {}
        self._run: Optional[_Run] = None
        for node in traced.gm.graph.nodes:
            if node.op != "call_function":
                continue
            self.report.total_eqns += 1
            site = traced.sites.get(node.name)
            if site is None:
                continue
            proven = verdicts is not None and verdicts.get(
                node.name) == PROVEN
            if site.tainted:
                field = _REPORT_FIELD[site.op.kind]
                pre = "elided_" if proven else "fenced_"
                setattr(self.report, pre + field,
                        getattr(self.report, pre + field) + 1)
            iv = index_ival.get(node.name)
            nonneg = bool(iv is not None and iv.lo is not None
                          and sym.le(lc(0), iv.lo))
            in_extent = bool(
                nonneg and iv.hi is not None
                and sym.le(iv.hi, lc(site.extent - site.length))
                and site.op.kind not in (ViolationKind.SLICE,
                                         ViolationKind.UPDATE))
            self.site_steps[node] = _SiteStep(site, proven, in_extent,
                                              nonneg)

    def run_node(self, n):
        # the base class also sets fx's current-node metadata, which
        # costs several microseconds a node and nothing here reads
        args, kwargs = self.fetch_args_kwargs_from_env(n)
        step = self.site_steps.get(n)
        if step is not None:
            return step(args, kwargs, self._run)
        return getattr(self, n.op)(n.target, args, kwargs)

    def launch(self, params: Optional[FenceParams], dyn_args: Sequence[Any],
               undo: Optional[UndoLog] = None):
        """``(outputs, ok, counts)`` of one launch over ``dyn_args`` (the
        kernel's tensor arguments, in order)."""
        check = self.policy is FencePolicy.CHECK
        inside, pow2 = _row_facts(params, self.traced.arena_extent)
        self._run = run = _Run(
            policy=self.policy, params=params,
            acc=_OkAcc(dyn_args[0].device) if check and dyn_args else None,
            undo=undo, row_in_arena=inside, pow2_row=pow2)
        try:
            out = self.run(*dyn_args, enable_io_processing=False)
        finally:
            self._run = None
            self.env = {}
        ok, counts = run.acc.result() if run.acc is not None else _NO_CHECK
        return out, ok, counts


class Sandboxed:
    """``sandboxed(fence_params, *args) -> (outputs, ok)`` (``(outputs,
    ok, counts)`` with ``count_violations``) — see :func:`sandbox`.
    :meth:`program` returns the planned program for one argument
    signature, which the manager caches."""

    def __init__(self, fn, arena_argnums, policy, count_violations, verify,
                 bound_argnums, on_proof):
        self.fn = fn
        self.arena_argnums = tuple(arena_argnums)
        self.policy = policy
        self.count_violations = count_violations
        self.verify = verify
        self.bound_argnums = tuple(bound_argnums)
        self.on_proof = on_proof
        self.kernel_name = getattr(fn, "__name__", "<kernel>")
        functools.update_wrapper(self, fn)

    def program(self, fence_params: Optional[FenceParams],
                args: Sequence[Any]) -> _Program:
        traced = trace_kernel(self.fn, args, self.arena_argnums)
        prog = _plan(traced, fence_params, self.policy, self.verify,
                     self.bound_argnums, self.kernel_name, self.on_proof)
        _constants_on(traced.gm, args[self.arena_argnums[0]].device)
        return prog

    def run(self, program: _Program, fence_params, args,
            undo: Optional[UndoLog] = None):
        dyn = [args[p] for p in program.traced.dyn_pos]
        out, ok, counts = program.launch(fence_params, dyn, undo)
        return (out, ok, counts) if self.count_violations else (out, ok)

    def __call__(self, fence_params: FenceParams, *args,
                 undo: Optional[UndoLog] = None):
        return self.run(self.program(fence_params, args), fence_params,
                        args, undo)


def _constants_on(gm: torch.fx.GraphModule, device: torch.device) -> None:
    """Move the trace's tensor constants (the value of ``arena[idx] =
    7.0`` is one, made on the host) to the launch's device, once, when
    the program is planned: a launch then copies nothing from the host,
    which a CUDA graph capture refuses."""
    for node in gm.graph.nodes:
        if node.op != "get_attr":
            continue
        owner, _, attr = node.target.rpartition(".")
        mod = gm.get_submodule(owner)
        val = getattr(mod, attr)
        if isinstance(val, torch.Tensor) and val.device != device:
            setattr(mod, attr, val.to(device))


def _plan(traced: Traced, params, policy, verify, bound_argnums,
          kernel_name, on_proof=None) -> _Program:
    static = params is not None and isinstance(params.base, int) \
        and isinstance(params.size, int)
    proof, index_ival, sym = verify_graph(
        traced, params if static else None,
        in_roles=roles_for(traced, bound_argnums))
    verdicts = None
    if verify:
        if proof.n_refuted:
            raise GuardianStaticViolation(refute_message(proof, kernel_name))
        verdicts = {s.path[0]: s.verdict for s in proof.sites}
        if on_proof is not None:
            on_proof(proof)
    return _Program(traced, policy, verdicts, proof if verify else None,
                    index_ival, sym)


def sandbox(
    fn: Callable,
    arena_argnums: Sequence[int] = (0,),
    policy: FencePolicy = FencePolicy.BITWISE,
    count_violations: bool = False,
    verify: bool = False,
    bound_argnums: Sequence[int] = (),
    on_proof: Optional[Callable[[SandboxProof], None]] = None,
) -> Sandboxed:
    """Instrument ``fn`` so every dynamic access to the arena args is
    fenced.

    Returns ``sandboxed(fence_params, *args) -> (outputs, ok)``; ``ok`` is
    a bool tensor, true unless the CHECK policy observed a violation
    (fencing policies contain, they do not detect).  With
    ``count_violations=True`` the return is ``(outputs, ok, counts)``:
    violating *elements* per access class, in
    :class:`~repro_torch.core.violations.ViolationKind` order.  A keyword
    ``undo=`` :class:`UndoLog` records what the fenced arena stores
    overwrite, for a selective rollback.

    ``verify=True`` runs the static verifier over each trace: PROVEN sites
    get no fence, REFUTED sites raise :class:`GuardianStaticViolation`.
    ``bound_argnums`` names the ``(base, mask)`` argument positions of a
    fence-aware kernel; ``on_proof`` receives each new proof.  Each call
    traces ``fn`` on fake tensors; the manager caches the planned program
    per argument signature instead (:meth:`Sandboxed.program`).
    """
    return Sandboxed(fn, arena_argnums, policy, count_violations, verify,
                     bound_argnums, on_proof)


def sandbox_report(
    fn: Callable,
    example_args: Sequence[Any],
    arena_argnums: Sequence[int] = (0,),
    policy: FencePolicy = FencePolicy.BITWISE,
    verify: bool = False,
    params: Optional[FenceParams] = None,
    bound_argnums: Sequence[int] = (),
) -> SandboxReport:
    """Dry-run the patcher and report how many accesses were safeguarded
    (Table 3).  Nothing is executed: the counts come from the plan.  With
    ``verify=True`` the report's ``proof`` carries the verifier's per-site
    classification and proven sites count as ``elided_*``;
    ``params=None`` verifies against the symbolic row."""
    traced = trace_kernel(fn, tuple(example_args), arena_argnums)
    return _plan(traced, params, policy, verify, bound_argnums,
                 getattr(fn, "__name__", "<kernel>")).report

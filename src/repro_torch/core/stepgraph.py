"""Compiled steps: one CUDA graph per (step, operand signature, width) —
the port's counterpart of the reference's "one compiled binary per key"
(``jax.jit`` of a trusted step or of N engines' steps fused, and of a
tenant kernel's sandboxed twin or of T tenants' launches fused).

A step's operands fall into three kinds, and the invariant that keeps a
replay inside its tenants' fences is stated over them:

* **by-value leaves** (ints, enums, ``None``): part of the cache key (see
  ``scheduler._arg_signature``), constant inside the graph — a value that
  changes gets a new graph, it is never frozen into an old one;
* **resident tensors** (the manager arena, the pool arena, the
  ViolationLog buffer, and the argument positions a step declares
  resident, such as an engine's weights): the graph addresses their
  storage directly, so their identity (pointer, shape, strides, dtype,
  device — :meth:`Operands.key`) is part of the key and they are never
  copied;
* **staged tensors** (every other tensor: tokens, page tables, sequence
  lengths, per-row fence rows, row policies, the page map, a tenant
  launch's row scalars, pointers and operands, the fused steps' fence and
  magic rows and ViolationLog row ids): copied into the graph's own
  persistent inputs immediately before each replay, at dispatch, never at
  enqueue.

So a graph replays only when every by-value leaf equals its captured value
and every tensor leaf either *is* the storage the graph captured or has
just been copied into the graph's persistent input.

On a CUDA device the first call of a key runs the step eagerly on a side
stream (its results are that call's; it also loads the kernel libraries
outside the capture), then captures it; later calls replay.  A step that
cannot be captured raises :class:`StepCaptureError` naming it — it never
runs eagerly instead.  Graphs capture into a memory pool of their own,
or into one ``pool`` that a caller shares among its graphs (sound when
their replays are serialised on one stream and every output that is not
resident is copied out before the next replay, as :meth:`StepGraph.run`
does).  On the CPU (only when the caller asked for it) the
same object calls the step on the same staged operands and copies the
results into the same persistent outputs a replay would fill, so a
staging or aliasing fault shows in a CPU test as it would on the card.

Outputs that are not resident tensors live in the graph and the next
replay of the key overwrites them: every call returns copies of them.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Hashable, Iterator, List, \
    Optional, Sequence, Tuple

import torch


#: the memory pools of the graphs being captured, innermost last
_POOLS: List[Any] = []


def capture_pool() -> Any:
    """The memory pool of the step graph being captured (a conditional
    node's body allocates from it)."""
    if not _POOLS:
        raise StepCaptureError("no step graph is being captured")
    return _POOLS[-1]


class StepCaptureError(RuntimeError):
    """A step that cannot be captured into a CUDA graph (a host sync, a
    pageable host-to-device copy, an ``.item()``, a fresh arena handed
    back...)."""


def tree_flatten(x: Any) -> Tuple[Hashable, List[Any]]:
    """``(struct, leaves)`` of a nested operand (dicts, lists, tuples,
    named tuples, dataclasses such as cache metas and guard specs, with
    tensors and scalars as leaves).  ``struct`` is hashable and rebuilds
    the operand with :func:`tree_unflatten`."""
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        subs = [tree_flatten(x[k]) for k in keys]
        return ((dict, keys, tuple(s for s, _ in subs)),
                [leaf for _, ls in subs for leaf in ls])
    if isinstance(x, (list, tuple)):
        subs = [tree_flatten(v) for v in x]
        return ((type(x), tuple(s for s, _ in subs)),
                [leaf for _, ls in subs for leaf in ls])
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        subs = [tree_flatten(getattr(x, n)) for n in names]
        return ((type(x), names, tuple(s for s, _ in subs)),
                [leaf for _, ls in subs for leaf in ls])
    return None, [x]


def tree_unflatten(struct: Hashable, leaves: Sequence[Any]) -> Any:
    """Inverse of :func:`tree_flatten`.  Builds through a module-level
    function: a nested recursive one would close over itself, a reference
    cycle that keeps ``leaves`` (a train step's gradients, GBs) alive
    until the cyclic garbage collector happens to run."""
    return _build(struct, iter(leaves))


def _build(s: Hashable, it: Iterator[Any]) -> Any:
    if s is None:
        return next(it)
    kind = s[0]
    if kind is dict:
        return {k: _build(sub, it) for k, sub in zip(s[1], s[2])}
    if len(s) == 2:
        vals = [_build(sub, it) for sub in s[1]]
        if kind is list:
            return vals
        return kind(*vals) if hasattr(kind, "_fields") else kind(vals)
    return kind(**{n: _build(sub, it) for n, sub in zip(s[1], s[2])})


@dataclasses.dataclass
class Operands:
    """A step's positional arguments, flattened: the structure, the leaves
    and the indices of the resident tensor leaves."""

    struct: Hashable
    leaves: List[Any]
    resident: Tuple[int, ...]

    @classmethod
    def of(cls, args: Sequence[Any], resident: Sequence[bool]) -> "Operands":
        """``resident[i]`` marks every tensor under ``args[i]`` resident."""
        structs, leaves, res = [], [], []
        for a, r in zip(args, resident):
            s, ls = tree_flatten(a)
            if r:
                res.extend(len(leaves) + j for j, leaf in enumerate(ls)
                           if isinstance(leaf, torch.Tensor))
            structs.append(s)
            leaves.extend(ls)
        return cls((tuple, tuple(structs)), leaves, tuple(res))

    def key(self) -> Tuple:
        """The identity of every resident tensor: the storage a graph
        addresses directly."""
        return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype,
                      t.device)
                     for t in (self.leaves[i] for i in self.resident))


class StepGraph:
    """One compiled step (see the module docstring).

    ``fn(*args)`` is the step; :meth:`run` takes each call's
    :class:`Operands` (whose structure and :meth:`Operands.key` the caller
    has matched against this graph's key) and returns the step's result
    tree, with resident outputs as the live resident tensors and every
    other tensor output as a fresh copy.  ``stream`` is the side stream
    the warm-up and the capture run on (``None`` on the CPU); ``pool`` a
    memory pool shared with other graphs (``None``: a pool of its own)."""

    def __init__(self, name: str, fn: Callable, ops: Operands,
                 device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None,
                 pool: Optional[Tuple[int, int]] = None):
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        self.stream = stream
        self.pool = pool
        self.struct = ops.struct
        resident = set(ops.resident)
        #: (leaf index, persistent input) of every staged tensor leaf
        self.staged: List[Tuple[int, torch.Tensor]] = [
            (i, leaf.clone()) for i, leaf in enumerate(ops.leaves)
            if isinstance(leaf, torch.Tensor) and i not in resident]
        self.graph = None
        #: whether the first call (and on the card the capture) is done
        self.ready = False
        self.out_struct: Hashable = None
        #: per output leaf: ("resident", input leaf index) | ("static",
        #: persistent output) | ("value", by-value leaf)
        self.out_spec: List[Tuple[str, Any]] = []
        self.launches: Dict[Any, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0

    # ------------------------------------------------------------------ #
    def _inputs(self, leaves: Sequence[Any]) -> Tuple:
        inputs = list(leaves)
        for i, t in self.staged:
            inputs[i] = t
        return tree_unflatten(self.struct, inputs)

    def _stage(self, leaves: Sequence[Any]) -> None:
        for i, t in self.staged:
            t.copy_(leaves[i])

    def _outputs(self, leaves: Sequence[Any]) -> Any:
        out = [leaves[v] if kind == "resident"
               else v.clone() if kind == "static" else v
               for kind, v in self.out_spec]
        return tree_unflatten(self.out_struct, out)

    def _spec(self, out: Any, inputs: Sequence[Any],
              resident: Sequence[int]) -> None:
        """Classify the output leaves of the first call (CPU) or of the
        capture (card): a resident input returned as is stays live."""
        self.out_struct, leaves = tree_flatten(out)
        by_id = {id(inputs[i]): i for i in resident}
        self.out_spec = [
            ("resident", by_id[id(leaf)]) if id(leaf) in by_id
            else ("static", leaf) if isinstance(leaf, torch.Tensor)
            else ("value", leaf) for leaf in leaves]

    # ------------------------------------------------------------------ #
    def run(self, ops: Operands) -> Any:
        if not self.ready:
            # set only once the first call (and on the card the capture)
            # succeeded: a step that failed to capture fails again, it
            # never falls through to an eager run
            out = self._first(ops)
            self.ready = True
            return out
        self._stage(ops.leaves)
        if self.graph is not None:
            self.graph.replay()
            for kernel, n in self.launches.items():
                kernel.launches += n
        else:
            _, res = tree_flatten(self.fn(*self._inputs(ops.leaves)))
            for (kind, static), leaf in zip(self.out_spec, res):
                if kind == "static" and leaf is not static:
                    static.copy_(leaf)
        self.replays += 1
        return self._outputs(ops.leaves)

    def _first(self, ops: Operands) -> Any:
        args = self._inputs(ops.leaves)
        _, inputs = tree_flatten(args)
        if self.device.type != "cuda":
            out = self.fn(*args)
            self._spec(out, inputs, ops.resident)
            return self._outputs(ops.leaves)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = self.fn(*args)
        current.wait_stream(self.stream)
        # this call's results come from the warm-up, copied as a replay's
        # are (an output may be a staged input passed through)
        self._spec(out, inputs, ops.resident)
        first = self._outputs(ops.leaves)
        self._capture(ops)
        return first

    def _capture(self, ops: Operands) -> None:
        """Record the step into a CUDA graph, in its own memory pool or
        the shared ``pool``.
        The step gets argument objects of its own: a value the warm-up
        cached on an argument (a guard's ``FenceParams.mask``) would
        otherwise reach the graph as a tensor computed outside it, frozen
        at the warm-up's operands.  Nothing runs on the card while it
        records: the launch counts the step's wrappers add are taken back
        and kept as the graph's per-replay deltas."""
        from repro_torch.kernels import _build

        args = self._inputs(ops.leaves)
        _, inputs = tree_flatten(args)
        counts = {k: k.launches for k in _build.KERNELS.values()}
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        # a pool of the graph's own, named, so that a conditional node's
        # body can allocate from it (capture_pool)
        pool = self.pool if self.pool is not None else \
            torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        failure = None
        _POOLS.append(pool)
        # no cyclic collection while recording: it could free an
        # unreachable graph of an earlier step, and a graph's teardown
        # during a capture invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=pool)
                try:
                    out = self.fn(*args)
                except RuntimeError as err:    # the operation refused
                    failure = err
                finally:
                    try:
                        graph.capture_end()
                    except RuntimeError as err:
                        failure = failure or err
        finally:
            if collecting:
                gc.enable()
            _POOLS.pop()
            self.launches = {k: k.launches - n for k, n in counts.items()
                             if k.launches != n}
            for k, n in counts.items():
                k.launches = n
        if failure is not None:
            raise StepCaptureError(
                f"step {self.name!r} cannot be captured into a CUDA "
                f"graph: {failure}") from failure
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._spec(out, inputs, ops.resident)
        self.graph = graph

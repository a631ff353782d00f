"""Trip-count-aware cost analysis over a step's traced aten graph: the
port's counterpart of ``repro/launch/hlo_analysis.py``.

The reference parses the post-SPMD HLO text of a compiled step.  The port
has no HLO: what a step lowers to is the aten graph ``make_fx`` records
over fake tensors (:func:`trace_step`; nothing is allocated, read or
launched), with the port's Python loops unrolled and each hand-written
kernel one ``repro_torch::<kernel>`` node.  :class:`GraphCostModel` walks
that graph with the reference's rules, one for one:

    flops               dot FLOPs: ``mm`` / ``addmm`` / ``bmm`` /
                        ``baddbmm`` / ``convolution`` / ``_scaled_mm``,
                        2 x result elements x contracted elements, and
                        each kernel's own rule (:data:`KERNEL_COSTS`)
    vector_flops        one flop per output element of every other op
    bytes               every op's operand + result bytes (an in-place
                        op's written operand once); views, aliases and
                        pytree nodes are free, as the reference's
                        ``_SKIP_OPS`` are
    collective_bytes    operand bytes of ``_c10d_functional`` / ``c10d``
                        ops, by the reference's kind names (none on one
                        card)

``scan`` bodies count x their scanned length, ``while_loop`` bodies x the
trip count (the largest int constant in the condition graph, as the
reference reads a ``while``'s), ``cond`` as its worst branch.
:func:`peak_live_bytes` is the counterpart of XLA's
``memory_analysis()``: a liveness walk over the graph's storages.

On a production mesh the graph is one device's program: the step is
partitioned by DTensor over a fake process group and traced as rank 0
(:meth:`repro_torch.launch.steps.StepBundle.partitioned`), so every
count is per device, as the reference reads its partitioned HLO, and the
collectives the partition needs are ``_c10d_functional`` nodes
(``all_gather_into_tensor`` -> all-gather, ``all_reduce`` -> all-reduce,
``reduce_scatter_tensor`` -> reduce-scatter, DTensor's
``_dtensor::shard_dim_alltoall`` -> all-to-all; ``wait_tensor`` is the
reference's ``-done``, free).

The model is deterministic and structural: counts from shapes, no clock
and no device, so the dry run (:mod:`repro_torch.launch.dryrun`) and the
kernel table's bounds (``chip_smoke.py`` phase 2) read the same rules.
"""

from __future__ import annotations

import contextlib
import dataclasses
import operator
from typing import Any, Callable, Dict, List, NamedTuple, Optional, \
    Sequence, Tuple

import torch

aten = torch.ops.aten

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast",
                "ragged-all-to-all")

#: the dot ops: 2 x result elements x contracted elements
_DOTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
         aten.baddbmm.default, aten.convolution.default,
         aten._scaled_mm.default}

#: ops that cost nothing: views the schema does not mark (``_unsafe_view``
#: of a fresh result), shape queries, and the counterparts of the
#: reference's ``iota`` / ``constant`` / allocation (no traffic)
_FREE = {aten._unsafe_view.default, aten.sym_size.int,
         aten.sym_stride.int, aten.sym_numel.default,
         aten.sym_storage_offset.default, aten.arange.default,
         aten.arange.start, aten.arange.start_step,
         aten.scalar_tensor.default, aten.lift_fresh_copy.default,
         aten.empty.memory_format, aten.empty_strided.default,
         aten.new_empty.default, aten.new_empty_strided.default,
         aten.empty_like.default}

#: ops with a workspace whose size depends on the device: the CPU kernel
#: of ``log_sigmoid_forward`` hands back a buffer of the input's shape that
#: its backward reads, the CUDA kernel an empty one; neither the result
#: nor the operand is counted, so what is counted does not depend on the
#: device (op -> the result / the operand position of the workspace)
_WORKSPACE_RESULT = {aten.log_sigmoid_forward.default: 1}
_WORKSPACE_OPERAND = {aten.log_sigmoid_backward.default: 2}

#: a collective op's kind, by a word of its name (``_c10d_functional`` /
#: ``c10d`` namespaces, and DTensor's ``_dtensor::shard_dim_alltoall``);
#: ``wait_tensor`` is the reference's ``-done``
_COLLECTIVE_WORDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("broadcast", "collective-broadcast"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    vector_flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def scaled(self, f: float) -> "Costs":
        return Costs(
            flops=self.flops * f, vector_flops=self.vector_flops * f,
            bytes=self.bytes * f,
            collectives={k: v * f for k, v in self.collectives.items()},
            collective_counts={k: int(v * f) for k, v in
                               self.collective_counts.items()})

    def add(self, o: "Costs") -> None:
        self.flops += o.flops
        self.vector_flops += o.vector_flops
        self.bytes += o.bytes
        for k in self.collectives:
            self.collectives[k] += o.collectives[k]
            self.collective_counts[k] += o.collective_counts[k]


# ---------------------------------------------------------------------------
# The kernels' cost rules (one per custom op, from its shapes)
# ---------------------------------------------------------------------------

class KernelCost(NamedTuple):
    """A kernel call's work: ``flops`` (dot-class operations), ``bytes``
    (each input read once, each output written once)."""

    flops: float
    bytes: float


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def paged_attention_cost(q, k_pages, page_table, base_rows=None,
                         mask_rows=None, *,
                         positions: Optional[int] = None,
                         k_tokens: Optional[int] = None,
                         v_tokens: Optional[int] = None) -> KernelCost:
    """K1: ``4 * H * D`` FLOPs per (row, position) it walks (QK^T and PV),
    and bytes: q read, the output written, each K and V token row it
    reads in the pool's type, the table, the lens and the per-row fence
    operands.  The counts a trace cannot know default to the extent the
    table allows: ``positions`` every row's pages x page size,
    ``k_tokens`` / ``v_tokens`` the pages the table can reach (at most the
    pool's) x page size.  A caller that holds the data passes what it
    walks."""
    B, H, D = q.shape
    P, page, KH = k_pages.shape[:3]
    n = page_table.shape[1]
    if positions is None:
        positions = B * n * page
    reach = min(B * n, P) * page
    k_tokens = reach if k_tokens is None else k_tokens
    v_tokens = reach if v_tokens is None else v_tokens
    n_bytes = ((k_tokens + v_tokens) * KH * D * k_pages.element_size()
               + 2 * B * H * D * q.element_size() + page_table.numel() * 4
               + B * 4 + _nbytes(base_rows) + _nbytes(mask_rows))
    return KernelCost(4.0 * positions * H * D, float(n_bytes))


#: K4's tiles (``kBQ`` / ``kBK`` of ``csrc/flash_attention.cu``)
FLASH_BQ = 64
FLASH_BK = 64


def flash_pairs(Sq: int, Skv: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs of the key tiles K4 visits: each 64-row
    query tile walks the key tiles from the window's first (0 without
    one) to the diagonal's (the last with ``causal=False``)."""
    pairs = 0
    for q0 in range(0, Sq, FLASH_BQ):
        last = min(q0 + FLASH_BQ, Sq) - 1
        hi = last // FLASH_BK + 1 if causal else -(-Skv // FLASH_BK)
        lo = max(q0 - window + 1, 0) // FLASH_BK if window > 0 else 0
        keys = min(hi * FLASH_BK, Skv) - lo * FLASH_BK
        pairs += (last + 1 - q0) * max(keys, 0)
    return pairs


def flash_attention_cost(q, k, causal: bool, window: int = 0, *,
                         pairs: Optional[int] = None) -> KernelCost:
    """K4: ``4 * B * H * D`` FLOPs per (query, key) pair (QK^T and PV),
    ``pairs`` defaulting to the tiles the kernel visits
    (:func:`flash_pairs`: the causal half on or below the diagonal, the
    window's band); bytes: q, k and v read, the output written."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if pairs is None:
        pairs = flash_pairs(Sq, Skv, causal, window)
    n_bytes = (2 * B * Sq * H + 2 * B * Skv * KH) * D * q.element_size()
    return KernelCost(4.0 * B * H * D * pairs, float(n_bytes))


def gather_rows_cost(table, idx, base_ids=None, mask_ids=None, *,
                     rows: Optional[int] = None) -> KernelCost:
    """K3: ``rows`` table rows read (default: every id's; a caller that
    holds the ids passes those inside the table), every output row
    written, the ids and per-id fence operands read."""
    N, D = idx.shape[0], table.shape[1]
    rows = N if rows is None else rows
    n_bytes = ((rows + N) * D * table.element_size() + N * 4
               + _nbytes(base_ids) + _nbytes(mask_ids))
    return KernelCost(0.0, float(n_bytes))


def gather_rows_backward_cost(table, grad, idx, base_ids=None,
                              mask_ids=None) -> KernelCost:
    """K3's backward: the gradient table written whole (zeros but the
    rows it scatters), the N gradient rows it scatters read, the ids and
    per-id fence operands read."""
    n_bytes = (_nbytes(table) + _nbytes(grad) + idx.numel() * 4
               + _nbytes(base_ids) + _nbytes(mask_ids))
    return KernelCost(0.0, float(n_bytes))


def scatter_pages_cost(k_pool, k_src, ids, base_ids=None, mask_ids=None, *,
                       pages: Optional[int] = None) -> KernelCost:
    """K2: for K and V, each page it stores written whole in the pool's
    type and its share of the source tokens read (a row's S tokens over
    its n pages), plus the ids and the fence operands.  ``pages``
    defaults to every id's page; a caller that holds the ids passes the
    distinct pages kept (last writer wins)."""
    B, S, KH, D = k_src.shape
    page = k_pool.shape[1]
    n_ids = ids.numel()
    pages = n_ids if pages is None else pages
    src_tokens = B * S * pages / n_ids if n_ids else 0
    n_bytes = (2 * (src_tokens * KH * D * k_src.element_size()
                    + pages * page * KH * D * k_pool.element_size())
               + n_ids * 4 + _nbytes(base_ids) + _nbytes(mask_ids))
    return KernelCost(0.0, float(n_bytes))


def moe_histogram_cost(expert_ids, num_experts: int) -> KernelCost:
    """K5: the ids read once, the bins written once."""
    return KernelCost(0.0, float(expert_ids.numel() * 4 + num_experts * 4))


def _k1(q, k_pages, v_pages, page_table, seq_lens, base_rows, mask_rows,
        *rest):
    return paged_attention_cost(q, k_pages, page_table, base_rows,
                                mask_rows)


def _k4(q, k, v, causal, window):
    return flash_attention_cost(q, k, causal, window)


def _k3(table, idx, base_ids, mask_ids, *rest):
    return gather_rows_cost(table, idx, base_ids, mask_ids)


def _k3_backward(table, grad, idx, base_ids, mask_ids, *rest):
    return gather_rows_backward_cost(table, grad, idx, base_ids, mask_ids)


def _k2(k_pool, v_pool, k_src, v_src, ids, base_ids, mask_ids, *rest):
    return scatter_pages_cost(k_pool, k_src, ids, base_ids, mask_ids)


def _k5(expert_ids, num_experts, *rest):
    return moe_histogram_cost(expert_ids, num_experts)


#: each ``repro_torch::<op>``'s rule over the node's arguments (fake
#: tensors and the baked scalars), and the kernel its node launches
#: (None: the op launches no kernel of the port's)
KERNEL_COSTS: Dict[str, Tuple[Callable[..., KernelCost], Optional[str]]] = {
    "paged_attention": (_k1, "paged_attention"),
    "flash_attention": (_k4, "flash_attention"),
    "gather_rows": (_k3, "gather_rows"),
    "gather_rows_backward": (_k3_backward, None),
    "scatter_pages": (_k2, "scatter_pages"),
    "moe_histogram": (_k5, "moe_histogram"),
}


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

class _NoBackwardOnCudaFakes(torch.overrides.TorchFunctionMode):
    """Refuses a backward pass over CUDA fakes on a build of torch without
    CUDA: its autograd engine asks for a CUDA device guard there and the
    process is terminated, so the step is stopped before it reaches it."""

    _REFUSED = {torch.Tensor.requires_grad_, torch.autograd.grad,
                torch.autograd.backward, torch.Tensor.backward}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self._REFUSED:
            raise RuntimeError(_NO_CUDA_BACKWARD)
        return func(*args, **(kwargs or {}))


_NO_CUDA_BACKWARD = (
    "a backward pass cannot be traced on cuda fakes: this build of torch "
    "has no CUDA (its autograd engine would end the process); trace it on "
    "the card, or on device='cpu'")


def _cuda_fakes_without_cuda(device) -> bool:
    return torch.device(device).type == "cuda" and \
        not torch.backends.cuda.is_built()


def refuse_cuda_backward(device) -> None:
    """Raise, before any trace, where a step with a backward pass cannot
    be traced on ``device``'s fakes: CUDA fakes without a CUDA build."""
    if _cuda_fakes_without_cuda(device):
        raise RuntimeError(_NO_CUDA_BACKWARD)


#: the loops a trace cuts (:func:`repro_torch.models.ssd.cut_loops`)
LOOP_KINDS = ("ssd", "slstm")


def trace_step(fn: Callable, args: Sequence[Any],
               device) -> torch.fx.GraphModule:
    """``fn(*args)`` traced into an aten graph over fresh fake tensors of
    the shapes, strides and dtypes of ``args``' tensor leaves (``meta``
    specs or real tensors; every leaf a graph input, in
    :func:`~repro_torch.core.stepgraph.tree_flatten` order) on
    ``device``, with :func:`~repro_torch.core.verifier.fake_trace`.  The
    graph returns the tensor leaves of ``fn``'s result, flattened;
    ``gm.meta`` keeps ``"arg_of_input"`` (each graph input's argument
    position), ``"out_struct"``, ``"out_leaves"`` and ``"out_leaf"`` (the
    result's structure, its leaf count and, per graph output, its leaf
    index) and ``"device"``.

    The loops the reference scans and the port unrolls (the SSD's chunks,
    the sLSTM's positions: :data:`LOOP_KINDS`) are cut to two steps each
    (:func:`~repro_torch.models.ssd.cut_loops`); for each kind that was
    cut, a second trace runs it three steps, kept in ``gm.meta["loops"]``
    as ``kind -> (steps, graph)``, and the cost model and
    :func:`peak_live_bytes` extrapolate to the loop's steps: every step
    but the first and the last does what the third does (the reference's
    trip-count rule, applied to a loop the trace does not keep).  Nothing
    is allocated on the device and no kernel is launched; the collectives
    of a cut loop are extrapolated with the rest.  ``fn`` may make
    DTensors of its arguments (a partitioned step: the arguments are one
    rank's shards, :meth:`~repro_torch.launch.steps.StepBundle.
    partitioned`, marked ``partitioned``); the trace is then that rank's
    program, its dead nodes dropped.  On CUDA fakes
    without a CUDA build a backward pass raises :class:`RuntimeError`
    where it starts."""
    from repro_torch.core.stepgraph import tree_flatten
    from repro_torch.core.verifier import fake_trace
    from repro_torch.models.ssd import cut_loops

    dev = torch.device(device)
    guard = _NoBackwardOnCudaFakes() if _cuda_fakes_without_cuda(dev) \
        else contextlib.nullcontext()
    out: Dict[str, Any] = {}

    def flat(*a):
        with guard:
            struct, leaves = tree_flatten(fn(*a))
        idx = [i for i, x in enumerate(leaves)
               if isinstance(x, torch.Tensor)]
        out.update(struct=struct, leaf=idx, n=len(leaves))
        return [leaves[i] for i in idx]

    def traced(trips):
        with cut_loops(trips) as steps:
            gm, dyn_pos = fake_trace(flat, args, flatten=True, device=dev)
        if getattr(fn, "partitioned", False):
            # some torch versions (2.11) also record each op over
            # DTensors at the global level, on fresh global-shaped
            # tensors whose results nothing reads: not the rank's work
            gm.graph.eliminate_dead_code()
            gm.recompile()
        return gm, dyn_pos, dict(steps)

    two = {kind: 2 for kind in LOOP_KINDS}
    gm, dyn_pos, steps = traced(two)
    loops = {kind: (n, traced({**two, kind: 3})[0])
             for kind, n in steps.items()}
    gm.meta.update(arg_of_input=list(dyn_pos), out_struct=out["struct"],
                   out_leaf=out["leaf"], out_leaves=out["n"], device=dev,
                   loops=loops)
    return gm


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _value(gm, a):
    """A node argument's value: its fake (a graph value), a constant
    tensor of the module, or the literal."""
    if isinstance(a, torch.fx.Node):
        if a.op == "get_attr":
            return getattr(gm, a.target)
        return a.meta.get("val")
    if isinstance(a, (list, tuple)):
        return type(a)(_value(gm, v) for v in a)
    return a


def _results(node) -> List[torch.Tensor]:
    """A node's result tensors but a device-dependent workspace."""
    res = _tensors(node.meta.get("val"))
    k = _WORKSPACE_RESULT.get(node.target)
    return res if k is None else res[:k] + res[k + 1:]


def _elems(ts) -> int:
    return sum(t.numel() for t in ts)


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def is_view(target) -> bool:
    """An aten op whose every result aliases an input without writing it
    (``view``, ``expand``, ``permute``, ``select``, ``split``, ``detach``,
    ``alias``, ...), by its schema."""
    schema = getattr(target, "_schema", None)
    if schema is None or not schema.returns:
        return False
    return all(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns)


def _written(target, args, kwargs) -> List[torch.Tensor]:
    """The tensors an op writes in place, by its schema."""
    schema = getattr(target, "_schema", None)
    if schema is None:
        return []
    out = []
    for i, a in enumerate(schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            out += _tensors(args[i] if i < len(args) else kwargs.get(a.name))
    return out


def _returns_written(target) -> bool:
    schema = getattr(target, "_schema", None)
    return schema is not None and any(
        r.alias_info is not None and r.alias_info.is_write
        for r in schema.returns)


def _collective_kind(target) -> Optional[str]:
    ns = getattr(target, "namespace", "")
    if ns not in ("_c10d_functional", "c10d", "c10d_functional",
                  "_dtensor"):
        return None
    name = target.__name__.split(".")[0]
    if "wait" in name:
        return ""
    return next((kind for word, kind in _COLLECTIVE_WORDS if word in name),
                "")


def _is_skipped(node) -> bool:
    """Placeholders, the output, ``getitem``, views, the pytree class
    nodes ``make_fx`` records for the cache dataclasses, shape queries
    and the free ops."""
    if node.op in ("placeholder", "output", "get_attr"):
        return True
    t = node.target
    return (t is operator.getitem or isinstance(t, type) or t in _FREE
            or is_view(t))


def _hop_parts(gm, node):
    """A higher-order node's kind and bodies (the verifier's parse)."""
    from repro_torch.core.verifier import COND, SCAN, WHILE

    body = lambda n: getattr(gm, n.target)  # noqa: E731
    a = node.args
    if node.target is COND:
        return "cond", [body(a[1]), body(a[2])], None
    if node.target is WHILE:
        return "while", [body(a[0]), body(a[1])], None
    if node.target is SCAN:
        xs = _tensors(_value(gm, a[2]))
        return "scan", [body(a[0])], xs[0].shape[0] if xs else 1
    raise ValueError(f"graph analysis: higher-order op `{node.target}` "
                     "has no cost rule")


def trip_count(cond_gm) -> int:
    """Largest int constant in a ``while_loop``'s condition graph, as the
    reference reads the s32 constants of a ``while``'s condition."""
    best = 1
    for n in cond_gm.graph.nodes:
        for a in (*n.args, *n.kwargs.values()):
            if isinstance(a, int) and not isinstance(a, bool):
                best = max(best, a)
    return best


class GraphCostModel:
    """The reference's ``HloCostModel`` over a traced ``GraphModule``:
    :meth:`analyze` gives the program's :class:`Costs`, :attr:`ops` each
    counted op's calls (``aten.mm.default`` ...), :attr:`launches` the
    hand-written kernels' launches by kernel name."""

    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.ops: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self._costs: Optional[Costs] = None

    def analyze(self) -> Costs:
        if self._costs is not None:
            return self._costs
        base = self._walk(self.gm, 1)
        counts = (dict(self.ops), dict(self.launches))
        self._costs = Costs()
        self._costs.add(base)
        for n, g3 in self.gm.meta.get("loops", {}).values():
            # each further step of the loop adds what its third one added
            more = GraphCostModel(g3)
            step = more.analyze()
            step.add(base.scaled(-1))
            self._costs.add(step.scaled(n - 2))
            for mine, was, theirs in zip((self.ops, self.launches), counts,
                                         (more.ops, more.launches)):
                for k in set(was) | set(theirs):
                    mine[k] = mine.get(k, 0) + (n - 2) * (
                        theirs.get(k, 0) - was.get(k, 0))
                    if not mine[k]:
                        del mine[k]
        return self._costs

    def _count(self, table: Dict[str, int], key: str, times: int) -> None:
        table[key] = table.get(key, 0) + times

    def _walk(self, gm, times: int) -> Costs:
        """``gm``'s costs; ``times`` is how often it runs in the program
        (a loop body's trips), for the op and launch counts."""
        total = Costs()
        for node in gm.graph.nodes:
            if node.op != "call_function" or _is_skipped(node):
                continue
            t = node.target
            if isinstance(t, torch._ops.HigherOrderOperator):
                kind, bodies, length = _hop_parts(gm, node)
                if kind == "cond":
                    subs = [self._walk(b, 0) for b in bodies]
                    worst = max(range(len(subs)), key=lambda i:
                                subs[i].flops + subs[i].bytes)
                    total.add(self._walk(bodies[worst], times))
                elif kind == "while":
                    trip = trip_count(bodies[0])
                    total.add(self._walk(bodies[1], times * trip)
                              .scaled(trip))
                else:
                    total.add(self._walk(bodies[0], times * length)
                              .scaled(length))
                self._count(self.ops, str(t), times)
                continue
            args = [_value(gm, a) for a in node.args]
            if t in _WORKSPACE_OPERAND:
                args[_WORKSPACE_OPERAND[t]] = None
            kwargs = {k: _value(gm, v) for k, v in node.kwargs.items()}
            res = _results(node)
            name = str(t)
            self._count(self.ops, name, times)
            coll = _collective_kind(t)
            if coll is not None:
                if coll:
                    b = _bytes(_tensors(args)) or _bytes(res)
                    total.collectives[coll] += b
                    total.collective_counts[coll] += 1
                    total.bytes += b + _bytes(res)
                continue
            if getattr(t, "namespace", "") == "repro_torch":
                op = t.__name__.split(".")[0]
                if op not in KERNEL_COSTS:
                    raise ValueError(f"graph analysis: custom op `{name}` "
                                     "has no cost rule")
                rule, kernel = KERNEL_COSTS[op]
                c = rule(*args, **kwargs)
                total.flops += c.flops
                total.bytes += c.bytes
                total.vector_flops += _elems(res)
                if kernel:
                    self._count(self.launches, kernel, times)
                continue
            ins = _tensors(args) + _tensors(list(kwargs.values()))
            if t in _DOTS:
                total.flops += _dot_flops(t, args, res)
                total.bytes += _bytes(ins) + _bytes(res)
                continue
            # an in-place op's results are its written operands
            fresh = [] if _returns_written(t) else res
            total.bytes += _bytes(ins) + _bytes(fresh)
            total.vector_flops += _elems(fresh) + _elems(
                _written(t, args, kwargs))
        return total


def _dot_flops(t, args, res) -> float:
    """2 x result elements x contracted elements."""
    out = _elems(res)
    if t in (aten.addmm.default, aten.baddbmm.default):
        return 2.0 * out * args[1].shape[-1]
    if t is aten.convolution.default:
        # the weights an output element meets (an input element's, for a
        # transposed convolution, whose weight is (C_in, C_out / groups, k))
        x, w, transposed = args[0], args[1], args[6]
        return 2.0 * (x.numel() if transposed else out) * (
            w.numel() // w.shape[0])
    return 2.0 * out * args[0].shape[-1]        # mm, bmm, _scaled_mm


def analyze_graph(gm: torch.fx.GraphModule) -> Costs:
    return GraphCostModel(gm).analyze()


# ---------------------------------------------------------------------------
# Memory: a liveness walk over the graph's storages
# ---------------------------------------------------------------------------

class Memory(NamedTuple):
    """The reference's ``memory_analysis()`` fields: ``argument`` (the
    inputs' storages), ``output`` (the results' storages), ``temp`` (the
    peak of every other live storage), ``alias`` (results that alias a
    donated input)."""

    argument: int
    output: int
    temp: int
    alias: int

    @property
    def peak(self) -> int:
        return self.argument + self.temp + self.output - self.alias


def _storage(t):
    from torch.multiprocessing.reductions import StorageWeakRef
    return StorageWeakRef(t.untyped_storage())


def _graph_temp(gm, inputs: set, keep: set) -> int:
    """Peak bytes of the storages ``gm`` creates that are neither its
    inputs' nor in ``keep`` (its outputs'), each live from the node that
    creates it to the last node that uses any view of it; a higher-order
    node adds its largest body's peak while it runs."""
    nodes = list(gm.graph.nodes)
    first: Dict[Any, Tuple[int, int]] = {}     # storage -> (node, bytes)
    last: Dict[Any, int] = {}
    node_st: Dict[Any, List[Any]] = {}
    workspace = {_storage(_tensors(n.meta.get("val"))[k])
                 for n in nodes if n.target in _WORKSPACE_RESULT
                 for k in (_WORKSPACE_RESULT[n.target],)}
    for i, n in enumerate(nodes):
        sts = []
        for t in _tensors(n.meta.get("val")):
            st = _storage(t)
            sts.append(st)
            if st not in first:
                first[st] = (i, t.untyped_storage().nbytes())
        node_st[n] = sts
        for a in n.all_input_nodes:
            for st in node_st.get(a, ()):
                last[st] = i
    born: Dict[int, List[Any]] = {}
    dies: Dict[int, List[Any]] = {}
    for st, (i, _) in first.items():
        if st in inputs or st in keep or st in workspace:
            continue
        born.setdefault(i, []).append(st)
        dies.setdefault(max(last.get(st, i), i), []).append(st)
    live = peak = 0
    for i, n in enumerate(nodes):
        live += sum(first[st][1] for st in born.get(i, ()))
        extra = 0
        if n.op == "call_function" and \
                isinstance(n.target, torch._ops.HigherOrderOperator):
            _, bodies, _ = _hop_parts(gm, n)
            extra = max(_graph_temp(b, _placeholder_storages(b),
                                    _output_storages(b)) for b in bodies)
        peak = max(peak, live + extra)
        live -= sum(first[st][1] for st in dies.get(i, ()))
    return peak


def _placeholder_storages(gm) -> set:
    return {_storage(t) for n in gm.graph.nodes if n.op == "placeholder"
            for t in _tensors(n.meta.get("val"))}


def _output_storages(gm) -> set:
    out = next(n for n in gm.graph.nodes if n.op == "output")
    return {_storage(t) for a in out.all_input_nodes
            for t in _tensors(a.meta.get("val"))}


def _donated_storages(gm, donated: Sequence[int]) -> set:
    pos = gm.meta.get("arg_of_input")
    places = [n for n in gm.graph.nodes if n.op == "placeholder"]
    keep = set(donated)
    return {_storage(t) for k, n in enumerate(places)
            if pos is not None and pos[k] in keep
            for t in _tensors(n.meta.get("val"))}


def aliased_outputs(gm, donated: Sequence[int]) -> set:
    """The positions of the graph's outputs whose storage is a donated
    argument's (``donated``: argument positions, read through
    ``gm.meta["arg_of_input"]``)."""
    st = _donated_storages(gm, donated)
    return {k for k, t in enumerate(output_leaves(gm))
            if isinstance(t, torch.Tensor) and _storage(t) in st}


def peak_live_bytes(gm: torch.fx.GraphModule,
                    donated: Sequence[int] = ()) -> Memory:
    """The traced program's memory as XLA's ``memory_analysis()`` reports
    it: argument bytes (each input storage once), output bytes (each
    result storage once), alias bytes (results whose storage is a
    donated argument's, :func:`aliased_outputs`) and temp bytes, the peak
    of every other storage live at once (:func:`_graph_temp`).  Views
    share their base's storage, so a view of the cache or an in-place
    write into it is no temp.  A cut loop's further steps are added
    linearly (:func:`trace_step`)."""
    args = {_storage(t): t.untyped_storage().nbytes()
            for n in gm.graph.nodes if n.op == "placeholder"
            for t in _tensors(n.meta.get("val"))}
    outs = {_storage(t): t.untyped_storage().nbytes()
            for t in output_leaves(gm) if isinstance(t, torch.Tensor)}
    donated_st = _donated_storages(gm, donated)
    temp = base = _graph_temp(gm, set(args), set(outs))
    for n, g3 in gm.meta.get("loops", {}).values():
        # a cut loop's further steps, linearly (an estimate: the whole
        # loop's peak need not grow by the same bytes each step)
        temp += (n - 2) * max(peak_live_bytes(g3, donated).temp - base, 0)
    alias = sum(b for st, b in outs.items() if st in donated_st)
    return Memory(argument=sum(args.values()), output=sum(outs.values()),
                  temp=temp, alias=alias)


def output_leaves(gm) -> List[Any]:
    """The result's tensor leaves (fakes) in the traced order."""
    out = next(n for n in gm.graph.nodes if n.op == "output")
    vals = out.args[0]
    return [v.meta.get("val") for v in (vals if isinstance(vals, (list, tuple))
                                        else [vals])]


def non_view_ops(gm) -> int:
    """The counted aten ops of the graph (every op the cost model does not
    skip), loop bodies once per trip."""
    model = GraphCostModel(gm)
    model.analyze()
    return sum(v for k, v in model.ops.items()
               if not k.startswith("repro_torch."))


__all__ = ["Costs", "GraphCostModel", "KERNEL_COSTS", "KernelCost",
           "Memory", "aliased_outputs", "analyze_graph",
           "flash_attention_cost", "flash_pairs",
           "gather_rows_backward_cost", "gather_rows_cost",
           "moe_histogram_cost", "non_view_ops", "paged_attention_cost",
           "peak_live_bytes", "refuse_cuda_backward", "scatter_pages_cost",
           "trace_step", "trip_count"]

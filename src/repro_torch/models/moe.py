"""MoE decoder LM (qwen3-moe-30b-a3b: 128 experts top-8; grok-1-314b: 8
experts top-2) — training forward and serving path.

Attention blocks, the paged KV pool and the four attention/embedding
kernels are the dense model's (:mod:`repro_torch.models.transformer`); the
feed-forward block is a bank of expert MLPs behind a float32 router.  The
router's expert ids are data-dependent addresses into the expert buffers:
they are fenced with the guard's ``expert`` space before they form a
dispatch offset, and the per-expert counts that place every (token, k)
assignment come from the fenced-histogram kernel (K5), which fences each
id again on its own bin address.

Dispatch is either of the reference's variants (``repro/models/moe.py``,
``dispatch=``): ``scatter`` (the default, and what any name but
``einsum`` selects, as there) stores each kept assignment's token into
its expert buffer row and gathers the outputs back; ``einsum`` is the
Mesh-TF one-hot formulation, dispatch and combine as (T, E, C) tensors
contracted with the tokens and the expert outputs.  Both share the
routing: capacity ``C = max(int(2 * K * T / E), 8)`` slots per expert,
shared by every token of the step (parked rows and right-padding
included); an assignment whose rank within its expert reaches ``C`` is
dropped.  The reference ranks assignments with a float cumsum over a
one-hot (T*K, E); here the rank is the assignment's position in a stable
sort of the fenced ids minus its expert's start, the exclusive cumsum of
K5's counts — the same integer for every (t, k).  The expert products and
the einsum dispatch's contractions are plain matmuls, as the reference
leaves them to XLA.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.partition import einsum, is_dtensor, \
    matmul, rank_block, settle, split_over, whole
from repro_torch.distributed.sharding import ShardingRules, constrain
from repro_torch.core.fence import FencePolicy
from repro_torch.kernels import moe_histogram
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.guard import GuardSpec, fence

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Expert MLP bank + router
# ---------------------------------------------------------------------------

def _normal(gen, shape, std: float, dtype, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, std, generator=gen)
    return w.to(dtype)


def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """The router (d, E) stays float32; the expert bank is in the config's
    dtype.  Each tensor is drawn in float32 and cast on its own, so the
    largest temporary is one (E, d, f) tensor."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    dt = L.dtype_of(cfg)
    std = 1.0 / math.sqrt(d)
    out_std = 1.0 / math.sqrt(f * 2 * cfg.n_layers)
    p: Params = {
        "router": _normal(gen, (d, e), std, torch.float32, device),
        "wu": _normal(gen, (e, d, f), std, dt, device),
        "wd": _normal(gen, (e, f, d), out_std, dt, device),
    }
    if cfg.act == "silu":
        p["wg"] = _normal(gen, (e, d, f), std, dt, device)
    return p


def moe_axes(cfg: ModelConfig) -> Params:
    """Logical axes of :func:`moe_init`'s leaves (experts over "expert")."""
    p: Params = {
        "router": (None, None),
        "wu": ("expert", "embed", None),
        "wd": ("expert", None, "embed"),
    }
    if cfg.act == "silu":
        p["wg"] = ("expert", "embed", None)
    return p


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``'s order: descending, and the lower index first
    among equal values (``torch.topk`` makes no promise on ties; a zero
    router gives a row of ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _expert_fence(guard: Optional[GuardSpec], ids: torch.Tensor):
    """``(fenced, hist_ids, base, mask)``: the fenced ids the dispatch
    addresses with, and K5's operands such that K5's fence of
    ``hist_ids`` gives ``fenced``.  A BITWISE guard with a scalar extent
    hands ``(base, size - 1)`` to the kernel, which fences each id on its
    bin address; any other guard is fenced here first and the kernel gets
    the identity fence, as ``layers.embed_tokens`` does for K3."""
    fenced = fence(guard, "expert", ids)
    ex = guard.expert if guard is not None else None
    if ex is not None and guard.policy is FencePolicy.BITWISE \
            and not isinstance(ex.base, torch.Tensor) \
            and not isinstance(ex.size, torch.Tensor):
        return fenced, ids, int(ex.base), int(ex.size) - 1
    return fenced, fenced, 0, -1


def dispatch_ranks(fenced: torch.Tensor, counts: torch.Tensor,
                   num_experts: int) -> torch.Tensor:
    """Rank of each (t, k) assignment among the earlier assignments (in
    flattened (t, k) order) to the same expert: its position in a stable
    sort of the fenced ids minus its expert's start (the exclusive cumsum
    of ``counts``).  Ids outside ``[0, E)`` rank 0, as the reference's
    one-hot cumsum gives them."""
    E = num_experts
    flat = fenced.reshape(-1).long()
    in_range = (flat >= 0) & (flat < E)
    key = torch.where(in_range, flat, torch.full_like(flat, E))
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel(), device=flat.device)
    start = torch.cumsum(counts.long(), 0) - counts.long()
    pos = rank - start[key.clamp(max=E - 1)]
    return torch.where(in_range, pos, torch.zeros_like(pos)) \
        .reshape(fenced.shape).to(torch.int32)


class Routing(NamedTuple):
    """One step's routing decisions, (T, K) each unless noted."""

    probs: torch.Tensor        # (T, E) float32 router softmax
    gates: torch.Tensor        # normalised top-k gates, zero where dropped
    experts: torch.Tensor      # fenced expert ids, int32
    counts: torch.Tensor       # (E,) int32 per-expert counts (K5)
    pos: torch.Tensor          # rank within the expert, int32
    keep: torch.Tensor         # pos < capacity
    capacity: int


def route(cfg: ModelConfig, p: Params, xf: torch.Tensor,
          guard: Optional[GuardSpec] = None,
          capacity_factor: float = 2.0) -> Routing:
    """Router, top-k, the expert fence, K5's counts and the capacity ranks
    for tokens xf (T, d) — ``repro/models/moe.py``'s ``moe_apply`` up to
    its dispatch."""
    m = cfg.moe
    T = xf.shape[0]
    E, K = m.num_experts, m.top_k
    logits = matmul(xf.float(), p["router"])                    # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _top_k(probs, K)
    experts, hist_ids, base, mask = _expert_fence(guard,
                                                  experts.to(torch.int32))
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    counts = moe_histogram(hist_ids.contiguous(), E, base, mask)  # K5
    capacity = max(int(capacity_factor * K * T / E), 8)
    pos = whole(functools.partial(dispatch_ranks, num_experts=E), experts,
                counts)
    keep = pos < capacity
    return Routing(probs, gates * keep.to(gates.dtype), experts, counts,
                   pos, keep, capacity)


def dispatch_dest(r: Routing) -> torch.Tensor:
    """(T*K,) buffer rows: ``expert * C + pos`` for a kept assignment, the
    spare row ``E * C`` for a dropped one."""
    E, C = r.counts.shape[0], r.capacity
    dest = (r.experts.long() * C + r.pos.long().clamp(max=C - 1)).reshape(-1)
    return torch.where(r.keep.reshape(-1), dest, torch.full_like(dest, E * C))


def _expert_mlps(cfg: ModelConfig, p: Params, xin: torch.Tensor,
                 product=torch.bmm) -> torch.Tensor:
    """The expert MLPs over the (E, C, d) buffers -> (E, C, d), each
    batched product ``product`` (a partitioned trace's own split:
    :func:`_split_bmm`)."""
    if cfg.act == "silu":
        h = F.silu(product(xin, p["wg"])) * product(xin, p["wu"])
    else:
        h = F.gelu(product(xin, p["wu"]), approximate="tanh")
    return product(h, p["wd"])


def _split_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` on DTensors split as the partitioner splits a dot
    (:func:`~repro_torch.distributed.partition.einsum`): each weight's
    gradient lands in the weight's own placement (its FSDP shard), where
    DTensor's rule leaves it a partial sum for the optimizer to reduce."""
    return einsum("eci,eio->eco", a, b)


def experts_einsum(cfg: ModelConfig, p: Params, xf: torch.Tensor,
                   r: Routing,
                   rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The reference's ``einsum`` dispatch of tokens xf (T, d): the
    (T, E, C) dispatch tensor one-hot on (expert, slot) — a dropped
    assignment's slot is class C, a zero row, and so is a fenced id past
    the experts — the buffers ``xin = einsum("td,tec->ecd")``, the expert
    MLPs, and the combine ``disp * sum_k onehot * gates`` contracted with
    their outputs -> (T, d).  Where a fence folds two of a token's ids
    onto one expert, ``disp`` holds both slots and the combine weighs each
    by the sum of both gates, as the reference's does."""
    E, C = cfg.moe.num_experts, r.capacity
    dt = xf.dtype
    onehot = (r.experts.long()[..., None]
              == torch.arange(E, device=xf.device)).to(dt)      # (T,K,E)
    slot = torch.where(r.keep, r.pos.long(), torch.full_like(
        r.pos, C, dtype=torch.long))
    slot_oh = (slot[..., None] == torch.arange(C, device=xf.device)).to(dt)
    disp = einsum("tke,tkc->tec", onehot, slot_oh)
    xin = constrain(einsum("td,tec->ecd", xf, disp), rules,
                    ("expert", None, None))
    out_e = constrain(_expert_mlps(cfg, p, xin), rules,
                      ("expert", None, None))
    combine = disp * einsum("tke,tk->te", onehot, r.gates.to(dt))[..., None]
    return einsum("tec,ecd->td", combine, out_e)


def experts(cfg: ModelConfig, p: Params, xf: torch.Tensor,
            r: Routing, rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """Dispatch tokens xf (T, d) into the (E, C, d) expert buffers, run
    the expert MLPs, and combine each token's kept outputs by its gates
    -> (T, d): the reference's ``scatter`` dispatch."""
    T, d = xf.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    # fenced scatter dispatch into (E*C + 1, d): a destination outside
    # [0, E*C] (a fenced id past E) is dropped onto the spare row, as the
    # reference's mode="drop" scatter drops it
    EC = E * r.capacity
    dest = dispatch_dest(r)
    dest_w = torch.where((dest >= 0) & (dest <= EC), dest,
                         torch.full_like(dest, EC))
    # the reference's pins: source rows token-major, the buffer's rows
    # expert-major (the store across them is the dispatch all-to-all)
    src = constrain(xf[:, None, :].expand(T, K, d).reshape(T * K, d), rules,
                    ("batch", None))
    blocks = _expert_blocks(src, rules, E, r.capacity)
    if blocks is not None:
        return _experts_by_block(cfg, p, src, dest, dest_w, r, blocks,
                                 rules)
    buf = constrain(torch.zeros((EC + 1, d), dtype=xf.dtype,
                                device=xf.device), rules, ("expert", None))
    buf = constrain(_dispatch_store(buf, dest_w, src), rules,
                    ("expert", None))
    xin = constrain(buf[:EC].reshape(E, r.capacity, d), rules,
                    ("expert", None, None))
    out_e = constrain(_expert_mlps(cfg, p, xin), rules,
                      ("expert", None, None))
    flat = constrain(out_e.reshape(EC, d), rules, ("expert", None))
    y_tk = constrain(_rows(flat, dest.clamp(0, EC - 1)).reshape(T, K, d),
                     rules, ("batch", None, None))
    return einsum("tkd,tk->td", y_tk, r.gates.to(xf.dtype))


def _expert_blocks(src, rules: Optional[ShardingRules], E: int, C: int):
    """On a partitioned trace, the mesh dims the ``expert`` rule splits
    the (E * C, d) buffer over, where each rank's block of its rows is
    whole experts or lies inside one (rows per rank a multiple or a
    divisor of C) and those dims split no token row of ``src``; else None
    (the buffer is then gathered whole, :func:`_dispatch_store`)."""
    if rules is None or not is_dtensor(src):
        return None
    axis = rules.lookup("expert")
    names = (axis,) if isinstance(axis, str) else tuple(axis or ())
    mesh = src.device_mesh
    dims = [m for m, n in enumerate(mesh.mesh_dim_names) if n in names]
    ranks = math.prod(mesh.size(m) for m in dims)
    rows = E * C // ranks if dims and E * C % ranks == 0 else 0
    if not rows or (rows % C and C % rows) or set(dims) & set(
            split_over(src, 0)):
        return None
    return dims


def _experts_by_block(cfg: ModelConfig, p: Params, src, dest, dest_w,
                      r: Routing, dims, rules: ShardingRules
                      ) -> torch.Tensor:
    """:func:`experts` on a partitioned trace, the buffer split by rows
    over the mesh dims ``dims`` (:func:`_expert_blocks`) and never whole
    on a rank: each rank stores, from the token rows it holds (``src``'s
    split over the data axis, whole on ``dims``), those whose destination
    falls in its block, into its block alone; the blocks are summed over
    the data axis (one all-reduce: each row is stored by one data rank's
    token), so every rank of a data group holds the same block, as the
    reference's pins place the buffer (experts over the model axis, whole
    over data); the block's experts run their MLPs on it; each rank reads
    back, for its tokens, the rows in its block, weighs them by the gates,
    and the partial sums are reduced over ``dims`` (one all-reduce of the
    (T, d) result).  Only a data rank's token rows, its block and the
    result move.  Where a rank's block lies inside one expert (fewer
    experts than ranks), that expert's weights stand for the rank's block
    of a virtual (ranks, d, f) bank, its gradient a partial sum over
    ``dims``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = src.device_mesh
    E, K, C = cfg.moe.num_experts, cfg.moe.top_k, r.capacity
    EC, d = E * C, src.shape[-1]
    data = split_over(src, 0)
    ranks = math.prod(mesh.size(m) for m in dims)
    R, lo = EC // ranks, rank_block(mesh, dims) * (EC // ranks)
    n = mesh.ndim

    def placed(on_data, on_dims):
        return [on_data if m in data else on_dims if m in dims
                else Replicate() for m in range(n)]

    def local(t, grad_on_dims):
        """``t``'s rows of this data rank, whole on ``dims``."""
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * n,
                                   run_check=False)
        return t.redistribute(mesh, placed(Shard(0), Replicate())) \
            .to_local(grad_placements=placed(Shard(0), grad_on_dims))

    rows = local(src, Partial())                         # (T_loc * K, d)
    at = local(dest_w, Replicate()) - lo
    inside = (at >= 0) & (at < R)
    blk = rows.new_zeros((R + 1, d)).index_copy(
        0, torch.where(inside, at, torch.full_like(at, R)), rows)[:R]
    blk = settle(DTensor.from_local(
        blk, mesh, placed(Partial(), Shard(0)), run_check=False,
        shape=torch.Size((EC, d)), stride=(d, 1))).to_local()
    # the block as its rank's experts: E / ranks whole ones, or a block of
    # one ((ranks, R, d), each rank's own expert's weights)
    even = E % ranks == 0
    shape = torch.Size((E, C, d) if even else (ranks, R, d))
    xin = DTensor.from_local(
        blk.reshape(-1, *shape[1:]), mesh, placed(Replicate(), Shard(0)),
        run_check=False, shape=shape,
        stride=(shape[1] * d, d, 1))
    if even:
        xin = constrain(xin, rules, ("expert", None, None))
        out = constrain(_expert_mlps(cfg, p, xin, _split_bmm), rules,
                        ("expert", None, None))
    else:
        out = _expert_mlps(cfg, {k: _block_expert(p[k], dims, lo // C, ranks)
                                 for k in ("wg", "wu", "wd") if k in p}, xin,
                           _split_bmm)
    out = out.redistribute(mesh, placed(Replicate(), Shard(0))).to_local(
        grad_placements=placed(Partial(), Shard(0))).reshape(R, d)
    at = local(dest, Replicate()).clamp(0, EC - 1) - lo
    inside = (at >= 0) & (at < R)
    got = torch.where(inside[:, None], out[at.clamp(0, R - 1)],
                      torch.zeros((), dtype=out.dtype))
    gates = local(r.gates, Partial()).to(got.dtype)
    y = torch.einsum("tkd,tk->td", got.reshape(-1, K, d), gates)
    return settle(DTensor.from_local(
        y, mesh, placed(Shard(0), Partial()), run_check=False,
        shape=torch.Size((src.shape[0] // K, d)), stride=(d, 1)))


def _block_expert(w, dims, expert: int, ranks: int):
    """Expert ``expert`` of the bank ``w`` (E, ...), whole on the mesh dims
    ``dims``, as this rank's block of a (ranks, ...) DTensor split over
    them (each rank's own expert; its gradient a partial sum there)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = w.device_mesh
    whole_on = [Replicate() if m in dims else pl
                for m, pl in enumerate(w.placements)]
    part = w.redistribute(mesh, whole_on).to_local(grad_placements=[
        Partial() if m in dims else pl for m, pl in enumerate(whole_on)])
    from torch.distributed.tensor import Shard
    shape = torch.Size((ranks, *w.shape[1:]))
    return DTensor.from_local(
        part[expert:expert + 1], mesh,
        [Shard(0) if m in dims else pl for m, pl in enumerate(whole_on)],
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _dispatch_store(buf: torch.Tensor, dest: torch.Tensor,
                    src: torch.Tensor) -> torch.Tensor:
    """``buf`` with row ``dest[i]`` set to ``src[i]`` (in place).  On a
    partitioned trace DTensor has no rule for a row store (into a split
    buffer, or at all): the buffer and the rows are gathered whole (an
    explicit redistribute), the store runs on every rank's copy, and the
    pins around it split the buffer again."""
    return whole(lambda b, d, s: b.index_copy_(0, d, s), buf, dest, src)


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; on a partitioned trace over the table gathered whole
    (an explicit redistribute: DTensor cannot index a split table)."""
    return whole(lambda t, i: t[i], table, ids)


def dispatch_experts(dispatch: str):
    """The expert block of a ``dispatch`` name: :func:`experts_einsum` for
    ``"einsum"``, else :func:`experts` (the reference's reading)."""
    return experts_einsum if dispatch == "einsum" else experts


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
              guard: Optional[GuardSpec] = None,
              capacity_factor: float = 2.0, dispatch: str = "scatter",
              rules: Optional[ShardingRules] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar): top-k routing with
    the capacity dispatch ``dispatch`` of ``repro/models/moe.py``."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    r = route(cfg, p, xf, guard, capacity_factor)
    # load-balancing aux loss (Switch-style); ce = counts / T
    aux = cfg.moe.num_experts * (
        r.probs.mean(dim=0) * (r.counts.float() / (B * S))).sum()
    return dispatch_experts(dispatch)(cfg, p, xf, r, rules).reshape(
        B, S, d), aux


# ---------------------------------------------------------------------------
# Model (attention blocks reuse the dense transformer pieces)
# ---------------------------------------------------------------------------

def layer_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {"attn": L.attention_init(gen, cfg, device),
            "moe": moe_init(gen, cfg, device),
            "norm1": L.norm_init(cfg, device),
            "norm2": L.norm_init(cfg, device)}


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    """Random weights from ``generator`` (which must live on ``device``),
    one layer at a time."""
    return {
        "embed": L.embedding_init(generator, cfg, device),
        "layers": [layer_init(generator, cfg, device)
                   for _ in range(cfg.n_layers)],
        "norm_f": L.norm_init(cfg, device),
    }


def param_logical_axes(cfg: ModelConfig) -> Params:
    """Logical axes matching :func:`init`'s tree, one dict per layer."""
    return {
        "embed": L.embedding_axes(cfg),
        "layers": [{"attn": L.attention_axes(cfg),
                    "moe": moe_axes(cfg),
                    "norm1": L.norm_axes(cfg),
                    "norm2": L.norm_axes(cfg)}
                   for _ in range(cfg.n_layers)],
        "norm_f": L.norm_axes(cfg),
    }


def moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor,
            guard: Optional[GuardSpec] = None,
            dispatch: str = "scatter",
            rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The MoE layer's feed-forward block: :func:`moe_apply` without the
    aux loss, a training quantity the reference's prefill/decode drop."""
    B, S, d = x.shape
    xf = L.apply_norm(cfg, p["norm2"], x).reshape(B * S, d)
    r = route(cfg, p["moe"], xf, guard)
    return dispatch_experts(dispatch)(cfg, p["moe"], xf, r, rules).reshape(
        B, S, d)


def prefill(cfg: ModelConfig, params: Params, cache, tokens: torch.Tensor,
            *, dispatch: str = "scatter",
            rules: Optional[ShardingRules] = None, **kw):
    """The dense serving loop's prefill with the expert block
    (``dispatch`` as :func:`moe_apply`'s)."""
    return TF.prefill(cfg, params, cache, tokens, rules=rules,
                      ffn=functools.partial(moe_ffn, dispatch=dispatch,
                                            rules=rules), **kw)


def decode(cfg: ModelConfig, params: Params, cache, tokens: torch.Tensor,
           *, dispatch: str = "scatter",
           rules: Optional[ShardingRules] = None, **kw):
    """The dense serving loop's decode step with the expert block
    (``dispatch`` as :func:`moe_apply`'s)."""
    return TF.decode(cfg, params, cache, tokens, rules=rules,
                     ffn=functools.partial(moe_ffn, dispatch=dispatch,
                                           rules=rules), **kw)


# ---------------------------------------------------------------------------
# Forward (training / scoring)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *,
            guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None, remat: bool = False,
            dispatch: str = "scatter", remat_policy: str = "nothing"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), the layers' mean aux loss).
    ``dispatch`` as :func:`moe_apply`'s; ``remat_policy`` is what a
    recomputed layer keeps (:func:`repro_torch.models.transformer.
    run_layers`: ``"dots"`` its plain products, else nothing)."""
    x = L.embed_tokens(params["embed"], tokens, guard)
    positions = TF.train_positions(tokens, positions)

    def layer(p, x, aux):
        x = x + TF.attn_block(cfg, p, x, positions)
        h, a = moe_apply(cfg, p["moe"], L.apply_norm(cfg, p["norm2"], x),
                         guard, dispatch=dispatch, rules=rules)
        return constrain(x + h, rules, ("batch", "seq", None)), aux + a

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = TF.run_layers(layer, params["layers"], x, aux0, remat=remat,
                           policy=remat_policy)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return L.lm_logits(cfg, params["embed"], x), aux / cfg.n_layers


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            guard: Optional[GuardSpec] = None,
            rules: Optional[ShardingRules] = None, remat: bool = True,
            aux_weight: float = 0.01, dispatch: str = "scatter",
            remat_policy: str = "nothing") -> torch.Tensor:
    """Mean next-token NLL plus ``aux_weight`` times the load-balancing
    aux loss."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens[:, :-1], guard=guard,
                          rules=rules, remat=remat, dispatch=dispatch,
                          remat_policy=remat_policy)
    return (L.softmax_cross_entropy(logits, tokens[:, 1:],
                                    batch.get("mask"))
            + aux_weight * aux)

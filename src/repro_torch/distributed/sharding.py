"""Sharding rules — the logical-axis to mesh-axis mapping of
``repro/distributed/sharding.py`` (DP / FSDP / TP / EP / SP), for one
card and for the reference's meshes.

Every parameter, cache field and batch input carries a tuple of *logical
axis names*; :class:`ShardingRules` maps each name to a mesh axis (a name,
a tuple of names, or ``None``: replicated).  The port has no
``PartitionSpec``: :meth:`ShardingRules.spec` returns the tuple of mesh
axes one would hold, and :meth:`ShardingRules.sharding` a
:class:`NamedSharding` record of (mesh, spec).  On one card every mesh
axis has size 1, so a placement says where a tensor would be split on the
reference's meshes and nothing is split.  On a ``DeviceMesh``
(:meth:`repro_torch.launch.mesh.Mesh.open`) :func:`to_placements` turns a
spec into DTensor placements and :func:`constrain` redistributes a
DTensor to them, as the reference's ``with_sharding_constraint`` pins a
value inside its partitioned program.

Default production mapping (single pod, mesh ``(data=16, model=16)``):

    batch        -> ("pod"?, "data")      DP over pod x data
    vocab        -> "model"               TP embedding / lm-head
    embed        -> the data axes when fsdp, else None (FSDP)
    heads        -> "model"               TP attention
    kv_heads     -> "model"
    ffn          -> "model"               TP MLP
    expert       -> "model"               EP: experts over the model axis
    seq          -> "model" with seq_parallel, else None
    pages        -> the data axes         KV / state pool slots
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

MeshAxis = Any          # None | str | Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec[i]`` is the mesh axis (or axes) dimension ``i``
    is split over on ``mesh``, ``None`` replicated."""

    mesh: Any
    spec: Tuple[MeshAxis, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis name -> mesh axis (str | tuple | None)."""

    rules: Tuple[Tuple[str, MeshAxis], ...]

    def lookup(self, logical: str) -> MeshAxis:
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def spec(self, logical_axes: Tuple[Optional[str], ...]
             ) -> Tuple[MeshAxis, ...]:
        return tuple(self.lookup(a) if a is not None else None
                     for a in logical_axes)

    def sharding(self, mesh, logical_axes: Tuple[Optional[str], ...]
                 ) -> NamedSharding:
        return NamedSharding(mesh, self.spec(logical_axes))


def make_rules(mesh, *, fsdp: bool = True,
               seq_parallel: bool = False) -> ShardingRules:
    """The production rule set for ``mesh`` (read for its ``axis_names``
    only).  The optional ``pod`` axis folds into data parallelism, so one
    rule set serves the single-pod (16, 16) and multi-pod (2, 16, 16)
    meshes; ``fsdp`` also shards the d_model ("embed") dimension of the
    weights over the data axes (ZeRO-3)."""
    names = mesh.axis_names
    data_axes = ("pod", "data") if "pod" in names else ("data",)
    batch = data_axes if len(data_axes) > 1 else data_axes[0]
    rules = [
        ("batch", batch),
        ("vocab", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("ffn", "model"),
        ("expert", "model"),
        ("embed", batch if fsdp else None),
        ("embed_nofsdp", None),
        ("head_dim", None),
        ("state", None),
        ("seq", "model" if seq_parallel else None),
        ("kv_seq", None),
        ("pages", batch),
        ("page", None),
        ("conv", None),
    ]
    return ShardingRules(rules=tuple(rules))


def is_axes(x) -> bool:
    """A logical-axes tuple (a leaf of an axes tree)."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = is_axes):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples that are
    not leaves, dataclasses such as the caches), each with the matching
    leaves of ``rest``; ``None`` stays ``None``."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest),
                             is_leaf=is_leaf)
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def logical_sharding(mesh, rules: ShardingRules, tree):
    """Map a tree of logical-axis tuples to :class:`NamedSharding` s."""
    return tree_map(lambda axes: rules.sharding(mesh, axes), tree)


def to_placements(device_mesh, spec: Tuple[MeshAxis, ...]) -> list:
    """A spec (per tensor dim a mesh axis, a tuple of them or None) as
    DTensor placements over ``device_mesh``'s dims: ``Shard(d)`` on each
    mesh dim that dim ``d`` is split over, ``Replicate()`` on the rest.  A
    dim split over several mesh axes (``batch`` -> ``("pod", "data")``)
    is split major to minor in the spec's order, the reference's
    ``PartitionSpec`` order; that must be the mesh's own order (a
    ``Shard`` on each dim then splits as the reference does, no
    ``_StridedShard``), else it raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        axes = () if axis is None else (axis,) if isinstance(axis, str) \
            else tuple(axis)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: dim {d} split over {axes}, "
                             f"not in the mesh's order {names}")
        for m in dims:
            out[m] = Shard(d)
    return out


def constrain(x, rules: Optional[ShardingRules],
              logical_axes: Tuple[Optional[str], ...]):
    """The reference's ``with_sharding_constraint`` by logical axes: a
    DTensor is redistributed to the rule's placements on its mesh, a dim
    the mapped mesh axes do not divide left whole (as the step bundles
    place an input: DTensor cannot reshape an uneven split); any other
    tensor (one card, no mesh, ``rules`` None) comes back unchanged."""
    import math

    from repro_torch.distributed.partition import is_dtensor

    if rules is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    spec = tuple(
        axis if axis is None or x.shape[d] % math.prod(
            mesh.size(names.index(a)) for a in (
                (axis,) if isinstance(axis, str) else axis)) == 0 else None
        for d, axis in enumerate(rules.spec(logical_axes)))
    pl = to_placements(mesh, spec)
    return x if list(x.placements) == pl else x.redistribute(mesh, pl)


# ---------------------------------------------------------------------------
# Pipeline-parallel cut points (documented, off by default)
# ---------------------------------------------------------------------------

def pp_cut_points(n_layers: int, n_stages: int) -> Tuple[int, ...]:
    """Equal-depth layer boundaries where the layer stack would be split
    if the ``pod`` axis were used for pipeline parallelism."""
    per = n_layers // n_stages
    rem = n_layers % n_stages
    cuts, acc = [], 0
    for s in range(n_stages - 1):
        acc += per + (1 if s < rem else 0)
        cuts.append(acc)
    return tuple(cuts)

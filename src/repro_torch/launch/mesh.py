"""Meshes for the port, as ``repro/launch/mesh.py``'s.

A :class:`Mesh` names its axes and their sizes.  :func:`make_local_mesh`
is the one-card mesh (data=1, model=1) over one device; the production
meshes are shapes only — they hold no device and allocate nothing — so
that placements and cache axes can be reckoned for the reference's
256- and 512-chip meshes on one card.

:meth:`Mesh.open` opens a ``fake`` process group of ``mesh.size`` ranks
(this process rank 0; no collective moves a byte), under a
``torch.distributed.device_mesh.DeviceMesh`` of the mesh's shape and axis
names, torn down when the context exits.  The dry run traces a step
bundle there as rank 0 of the partitioned program
(:mod:`repro_torch.launch.dryrun`).  :meth:`Mesh.join` joins one rank
to a real group of ``mesh.size`` processes, where the partitioned step
runs with every collective moving its bytes (a check of its numbers
against the unpartitioned step).  Serving and training open neither.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` in order, ``shape`` name -> size (as
    ``jax.sharding.Mesh.shape``), ``devices`` the devices it spans (empty
    for a mesh reckoned as a shape only)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    devices: Tuple[torch.device, ...] = ()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @contextlib.contextmanager
    def open(self, device="cpu") -> Iterator[object]:
        """The mesh as a ``DeviceMesh`` of ``device``'s type over a
        ``fake`` process group of :attr:`size` ranks, this process rank 0;
        the group is destroyed on exit, also when the body raises.  The
        kernels' sharding rules are registered first
        (:func:`repro_torch.kernels.register_sharding_rules`).  Refuses to
        open where a process group already exists."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.distributed.partition import opened
        from repro_torch.kernels import register_sharding_rules

        if dist.is_initialized():
            raise RuntimeError(f"{describe(self)}: a process group is "
                               "already open in this process")
        _fake_backend()
        register_sharding_rules()
        dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                                world_size=self.size)
        try:
            ranks = torch.arange(self.size).reshape(
                tuple(self.shape[a] for a in self.axis_names))
            with _gpu_all_to_all(), opened():
                yield DeviceMesh(torch.device(device).type, ranks,
                                 mesh_dim_names=self.axis_names)
        finally:
            dist.destroy_process_group()

    @contextlib.contextmanager
    def join(self, rank: int, store, timeout=None) -> Iterator[object]:
        """The mesh as a CPU ``DeviceMesh`` over a real gloo process group
        of :attr:`size` ranks, this process ``rank``, rendezvous through
        ``store`` (a ``dist.FileStore``: no network), with the kernels'
        sharding rules and :func:`~repro_torch.distributed.partition.
        opened` as :meth:`open` sets them; every collective moves its
        bytes (gloo has no all-to-all: DTensor all-gathers and chunks in
        its place); a collective waits ``timeout`` (a ``timedelta``) at
        most.  The group is destroyed on exit."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.distributed.partition import opened
        from repro_torch.kernels import register_sharding_rules

        if dist.is_initialized():
            raise RuntimeError(f"{describe(self)}: a process group is "
                               "already open in this process")
        register_sharding_rules()
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=self.size,
                                **({} if timeout is None else
                                   {"timeout": timeout}))
        try:
            ranks = torch.arange(self.size).reshape(
                tuple(self.shape[a] for a in self.axis_names))
            with opened():
                yield DeviceMesh("cpu", ranks,
                                 mesh_dim_names=self.axis_names)
        finally:
            dist.destroy_process_group()


def _fake_backend() -> None:
    """Register torch's ``fake`` backend (a process group that
    hallucinates every collective: each rank sees the shapes it would
    receive), from ``torch.testing._internal.distributed.fake_pg``."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401


@contextlib.contextmanager
def _gpu_all_to_all():
    """DTensor moves a split from one tensor dim to another with an
    all-to-all, but on a CPU mesh with an all-gather and a chunk (gloo
    has no all-to-all): inside the context a CPU mesh issues the
    all-to-all a GPU mesh does (``_dtensor::shard_dim_alltoall``, traced
    as one node), so CPU and CUDA fakes trace one program.  Where this
    torch lacks either hook, DTensor's own choice stands."""
    from torch.distributed.tensor import placement_types as pt

    op = getattr(torch.ops._dtensor, "shard_dim_alltoall", None)
    orig = getattr(pt, "shard_dim_alltoall", None)
    if op is None or orig is None:
        yield
        return

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)

    pt.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


def _mesh(shape, axes, devices=()) -> Mesh:
    return Mesh(axis_names=tuple(axes), shape=dict(zip(axes, shape)),
                devices=tuple(devices))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 chips; multi-pod: (pod=2,
    data=16, model=16) = 512 chips.  Shape only: no device."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_local_mesh(device="cuda") -> Mesh:
    """The 1 x 1 (data, model) mesh over one device."""
    return _mesh((1, 1), ("data", "model"), (torch.device(device),))


def describe(mesh: Mesh) -> str:
    return f"mesh {dict(mesh.shape)} = {mesh.size} devices"

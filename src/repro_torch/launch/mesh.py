"""Meshes for the port, as ``repro/launch/mesh.py``'s.

A :class:`Mesh` names its axes and their sizes.  :func:`make_local_mesh`
is the one-card mesh (data=1, model=1) over one device; the production
meshes are shapes only — they hold no device and allocate nothing — so
that placements and cache axes can be reckoned for the reference's
256- and 512-chip meshes on one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

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

"""Meshes and gossip-axis placement: the counterpart of
``repro/launch/mesh.py``.

single-pod : (16, 16)    ("data", "model")           — 256 cards
multi-pod  : (2, 16, 16) ("pod", "data", "model")    — 512 cards

The *gossip axes* enumerate decentralized nodes; the remaining axis
("model") shards each node's replica (tensor and expert parallelism).  A
``Mesh`` here is plain bookkeeping — axis names, their sizes, and the map
between a rank of the world (row-major over the axes, the last axis
fastest) and its coordinates — and touches no device: the ranks engine
(``launch/train.py``) builds its process groups from it, and the stacked
engine on one card reads only its model size (the padded heads).
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

__all__ = [
    "Mesh",
    "make_mesh",
    "make_production_mesh",
    "gossip_axes_for",
    "gossip_size",
]


class Mesh:
    """Axis names and sizes; rank ↔ coordinates in row-major order."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
        if len(set(axes)) != len(axes):
            raise ValueError(f"mesh axes repeat: {tuple(axes)}")
        if any(int(n) < 1 for n in shape):
            raise ValueError(f"mesh sizes must be positive: {tuple(shape)}")
        self.axis_names = tuple(axes)
        self.shape = {a: int(n) for a, n in zip(axes, shape)}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis) -> int:
        """Size of one axis, of a tuple of axes (their product), 1 for None."""
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            return math.prod(self.shape[a] for a in axis)
        return self.shape[axis]

    def coords(self, rank: int) -> dict[str, int]:
        """Axis -> index of ``rank``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Mapping[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + int(coords[a])
        return r

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names) if hasattr(mesh, "axis_names") else tuple(mesh)


def _sizes(mesh) -> Mapping[str, int]:
    return mesh.shape if hasattr(mesh, "axis_names") else mesh


def gossip_axes_for(arch_name: str, mesh) -> tuple[str, ...]:
    """Which mesh axes enumerate gossip nodes for an architecture (``mesh``
    a ``Mesh`` or a mapping of axis names to sizes).

    Default: every non-"model" axis is a gossip axis (node = one
    tensor-parallel group).  1T-scale MoE (kimi-k2): a replica needs the
    whole pod (FSDP × EP), so gossip runs across pods only — () on a single
    pod (G = 1), ("pod",) on two.
    """
    names = _names(mesh)
    if arch_name.startswith("kimi-k2"):
        return ("pod",) if "pod" in names else ()
    return tuple(a for a in names if a != "model")


def gossip_size(mesh, gossip_axes: tuple[str, ...]) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in gossip_axes) if gossip_axes else 1

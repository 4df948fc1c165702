"""Logical partition specs → per-rank shards: the counterpart of
``repro/launch/sharding.py``.

Model modules declare per-weight logical specs (entries None or "model",
``models/common.ParamDef.spec``).  This module validates them for a
concrete mesh and gossip placement:

  * gossip placement (G > 1): every leaf gains a leading stacked-replica
    dim over the gossip axes: (gossip_axes, *logical);
  * the degenerate placement (G = 1, kimi-k2 on one pod) shards the
    remaining axes FSDP-style in the reference; here ``fsdp=True`` raises
    (ROADMAP queue 1 item 8d).

A spec entry whose dim does not divide by its axes' size falls back to
replication on that dim (the reference's ``_validated_spec``: never an
error).  A ``Sharding`` is the port's own record of the result — the mesh
and one entry per dim — and ``shard_leaf``/``unshard`` cut a full leaf
into one rank's slice and put the ranks' slices back together: the ranks
engine (``launch/train.py``) holds each leaf's model-axis slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import torch

from repro_torch.launch.mesh import Mesh

__all__ = [
    "Sharding",
    "leaf_sharding",
    "param_shardings",
    "stack_abstract",
    "batch_sharding",
    "tree_size_bytes",
    "shard_leaf",
    "unshard",
]

_FSDP_ITEM = ("fsdp=True (the G = 1 placement: FSDP over the data axes) is not "
              "ported: ROADMAP queue 1 item 8d")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's placement: ``spec`` holds, per dim, None (replicated), an
    axis name or a tuple of axis names (sharded over their product), as the
    reference's ``PartitionSpec`` holds them."""

    mesh: Mesh
    spec: tuple

    def _axes(self, entry) -> tuple:
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def parts(self, dim: int) -> int:
        """How many slices dim ``dim`` is cut into."""
        return self.mesh.axis_size(self._axes(self.spec[dim]) or None)

    def dim_of(self, axis: str) -> Optional[int]:
        """The dim sharded over ``axis`` (None when no dim is)."""
        for d, e in enumerate(self.spec):
            if axis in self._axes(e):
                return d
        return None

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(n // self.parts(d) for d, n in enumerate(shape))

    def index(self, dim: int, coords: Mapping[str, int]) -> int:
        """This rank's slice index along ``dim`` (row-major over its axes)."""
        i = 0
        for a in self._axes(self.spec[dim]):
            i = i * self.mesh.shape[a] + int(coords[a])
        return i

    def slices(self, shape: Sequence[int], coords: Mapping[str, int]) -> tuple:
        out = []
        for d, n in enumerate(shape):
            k = n // self.parts(d)
            i = self.index(d, coords)
            out.append(slice(i * k, (i + 1) * k))
        return tuple(out)


def _entry(axes: Sequence[str]):
    """A tuple of axes as a spec entry, as ``PartitionSpec`` normalizes it:
    () -> None, one axis -> its name."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _validated_spec(shape, spec_entries, mesh: Mesh) -> list:
    out = []
    for dim, ax in zip(shape, spec_entries):
        if ax is not None and dim % mesh.axis_size(ax) == 0:
            out.append(ax)
        else:
            out.append(None)
    return out


def leaf_sharding(shape: tuple[int, ...], logical: tuple[Optional[str], ...], mesh: Mesh,
                  gossip_axes: tuple[str, ...], *, stacked: bool,
                  fsdp: bool = False) -> Sharding:
    """Sharding for one (possibly gossip-stacked) weight leaf."""
    if fsdp:
        raise ValueError(_FSDP_ITEM)
    if stacked:
        entries = _validated_spec(shape[1:], logical, mesh)
        return Sharding(mesh, (_entry(gossip_axes), *entries))
    return Sharding(mesh, tuple(_validated_spec(shape, logical, mesh)))


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def param_shardings(abstract, logical_specs, mesh: Mesh, gossip_axes: tuple[str, ...], *,
                    stacked: bool, fsdp: bool = False):
    """Shardings for a whole (possibly stacked) tree: (nested) dicts of
    anything with a ``shape``.  ``logical_specs`` mirrors the *unstacked*
    tree; when ``stacked`` the leaves carry the extra leading G dim."""
    return _map(lambda leaf, spec: leaf_sharding(tuple(leaf.shape), spec, mesh, gossip_axes,
                                                 stacked=stacked, fsdp=fsdp),
                abstract, logical_specs)


def stack_abstract(abstract, g: int):
    """Prepend the gossip-replica dim to an abstract tree (``meta`` leaves)."""
    return _map(lambda l: torch.empty((g,) + tuple(l.shape), dtype=l.dtype, device="meta"),
                abstract)


def batch_sharding(mesh: Mesh, gossip_axes: tuple[str, ...], ndim: int, *,
                   stacked: bool) -> Sharding:
    """Training batches: (G, b, ...) with G over the gossip axes (stacked),
    or (B, ...) with B over every non-model axis (G = 1)."""
    if stacked:
        return Sharding(mesh, (_entry(gossip_axes),) + (None,) * (ndim - 1))
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    return Sharding(mesh, (_entry(data_axes),) + (None,) * (ndim - 1))


def tree_size_bytes(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(tree_size_bytes(v) for v in tree.values())
    return math.prod(tree.shape) * tree.dtype.itemsize


def shard_leaf(x: torch.Tensor, sharding: Sharding, coords: Mapping[str, int]) -> torch.Tensor:
    """The slice of the full leaf ``x`` that the rank at ``coords`` (axis ->
    index) holds: a view."""
    return x[sharding.slices(x.shape, coords)]


def unshard(shards: Sequence[torch.Tensor], sharding: Sharding) -> torch.Tensor:
    """The full leaf from every rank's slice, in the mesh's rank order
    (``shards[r]`` from the rank at ``mesh.coords(r)``); a replicated dim
    takes the first rank's copy."""
    mesh = sharding.mesh
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} ranks")
    local = tuple(shards[0].shape)
    full = tuple(n * sharding.parts(d) for d, n in enumerate(local))
    out = shards[0].new_empty(full)
    done = set()
    for r, s in enumerate(shards):
        sl = sharding.slices(full, mesh.coords(r))
        key = tuple((x.start, x.stop) for x in sl)
        if key not in done:
            done.add(key)
            out[sl] = s
    return out

"""Flat (G, P) layout of the gossip-stacked training state.

The port holds each node's parameters, gradients and momentum as views into
three persistent (G, P) buffers instead of one tensor per leaf: the fused
gossip kernel and the DBench probe then run over one contiguous matrix with
no concatenated copy.  Leaves sit in the reference package's leaf order
(``jax.tree.leaves`` of the nested parameter dict: sorted keys, depth
first), so column ``offsets[j]:offsets[j+1]`` of a buffer is leaf ``j`` of
the reference tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

__all__ = ["FlatLayout"]


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Named leaf shapes packed back to back along one flat axis."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]

    @classmethod
    def from_shapes(cls, shapes: Mapping[str, tuple[int, ...]]) -> "FlatLayout":
        """Leaves in the mapping's order (the port's dicts keep leaf order)."""
        return cls(tuple(shapes), tuple(tuple(s) for s in shapes.values()))

    @classmethod
    def of_stacked(cls, tree: Mapping[str, torch.Tensor]) -> "FlatLayout":
        """Layout of a dict of (G, ...) tensors (the node axis dropped)."""
        return cls.from_shapes({k: tuple(v.shape[1:]) for k, v in tree.items()})

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)

    @property
    def offsets(self) -> tuple[int, ...]:
        """(n_leaves + 1,) column offsets of each leaf."""
        out = [0]
        for s in self.sizes:
            out.append(out[-1] + s)
        return tuple(out)

    @property
    def size(self) -> int:
        """P: elements of one node's flattened state."""
        return self.offsets[-1]

    def views(self, row: torch.Tensor) -> dict[str, torch.Tensor]:
        """Leaf views into one node's (P,) row."""
        off = self.offsets
        return {
            name: row[off[j]:off[j + 1]].view(shape)
            for j, (name, shape) in enumerate(zip(self.names, self.shapes))
        }

    def stacked_views(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        """Leaf views (G, *shape) into a (G, P) buffer."""
        g = buf.shape[0]
        off = self.offsets
        return {
            name: buf[:, off[j]:off[j + 1]].view((g,) + shape)
            for j, (name, shape) in enumerate(zip(self.names, self.shapes))
        }

    def flatten(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """A dict of (G, *shape) leaves -> a new contiguous (G, P) buffer."""
        leaves = [tree[name] for name in self.names]
        g = leaves[0].shape[0]
        return torch.cat([x.reshape(g, -1) for x in leaves], dim=1).contiguous()

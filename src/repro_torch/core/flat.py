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
from typing import Callable, Mapping, Optional

import torch

from repro_torch.optim.sgd import state_from, state_parts

__all__ = ["FlatLayout", "node_grads_into", "opt_buffers", "update_leaves"]


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


def opt_buffers(optimizer, layout: FlatLayout, theta: torch.Tensor) -> dict:
    """The optimizer's initial state for every row of ``theta`` as flat
    buffers: one (rows, P) float32 buffer per slot, and ``"t"`` (rows,)
    int32 for a step-counted optimizer; every row starts as row 0's."""
    rows = theta.shape[0]
    parts, t = state_parts(optimizer, optimizer.init(layout.views(theta[0])))
    opt = {}
    for slot, leaves in parts.items():
        buf = torch.empty(theta.shape, dtype=torch.float32, device=theta.device)
        for name, view in layout.views(buf[0]).items():
            view.copy_(leaves[name])
        buf[1:].copy_(buf[:1].expand(rows - 1, -1))
        opt[slot] = buf
    if t is not None:
        opt["t"] = t.reshape(1).expand(rows).to(torch.int32).clone()
    return opt


def update_leaves(optimizer, update: Callable, layout: FlatLayout, theta: torch.Tensor,
                  opt: dict, grads: Mapping[str, torch.Tensor], lr: float, *,
                  mix: Optional[Callable] = None, mix_order: str = "post") -> None:
    """One local optimizer step and gossip mix over flat state, leaf by leaf,
    written back IN PLACE, so float32 temporaries stay one leaf's.

    ``theta`` (rows, P) and ``opt`` (a (rows, P) float32 buffer per
    optimizer slot, ``"t"`` (rows,) for a step-counted optimizer) are laid
    out by ``layout``; ``grads`` maps each leaf to its (rows, ...) gradient;
    ``update`` is ``optimizer.update`` vmapped over the rows.  ``mix`` (a
    function of one (rows, ...) leaf) runs after the update for ``"post"``,
    on the parameters before it for ``"pre"``.
    """
    p_views = layout.stacked_views(theta)
    slot_views = {s: layout.stacked_views(opt[s]) for s in optimizer.slots}
    t, new_t = opt.get("t"), None
    for name in layout.names:
        p = p_views[name]
        p_in = mix(p) if mix is not None and mix_order == "pre" else p
        st = state_from(optimizer, {s: {name: v[name]} for s, v in slot_views.items()}, t)
        new_p, new_st = update({name: grads[name]}, st, {name: p_in}, lr)
        out = new_p[name]
        if mix is not None and mix_order == "post":
            out = mix(out)
        p.copy_(out)
        parts, new_t = state_parts(optimizer, new_st)
        for s, leaves in parts.items():
            slot_views[s][name].copy_(leaves[name])
    if new_t is not None:
        opt["t"].copy_(new_t)


def node_grads_into(loss_fn: Callable, layout: FlatLayout, theta: torch.Tensor,
                    grad: torch.Tensor, batch: Mapping, *extra) -> torch.Tensor:
    """Per-node loss and gradients, one node (row) at a time, so only one
    node's activations are alive: ``loss_fn(params, node_batch, *extra)``
    on row i's leaf views of ``theta``, its gradients written into row i of
    ``grad`` (same shape and dtype).  Returns the (rows,) float32 losses."""
    losses = torch.empty(theta.shape[0], dtype=torch.float32, device=theta.device)
    for i in range(theta.shape[0]):
        params = {k: v.detach().requires_grad_() for k, v in layout.views(theta[i]).items()}
        loss = loss_fn(params, {k: v[i] for k, v in batch.items()}, *extra)
        grads = torch.autograd.grad(loss, list(params.values()))
        for view, gi in zip(layout.views(grad[i]).values(), grads):
            view.copy_(gi)
        losses[i] = loss.detach()
    return losses

"""Flat (G, P) layout of the gossip-stacked training state.

The port holds each node's parameters, gradients and momentum as views into
three persistent (G, P) buffers instead of one tensor per leaf: the fused
gossip kernel and the DBench probe then run over one contiguous matrix with
no concatenated copy.  Leaves sit in the reference package's leaf order
(``jax.tree.leaves`` of the nested parameter dict: sorted keys, depth
first), so column ``offsets[j]:offsets[j+1]`` of a buffer is leaf ``j`` of
the reference tree.

A model whose leaves are of more than one dtype (a bfloat16 hybrid keeps its
Mamba2 ``a_log``/``d_skip`` in float32) is held in the promoted dtype:
``state_dtype`` is float32 there, as the reference's fused step promotes the
concatenated leaves, and the update keeps it: after every update the
narrower leaves' columns are rounded back to their own dtype
(``round_leaves_``), so every parameter holds a value of its leaf's dtype,
while the f32 leaves stay float32 and the gossip wire carries float32.  The
forward takes each leaf in its own dtype (``leaf_views``); the gradients,
each leaf's in its dtype, land in the float32 gradient buffer exactly.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Mapping, Optional

import torch

from repro_torch.checkpoint.ckpt import AsDtype
from repro_torch.models.common import unflatten_tree
from repro_torch.optim.sgd import state_from, state_parts

__all__ = ["FlatLayout", "checkpoint_tree", "node_grads_into", "opt_buffers",
           "update_leaves"]


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Named leaf shapes packed back to back along one flat axis."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    # each leaf's own dtype (None: every leaf is of the state's dtype)
    dtypes: Optional[tuple[torch.dtype, ...]] = None

    @classmethod
    def from_shapes(cls, shapes: Mapping[str, tuple[int, ...]],
                    dtypes: Optional[Mapping[str, torch.dtype]] = None) -> "FlatLayout":
        """Leaves in the mapping's order (the port's dicts keep leaf order)."""
        return cls(tuple(shapes), tuple(tuple(s) for s in shapes.values()),
                   None if dtypes is None else tuple(dtypes[k] for k in shapes))

    @classmethod
    def of_defs(cls, defs: Mapping) -> "FlatLayout":
        """Layout of a flat ParamDef dict, each leaf with its dtype."""
        return cls.from_shapes({k: d.shape for k, d in defs.items()},
                               {k: d.dtype for k, d in defs.items()})

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

    @property
    def state_dtype(self) -> torch.dtype:
        """The flat state's dtype: the leaves' promoted dtype."""
        return functools.reduce(torch.promote_types, self.dtypes)

    @property
    def mixed(self) -> bool:
        """Whether the leaves are of more than one dtype."""
        return self.dtypes is not None and len(set(self.dtypes)) > 1

    def narrow_leaves(self) -> tuple[tuple[int, int, torch.dtype], ...]:
        """(start, stop, dtype) column ranges of the leaves narrower than
        the state's dtype."""
        if not self.mixed:
            return ()
        wide = self.state_dtype
        off = self.offsets
        return tuple((off[j], off[j + 1], dt) for j, dt in enumerate(self.dtypes)
                     if dt != wide)

    def round_leaves_(self, buf: torch.Tensor) -> torch.Tensor:
        """Round every narrower leaf's columns of a (rows, P) buffer to its
        own dtype, IN PLACE (a no-op unless the layout is mixed)."""
        for a, b, dt in self.narrow_leaves():
            cols = buf[:, a:b]
            cols.copy_(cols.to(dt))
        return buf

    @property
    def row_bytes(self) -> int:
        """Bytes of one node's parameters, each leaf in its own dtype."""
        return sum(n * torch.empty((), dtype=dt).element_size()
                   for n, dt in zip(self.sizes, self.dtypes))

    def leaf_views(self, row: torch.Tensor) -> dict[str, torch.Tensor]:
        """One node's leaves, each in its own dtype: views into the (P,) row,
        copies for the leaves narrower than the row."""
        views = self.views(row)
        if not self.mixed:
            return views
        return {k: v.to(dt) for (k, v), dt in zip(views.items(), self.dtypes)}

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
                  mix: Optional[Callable] = None, mix_order: str = "post",
                  gate: Optional[torch.Tensor] = None) -> None:
    """One local optimizer step and gossip mix over flat state, leaf by leaf,
    written back IN PLACE, so float32 temporaries stay one leaf's.

    ``theta`` (rows, P) and ``opt`` (a (rows, P) float32 buffer per
    optimizer slot, ``"t"`` (rows,) for a step-counted optimizer) are laid
    out by ``layout``; ``grads`` maps each leaf to its (rows, ...) gradient;
    ``update`` is ``optimizer.update`` vmapped over the rows.  ``mix`` (a
    function of one (rows, ...) leaf) runs after the update for ``"post"``,
    on the parameters before it for ``"pre"``.  ``gate`` (a (rows,) fault
    mask, ``update``) keeps the rows where it is 0 at their parameters
    (mixed first for ``"pre"``) and optimizer state: stragglers and dead
    nodes skip their local update.  A mixed layout's leaves are updated
    and mixed in their own dtypes, as the reference's per-leaf interpreter
    runs them.
    """
    p_views = layout.stacked_views(theta)
    slot_views = {s: layout.stacked_views(opt[s]) for s in optimizer.slots}
    t, new_t = opt.get("t"), None
    keep = None if gate is None else torch.as_tensor(gate, device=theta.device) > 0
    dtypes = dict(zip(layout.names, layout.dtypes)) if layout.mixed else {}
    for name in layout.names:
        p = p_views[name]
        if name in dtypes:   # a mixed layout: the leaf in its own dtype
            p = p.to(dtypes[name])
        p_in = mix(p) if mix is not None and mix_order == "pre" else p
        st = state_from(optimizer, {s: {name: v[name]} for s, v in slot_views.items()}, t)
        new_p, new_st = update({name: grads[name]}, st, {name: p_in}, lr)
        out = new_p[name]
        col = None if keep is None else keep.reshape((-1,) + (1,) * (out.dim() - 1))
        if col is not None:
            out = torch.where(col, out, p_in)
        if mix is not None and mix_order == "post":
            out = mix(out)
        p_views[name].copy_(out)
        parts, new_t = state_parts(optimizer, new_st)
        for s, leaves in parts.items():
            view = slot_views[s][name]
            view.copy_(leaves[name] if col is None else torch.where(col, leaves[name], view))
    if new_t is not None:
        opt["t"].copy_(new_t if keep is None else torch.where(keep, new_t, opt["t"]))


def node_grads_into(loss_fn: Callable, layout: FlatLayout, theta: torch.Tensor,
                    grad: torch.Tensor, batch: Mapping, *extra,
                    accum_steps: int = 1) -> torch.Tensor:
    """Per-node loss and gradients, one node (row) at a time, so only one
    node's activations are alive: ``loss_fn(params, node_batch, *extra)``
    on row i's leaf views of ``theta``, its gradients written into row i of
    ``grad`` (same shape and dtype).  Returns the (rows,) float32 losses.

    With ``accum_steps`` k > 1 a node's batch splits along its first axis
    into k microbatches (the reference's reshape to (k, B/k, ...)); the
    loss and the gradients are their means, summed from zero in microbatch
    order as the reference's scan sums them, the gradients IN PLACE in the
    node's row of ``grad`` (in its dtype: a bfloat16 row rounds each
    partial sum, where the reference carries a float32 tree)."""
    losses = torch.empty(theta.shape[0], dtype=torch.float32, device=theta.device)
    for i in range(theta.shape[0]):
        node_batch = {k: v[i] for k, v in batch.items()}
        views = layout.views(grad[i]).values()
        if accum_steps == 1:
            loss, grads = _loss_and_grads(loss_fn, layout, theta[i], node_batch, extra)
            for view, gi in zip(views, grads):
                view.copy_(gi)
            losses[i] = loss
            continue
        micro = {}
        for k, v in node_batch.items():
            if v.shape[0] % accum_steps:
                raise ValueError(f"per-node batch {v.shape[0]} ({k}) does not split into "
                                 f"{accum_steps} microbatches")
            micro[k] = v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])
        total = torch.zeros((), dtype=torch.float32, device=theta.device)
        for view in views:
            view.zero_()
        for m in range(accum_steps):
            loss, grads = _loss_and_grads(loss_fn, layout, theta[i],
                                          {k: v[m] for k, v in micro.items()}, extra)
            for view, gi in zip(views, grads):
                view.add_(gi / accum_steps)
            total = total + loss.float() / accum_steps
        losses[i] = total
    return losses


def _loss_and_grads(loss_fn, layout: FlatLayout, row: torch.Tensor, batch, extra):
    """One node's loss (detached) and its gradients, in leaf order, each
    leaf in its own dtype."""
    params = {k: v.detach().requires_grad_() for k, v in layout.leaf_views(row).items()}
    loss = loss_fn(params, batch, *extra)
    return loss.detach(), torch.autograd.grad(loss, list(params.values()))


def checkpoint_tree(optimizer, layout: FlatLayout, theta: torch.Tensor, opt: dict) -> dict:
    """The flat state as the reference's ``{"p": params, "o": opt_state}``
    tree of (rows, ...) leaves: views into the buffers, no copy, nested by
    the leaves' dotted names (``checkpoint/ckpt.py`` keys them by their
    tree paths).  The optimizer state takes the reference's shape:
    params-like (momentum, LARS), ``{"mu", "nu", "t"}`` (AdamW) or ``()``.
    A mixed layout's narrower leaves come in an ``AsDtype`` of their own
    dtype: written as the reference writes them, restored into the view."""
    parts = {s: unflatten_tree(layout.stacked_views(opt[s])) for s in optimizer.slots}
    params = layout.stacked_views(theta)
    if layout.mixed:
        params = {k: v if dt == theta.dtype else AsDtype(v, dt)
                  for (k, v), dt in zip(params.items(), layout.dtypes)}
    return {"p": unflatten_tree(params),
            "o": state_from(optimizer, parts, opt.get("t"))}

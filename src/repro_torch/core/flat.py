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

The simulator's split state (``shard_nodes`` over several cards) holds
each buffer as a ``core/node_split.NodeBlocks`` of row blocks: the views,
the optimizer buffers, the update, the gradients and the rounding below
work block by block, each on its block's card, and a split leaf is a
NodeBlocks of its blocks' views.  Only the ``mix`` of ``update_leaves``
reads across blocks (the program's split interpreter).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Mapping, Optional

import torch

from repro_torch.checkpoint.ckpt import AsDtype, RowBlocks, map_leaves
from repro_torch.core.node_split import as_blocks, blocks_of, like
from repro_torch.models.common import unflatten_tree
from repro_torch.optim.sgd import state_from, state_parts

__all__ = ["FlatLayout", "checkpoint_tree", "node_grads_into", "opt_buffers",
           "round_columns_", "update_leaves"]


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
        return round_columns_(buf, self.narrow_leaves())

    @property
    def row_bytes(self) -> int:
        """Bytes of one node's parameters, each leaf in its own dtype."""
        return sum(n * dt.itemsize for n, dt in zip(self.sizes, self.dtypes))

    def stacked_leaf_views(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        """(rows, *shape) leaves of a (rows, P) buffer, each in its own
        dtype: views, copies for the leaves narrower than the buffer."""
        views = self.stacked_views(buf)
        if not self.mixed:
            return views
        return {k: v.to(dt) for (k, v), dt in zip(views.items(), self.dtypes)}

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
        """Leaf views (G, *shape) into a (G, P) buffer (of a split buffer,
        each leaf a NodeBlocks of its blocks' views)."""
        off = self.offsets
        per = [{name: b[:, off[j]:off[j + 1]].view((b.shape[0],) + shape)
                for j, (name, shape) in enumerate(zip(self.names, self.shapes))}
               for b in blocks_of(buf)]
        return {name: like(buf, [v[name] for v in per]) for name in self.names}

    def flatten(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """A dict of (G, *shape) leaves -> a new contiguous (G, P) buffer
        (split leaves, block by block, -> a NodeBlocks)."""
        first = tree[self.names[0]]
        per = zip(*(blocks_of(tree[name]) for name in self.names))
        return like(first, [torch.cat([x.reshape(x.shape[0], -1) for x in leaves],
                                      dim=1).contiguous() for leaves in per])


def round_columns_(x: torch.Tensor, ranges, offset: int = 0) -> torch.Tensor:
    """Round IN PLACE the columns of ``x`` that ``ranges`` ((start, stop,
    dtype) column ranges of a flat buffer whose columns ``offset`` on ``x``
    holds) give a dtype other than ``x``'s, to that dtype (a split ``x``
    block by block)."""
    for a, b, dt in ranges:
        lo, hi = max(a - offset, 0), min(b - offset, x.shape[-1])
        if hi > lo and dt != x.dtype:
            for blk in blocks_of(x):
                cols = blk[..., lo:hi]
                cols.copy_(cols.to(dt))
    return x


def opt_buffers(optimizer, layout: FlatLayout, theta: torch.Tensor) -> dict:
    """The optimizer's initial state for every row of ``theta`` as flat
    buffers: one (rows, P) float32 buffer per slot, and ``"t"`` (rows,)
    int32 for a step-counted optimizer; every row starts as row 0's.  A
    split ``theta`` gets split buffers, each block's on its card."""
    per = [_opt_buffers(optimizer, layout, b) for b in blocks_of(theta)]
    return {k: like(theta, [o[k] for o in per]) for k in per[0]}


def _opt_buffers(optimizer, layout: FlatLayout, theta: torch.Tensor) -> dict:
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
    runs them.  A split state (NodeBlocks buffers, the gradients NodeBlocks
    leaves) is updated block by block on each block's card; ``mix`` then
    takes and returns a NodeBlocks leaf.
    """
    thetas = blocks_of(theta)
    p_views = [layout.stacked_views(b) for b in thetas]
    slot_views = [{} for _ in thetas]
    for s in optimizer.slots:
        for views, buf in zip(slot_views, blocks_of(opt[s])):
            views[s] = layout.stacked_views(buf)
    ts = blocks_of(opt["t"]) if "t" in opt else [None] * len(thetas)
    if gate is None:
        keeps = [None] * len(thetas)
    else:
        keep = torch.as_tensor(gate, device=thetas[0].device) > 0
        keeps = as_blocks(theta).per_node(keep)
    dtypes = dict(zip(layout.names, layout.dtypes)) if layout.mixed else {}
    new_ts = [None] * len(thetas)
    for name in layout.names:
        p = like(theta, [v[name] for v in p_views])
        if name in dtypes:   # a mixed layout: the leaf in its own dtype
            p = p.to(dtypes[name])
        p_in = mix(p) if mix is not None and mix_order == "pre" else p
        g = blocks_of(grads[name])
        outs, cols, states = [], [], []
        for j, pj in enumerate(blocks_of(p_in)):
            st = state_from(optimizer, {s: {name: v[name]} for s, v in slot_views[j].items()},
                            ts[j])
            new_p, new_st = update({name: g[j]}, st, {name: pj}, lr)
            out = new_p[name]
            col = None if keeps[j] is None else keeps[j].reshape((-1,) + (1,) * (out.dim() - 1))
            outs.append(out if col is None else torch.where(col, out, pj))
            cols.append(col)
            states.append(new_st)
        out = like(theta, outs)
        if mix is not None and mix_order == "post":
            out = mix(out)
        for j, oj in enumerate(blocks_of(out)):
            p_views[j][name].copy_(oj)
            parts, new_ts[j] = state_parts(optimizer, states[j])
            for s, leaves in parts.items():
                view = slot_views[j][s][name]
                view.copy_(leaves[name] if cols[j] is None
                           else torch.where(cols[j], leaves[name], view))
    for t, new_t, keep in zip(ts, new_ts, keeps):
        if new_t is not None:
            t.copy_(new_t if keep is None else torch.where(keep, new_t, t))


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
    partial sum, where the reference carries a float32 tree).

    The simulator's split state calls it once a row block."""
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
    dtype: written as the reference writes them, restored into the view.
    A split state's leaves are ``RowBlocks`` of their blocks' views, so
    the file is the unsplit one byte for byte."""
    parts = {s: unflatten_tree(layout.stacked_views(opt[s])) for s in optimizer.slots}
    params = layout.stacked_views(theta)
    if layout.mixed:
        params = {k: v if dt == theta.dtype else AsDtype(v, dt)
                  for (k, v), dt in zip(params.items(), layout.dtypes)}
    tree = {"p": unflatten_tree(params), "o": state_from(optimizer, parts, opt.get("t"))}
    if len(blocks_of(theta)) == 1:
        return tree
    return map_leaves(lambda v: RowBlocks(tuple(v.blocks)), tree)

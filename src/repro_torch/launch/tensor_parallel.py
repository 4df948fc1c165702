"""Tensor parallelism inside a node: the autograd collectives over a node's
model group.

The reference lets GSPMD partition each node's replica over its "model"
mesh axis.  The port realizes the same placement explicitly, Megatron
style: rank j of a node holds shard j of every leaf that the leaf's
validated spec puts on "model" (``launch/sharding.py``) and a copy of
every other leaf, and the forward (``models/transformer.py``,
``models/mlp.py``, ``models/moe.py``) calls the collectives below where a
computation turns sharded or back:

* ``enter`` — identity forward, all-reduce of the gradient backward: a
  replicated tensor entering a sharded computation (the input of a
  column- or row-parallel product, a replicated bias added to local heads,
  the router's weights in the local experts' combine).  Each rank's
  gradient there is its share of the whole; the all-reduce makes it the
  whole on every rank, so the gradient of every replicated leaf is the
  full one, the same bits on every rank of the node;
* ``reduce`` — all-reduce forward, identity backward: the partial sums of
  a row-parallel product (or of the local experts), in float32, rounded
  once to the input's dtype as the reference's ``psum`` is;
* ``gather`` — all-gather along a dim forward, this rank's slice of the
  gradient backward (the embedding's d_model columns, a ``wo`` split on
  its output dim);
* ``max`` — all-reduce max, no gradient (the vocab-parallel log-softmax's
  shift);
* ``sum`` — all-reduce in float32 (or wider), NOT rounded to the input's
  dtype, with the backward of a sum: the gradient all-reduced too, since
  the replicated total feeds each rank's share of a sharded computation
  (a norm over sharded channels: Mamba2's gated RMSNorm over d_inner sums
  each rank's squares with it, so its mean is the reference's).

A node that spans data axes too (kimi-k2's G = 1 placement: FSDP over
the data axes, ``moe_shard_ff``'s expert d_ff over "data") has a **data
group** as well: the node's ranks that hold the same model index
(``DataParallel``).  A leaf whose spec names a data axis is stored as the
rank's slice; ``DataParallel.gather`` all-gathers it over the data group
to the rank's model shard just before the forward reads it (one layer's
leaves at a time, inside the layer's remat region) and reduce-scatters its
gradient back (the sum over the data ranks; the trainer divides by their
count: the mean over their shares of the batch).  The same collective pair
gathers a MoE layer's tokens over the data group when the batch is split
over it (``gather(x, 0)``): the experts route the whole batch once,
identically on every data rank, as the reference's capacity rule counts
the tokens of the whole batch; each data rank computes its share of the
experts' capacity slots, and ``scatter_rows`` (reduce-scatter forward,
all-gather backward) sums the shares into each rank's own rows.

Every collective goes through ``launch/comm.py``'s ``Comm`` of the model
group (or the data group), so its op record, the linter and the roofline's wire term see it;
a ``RecordingComm`` makes them shape-only on ``meta`` (the dry run).
"""
from __future__ import annotations

import torch

__all__ = ["ModelParallel", "DataParallel"]


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(ctx.comm, g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return _all_reduce_f32(comm, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, x.shape[dim]
        return comm.all_gather(x.contiguous(), dim=dim)

    @staticmethod
    def backward(ctx, g):
        a = ctx.comm.rank * ctx.n
        return g.narrow(ctx.dim, a, ctx.n), None, None


class _GatherAtUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x.contiguous(), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g.contiguous(), ctx.dim), None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.reduce_scatter(x.contiguous(), 0)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g.contiguous(), dim=0), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _all_reduce_f32(comm, x, rounded=False)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(ctx.comm, g), None


def _all_reduce_f32(comm, x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """Sum over the group in float32 (or wider), rounded once to x's dtype
    (``rounded``) or kept wide."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
    if xf is x:
        xf = xf.clone()
    out = comm.all_reduce(xf)
    return out.to(x.dtype) if rounded else out


class ModelParallel:
    """A node's model group as the forward sees it: ``size`` ranks, this
    one ``rank``, the collectives over ``comm`` (a ``Comm`` of the group)."""

    def __init__(self, comm, data=None):
        self.comm = comm
        self.size = comm.world
        self.rank = comm.rank
        # the node's data group (a ``DataParallel``), None without one
        self.data = data

    def split(self, n: int):
        """This group when a dim of ``n`` is sharded over it (the reference's
        validated spec: ``n`` divides by the group's size), else None."""
        return self if self.size > 1 and n % self.size == 0 else None

    def local(self, n: int) -> slice:
        """This rank's range of a dim of ``n`` sharded over the group."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.comm)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.comm)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self.comm, dim % x.dim())

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(x, self.comm)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(x.detach().contiguous().clone(), op="max")


class DataParallel:
    """A node's data group as the forward sees it: ``size`` ranks, this one
    ``rank``; ``dims`` maps each leaf the group shards to the dim it is
    split on (its full name, the stacked layer dim included), and
    ``split_batch`` says whether the node's batch is split over the group
    (G = 1) or every data rank holds all of it (G > 1)."""

    def __init__(self, comm, dims: dict, *, split_batch: bool):
        self.comm = comm
        self.size = comm.world
        self.rank = comm.rank
        self.dims = dict(dims)
        self.split_batch = bool(split_batch)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather along ``dim`` forward, reduce-scatter (sum) backward."""
        return _GatherAtUse.apply(x, self.comm, dim % x.dim())

    def layer_leaves(self, lp: dict, prefix: str) -> dict:
        """One layer's views ``lp`` (names under ``prefix``, their stacked
        layer dim dropped) with every leaf the group splits gathered; a
        leaf split on its layer dim comes whole from the forward's entry."""
        out = {}
        for k, v in lp.items():
            d = self.dims.get(prefix + k)
            out[k] = v if not d else self.gather(v, d - 1)
        return out

    def own_rows(self, y: torch.Tensor, b: int) -> torch.Tensor:
        """This rank's ``b`` rows of a gathered (size·b, ...) tensor."""
        return y.narrow(0, self.rank * b, b)

    def scatter_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's (size·b, ...) ``x``, this rank's b rows
        kept: reduce-scatter forward, all-gather backward."""
        return _ScatterRows.apply(x, self.comm)

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
  shift).

Every collective goes through ``launch/comm.py``'s ``Comm`` of the model
group, so its op record, the linter and the roofline's wire term see it;
a ``RecordingComm`` makes them shape-only on ``meta`` (the dry run).
"""
from __future__ import annotations

import torch

__all__ = ["ModelParallel"]


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


def _all_reduce_f32(comm, x: torch.Tensor) -> torch.Tensor:
    """Sum over the group in float32 (or wider), rounded once to x's dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
    if xf is x:
        xf = xf.clone()
    return comm.all_reduce(xf).to(x.dtype)


class ModelParallel:
    """A node's model group as the forward sees it: ``size`` ranks, this
    one ``rank``, the collectives over ``comm`` (a ``Comm`` of the group)."""

    def __init__(self, comm):
        self.comm = comm
        self.size = comm.world
        self.rank = comm.rank

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

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(x.detach().contiguous().clone(), op="max")

"""The simulator's node split over several cards (``shard_nodes``): the
counterpart of the reference's virtual-node sharding
(``repro/core/simulator.py``'s ``_node_sharding``/``_place``).

``split_devices`` is the reference's rule: the node axis goes over the
largest count ``d`` of the simulator's device type that divides n.  With
``d > 1`` the simulator holds every (n, ...) buffer of its state (θ, each
optimizer slot, the gradient buffer) as a ``NodeBlocks``: ``d`` row blocks,
block ``j`` holding nodes ``[j·n/d, (j+1)·n/d)`` on card ``j``.  A card
holds its own block and the transient rows it receives; every per-node
computation (the gradients, the optimizer update, the DBench probe) runs
block by block on the block's card, and what reads other nodes' rows
(mixing, the consensus probe, the centralized mean, the elastic handoffs)
copies the rows it reads with ``Tensor.to``, which orders the copy on both
cards' current streams.  Peer access between cards is not assumed.  A
reduction over every node takes one column chunk at a time
(``over_nodes``): only that chunk of every row is gathered to the first
card, and each block receives back its rows of the result.

The callers see one layout: ``as_blocks`` takes an unsplit (n, ...) tensor
as one block (its shortcuts copy nothing), ``blocks_of`` lists the blocks
and ``like`` gives parts back in the caller's layout, so the same code
runs the split and the unsplit state.

The numbers are the unsplit run's bit for bit where each node's gradients
are taken one node at a time (``node_loop``): an elementwise operation
gives every row the same bits whatever block holds it, and a sum down
each column (a mean over the nodes, Ξ, a norm) adds the same values in
the same order in a chunk as over the whole width.  Three things may
round apart, each within 1e-6 relative: the dense interpreter, which
multiplies each block's rows of W by column chunks of θ on the block's
card (``split_matmul``); the other matrix products over every node (a
GatherRow op, a masked program that is not all-PPermute), taken on
column chunks whose kernel the card picks by the chunk's shape; and the
gradients under vmap, whose batched operations run over a block's n/d
nodes instead of all n.

Tests, and the chip script's check, replace ``split_devices`` to place k
blocks on one device (``[dev] * k``): the only way to run a k-block split
on a machine with fewer cards.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["NodeBlocks", "SPLIT_CHUNK", "as_blocks", "blocks_of", "cat_nodes", "cols", "empty",
           "like", "over_nodes", "place", "split_devices", "split_matmul"]

# columns of one gathered chunk (per row) of a reduction over every node
# and of the dense interpreter: a card holds at most one such chunk of
# every node's rows at a time
SPLIT_CHUNK = 1 << 22


def split_devices(n: int, device) -> list[torch.device]:
    """The devices the n rows split over: the largest count of the
    simulator's device type that divides n (the reference's rule), the
    first that many cards; the simulator's own device when that count is
    1 (always on the CPU)."""
    device = torch.device(device)
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    d = max(k for k in range(1, count + 1) if n % k == 0)
    if d == 1:
        return [device]
    return [torch.device("cuda", i) for i in range(d)]


def _even_starts(n: int, k: int) -> tuple[int, ...]:
    if n % k:
        raise ValueError(f"{n} rows do not split into {k} equal blocks")
    return tuple(j * (n // k) for j in range(k + 1))


class NodeBlocks:
    """A node-major buffer of n rows held as row blocks: ``blocks[j]`` is
    rows ``starts[j]:starts[j+1]`` on its own device.  It answers
    ``shape``, ``dtype`` and ``device`` (the first block's) as the unsplit
    tensor would."""

    def __init__(self, blocks: Sequence[torch.Tensor], starts: Sequence[int]):
        self.blocks = list(blocks)
        self.starts = tuple(int(s) for s in starts)
        if len(self.starts) != len(self.blocks) + 1 or any(
                b.shape[0] != hi - lo for b, lo, hi in
                zip(self.blocks, self.starts[:-1], self.starts[1:])):
            raise ValueError(f"blocks of {[b.shape[0] for b in self.blocks]} rows do not "
                             f"match the row starts {self.starts}")

    # -- construction ---------------------------------------------------------
    @classmethod
    def empty(cls, n: int, tail: tuple, dtype, devices) -> "NodeBlocks":
        starts = _even_starts(n, len(devices))
        return cls([torch.empty((b - a,) + tuple(tail), dtype=dtype, device=d)
                    for a, b, d in zip(starts[:-1], starts[1:], devices)], starts)

    @classmethod
    def split(cls, full: torch.Tensor, devices) -> "NodeBlocks":
        """Copies of ``full``'s rows in equal blocks on ``devices``."""
        starts = _even_starts(full.shape[0], len(devices))
        return cls([full[a:b].to(d, copy=True) for a, b, d in
                    zip(starts[:-1], starts[1:], devices)], starts)

    # -- the unsplit tensor's attributes ---------------------------------------
    @property
    def n(self) -> int:
        return self.starts[-1]

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.n,) + tuple(self.blocks[0].shape[1:]))

    @property
    def ndim(self) -> int:
        return self.blocks[0].dim()

    def dim(self) -> int:
        return self.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def devices(self) -> list[torch.device]:
        return [b.device for b in self.blocks]

    @property
    def ranges(self) -> list[tuple[int, int]]:
        return list(zip(self.starts[:-1], self.starts[1:]))

    # -- block by block --------------------------------------------------------
    def map(self, fn: Callable) -> "NodeBlocks":
        """``fn`` on each block, the results at the same rows."""
        return NodeBlocks([fn(b) for b in self.blocks], self.starts)

    def to(self, *args, **kwargs) -> "NodeBlocks":
        """Each block cast (``Tensor.to``) on its own device."""
        return self.map(lambda b: b.to(*args, **kwargs))

    def copy_(self, src) -> "NodeBlocks":
        """Block by block, IN PLACE, from a NodeBlocks of the same rows."""
        for dst, s in zip(self.blocks, src.blocks):
            dst.copy_(s)
        return self

    def per_node(self, vec) -> list:
        """An (n, ...) per-node tensor cut into the blocks' rows, each on its
        block's device."""
        vec = torch.as_tensor(vec)
        return [vec[a:b].to(blk.device) for (a, b), blk in zip(self.ranges, self.blocks)]

    # -- rows and columns across blocks ------------------------------------------
    def locate(self, i: int) -> tuple[int, int]:
        """(block, row within it) of node ``i``."""
        i = int(i)
        if not 0 <= i < self.n:
            raise IndexError(f"node {i} of {self.n}")
        j = int(np.searchsorted(self.starts, i, side="right")) - 1
        return j, i - self.starts[j]

    def row(self, i: int) -> torch.Tensor:
        """Node ``i``'s row: a view into its block."""
        j, r = self.locate(i)
        return self.blocks[j][r]

    def rows(self, idx, device=None, cols: Optional[tuple[int, int]] = None) -> torch.Tensor:
        """Copies of the rows ``idx`` (global node indices, in that order) on
        ``device`` (the first block's by default), of columns ``cols`` of
        the last axis when given: one ``index_select`` on each block that
        holds any of them and one copy to ``device``."""
        device = self.device if device is None else torch.device(device)
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        if len(self.blocks) == 1:
            blk = self.blocks[0] if cols is None else self.blocks[0][..., cols[0]:cols[1]]
            return blk.index_select(0, torch.as_tensor(idx, device=blk.device)).to(device)
        owner = np.searchsorted(self.starts, idx, side="right") - 1
        pieces = []
        for j in np.unique(owner):
            pos = np.nonzero(owner == j)[0]
            blk = self.blocks[j] if cols is None else self.blocks[j][..., cols[0]:cols[1]]
            local = torch.as_tensor(idx[pos] - self.starts[j], device=blk.device)
            pieces.append((pos, blk.index_select(0, local).to(device)))
        if len(pieces) == 1 and np.array_equal(pieces[0][0], np.arange(len(idx))):
            return pieces[0][1]
        out = torch.empty((len(idx),) + tuple(pieces[0][1].shape[1:]),
                          dtype=self.dtype, device=device)
        for pos, got in pieces:
            out[torch.as_tensor(pos, device=device)] = got
        return out

    def shifted(self, offset: int, a: int, b: int, device=None) -> torch.Tensor:
        """Copies of the rows ``(i + offset) % n`` for i in ``a:b`` on
        ``device``: of one block holding every row, one ``torch.roll``."""
        if len(self.blocks) == 1 and (a, b) == (0, self.n):
            return torch.roll(self.blocks[0], -offset, dims=0).to(
                self.device if device is None else device)
        return self.rows((np.arange(a, b) + offset) % self.n, device)

    def columns(self, a: int, b: int, device=None) -> torch.Tensor:
        """Columns ``a:b`` of every row of the (rows, P)-shaped blocks,
        gathered in node order into one new (n, b - a) tensor on ``device``
        (the first block's by default); of one block, a view where it lies
        on ``device``."""
        device = self.device if device is None else torch.device(device)
        if len(self.blocks) == 1:
            blk = self.blocks[0]
            return blk.reshape(blk.shape[0], -1)[:, a:b].to(device)
        return torch.cat([blk.reshape(blk.shape[0], -1)[:, a:b].to(device)
                          for blk in self.blocks])

    def to_full(self, device=None) -> torch.Tensor:
        """Every row, in node order, copied into one tensor on ``device``
        (the first block's by default): for tests, reads and checkpoints
        of small states; of one block, the block itself where it lies on
        ``device``."""
        device = self.device if device is None else torch.device(device)
        if len(self.blocks) == 1:
            return self.blocks[0].to(device)
        return torch.cat([blk.to(device) for blk in self.blocks])

    def grow(self, rows: torch.Tensor) -> "NodeBlocks":
        """The buffer with ``rows`` appended after node n - 1 (in the last
        block, which is copied once)."""
        last = self.blocks[-1]
        return NodeBlocks(self.blocks[:-1] + [torch.cat([last, rows.to(last.device)])],
                          self.starts[:-1] + (self.n + rows.shape[0],))

    def resplit(self, devices) -> "NodeBlocks":
        """The same rows in equal blocks on ``devices``: each new block
        gathered from the old ones that hold its rows."""
        starts = _even_starts(self.n, len(devices))
        if starts == self.starts and list(devices) == self.devices:
            return self
        return NodeBlocks([self.rows(np.arange(a, b), d) for a, b, d in
                           zip(starts[:-1], starts[1:], devices)], starts)


def as_blocks(x) -> NodeBlocks:
    """A NodeBlocks as it is; an unsplit (n, ...) tensor as one block (no
    copy)."""
    return x if isinstance(x, NodeBlocks) else NodeBlocks([x], (0, x.shape[0]))


def blocks_of(x) -> list:
    """The blocks of a NodeBlocks, or ``[x]`` for an unsplit tensor."""
    return as_blocks(x).blocks


def like(x, parts: Sequence):
    """``parts`` (one per block of ``x``, in block order) in ``x``'s layout:
    a NodeBlocks of them (row starts from their row counts), or the one
    part for an unsplit ``x``."""
    if not isinstance(x, NodeBlocks):
        return parts[0]
    return NodeBlocks(parts, np.cumsum([0] + [p.shape[0] for p in parts]))


def empty(n: int, tail: tuple, dtype, devices):
    """An uninitialized (n, *tail) buffer laid out for ``devices``: a tensor
    on the one device, or equal row blocks over several."""
    if len(devices) == 1:
        return torch.empty((n,) + tuple(tail), dtype=dtype, device=devices[0])
    return NodeBlocks.empty(n, tail, dtype, devices)


def cols(x, a: int, b: int):
    """Views of columns ``a:b`` of the last axis, in ``x``'s layout."""
    return like(x, [blk[..., a:b] for blk in blocks_of(x)])


def cat_nodes(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Per-block (rows, ...) results in node order on ``device``: the one
    part itself (moved) where there is one."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def over_nodes(x, fn: Callable) -> list[torch.Tensor]:
    """A reduction over every node: ``fn`` takes an (n, c) column chunk of
    ``x``'s rows flattened to (n, m) on the first block's device and
    returns a (1, c) or an (n, c) result.  Returns per block, on its
    device, the (1, m) result or the block's (rows, m) of it.

    An unsplit ``x`` is one chunk, a view of all its columns: the result
    comes back as it is, with no copy.  A split ``x`` goes by chunks of
    ``SPLIT_CHUNK`` columns gathered to the first card (the last chunk
    takes the remainder, so no chunk is narrower than ``SPLIT_CHUNK``
    unless x is): each chunk starts on a multiple of ``SPLIT_CHUNK``, so a
    column's reduction runs as it does over the whole width."""
    xb = as_blocks(x)
    m = math.prod(xb.shape[1:])
    step = max(m, 1) if len(xb.blocks) == 1 else SPLIT_CHUNK
    starts = list(range(0, max(m, 1), step))
    if len(starts) > 1 and m - starts[-1] < step:
        starts.pop()
    ends = starts[1:] + [m]
    outs = None
    for c, e in zip(starts, ends):
        r = fn(xb.columns(c, e))
        parts = [r if r.shape[0] == 1 else r[a:b] for a, b in xb.ranges]
        if len(starts) == 1:
            return [p.to(blk.device) for p, blk in zip(parts, xb.blocks)]
        if outs is None:
            outs = [torch.empty((p.shape[0], m), dtype=r.dtype, device=blk.device)
                    for p, blk in zip(parts, xb.blocks)]
        for p, out in zip(parts, outs):
            out[:, c:e].copy_(p)
    return outs


def place(x, devices):
    """A state buffer (a tensor or a NodeBlocks) laid out for ``devices``:
    one device gives a tensor on it, more give equal row blocks."""
    if len(devices) == 1:
        return x.to_full(devices[0]) if isinstance(x, NodeBlocks) else x.to(devices[0])
    if isinstance(x, NodeBlocks):
        return x.resplit(devices)
    return NodeBlocks.split(x, devices)


def split_matmul(w: torch.Tensor, x: NodeBlocks) -> NodeBlocks:
    """θ ← W θ over row blocks: block j's rows of the float32 (n, n) ``w``
    times every node's rows, one column chunk of ``SPLIT_CHUNK`` at a time
    gathered to block j's card; float32 accumulation, the result in
    ``x``'s dtype."""
    tail = tuple(x.shape[1:])
    m = int(np.prod(tail)) if tail else 1
    outs = []
    for (a, b), blk in zip(x.ranges, x.blocks):
        dev = blk.device
        wj = w[a:b].to(dev)
        out = torch.empty((b - a, m), dtype=x.dtype, device=dev)
        for c in range(0, m, SPLIT_CHUNK):
            chunk = x.columns(c, c + SPLIT_CHUNK, dev)
            out[:, c:c + chunk.shape[1]] = torch.einsum(
                "ij,jk->ik", wj, chunk.float()).to(x.dtype)
        outs.append(out.reshape((b - a,) + tail))
    return NodeBlocks(outs, x.starts)

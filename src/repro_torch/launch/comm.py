"""Collectives of the one-rank-per-node engine over ``torch.distributed``.

The counterpart of what the reference's node step takes from its mesh: the
flat axis index (``rank``), the gossip size (``world``) and the three
collectives a ``GossipProgram`` lowers to — ``jax.lax.ppermute``
(``permute``), ``pmean`` and ``all_gather``.

The transport is chosen once, explicitly, from the group's backend and the
device the rank computes on:

* ``"nccl"``: device tensors over NCCL, one card per rank;
* ``"gloo-host"``: CUDA tensors over gloo, staged through fixed-size
  pinned host chunks.  This is the transport of a machine with fewer cards
  than ranks (NCCL refuses two ranks on one card; gloo moves CUDA tensors
  for ``broadcast``/``all_reduce`` only).  The chunks bound the host memory
  and keep every gloo message far below 2 GiB;
* ``"gloo"``: CPU tensors over gloo, directly.

``RecordingComm`` is one rank of a world that exists only on paper: the
dry run's stand-in (``launch/dryrun.py``), which records and bills every
collective and moves no data.

A ``Comm`` may be one of a sub-group (``mesh_comms``): a node's model
group or a shard index's gossip group of a data × model world (the
tensor-parallel ranks engine).  Its ``rank`` and ``world`` are then the
group's, every collective runs on the group, and a permute's, gather's or
scatter's group-local ranks are mapped to the global ones.  Sub-groups
also ``all_reduce`` (sum or max) and ``all_gather`` along a dim, the
tensor-parallel forward's collectives (``launch/tensor_parallel.py``).

``rank_device`` picks a rank's device and backend the same way for every
launcher, and ``spawn_world`` runs a function on every rank of a fresh
world on this machine (file-store rendezvous, hard timeout).

``Comm.recording()`` records, in order, every collective the rank issues
(``CollectiveOp``: kind, peer pairs, bytes): the record the collective
linter (``repro_torch.analysis.collectives``) reads, as the reference's
reads a module's HLO; every collective is also billed to the active op
accounting (``launch/hlo_analysis.py``).  Off, both cost a test a
collective.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import pickle
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import cost

__all__ = ["Comm", "CollectiveOp", "RecordingComm", "mesh_comms", "rank_device",
           "spawn_world", "CHUNK_BYTES"]

# bytes per staged gloo message: bounds the pinned host buffers and keeps
# each message far below gloo's 2 GiB limit
CHUNK_BYTES = 256 << 20


def rank_device(local_rank: int, local_world: int, device=None) -> tuple[torch.device, str]:
    """(device, backend) of one rank: the CPU over gloo when asked
    (``device="cpu"``); else its own card over NCCL when the machine has a
    card per rank; else the one card over gloo (the ``gloo-host`` transport).
    Raises when there is no card and the CPU was not asked for."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu"), "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the ranks "
            "on the CPU"
        )
    if torch.cuda.device_count() >= local_world:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", 0), "gloo"


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective a rank issued: ``kind`` (``permute``, ``pmean``,
    ``all_reduce``, ``all_gather``, ``gather_host``, ``scatter_host``),
    ``pairs`` (a permute's (src, dst) pairs, every rank's, in the group's
    ranks; () for the others, which every rank joins), ``nbytes`` (this
    rank's operand) and ``world`` (the size of the group it ran on; 0
    where the record does not say)."""

    kind: str
    pairs: tuple
    nbytes: int
    world: int = 0


class Comm:
    """This rank's view of an initialised ``torch.distributed`` group (the
    default group, or ``group`` from ``dist.new_group``); ``device`` is the
    device the rank computes on."""

    def __init__(self, device, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised")
        self.device = torch.device(device)
        self.group = group
        if group is None:
            self.ranks = tuple(range(dist.get_world_size()))
        else:
            self.ranks = tuple(dist.get_process_group_ranks(group))
        self.rank = self.ranks.index(dist.get_rank())
        self.world = len(self.ranks)
        backend = dist.get_backend(group)
        if backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError(f"NCCL needs a CUDA device, got {self.device}")
            self.transport = "nccl"
        elif backend == "gloo":
            self.transport = "gloo-host" if self.device.type == "cuda" else "gloo"
        else:
            raise ValueError(f"unsupported backend {backend!r} (nccl, gloo)")
        self._pinned: dict[torch.dtype, tuple[torch.Tensor, torch.Tensor]] = {}
        self.ops: Optional[list] = None   # the op record, while ``recording``
        if self.transport == "nccl":
            # bring the communicator up with every rank taking part: a first
            # batched send/receive in which some ranks idle would not
            dist.all_reduce(torch.zeros(1, device=self.device), group=group)

    @contextlib.contextmanager
    def recording(self):
        """Record every collective issued inside the block, in order, into
        the yielded list of ``CollectiveOp``."""
        prev, self.ops = self.ops, []
        try:
            yield self.ops
        finally:
            self.ops = prev

    def _note(self, kind: str, x: torch.Tensor, pairs=()) -> None:
        if self.ops is None and not cost._ACTIVE:
            return
        op = CollectiveOp(kind, tuple(tuple(p) for p in pairs), x.numel() * x.element_size(),
                          self.world)
        if self.ops is not None:
            self.ops.append(op)
        cost.bill_collective(op, self.world)

    def _check(self, x: torch.Tensor) -> None:
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, the rank computes on {self.device}")
        if not x.is_contiguous():
            raise ValueError("collectives take contiguous tensors")

    def _host_buffers(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(send, receive) pinned host chunks of ``CHUNK_BYTES`` each."""
        if dtype not in self._pinned:
            n = CHUNK_BYTES // torch.empty((), dtype=dtype).element_size()
            self._pinned[dtype] = tuple(
                torch.empty(n, dtype=dtype, pin_memory=True) for _ in range(2)
            )
        return self._pinned[dtype]

    def _chunks(self, numel: int, dtype: torch.dtype):
        n = self._host_buffers(dtype)[0].numel()
        for a in range(0, numel, n):
            yield a, min(a + n, numel)

    # -- permute -------------------------------------------------------------
    def permute(self, x: torch.Tensor, perm: Sequence[tuple[int, int]],
                out: torch.Tensor | None = None) -> torch.Tensor:
        """``jax.lax.ppermute``: send ``x`` to every dst paired with this
        rank as src, receive into ``out`` from the src paired with it as dst.
        A rank that is no destination gets zeros.  One batched send/receive
        per call; returns ``out``."""
        self._check(x)
        if out is None:
            out = torch.empty_like(x)
        self._check(out)
        if out.shape != x.shape or out.dtype != x.dtype:
            raise ValueError("out must match x in shape and dtype")
        self._note("permute", x, perm)
        dsts = [d for s, d in perm if s == self.rank]
        srcs = [s for s, d in perm if d == self.rank]
        if len(dsts) > 1 or len(srcs) > 1:
            raise ValueError(f"perm is not a permutation at rank {self.rank}: {perm}")
        dst = dsts[0] if dsts else None
        src = srcs[0] if srcs else None
        if src is None:
            out.zero_()
        if dst == self.rank:   # a fixed point: this rank receives its own x
            out.copy_(x)
            return out
        if dst is None and src is None:
            return out
        if self.transport == "gloo-host":
            flat_x, flat_out = x.view(-1), out.view(-1)
            send_buf, recv_buf = self._host_buffers(x.dtype)
            for a, b in self._chunks(x.numel(), x.dtype):
                s, r = send_buf[: b - a], recv_buf[: b - a]
                if dst is not None:
                    s.copy_(flat_x[a:b])
                self._exchange(s if dst is not None else None, dst,
                               r if src is not None else None, src)
                if src is not None:
                    flat_out[a:b].copy_(r)
        else:
            self._exchange(x if dst is not None else None, dst,
                           out if src is not None else None, src)
        return out

    def _exchange(self, send, dst, recv, src) -> None:
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, self.ranks[dst], self.group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, self.ranks[src], self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    # -- all-reduce and all-gather ---------------------------------------------
    def _reduce(self, x: torch.Tensor, op) -> None:
        if self.transport == "gloo-host":
            flat = x.view(-1)
            buf = self._host_buffers(x.dtype)[0]
            for a, b in self._chunks(x.numel(), x.dtype):
                h = buf[: b - a]
                h.copy_(flat[a:b])
                dist.all_reduce(h, op=op, group=self.group)
                flat[a:b].copy_(h)
        else:
            dist.all_reduce(x, op=op, group=self.group)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks, IN PLACE (sum, then divide by ``world``);
        returns ``x``."""
        self._check(x)
        self._note("pmean", x)
        self._reduce(x, dist.ReduceOp.SUM)
        return x.div_(self.world)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or ``op="max"``) over the ranks, IN PLACE; returns ``x``.
        Every rank receives the same bits."""
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op must be 'sum' or 'max', got {op!r}")
        self._check(x)
        self._note("all_reduce", x)
        self._reduce(x, dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        return x

    def all_gather(self, x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """(world, *x.shape): every rank's ``x``, in rank order; with ``dim``,
        the ranks' tensors concatenated along that dim instead."""
        self._check(x)
        self._note("all_gather", x)
        out = torch.empty((self.world,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        if self.transport == "nccl":
            dist.all_gather_into_tensor(out, x, group=self.group)
        elif self.transport == "gloo":
            dist.all_gather(list(out.unbind(0)), x, group=self.group)
        else:
            flat, rows = x.view(-1), out.view(self.world, -1)
            send_buf, recv_buf = self._host_buffers(x.dtype)
            per = recv_buf.numel() // self.world
            for a in range(0, x.numel(), per):
                b = min(a + per, x.numel())
                s = send_buf[: b - a]
                r = recv_buf[: self.world * (b - a)].view(self.world, b - a)
                s.copy_(flat[a:b])
                dist.all_gather(list(r.unbind(0)), s, group=self.group)
                rows[:, a:b].copy_(r)
        return out if dim is None else _concat(out, dim)

    def rank0_value(self, value: int) -> int:
        """Rank 0's integer ``value`` on every rank (one ``all_gather``)."""
        mine = torch.tensor([value], dtype=torch.float32, device=self.device)
        return int(self.all_gather(mine)[0, 0])

    # -- gather to and scatter from one rank's host memory -------------------------
    def _rows_chunks(self, nbytes: int):
        """Byte ranges [a, b) of a row of which ``world`` rows fit one
        staged chunk."""
        per = CHUNK_BYTES // self.world
        for a in range(0, nbytes, per):
            yield a, min(a + per, nbytes)

    def _staged_rows(self, n: int) -> torch.Tensor:
        """(world, n) staging bytes: the pinned receive chunk (gloo-host) or
        a device buffer (NCCL)."""
        if self.transport == "gloo-host":
            return self._host_buffers(torch.uint8)[1][: self.world * n].view(self.world, n)
        return torch.empty((self.world, n), dtype=torch.uint8, device=self.device)

    def gather_host(self, x: torch.Tensor, dst: int = 0):
        """Every rank's ``x`` (the same shape everywhere) gathered into
        ``dst``'s host memory, column chunk by column chunk: a (world,
        x.numel()) CPU tensor, rows in rank order, on ``dst``; None
        elsewhere.  Every rank must call it.  Unlike ``all_gather`` no rank
        holds more than a chunk of the result on its device."""
        self._check(x)
        self._note("gather_host", x)
        dtype = x.dtype
        x = x.view(-1).view(torch.uint8)   # bytes: every backend moves them
        mine = self.rank == dst
        out = torch.empty((self.world, x.numel()), dtype=x.dtype) if mine else None
        for a, b in self._rows_chunks(x.numel()):
            if self.transport == "gloo":
                dist.gather(x[a:b], list(out[:, a:b].unbind(0)) if mine else None,
                            dst=self.ranks[dst], group=self.group)
                continue
            send = x[a:b]
            if self.transport == "gloo-host":
                send = self._host_buffers(torch.uint8)[0][: b - a]
                send.copy_(x[a:b])
            rows = self._staged_rows(b - a) if mine else None
            dist.gather(send, list(rows.unbind(0)) if mine else None, dst=self.ranks[dst],
                        group=self.group)
            if mine:
                out[:, a:b].copy_(rows)
        return None if out is None else out.view(dtype)

    def scatter_host(self, out: torch.Tensor, rows=None, src: int = 0) -> torch.Tensor:
        """Inverse of ``gather_host``: ``src`` holds ``rows`` ((world,
        out.numel()) in host memory) and every rank receives its own row
        into ``out``, IN PLACE, column chunk by column chunk.  Every rank
        must call it; returns ``out``."""
        self._check(out)
        self._note("scatter_host", out)
        mine = self.rank == src
        if mine and (rows is None or tuple(rows.shape) != (self.world, out.numel())):
            raise ValueError(f"scatter_host needs ({self.world}, {out.numel()}) rows on "
                             f"rank {src}")
        flat = out.view(-1).view(torch.uint8)   # bytes: every backend moves them
        if mine:
            rows = rows.to(out.dtype).contiguous().view(torch.uint8)
        for a, b in self._rows_chunks(flat.numel()):
            if self.transport == "gloo":
                parts = [r.contiguous() for r in rows[:, a:b].unbind(0)] if mine else None
                dist.scatter(flat[a:b], parts, src=self.ranks[src], group=self.group)
                continue
            staged = None
            if mine:
                staged = self._staged_rows(b - a)
                staged.copy_(rows[:, a:b])
            recv = flat[a:b]
            if self.transport == "gloo-host":
                recv = self._host_buffers(torch.uint8)[0][: b - a]
            dist.scatter(recv, list(staged.unbind(0)) if mine else None,
                         src=self.ranks[src], group=self.group)
            if self.transport == "gloo-host":
                flat[a:b].copy_(recv)
        return out


class RecordingComm(Comm):
    """Rank ``rank`` of a ``world``-rank group with no process group behind
    it: the dry run's stand-in for ``Comm`` (the reference lowers its step
    over placeholder devices instead).  Every collective is checked,
    recorded (``recording``) and billed to the active op accounting as
    ``Comm``'s are, and moves no data: a permute leaves its landing buffer
    as it is, ``pmean`` returns its input, ``all_gather`` an unfilled
    (world, ...) buffer, and ``rank0_value`` answers with this rank's own
    value.  On ``meta`` (the default) nothing is allocated either."""

    def __init__(self, rank: int, world: int, device="meta"):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.device = torch.device(device)
        self.group = None
        self.ranks = tuple(range(world))
        self.rank = rank
        self.world = world
        self.transport = "none"
        self._pinned = {}
        self.ops = None

    def permute(self, x, perm, out=None):
        self._check(x)
        if out is None:
            out = torch.empty_like(x)
        self._check(out)
        self._note("permute", x, perm)
        return out

    def pmean(self, x):
        self._check(x)
        self._note("pmean", x)
        return x

    def all_reduce(self, x, op="sum"):
        self._check(x)
        self._note("all_reduce", x)
        return x

    def all_gather(self, x, dim=None):
        self._check(x)
        self._note("all_gather", x)
        out = x.new_empty((self.world,) + tuple(x.shape))
        return out if dim is None else _concat(out, dim)

    def rank0_value(self, value: int) -> int:
        self._note("all_gather", torch.empty(1, dtype=torch.float32, device="meta"))
        return int(value)

    def gather_host(self, x, dst: int = 0):
        raise NotImplementedError("a RecordingComm holds no other rank's data")

    def scatter_host(self, out, rows=None, src: int = 0):
        raise NotImplementedError("a RecordingComm holds no other rank's data")


def _concat(stacked: torch.Tensor, dim: int) -> torch.Tensor:
    """(world, *shape) -> the world's tensors concatenated along ``dim``."""
    dim = dim % (stacked.dim() - 1)
    return torch.cat(stacked.unbind(0), dim=dim)


def mesh_comms(comm: Comm, data: int, model: int) -> tuple[Comm, Comm]:
    """This rank's (gossip group, model group) of a data × model world laid
    out row-major (global rank i·model + j is shard j of node i): the
    gossip group of shard j holds ranks (·, j), the model group of node i
    ranks (i, ·).  Every rank creates every group, in the same order (all
    model groups, then all gossip groups), as ``dist.new_group`` needs."""
    if comm.world != data * model or comm.group is not None:
        raise ValueError(f"mesh_comms needs the whole world of {data} x {model} ranks; "
                         f"got a group of {comm.world}")
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(data)]
    gossip_groups = [dist.new_group([i * model + j for i in range(data)])
                     for j in range(model)]
    i, j = divmod(comm.rank, model)
    return Comm(comm.device, gossip_groups[j]), Comm(comm.device, model_groups[i])


# ---------------------------------------------------------------------------
# A world of ranks on this machine
# ---------------------------------------------------------------------------

def _rank_entry(fn, rank, world, init_method, device, timeout, result_path, args):
    """One rank: join the group, run ``fn(comm, *args)``, pickle its result."""
    dev, backend = rank_device(rank, world, device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        result = fn(Comm(dev), *args)
        with open(result_path, "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, args: tuple = (), *, timeout: float,
                device=None, workdir=None) -> list:
    """Run ``fn(comm, *args)`` on ``world`` spawned ranks of a fresh group
    and return their results in rank order.

    Rendezvous is a file store in ``workdir`` (a new temporary directory by
    default), so concurrent worlds never race for a port.  ``fn`` must be
    importable by the spawned interpreters and its result picklable.  Every
    rank must end within ``timeout`` seconds (also the group's collective
    timeout): a rank that fails or outlives it ends the whole world, and
    this raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        tmp = Path(tmp)
        init_method = f"file://{tmp / 'rendezvous'}"
        procs = [
            ctx.Process(
                target=_rank_entry,
                args=(fn, r, world, init_method, device, timeout,
                      str(tmp / f"rank{r}.pkl"), args),
                daemon=True,
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(
                        f"rank(s) {failed} failed with exit codes "
                        f"{[procs[r].exitcode for r in failed]}"
                    )
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {world} ranks outlived {timeout}s")
                time.sleep(0.05)
            codes = [p.exitcode for p in procs]
            if any(c != 0 for c in codes):
                raise RuntimeError(f"ranks ended with exit codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
        results = []
        for r in range(world):
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results

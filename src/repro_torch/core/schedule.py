"""Mixing-program IR: compile any communication graph into a gossip program.

The PyTorch counterpart of ``repro/core/schedule.py``.  A ``GossipProgram``
is a small list of primitive communication ops that realizes one mixing
step  θ ← W θ  for an n-node gossip graph:

  * ``PPermute(perm, weight[, offset])`` — every node receives one weighted
    neighbor buffer along a permutation.  ``offset`` marks the circulant
    special case (perm is the shift ``i ← i+d``), which the stacked
    interpreter realizes as one ``torch.roll``.
  * ``AllReduce()``                      — uniform average over all nodes.
  * ``GatherRow(w)``                     — dense fallback: contract the
    stacked replicas with this node's row of W.

Program semantics (all interpreters agree to float32 accumulation):

    out = self_weight ⊙ x + Σ_op op(x)

with ``self_weight`` a scalar or per-node vector.

Two interpreters run the compiled program on tensors whose leading axis is
the node axis (a tensor, or a dict of such tensors):

  * ``apply_dense``   — dense mixing-matrix einsum (the oracle).
  * ``apply_stacked`` — index gathers of the sender rows over the stacked
    axis.

A third, ``apply_shard``, runs it on one rank's own values with one
collective per op (the one-rank-per-node engine).  The stacked and masked
interpreters are one loop over row blocks (``_apply_rows``): an unsplit
leaf is one block, and the simulator's node axis split over cards
(``core/node_split.NodeBlocks``) is several.  A block receives only the
sender rows its nodes read in each op (n/d rows an op for a permutation)
and computes its rows in the program's order, so the split result is the
unsplit one bit for bit; an AllReduce or GatherRow op reduces column
chunks gathered to the first card (``node_split.over_nodes``): the
mean's bits hold, a GatherRow product's within 1e-6 relative where the
card's GEMM treats a chunk apart.  The dense
engine multiplies a split leaf's blocks of W's rows by column chunks
gathered to each block's card (``split_matmul``).  ``apply_stacked_bucketed``
and ``apply_shard_bucketed`` run the stacked and shard interpreters one
bucket (a column range of the flat state, ``core/buckets.py``) at a time.

Faults (``core/faults.py``): ``degraded_matrix`` is the dense oracle of a
fault realization; ``GossipProgram.degrade`` is the pre-enumerated program
of a permanent membership; ``apply_masked`` (dense and stacked engines)
and ``apply_shard_masked`` run the base program under *runtime* masks, and
their bucketed variants one bucket at a time.  Float masks are linear: a
drain boost above 1 up-weights a node's edges and lowers the receivers'
self weight by the same mass.

Multi-step fusion: ``GossipProgram.fuse`` composes H consecutive programs
(a full one-peer cycle, say) into one ``FusedProgram`` whose interpreters
run the H rounds in sequence; ``hub_balanced_rounds`` spreads a static
multi-matching program's matchings over the H rounds, so a hub no longer
sends in every round.  ``program_comm_bytes`` and
``program_max_node_bytes`` are the comm-cost model (a fault realization
bills its surviving edges only).

``compile_graph`` picks the cheapest faithful realization: circulant graph
→ one PPermute per offset; complete graph → AllReduce; any other
``EdgeGraph`` → an edge-colored program of ≤ Δ+1 per-node-weighted
PPermutes, verified against W exactly, with the dense ``GatherRow`` as the
fallback.  Programs are frozen and hashable, and ``cache_key`` digests the
same canonical repr as the reference package, so both packages key a given
program identically.
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import lru_cache
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.node_split import NodeBlocks, as_blocks, like, over_nodes, split_matmul

__all__ = [
    "PPermute",
    "AllReduce",
    "GatherRow",
    "GossipProgram",
    "FusedProgram",
    "compile_graph",
    "degraded_matrix",
    "dense_program",
    "edge_coloring",
    "hub_balanced_rounds",
    "identity_program",
    "maybe_hub_balanced",
    "permutation_for_offset",
    "program_comm_bytes",
    "program_max_node_bytes",
]


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------

def permutation_for_offset(n: int, d: int) -> tuple[tuple[int, int], ...]:
    """(src, dst) pairs so that node i receives from node (i + d) % n."""
    return tuple(((i + d) % n, i) for i in range(n))


@dataclasses.dataclass(frozen=True)
class PPermute:
    """Receive one weighted buffer along a permutation.

    perm: (src, dst) pairs; a dst absent from the list receives zeros.
    weight: scalar, or per-dst-node tuple of length n (applied at receiver).
    offset: when the perm is the circulant shift ``dst ← dst + offset``,
      the stacked interpreter takes its sources as ``(i + offset) % n``.
    """

    perm: tuple[tuple[int, int], ...]
    weight: Union[float, tuple[float, ...]]
    offset: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class AllReduce:
    """Uniform average over all nodes (contributes J/n to W)."""


@dataclasses.dataclass(frozen=True)
class GatherRow:
    """Dense fallback: contract all replicas with this node's W row.

    w: the full n×n mixing matrix (including the diagonal) as nested tuples.
    """

    w: tuple[tuple[float, ...], ...]


Op = Union[PPermute, AllReduce, GatherRow]


def _weight_column(weight, n: int) -> np.ndarray:
    if isinstance(weight, tuple):
        return np.asarray(weight, dtype=np.float64)
    return np.full(n, float(weight), dtype=np.float64)


def _tree_map(fn, tree):
    """Apply ``fn`` to a tensor, or to every tensor of a dict."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape((v.shape[0],) + (1,) * (ndim - 1))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _dense(w: torch.Tensor, x):
    """θ ← W θ for one leaf in float32, the result in the leaf's dtype: one
    einsum, or block by block over a split leaf (``split_matmul``)."""
    if isinstance(x, NodeBlocks):
        return split_matmul(w, x)
    return torch.einsum("ij,j...->i...", w.to(x.device), x.float()).to(x.dtype)


def _reduction(op, device):
    """The (n, c) → (1, c) or (n, c) float32 term of an op that reads every
    node (``over_nodes``): AllReduce's mean, GatherRow's rows of W."""
    if isinstance(op, AllReduce):
        return lambda c: c.float().mean(dim=0, keepdim=True)
    wm = _f32(np.asarray(op.w), device)
    return lambda c: torch.einsum("ij,jk->ik", wm, c.float())


def degraded_matrix(w, alive, link_up=None) -> np.ndarray:
    """The fault-degraded mixing matrix W' (the dense oracle, float64).

    Every off-diagonal entry whose edge is down (either endpoint not in
    ``alive``, or the link masked by ``link_up``) is zeroed and its mass
    moved onto the *receiver's* diagonal, so W' stays row-stochastic,
    symmetric when W and the masks are (so doubly stochastic when W is); a
    node that loses every edge self-averages (identity row).  ``degrade``,
    the masked interpreters and the fused kernels' fault rows all realize
    this matrix.

    Degrading by mask A and then masking by B realizes ``degraded_matrix(W,
    A & B)`` (composition).  The formula is linear in ``alive``: a float
    b > 1 at node d scales d's edges by b, the excess subtracted from the
    receivers' diagonals (the preemption drain).  A ghost (alive 0 from
    step 0, ``faults.SparePool``) is an identity row and column."""
    w = np.asarray(w, dtype=np.float64)
    n = w.shape[0]
    alive = np.asarray(alive, dtype=np.float64).reshape(n)
    em = np.outer(alive, alive)
    if link_up is not None:
        em = em * np.asarray(link_up, dtype=np.float64)
    off = w * em
    np.fill_diagonal(off, 0.0)
    return off + np.diag(1.0 - off.sum(axis=1))


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GossipProgram:
    """A compiled mixing schedule: out = self_weight ⊙ x + Σ_op op(x)."""

    name: str
    n: int
    ops: tuple[Op, ...]
    self_weight: Union[float, tuple[float, ...]] = 0.0

    @property
    def cache_key(self):
        """Cheap hashable identity, computed once per program (the sha256
        digest of the canonical repr)."""
        key = self.__dict__.get("_cache_key")
        if key is None:
            digest = hashlib.sha256(
                repr((self.n, self.ops, self.self_weight)).encode()
            ).hexdigest()[:32]
            key = (self.name, self.n, digest)
            object.__setattr__(self, "_cache_key", key)
        return key

    @property
    def is_identity(self) -> bool:
        return not self.ops

    @property
    def num_collectives(self) -> int:
        return len(self.ops)

    def matrix(self) -> np.ndarray:
        """The dense (n, n) mixing matrix W this program realizes (float64)."""
        return _program_matrix(self)

    def describe(self) -> str:
        kinds = [type(op).__name__ for op in self.ops]
        return f"{self.name}(n={self.n}, ops=[{', '.join(kinds)}])"

    def permute_tables(self):
        """Dense per-node tables for an all-PPermute program, or ``None``.

        Returns ``(srcs, weights)``: ``srcs`` an (n, deg) int32 array —
        ``srcs[i, k]`` is the node whose buffer node i receives in permute
        round k (itself when i idles that round) — and ``weights`` an
        (n, deg+1) float32 array ``[self, w_1 .. w_deg]`` whose masked
        entries are 0.  This is the layout the fused gossip kernel reads.
        """
        if not self.ops or not all(isinstance(op, PPermute) for op in self.ops):
            return None
        n, deg = self.n, len(self.ops)
        srcs = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, deg))
        weights = np.zeros((n, deg + 1), dtype=np.float32)
        weights[:, 0] = _weight_column(self.self_weight, n)
        for k, op in enumerate(self.ops):
            wv = _weight_column(op.weight, n)
            for s, d in op.perm:
                srcs[d, k] = s
                weights[d, k + 1] = wv[d]
        return srcs, weights

    def degrade(self, alive) -> "GossipProgram":
        """The program for the surviving membership ``alive`` ((n,) bools):
        permute pairs with a dead endpoint removed and their weight moved
        onto the receiver's self weight, so it realizes exactly
        ``degraded_matrix(self.matrix(), alive)``; programs with AllReduce
        or GatherRow ops become one GatherRow of the degraded matrix.  One
        cached program per alive-set (the permanent-crash path)."""
        alive_t = tuple(bool(a) for a in np.asarray(alive).reshape(-1))
        if len(alive_t) != self.n:
            raise ValueError(f"alive mask has {len(alive_t)} entries, n={self.n}")
        if all(alive_t):
            return self
        return _degrade_cached(self, alive_t)

    # -- runtime-masked interpreters (transient faults) ---------------------
    def _masked_tables(self, alive, link_up, device):
        """(host srcs, per-node effective weight rows (n, deg+1) float32 on
        ``device``) under runtime masks, or None for a program that is not
        all-PPermute.  ``alive`` may be a float mask (values > 1 up-weight
        a node's edges); the self weight keeps every row sum at 1."""
        tables = self.permute_tables()
        if tables is None:
            return None
        srcs_np, weights_np = tables
        srcs = torch.as_tensor(srcs_np, dtype=torch.long, device=device)
        w = torch.as_tensor(weights_np, device=device)
        af = _f32(alive, device).reshape(self.n)
        m = af[srcs] * af[:, None]
        if link_up is not None:
            rows = torch.arange(self.n, device=device)[:, None]
            m = m * _f32(link_up, device)[rows, srcs]
        wn = w[:, 1:] * m
        w0 = w[:, 0] + torch.sum(w[:, 1:] * (1.0 - m), dim=1)
        return srcs_np, torch.cat([w0[:, None], wn], dim=1)

    def _masked_matrix(self, alive, link_up, device) -> torch.Tensor:
        """The runtime degraded matrix in float32 (the dense fallback)."""
        w0 = torch.as_tensor(self.matrix(), dtype=torch.float32, device=device)
        af = _f32(alive, device).reshape(self.n)
        em = af[:, None] * af[None, :]
        if link_up is not None:
            em = em * _f32(link_up, device)
        off = w0 * em * (1.0 - torch.eye(self.n, dtype=torch.float32, device=device))
        return off + torch.diag(1.0 - torch.sum(off, dim=1))

    def apply_masked(self, tree, alive, *, link_up=None, engine: str = "stacked"):
        """One fault-degraded mixing step with *runtime* masks ``alive``
        ((n,), bool or float) and ``link_up`` ((n, n) or None), numpy or
        tensors: ``self.degrade(alive)`` plus link masking, with no new
        program.  ``engine="dense"`` multiplies by the degraded matrix;
        ``"stacked"`` uses the masked permute tables (the dense matrix for
        a program that is not all-PPermute)."""
        if engine not in ("dense", "stacked"):
            raise ValueError(f"unknown engine {engine!r}")
        dev = self._first_device(tree)
        if engine == "dense":
            wm = self._masked_matrix(alive, link_up, dev)
            return _tree_map(lambda x: _dense(wm, x), tree)
        w0, terms = self._terms(dev, (alive, link_up))
        return _tree_map(lambda x: self._apply_rows(x, w0, terms), tree)

    def apply_shard_masked(self, local, comm, alive, *, link_up=None):
        """``apply_masked`` on this rank's own values over ``comm``: every
        compiled permute still runs (dropped edges move bytes, weight 0 at
        the receiver); this rank multiplies by its row of the masked
        tables, so it equals the stacked interpreter's row bit for bit.
        Programs that are not all-PPermute gather every row and take this
        rank's row of the degraded matrix."""
        if comm.world != self.n:
            raise ValueError(f"program over {self.n} nodes on a world of {comm.world}")
        i = comm.rank

        def _mix(x):
            dev = x.device
            xf = x.float().contiguous()
            masked = self._masked_tables(alive, link_up, dev)
            if masked is None:
                row = self._masked_matrix(alive, link_up, dev)[i]
                return torch.einsum("g...,g->...", comm.all_gather(xf), row).to(x.dtype)
            wrow = masked[1][i]
            acc = wrow[0] * xf
            for k, op in enumerate(self.ops):
                acc = acc + wrow[k + 1] * comm.permute(xf, op.perm)
            return acc.to(x.dtype)

        return _tree_map(_mix, local)

    @staticmethod
    def fuse(programs: Sequence["GossipProgram"], name: Optional[str] = None):
        """Compose H consecutive mixing steps into one program that applies
        ``programs[0]`` first (``matrix() == W_H ··· W_1``).  Nested fused
        programs flatten; a single program passes through unchanged."""
        stages: list[GossipProgram] = []
        for p in programs:
            if isinstance(p, FusedProgram):
                stages.extend(p.stages)
            else:
                stages.append(p)
        if not stages:
            raise ValueError("fuse needs at least one program")
        if len({p.n for p in stages}) > 1:
            raise ValueError("cannot fuse programs over different node counts")
        if len(stages) == 1:
            return stages[0]
        return FusedProgram(
            name=name or f"fuse[{'+'.join(p.name for p in stages)}]",
            n=stages[0].n,
            ops=tuple(op for p in stages for op in p.ops),
            self_weight=0.0,
            stages=tuple(stages),
        )

    # -- interpreters --------------------------------------------------------
    def apply(self, tree, *, engine: str = "stacked"):
        """Run one mixing step with the ``"dense"`` or ``"stacked"`` engine."""
        if engine == "dense":
            return self.apply_dense(tree)
        if engine == "stacked":
            return self.apply_stacked(tree)
        raise ValueError(f"unknown engine {engine!r}")

    def apply_dense(self, stacked):
        """θ ← W θ via the dense matrix (leading axis 0 = node axis)."""
        if self.is_identity and self.self_weight == 1.0:
            return stacked
        w = _f32(self.matrix(), self._first_device(stacked))
        return _tree_map(lambda x: _dense(w, x), stacked)

    def apply_stacked(self, stacked):
        """Mixing over the stacked node axis via index gathers of the sender
        rows (``_apply_rows``)."""
        if self.is_identity and self.self_weight == 1.0:
            return stacked
        w0, terms = self._terms(self._first_device(stacked))
        return _tree_map(lambda x: self._apply_rows(x, w0, terms), stacked)

    @staticmethod
    def _first_device(tree) -> torch.device:
        x = next(iter(tree.values())) if isinstance(tree, dict) else tree
        return x.device

    def _terms(self, device, masks=None):
        """The stacked interpreter's float32 terms on ``device``, built once
        a call: (self weights (n,), or None for a product alone, and in
        program order (weights (n,), source) pairs whose source is an
        offset (node i reads node (i + d) % n), an (n,) array of source
        rows, or, with weights None, a reduction over every node for
        ``over_nodes``).  ``masks``: the runtime ``(alive, link_up)`` of
        ``apply_masked``."""
        n = self.n
        if masks is not None:
            tables = self._masked_tables(*masks, device)
            if tables is None:   # W' θ with the runtime degraded matrix
                wm = self._masked_matrix(*masks, device)
                return None, [(None, lambda c: torch.einsum("ij,jk->ik", wm, c.float()))]
            srcs_np, weights = tables
            return weights[:, 0], [(weights[:, k + 1], srcs_np[:, k].astype(np.int64))
                                   for k in range(srcs_np.shape[1])]
        terms = []
        for op in self.ops:
            if not isinstance(op, PPermute):
                terms.append((None, _reduction(op, device)))
                continue
            wv = _f32(_weight_column(op.weight, n), device)
            if op.offset is not None:
                terms.append((wv, int(op.offset)))
                continue
            src = np.zeros(n, dtype=np.int64)
            mask = np.zeros(n, dtype=np.float32)
            for s, d in op.perm:
                src[d] = s
                mask[d] = 1.0
            terms.append((wv * _f32(mask, device), src))
        return _f32(_weight_column(self.self_weight, n), device), terms

    def _apply_rows(self, x, w0, terms):
        """The stacked and masked interpreters on one leaf ``x``, an (n, ...)
        tensor or a ``NodeBlocks`` of row blocks, given ``_terms``: node
        i's row is the program's weighted sum of rows in float32, its terms
        added in the program's order.  Each block gathers the sender rows
        its nodes read in each op from the float32 blocks on its own device
        (unsplit, a roll or an ``index_select`` of the leaf); a reduction
        over every node (AllReduce, GatherRow, a masked program that is not
        all-PPermute) is taken over column chunks gathered to the first
        device (``over_nodes``), each block receiving its rows of it."""
        xb = as_blocks(x)
        xf = xb.map(lambda b: b.float())
        whole = len(xb.blocks) == 1
        accs = [None if w0 is None else _col(w0 if whole else w0[a:b].to(blk.device),
                                             blk.ndim) * blk
                for (a, b), blk in zip(xf.ranges, xf.blocks)]
        for w, src in terms:
            parts = None if w is not None else over_nodes(xf, src)
            for j, ((a, b), blk) in enumerate(zip(xf.ranges, xf.blocks)):
                if w is None:
                    t = parts[j].reshape((parts[j].shape[0],) + tuple(blk.shape[1:]))
                else:
                    dev = blk.device
                    t = _col(w if whole else w[a:b].to(dev), blk.ndim) * (
                        xf.shifted(src, a, b, dev) if isinstance(src, int)
                        else xf.rows(src[a:b], dev))
                accs[j] = t if accs[j] is None else accs[j] + t
                # a term and its gathered rows go before the next term is made,
                # so the peak holds one leaf-sized temporary fewer
                del t
            del parts
        return like(x, [acc.to(blk.dtype) for acc, blk in zip(accs, xb.blocks)])

    def apply_shard(self, local, comm):
        """Mixing on this rank's own values (a tensor, or a dict of them),
        one collective per op over ``comm`` (``launch/comm.py``): PPermute
        → ``permute``, AllReduce → ``pmean``, GatherRow → ``all_gather``
        and this rank's row of W.  Per-node weights are selected by
        ``comm.rank``; accumulation is float32, the result keeps the
        input's dtype."""
        if self.is_identity and self.self_weight == 1.0:
            return local
        if comm.world != self.n:
            raise ValueError(f"program over {self.n} nodes on a world of {comm.world}")
        i = comm.rank

        def _here(weight):
            # the float32 weight the stacked interpreter multiplies by
            return float(np.float32(weight[i] if isinstance(weight, tuple) else weight))

        def _mix(x):
            xf = x.float().contiguous()
            acc = _here(self.self_weight) * xf
            for op in self.ops:
                if isinstance(op, PPermute):
                    acc = acc + _here(op.weight) * comm.permute(xf, op.perm)
                elif isinstance(op, AllReduce):
                    acc = acc + comm.pmean(xf.clone())
                else:  # GatherRow
                    row = torch.as_tensor(op.w[i], dtype=torch.float32, device=x.device)
                    acc = acc + torch.einsum("g...,g->...", comm.all_gather(xf), row)
            return acc.to(x.dtype)

        return _tree_map(_mix, local)

    # -- bucketed interpreters (one call per bucket) -------------------------
    # Each bucket's mixing runs over its own column range of the flat state
    # (``core.buckets.BucketLayout``).  They delegate to the per-bucket
    # applies, so ``FusedProgram`` inherits them with every stage run on
    # the same bucket.

    def apply_stacked_bucketed(self, stacked: torch.Tensor, layout) -> torch.Tensor:
        """``apply_stacked`` over a flat (n, P) buffer, one call per bucket;
        a new buffer (the input itself for the identity)."""
        if self.is_identity and self.self_weight == 1.0:
            return stacked
        out = torch.empty_like(stacked)
        for src, dst in zip(layout.views(stacked), layout.views(out)):
            dst.copy_(self.apply_stacked(src))
        return out

    def apply_shard_bucketed(self, local: torch.Tensor, comm, layout) -> torch.Tensor:
        """``apply_shard`` over this rank's flat (P,) buffer, one chain of
        collectives per bucket; a new buffer (the input for the identity)."""
        if self.is_identity and self.self_weight == 1.0:
            return local
        out = torch.empty_like(local)
        for src, dst in zip(layout.views(local), layout.views(out)):
            dst.copy_(self.apply_shard(src, comm))
        return out

    def apply_masked_bucketed(self, stacked: torch.Tensor, alive, *, link_up=None,
                              layout) -> torch.Tensor:
        """``apply_masked`` over a flat (n, P) buffer, one call per bucket
        (the masks are the same for every bucket); a new buffer."""
        out = torch.empty_like(stacked)
        for src, dst in zip(layout.views(stacked), layout.views(out)):
            dst.copy_(self.apply_masked(src, alive, link_up=link_up))
        return out

    def apply_shard_masked_bucketed(self, local: torch.Tensor, comm, alive, *,
                                    link_up=None, layout) -> torch.Tensor:
        """``apply_shard_masked`` over this rank's flat (P,) buffer, one
        chain of collectives per bucket; a new buffer."""
        out = torch.empty_like(local)
        for src, dst in zip(layout.views(local), layout.views(out)):
            dst.copy_(self.apply_shard_masked(src, comm, alive, link_up=link_up))
        return out


@dataclasses.dataclass(frozen=True)
class FusedProgram(GossipProgram):
    """H mixing rounds applied in sequence (``GossipProgram.fuse``):
    ``out = W_H ··· W_1 x``.  ``ops`` holds the stages' ops concatenated,
    so collective counts and the comm-cost model sum over the rounds; the
    interpreters fold over ``stages`` instead."""

    stages: tuple[GossipProgram, ...] = ()

    @property
    def cache_key(self):
        key = self.__dict__.get("_cache_key")
        if key is None:
            key = ("fused",) + tuple(p.cache_key for p in self.stages)
            object.__setattr__(self, "_cache_key", key)
        return key

    @property
    def is_identity(self) -> bool:
        return all(p.is_identity and p.self_weight == 1.0 for p in self.stages)

    def matrix(self) -> np.ndarray:
        w = np.eye(self.n)
        for p in self.stages:
            w = p.matrix() @ w
        return w

    def describe(self) -> str:
        inner = ", ".join(p.describe() for p in self.stages)
        return f"{self.name}(n={self.n}, stages=[{inner}])"

    def permute_tables(self):
        """Fused programs mix in sequence: one round's kernel tables do not
        apply (each stage has its own)."""
        return None

    def apply_dense(self, stacked):
        """One einsum with the *product* matrix: the fused dense oracle."""
        if self.is_identity:
            return stacked
        w = _f32(self.matrix(), self._first_device(stacked))
        return _tree_map(lambda x: _dense(w, x), stacked)

    def apply_stacked(self, stacked):
        for p in self.stages:
            stacked = p.apply_stacked(stacked)
        return stacked

    def apply_shard(self, local, comm):
        for p in self.stages:
            local = p.apply_shard(local, comm)
        return local

    def degrade(self, alive) -> "GossipProgram":
        """Stage by stage: each round renormalizes on its own (faults apply
        to every wire round, not to the product matrix)."""
        alive_t = tuple(bool(a) for a in np.asarray(alive).reshape(-1))
        if all(alive_t):
            return self
        dead = ",".join(str(i) for i, a in enumerate(alive_t) if not a)
        return GossipProgram.fuse([p.degrade(alive_t) for p in self.stages],
                                  name=f"{self.name}!dead[{dead}]")

    def apply_masked(self, tree, alive, *, link_up=None, engine="stacked"):
        for p in self.stages:
            tree = p.apply_masked(tree, alive, link_up=link_up, engine=engine)
        return tree

    def apply_shard_masked(self, local, comm, alive, *, link_up=None):
        for p in self.stages:
            local = p.apply_shard_masked(local, comm, alive, link_up=link_up)
        return local


@lru_cache(maxsize=512)
def _degrade_cached(program: GossipProgram, alive: tuple) -> GossipProgram:
    n = program.n
    dead = [i for i, a in enumerate(alive) if not a]
    name = f"{program.name}!dead[{','.join(map(str, dead))}]"
    if not all(isinstance(op, PPermute) for op in program.ops):
        # AllReduce / GatherRow programs: one dense row of the degraded W
        return GossipProgram(
            name=name, n=n,
            ops=(GatherRow(_matrix_to_tuple(degraded_matrix(program.matrix(), alive))),),
            self_weight=0.0,
        )
    self_w = _weight_column(program.self_weight, n).copy()
    ops = []
    for op in program.ops:
        wv = _weight_column(op.weight, n)
        perm, weight = [], np.zeros(n)
        for s, d in op.perm:
            if alive[s] and alive[d]:
                perm.append((s, d))
                weight[d] = wv[d]
            elif alive[d]:
                self_w[d] += wv[d]  # the receiver renormalizes the lost edge
        if perm:
            ops.append(PPermute(tuple(perm), tuple(float(v) for v in weight)))
    for i in dead:
        self_w[i] = 1.0  # dead nodes self-average: parameters frozen
    return GossipProgram(name=name, n=n, ops=tuple(ops),
                         self_weight=tuple(float(v) for v in self_w))


@lru_cache(maxsize=512)
def _program_matrix(program: GossipProgram) -> np.ndarray:
    n = program.n
    w = np.diag(_weight_column(program.self_weight, n))
    for op in program.ops:
        if isinstance(op, PPermute):
            wv = _weight_column(op.weight, n)
            for s, d in op.perm:
                w[d, s] += wv[d]
        elif isinstance(op, AllReduce):
            w += np.ones((n, n)) / n
        else:  # GatherRow
            w += np.asarray(op.w, dtype=np.float64)
    return w


# ---------------------------------------------------------------------------
# Edge coloring: decompose an arbitrary edge set into <= Δ+1 matchings
# ---------------------------------------------------------------------------

def _greedy_coloring(n: int, edges, ncolors: int):
    """Smallest-free-color greedy pass; None when it exceeds ncolors."""
    used = [set() for _ in range(n)]
    color: dict[tuple[int, int], int] = {}
    for i, j in edges:
        taken = used[i] | used[j]
        c = next((c for c in range(ncolors) if c not in taken), None)
        if c is None:
            return None
        color[(i, j)] = c
        used[i].add(c)
        used[j].add(c)
    return color


def _misra_gries_coloring(n: int, edges, ncolors: int):
    """Misra & Gries (1992) constructive Vizing coloring: always <= Δ+1
    colors on a simple graph.  Invoked only when the greedy pass overflows."""
    adj = [dict() for _ in range(n)]   # adj[u][v] = color of edge (u, v)
    # color -> multiplicity at each node: a color transiently sits on two
    # edges of one node during path inversion / fan rotation
    used = [dict() for _ in range(n)]

    def _add(u, c):
        used[u][c] = used[u].get(c, 0) + 1

    def _rm(u, c):
        k = used[u][c] - 1
        if k:
            used[u][c] = k
        else:
            del used[u][c]

    def free(u):
        return next(c for c in range(ncolors) if c not in used[u])

    def set_color(u, v, c):
        adj[u][v] = c
        adj[v][u] = c
        _add(u, c)
        _add(v, c)

    def unset(u, v):
        c = adj[u].pop(v)
        adj[v].pop(u)
        _rm(u, c)
        _rm(v, c)

    def invert_cd_path(u, c, d):
        """Flip colors along the maximal c/d-alternating path through u."""
        prev, cur, want = None, u, d
        while True:
            nxt = next(
                (w for w, cc in adj[cur].items() if cc == want and w != prev),
                None,
            )
            if nxt is None:
                return
            unset(cur, nxt)
            set_color(cur, nxt, c if want == d else d)
            prev, cur = cur, nxt
            want = c if want == d else d

    for u, v in edges:
        # maximal fan of u: F[0] = v; color(u, F[i]) is free on F[i-1]
        fan, in_fan = [v], {v}
        grown = True
        while grown:
            grown = False
            for w, c in adj[u].items():
                if w not in in_fan and c not in used[fan[-1]]:
                    fan.append(w)
                    in_fan.add(w)
                    grown = True
                    break
        c, d = free(u), free(fan[-1])
        invert_cd_path(u, c, d)
        # the inversion may shrink the usable fan: take the shortest prefix
        # that is still a fan and whose tip has d free, then rotate it
        w_idx = None
        for i, w in enumerate(fan):
            if i > 0 and adj[u][fan[i]] in used[fan[i - 1]]:
                break
            if d not in used[w]:
                w_idx = i
                break
        if w_idx is None:  # pragma: no cover - MG invariant guarantees a w
            return None
        old = [adj[u].get(fan[i]) for i in range(w_idx + 1)]
        for i in range(w_idx + 1):
            if fan[i] in adj[u]:
                unset(u, fan[i])
        for i in range(w_idx):
            set_color(u, fan[i], old[i + 1])
        set_color(u, fan[w_idx], d)

    return {(i, j): adj[i][j] for i, j in edges}


def edge_coloring(
    n: int, edges: Sequence[tuple[int, int]]
) -> list[list[tuple[int, int]]]:
    """Partition an undirected edge set into <= Δ+1 matchings (greedy
    first, Misra–Gries when greedy overflows the Δ+1 palette)."""
    edges = [tuple(sorted(e)) for e in edges]
    if not edges:
        return []
    deg = [0] * n
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    ncolors = max(deg) + 1
    color = _greedy_coloring(n, edges, ncolors)
    if color is None:
        color = _misra_gries_coloring(n, edges, ncolors)
    if color is None:  # pragma: no cover - MG always succeeds on simple graphs
        color = _greedy_coloring(n, edges, 2 * max(deg))
    classes: dict[int, list[tuple[int, int]]] = {}
    for e, c in color.items():
        classes.setdefault(c, []).append(e)
    return [sorted(classes[c]) for c in sorted(classes)]


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def identity_program(n: int, name: str = "identity") -> GossipProgram:
    return GossipProgram(name=name, n=n, ops=(), self_weight=1.0)


def _matrix_to_tuple(w: np.ndarray) -> tuple[tuple[float, ...], ...]:
    return tuple(tuple(float(v) for v in row) for row in np.asarray(w))


@lru_cache(maxsize=512)
def dense_program(graph) -> GossipProgram:
    """The paper-faithful dense realization: one GatherRow of the full W."""
    w = graph.mixing_matrix()
    return GossipProgram(
        name=f"dense:{graph.name}",
        n=graph.n,
        ops=(GatherRow(_matrix_to_tuple(w)),),
        self_weight=0.0,
    )


def compile_graph(graph_or_sequence):
    """Compile a graph (or a sequence of graphs) into GossipProgram(s)."""
    if isinstance(graph_or_sequence, (list, tuple)):
        return tuple(_compile_one(g) for g in graph_or_sequence)
    return _compile_one(graph_or_sequence)


@lru_cache(maxsize=512)
def _compile_one(graph) -> GossipProgram:
    # Local import: graphs.py ↔ schedule.py would otherwise cycle.
    from repro_torch.core.graphs import CirculantGraph, EdgeGraph

    n = graph.n
    if graph.degree == 0 or n <= 1:
        return identity_program(n, name=graph.name)

    if isinstance(graph, CirculantGraph):
        if graph.name == "complete" and graph.degree == n - 1:
            # Uniform complete graph: W = J/n == one all-reduce.
            return GossipProgram(
                name=graph.name, n=n, ops=(AllReduce(),), self_weight=0.0
            )
        ops = tuple(
            PPermute(permutation_for_offset(n, d), wd, offset=d)
            for d, wd in graph.weighted_offsets()
        )
        return GossipProgram(
            name=graph.name, n=n, ops=ops, self_weight=graph.self_weight
        )

    if isinstance(graph, EdgeGraph):
        w = graph.mixing_matrix()
        # Edge-colored sparse decomposition: every off-diagonal W entry
        # lands in exactly one matching, the diagonal rides in self_weight.
        ops = []
        for matching in edge_coloring(n, graph.edges):
            perm = []
            weight = np.zeros(n)
            for i, j in matching:
                perm += [(i, j), (j, i)]
                weight[j] = w[j, i]
                weight[i] = w[i, j]
            ops.append(
                PPermute(
                    tuple(sorted(perm, key=lambda p: p[1])),
                    tuple(float(v) for v in weight),
                )
            )
        program = GossipProgram(
            name=graph.name,
            n=n,
            ops=tuple(ops),
            self_weight=tuple(float(v) for v in np.diag(w)),
        )
        if np.allclose(program.matrix(), w, rtol=0.0, atol=1e-12):
            return program
        # Exactness check failed (cannot happen for a proper coloring of a
        # simple graph; kept as the safety net): dense fallback.
        return GossipProgram(  # pragma: no cover
            name=graph.name,
            n=n,
            ops=(GatherRow(_matrix_to_tuple(w)),),
            self_weight=0.0,
        )

    raise TypeError(f"cannot compile {type(graph).__name__} into a GossipProgram")


# ---------------------------------------------------------------------------
# Hub-balanced round scheduling
# ---------------------------------------------------------------------------

def hub_balanced_rounds(
    program: GossipProgram, rounds: int, name: Optional[str] = None
) -> GossipProgram:
    """Spread a static permute program's C matchings over ``rounds`` fused
    steps: stage h applies ``ops[h::rounds]`` and keeps the unapplied
    neighbour mass on its self weight, so every stage is row-stochastic and
    each matching runs once per cycle.  A hub of degree Δ then sends
    ⌈Δ/rounds⌉·P per step instead of Δ·P."""
    rounds = int(rounds)
    if rounds <= 1:
        return program
    if not all(isinstance(op, PPermute) for op in program.ops):
        raise ValueError(
            f"hub_balanced_rounds needs an all-PPermute program, got "
            f"{program.describe()}"
        )
    if len(program.ops) <= 1:
        return program
    n = program.n
    base_self = _weight_column(program.self_weight, n)
    cols = [_weight_column(op.weight, n) for op in program.ops]
    # receiver-side mass per op: only perm-participating dsts carry weight
    masks = []
    for op in program.ops:
        m = np.zeros(n)
        for _, d in op.perm:
            m[d] = 1.0
        masks.append(m)
    stages = []
    for h in range(rounds):
        picked = list(range(h, len(program.ops), rounds))
        sw = base_self.copy()
        for k, (wv, m) in enumerate(zip(cols, masks)):
            if k not in picked:
                sw += wv * m  # unapplied matchings self-average this step
        stages.append(
            GossipProgram(
                name=f"{program.name}@round{h}",
                n=n,
                ops=tuple(program.ops[k] for k in picked),
                self_weight=tuple(float(v) for v in sw),
            )
        )
    return GossipProgram.fuse(
        stages, name=name or f"hub_balanced[{program.name}/H{rounds}]"
    )


def maybe_hub_balanced(progs: Sequence[GossipProgram], rounds: int):
    """The shared eligibility rule: hub-balance only when the ``rounds``
    fused steps are one static multi-matching permute program repeated.
    Returns the rescheduled program, or ``None`` when plain fusion
    applies."""
    if (
        rounds > 1
        and len({p.cache_key for p in progs}) == 1
        and progs[0].permute_tables() is not None
        and len(progs[0].ops) > 1
    ):
        return hub_balanced_rounds(progs[0], rounds)
    return None


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

def _live_pairs(op: PPermute, n: int, alive=None, link_up=None):
    """The (src, dst) pairs that move bytes: not a pair whose receiver
    weight is zero, nor one whose endpoint or link a fault mask kills."""
    wv = _weight_column(op.weight, n)
    pairs = []
    for s, d in op.perm:
        if wv[d] == 0.0:
            continue
        if alive is not None and not (alive[s] and alive[d]):
            continue
        if link_up is not None and not link_up[s][d]:
            continue
        pairs.append((s, d))
    return pairs


def _mask_lists(alive, link_up):
    alive_l = None if alive is None else [bool(a) for a in np.asarray(alive)]
    link_l = None if link_up is None else np.asarray(link_up).tolist()
    return alive_l, link_l


def program_comm_bytes(program: GossipProgram, param_bytes: int, *, alive=None,
                       link_up=None) -> int:
    """Mean bytes each node sends per mixing step under this program: a
    permute costs ``P · pairs/n`` per node, the all-reduce 2·P·(n−1)/n, the
    dense all-gather P·(n−1).  ``alive``/``link_up`` bill a fault
    realization by its surviving edges (the all-gather moves every
    replica regardless)."""
    total = 0.0
    n = program.n
    alive_l, link_l = _mask_lists(alive, link_up)
    for op in program.ops:
        if isinstance(op, PPermute):
            total += param_bytes * (len(_live_pairs(op, n, alive_l, link_l)) / n)
        elif isinstance(op, AllReduce):
            total += 2 * param_bytes * (n - 1) / n
        else:  # GatherRow: ring all-gather — each node forwards P to n-1 peers
            total += param_bytes * (n - 1)
    return int(total)


def program_max_node_bytes(program: GossipProgram, param_bytes: int, *, alive=None,
                           link_up=None) -> int:
    """Bytes the busiest node sends per mixing step (a star hub sends Δ·P
    though the mean is ~2P; ``hub_balanced_rounds`` caps this)."""
    n = program.n
    sends = np.zeros(n)
    alive_l, link_l = _mask_lists(alive, link_up)
    for op in program.ops:
        if isinstance(op, PPermute):
            for s, _ in _live_pairs(op, n, alive_l, link_l):
                sends[s] += param_bytes
        elif isinstance(op, AllReduce):
            sends += 2 * param_bytes * (n - 1) / n
        else:  # GatherRow
            sends += param_bytes * (n - 1)
    return int(sends.max()) if n else 0

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
  * ``apply_stacked`` — rolls / index gathers over the stacked axis.

A third, ``apply_shard``, runs it on one rank's own values with one
collective per op (the one-rank-per-node engine).

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

__all__ = [
    "PPermute",
    "AllReduce",
    "GatherRow",
    "GossipProgram",
    "compile_graph",
    "dense_program",
    "edge_coloring",
    "identity_program",
    "permutation_for_offset",
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
      the stacked interpreter uses one ``torch.roll`` instead of a gather.
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
        w64 = self.matrix()

        def _mix(x):
            w = torch.as_tensor(w64, dtype=torch.float32, device=x.device)
            return torch.einsum("ij,j...->i...", w, x.float()).to(x.dtype)

        return _tree_map(_mix, stacked)

    def apply_stacked(self, stacked):
        """Mixing over the stacked node axis via rolls / index gathers."""
        if self.is_identity and self.self_weight == 1.0:
            return stacked
        n = self.n

        def _f32(v, device):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        def _mix(x):
            dev = x.device
            xf = x.float()
            acc = _col(_f32(_weight_column(self.self_weight, n), dev), x.ndim) * xf
            for op in self.ops:
                if isinstance(op, PPermute):
                    wv = _f32(_weight_column(op.weight, n), dev)
                    if op.offset is not None:
                        # node i receives from (i + d) % n: roll by -d
                        acc = acc + _col(wv, x.ndim) * torch.roll(
                            xf, -op.offset, dims=0
                        )
                    else:
                        src = np.zeros(n, dtype=np.int64)
                        mask = np.zeros(n, dtype=np.float32)
                        for s, d in op.perm:
                            src[d] = s
                            mask[d] = 1.0
                        gathered = xf.index_select(
                            0, torch.as_tensor(src, device=dev)
                        )
                        acc = acc + _col(wv * _f32(mask, dev), x.ndim) * gathered
                elif isinstance(op, AllReduce):
                    acc = acc + xf.mean(dim=0, keepdim=True)
                else:  # GatherRow
                    wm = _f32(np.asarray(op.w), dev)
                    acc = acc + torch.einsum("ij,j...->i...", wm, xf)
            return acc.to(x.dtype)

        return _tree_map(_mix, stacked)

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

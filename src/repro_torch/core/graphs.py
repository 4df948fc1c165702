"""Communication graphs for decentralized data-parallel training.

Implements the five representative graphs of the paper (Table 1 / Figure 1)
— ring, torus, ring lattice, exponential, complete — plus beyond-paper
families from related work: the time-varying one-peer exponential graph
(arXiv:2410.11998), seeded random matchings (pairwise averaging), the star,
and arbitrary graphs via ``from_adjacency``.

Graphs are *descriptions only*.  How a graph's mixing step  θ ← W θ  is
executed is decided by compiling it into a ``GossipProgram``
(``core/schedule.py``), the IR both training engines interpret.  Two graph
classes split the old monolithic ``CommGraph``:

  * ``CirculantGraph`` — the fast path.  W is circulant on the flattened
    node index: fully described by (offset, multiplicity) pairs with
    ``W[i, (i+d) % n] = mult_d / (deg + 1)``.  Compiles to exactly one
    collective-permute per offset (complete graph → one all-reduce), and
    its spectral gap is the DFT of the weight vector (exact at n = 1008).
  * ``EdgeGraph``      — the general path: an explicit undirected edge set
    with per-node degrees and Metropolis–Hastings weights
    ``W_ij = 1/(1 + max(deg_i, deg_j))`` (doubly stochastic for *any*
    undirected graph).  The compiler edge-colors the edge set into ≤ Δ+1
    matchings (Vizing / Misra–Gries), one per-node-weighted permute each —
    a matching is the 1-color special case, and the star costs O(Δ)
    permute rounds instead of the dense gather-row all-gather.

Weights on circulant graphs follow Algorithm 1 of the paper: uniform
``1/(deg+1)`` over the closed neighborhood (self included; multi-edges —
e.g. the 2×b torus column wrap — count with multiplicity), making W
row-stochastic, and symmetric (doubly stochastic) for undirected graphs.
The directed exponential graph is row-stochastic only, as in the paper;
one-peer graphs are permutations and therefore doubly stochastic even
though directed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "CommGraph",
    "CirculantGraph",
    "EdgeGraph",
    "Ring",
    "Torus",
    "RingLattice",
    "Exponential",
    "Complete",
    "Star",
    "OnePeerExponential",
    "one_peer_exponential",
    "random_matching",
    "from_adjacency",
    "make_graph",
    "spectral_gap",
]


class CommGraph:
    """Base interface of a communication graph over ``n`` gossip nodes.

    Concrete classes: ``CirculantGraph`` (offset-structured fast path) and
    ``EdgeGraph`` (explicit adjacency).  Shared surface: ``n``, ``name``,
    ``degree``, ``num_edges``, ``directed``, ``is_symmetric``,
    ``mixing_matrix()``, ``neighbors(i)``, ``describe()``.
    """

    name: str
    n: int
    directed: bool

    # concrete classes provide: degree, num_edges, is_symmetric,
    # mixing_matrix(), neighbors(i)

    def comm_bytes_per_node(self, param_bytes: int) -> int:
        """Bytes each node sends per mixing step (the paper's cost argument)."""
        return self.degree * param_bytes

    def program(self):
        """Compile this graph into its ``GossipProgram`` (cached)."""
        from repro_torch.core.schedule import compile_graph

        return compile_graph(self)

    def describe(self) -> str:
        return (
            f"{self.name}(n={self.n}, degree={self.degree}, "
            f"edges={self.num_edges}, directed={self.directed})"
        )


# ---------------------------------------------------------------------------
# Circulant fast path
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CirculantGraph(CommGraph):
    """A circulant graph: node ``i`` receives from ``(i + d) % n`` per offset.

    Attributes:
      name: human-readable graph name.
      n: number of nodes.
      offsets: distinct circulant offsets ``d`` (mod n, 0 excluded).
      mult: per-offset edge multiplicity (parallel edges, e.g. the 2×b torus
        column wrap where +b and −b coincide).  Defaults to all-ones.
      directed: whether the offset set is closed under negation.
    """

    name: str
    n: int
    offsets: tuple[int, ...]
    directed: bool = False
    mult: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"graph needs >=1 node, got n={self.n}")
        mult = self.mult or (1,) * len(self.offsets)
        if len(mult) != len(self.offsets):
            raise ValueError("mult must align with offsets")
        merged: dict[int, int] = {}
        for d, m in zip(self.offsets, mult):
            d = d % self.n
            if d == 0:
                continue
            merged[d] = merged.get(d, 0) + m
        offs = tuple(sorted(merged))
        object.__setattr__(self, "offsets", offs)
        object.__setattr__(self, "mult", tuple(merged[d] for d in offs))

    # -- basic characteristics (Table 1) ------------------------------------
    @property
    def degree(self) -> int:
        """In-degree per node counting multiplicity (paper Table 1)."""
        return sum(self.mult)

    @property
    def num_edges(self) -> int:
        """Directed edge count (undirected edges counted once)."""
        e = self.n * self.degree
        return e if self.directed else e // 2

    @property
    def self_weight(self) -> float:
        return 1.0 / (self.degree + 1)

    @property
    def neighbor_weight(self) -> float:
        """Weight per *unit* edge (an offset of multiplicity m gets m×this)."""
        return 1.0 / (self.degree + 1)

    @property
    def is_symmetric(self) -> bool:
        offs = dict(zip(self.offsets, self.mult))
        return all(offs.get((-d) % self.n) == m for d, m in offs.items())

    # -- matrix / schedule views --------------------------------------------
    def mixing_matrix(self, weights: str = "uniform") -> np.ndarray:
        """Dense row-stochastic mixing matrix W (float64).

        weights:
          "uniform"    — 1/(deg+1) per unit edge (paper Algorithm 1).
          "metropolis" — Metropolis–Hastings (coincides with uniform on
            these regular graphs; see ``EdgeGraph`` for the general case).
        """
        if weights == "metropolis":
            if self.directed:
                raise ValueError("metropolis weights need an undirected graph")
            deg = self.degree
            w = np.zeros((self.n, self.n), dtype=np.float64)
            for i in range(self.n):
                for d, m in zip(self.offsets, self.mult):
                    w[i, (i + d) % self.n] += m / (1.0 + deg)
            np.fill_diagonal(w, 1.0 - w.sum(axis=1))
            return w
        if weights != "uniform":
            raise ValueError(f"unknown weight scheme {weights!r}")
        w = np.zeros((self.n, self.n), dtype=np.float64)
        np.fill_diagonal(w, self.self_weight)
        for i in range(self.n):
            for d, m in zip(self.offsets, self.mult):
                w[i, (i + d) % self.n] += m * self.neighbor_weight
        return w

    def weight_vector(self) -> np.ndarray:
        """The circulant generator c with ``W[i, j] = c[(j - i) mod n]``."""
        c = np.zeros(self.n, dtype=np.float64)
        c[0] = self.self_weight
        for d, m in zip(self.offsets, self.mult):
            c[d] += m * self.neighbor_weight
        return c

    def weighted_offsets(self) -> list[tuple[int, float]]:
        """(offset, weight) pairs excluding self — drives permute compilation."""
        return [
            (d, m * self.neighbor_weight) for d, m in zip(self.offsets, self.mult)
        ]

    def neighbors(self, i: int) -> list[int]:
        return [(i + d) % self.n for d in self.offsets]


# ---------------------------------------------------------------------------
# General graphs: explicit adjacency, Metropolis–Hastings weights
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeGraph(CommGraph):
    """An arbitrary undirected graph given by its edge set.

    Attributes:
      name: human-readable graph name.
      n: number of nodes.
      edges: undirected edges as sorted (i, j) pairs, i < j, deduplicated.

    Mixing weights are Metropolis–Hastings by default:
    ``W_ij = 1/(1 + max(deg_i, deg_j))``, ``W_ii = 1 − Σ_j W_ij`` — doubly
    stochastic for any undirected graph, including irregular ones where the
    paper's uniform 1/(deg+1) rule is ill-defined.
    """

    name: str
    n: int
    edges: tuple[tuple[int, int], ...]
    directed: bool = dataclasses.field(default=False, init=False)

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"graph needs >=1 node, got n={self.n}")
        seen = set()
        for i, j in self.edges:
            if not (0 <= i < self.n and 0 <= j < self.n):
                raise ValueError(f"edge ({i}, {j}) out of range for n={self.n}")
            if i == j:
                raise ValueError(f"self-loop ({i}, {j}) not allowed")
            seen.add((min(i, j), max(i, j)))
        object.__setattr__(self, "edges", tuple(sorted(seen)))

    @property
    def degrees(self) -> tuple[int, ...]:
        deg = [0] * self.n
        for i, j in self.edges:
            deg[i] += 1
            deg[j] += 1
        return tuple(deg)

    @property
    def degree(self) -> int:
        """Maximum node degree (the per-step collective budget)."""
        return max(self.degrees) if self.edges else 0

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    @property
    def is_symmetric(self) -> bool:
        return True

    def mixing_matrix(self, weights: str = "metropolis") -> np.ndarray:
        """Metropolis–Hastings W (doubly stochastic; the only scheme that is
        well-defined for irregular graphs — the paper's uniform 1/(deg+1)
        rule is not row-stochastic when degrees differ, so it is rejected
        rather than silently substituted)."""
        if weights != "metropolis":
            raise ValueError(
                f"EdgeGraph supports only 'metropolis' weights, got {weights!r}"
            )
        deg = self.degrees
        w = np.zeros((self.n, self.n), dtype=np.float64)
        for i, j in self.edges:
            wij = 1.0 / (1.0 + max(deg[i], deg[j]))
            w[i, j] = wij
            w[j, i] = wij
        np.fill_diagonal(w, 1.0 - w.sum(axis=1))
        return w

    def neighbors(self, i: int) -> list[int]:
        out = []
        for a, b in self.edges:
            if a == i:
                out.append(b)
            elif b == i:
                out.append(a)
        return sorted(out)


# ---------------------------------------------------------------------------
# The five representative graphs (paper Figure 1 / Table 1)
# ---------------------------------------------------------------------------

def Ring(n: int) -> CirculantGraph:
    """Ring: 2 neighbors (±1 hop). Degenerates gracefully for tiny n."""
    if n <= 1:
        return CirculantGraph("ring", n, ())
    if n == 2:
        return CirculantGraph("ring", n, (1,))
    return CirculantGraph("ring", n, (1, n - 1))


def Torus(n: int, grid: tuple[int, int] | None = None) -> CirculantGraph:
    """2-D torus: 4 neighbors (±1 on each grid dimension).

    The node index is flattened row-major over ``grid=(a, b)`` with
    ``a*b == n``; a torus row/column wrap becomes a circulant offset of the
    flattened index (±1 and ±b) — the standard "twisted torus" embedding
    used on real interconnects, 4 neighbors per node and 2n edges like the
    paper's torus.  If ``grid`` is not given we pick the most-square
    factorization.

    For ``a == 2`` the column offsets +b and −b coincide mod n (the column
    ring of length 2 is a double edge); the offset carries multiplicity 2 so
    the graph stays 4-regular with weight 2/5 on that neighbor — *not*
    silently degree-3 with 1/4 weights.
    """
    if n <= 4:
        g = Ring(n)
        return dataclasses.replace(g, name="torus")
    if grid is None:
        a = int(math.isqrt(n))
        while n % a:
            a -= 1
        grid = (a, n // a)
    a, b = grid
    if a * b != n:
        raise ValueError(f"torus grid {grid} does not tile n={n}")
    if a == 1 or b == 1:
        return dataclasses.replace(Ring(n), name="torus")
    offs: dict[int, int] = {}
    for d in (1, n - 1, b % n, (n - b) % n):
        offs[d] = offs.get(d, 0) + 1
    return CirculantGraph(
        "torus", n, tuple(offs), mult=tuple(offs[d] for d in offs)
    )


def RingLattice(n: int, k: int) -> CirculantGraph:
    """Ring lattice per Algorithm 1: neighbors j ∈ [-k//2, k//2], j != 0.

    ``k`` is the *total neighbor count* (coordination number as used by
    Algorithm 1, where the mixing weight is 1/(k+1)).  NOTE: the paper's §4.1
    prose describes 2k neighbors for coordination number k; Algorithm 1 (which
    we follow) uses k neighbors, k//2 hops on each side.
    """
    if n <= 1:
        return CirculantGraph(f"ring_lattice(k={k})", n, ())
    k = max(int(k), 1)
    half = max(k // 2, 1)
    half = min(half, (n - 1) // 2 if n > 2 else 1)
    offs: set[int] = set()
    for j in range(1, half + 1):
        offs.add(j % n)
        offs.add((n - j) % n)
    offs.discard(0)
    return CirculantGraph(f"ring_lattice(k={k})", n, tuple(sorted(offs)))


def Exponential(n: int) -> CirculantGraph:
    """Directed exponential (expander) graph: neighbors (i + 2^m) % n.

    m = 0, 1, ..., floor(log2(n-1)); degree = floor(log2(n-1)) + 1.
    """
    if n <= 1:
        return CirculantGraph("exponential", n, (), directed=True)
    mmax = int(math.floor(math.log2(n - 1))) if n > 2 else 0
    offs = {pow(2, m) % n for m in range(mmax + 1)}
    offs.discard(0)
    return CirculantGraph("exponential", n, tuple(sorted(offs)), directed=True)


def Complete(n: int) -> CirculantGraph:
    """Complete graph: every node averages with every other node."""
    return CirculantGraph("complete", n, tuple(range(1, n)))


# ---------------------------------------------------------------------------
# Beyond-paper families (related work)
# ---------------------------------------------------------------------------

def one_peer_exponential(n: int, step: int = 0) -> CirculantGraph:
    """One-peer time-varying exponential graph (arXiv:2410.11998).

    At step t every node talks to exactly ONE peer at hop 2^(t mod p),
    p = ceil(log2(n)): degree 1 per step, and a full cycle of p steps mixes
    like the dense exponential graph.  W = (I + P)/2 with P a cyclic
    permutation — doubly stochastic despite being directed.
    """
    if n <= 1:
        return CirculantGraph("one_peer_exp[0]", n, (), directed=True)
    p = max(int(math.ceil(math.log2(n))), 1)
    m = step % p
    d = pow(2, m) % n
    if d == 0:
        d = 1 % n
    return CirculantGraph(f"one_peer_exp[{m}]", n, (d,), directed=True)


def one_peer_period(n: int) -> int:
    """Steps in one full one-peer exponential cycle."""
    return max(int(math.ceil(math.log2(n))), 1) if n > 1 else 1


def random_matching(n: int, seed: int = 0, round: int = 0) -> EdgeGraph:
    """Seeded random (near-)perfect matching: pairwise parameter averaging.

    Every node averages with exactly one partner (one node idles when n is
    odd).  Deterministic in (seed, round), so an engine can precompile the
    programs of a fixed pool of rounds and rotate through them.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, round]))
    order = rng.permutation(n)
    edges = tuple(
        (int(order[2 * i]), int(order[2 * i + 1])) for i in range(n // 2)
    )
    return EdgeGraph(f"random_matching[s{seed}r{round}]", n, edges)


def Star(n: int) -> EdgeGraph:
    """Star graph: node 0 is the hub; MH weights keep it doubly stochastic."""
    return EdgeGraph("star", n, tuple((0, i) for i in range(1, n)))


def OnePeerExponential(n: int) -> CirculantGraph:
    """Alias for the step-0 one-peer exponential graph (see factory)."""
    return one_peer_exponential(n, 0)


def from_adjacency(adj, name: str = "custom") -> EdgeGraph:
    """Build an ``EdgeGraph`` from an adjacency matrix or an edge list.

    ``adj``: an (n, n) 0/1 symmetric ``np.ndarray`` adjacency matrix, or any
    other iterable of (i, j) pairs (``n`` inferred from the maximum index).
    The type disambiguates: a plain list of pairs is ALWAYS an edge list —
    wrap a nested-list matrix in ``np.asarray`` to use the matrix form
    (otherwise a 2-edge list would be indistinguishable from a 2×2 matrix).
    """
    if isinstance(adj, np.ndarray):
        arr = adj
        if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
            raise ValueError(
                f"adjacency matrix must be square 2-D, got shape {arr.shape}"
            )
        if not np.array_equal(arr, arr.T):
            raise ValueError("adjacency matrix must be symmetric (undirected)")
        n = arr.shape[0]
        edges = tuple(
            (int(i), int(j))
            for i in range(n)
            for j in range(i + 1, n)
            if arr[i, j]
        )
        return EdgeGraph(name, n, edges)
    pairs = [(int(i), int(j)) for i, j in adj]
    n = max((max(i, j) for i, j in pairs), default=-1) + 1
    return EdgeGraph(name, n, tuple(pairs))


_FACTORIES = {
    "ring": lambda n, **kw: Ring(n),
    "torus": lambda n, **kw: Torus(n, grid=kw.get("grid")),
    "ring_lattice": lambda n, **kw: RingLattice(n, kw.get("k", 2)),
    "exponential": lambda n, **kw: Exponential(n),
    "complete": lambda n, **kw: Complete(n),
    "star": lambda n, **kw: Star(n),
    "one_peer_exponential": lambda n, **kw: one_peer_exponential(
        n, kw.get("step", 0)
    ),
    "random_matching": lambda n, **kw: random_matching(
        n, kw.get("seed", 0), kw.get("round", 0)
    ),
    "from_adjacency": lambda n, **kw: from_adjacency(
        kw["adjacency"], kw.get("name", "custom")
    )
    if "adjacency" in kw
    else _missing_adjacency(),
}


def _missing_adjacency():
    raise ValueError("graph kind 'from_adjacency' requires adjacency=")


def make_graph(kind: str, n: int, **kwargs) -> CommGraph:
    """Factory: ``make_graph("ring_lattice", 96, k=10)``."""
    try:
        factory = _FACTORIES[kind]
    except KeyError:
        # narrow: only the registry lookup — a KeyError raised *inside* a
        # factory must not be misreported as an unknown kind
        raise ValueError(
            f"unknown graph kind {kind!r}; one of {sorted(_FACTORIES)}"
        ) from None
    return factory(n, **kwargs)


def spectral_gap(graph_or_matrix) -> float:
    """1 - |lambda_2(W)|: the consensus rate of a mixing matrix.

    Larger gap = faster information spreading (complete: gap = 1).

    Circulant graphs use the exact O(n log n) fast path: a circulant W is
    diagonalized by the DFT, so its eigenvalues are the DFT of the weight
    vector — exact gaps at n = 1008 and beyond, no dense eigendecomposition.
    """
    if isinstance(graph_or_matrix, CirculantGraph):
        if graph_or_matrix.n == 1:
            return 1.0
        eig = np.fft.fft(graph_or_matrix.weight_vector())
        mags = np.sort(np.abs(eig))[::-1]
        return float(1.0 - mags[1])
    w = (
        graph_or_matrix.mixing_matrix()
        if isinstance(graph_or_matrix, CommGraph)
        else np.asarray(graph_or_matrix, dtype=np.float64)
    )
    if w.shape[0] == 1:
        return 1.0
    eig = np.linalg.eigvals(w)
    mags = np.sort(np.abs(eig))[::-1]
    return float(1.0 - mags[1])

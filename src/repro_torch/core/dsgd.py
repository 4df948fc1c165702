"""Topology registry for (de)centralized SGD (paper §3.1.2).

The PyTorch counterpart of ``repro/core/dsgd.py``.  The eleven
implementations:

  c_complete        centralized: all-reduce *gradients* (PyTorch-DDP analogue)
  d_complete        decentralized: average *parameters* over the complete graph
  d_ring            decentralized, ring
  d_torus           decentralized, torus
  d_exponential     decentralized, directed exponential graph
  d_ring_lattice    decentralized, static ring lattice (coordination number k)
  d_ada             decentralized, Ada adaptive ring lattice (Algorithm 1,
                    open loop); ``k_floor="one_peer"`` decays onto the
                    one-peer family
  d_one_peer_exp    decentralized, one-peer time-varying exponential
  d_random_matching decentralized, seeded random pairwise averaging rotating
                    through a precompiled pool of matchings
  d_star            decentralized, star graph (MH weights)
  d_custom          decentralized, arbitrary undirected graph (``adjacency=``)

A ``Topology`` answers one question per (epoch, step): *which compiled
mixing program is in force* (``program_at``; ``None`` for the centralized
implementation, which mixes gradients globally instead).  Time-varying
topologies rotate through a small program set that ``distinct_programs``
enumerates up front.

Closed-loop Ada (``consensus_target``) and fault models are not ported yet
(ROADMAP queue 1, steps 7 and 10); ``make_topology`` rejects them.

Update order (paper §2.1):
  ``post``: local SGD update, then gossip-average parameters (default)
  ``pre`` : gossip-average parameters, then local SGD update
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.ada import AdaSchedule, default_k0
from repro_torch.core.graphs import (
    CommGraph, make_graph, one_peer_exponential, one_peer_period,
    random_matching,
)
from repro_torch.core.schedule import GossipProgram, compile_graph

__all__ = [
    "Topology",
    "GraphSequence",
    "OnePeerSequence",
    "MatchingSequence",
    "make_topology",
    "TOPOLOGIES",
]

TOPOLOGIES = (
    "c_complete",
    "d_complete",
    "d_ring",
    "d_torus",
    "d_exponential",
    "d_ring_lattice",
    "d_ada",
    "d_one_peer_exp",
    "d_random_matching",
    "d_star",
    "d_custom",
)


class GraphSequence:
    """A periodic step-indexed family of graphs (time-varying topology)."""

    n: int

    def period_steps(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def graph_at(self, step: int) -> CommGraph:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class OnePeerSequence(GraphSequence):
    """One-peer exponential: hop 2^(t mod p), degree 1 per step."""

    n: int

    def period_steps(self) -> int:
        return one_peer_period(self.n)

    def graph_at(self, step: int) -> CommGraph:
        return one_peer_exponential(self.n, step)


@dataclasses.dataclass(frozen=True)
class MatchingSequence(GraphSequence):
    """Random pairwise averaging rotating through ``pool`` seeded matchings."""

    n: int
    seed: int = 0
    pool: int = 8

    def period_steps(self) -> int:
        return max(int(self.pool), 1)

    def graph_at(self, step: int) -> CommGraph:
        return random_matching(self.n, self.seed, step % self.period_steps())


@dataclasses.dataclass(frozen=True)
class Topology:
    """A (possibly epoch- and step-varying) communication topology."""

    name: str
    n_nodes: int
    centralized: bool = False
    static_graph: Optional[CommGraph] = None
    ada: Optional[AdaSchedule] = None
    sequence: Optional[GraphSequence] = None
    mix_order: str = "post"  # "post" | "pre"

    def graph_at(self, epoch: int = 0, step: int = 0) -> Optional[CommGraph]:
        """The parameter-mixing graph in force; None => centralized."""
        if self.centralized:
            return None
        if self.sequence is not None:
            return self.sequence.graph_at(step)
        if self.ada is not None:
            return self.ada.graph_at(epoch, step)
        return self.static_graph

    def program_at(self, *, step: int = 0, epoch: int = 0) -> Optional[GossipProgram]:
        """The compiled mixing program in force; None => centralized.

        Keyword-only: ``graph_at`` takes (epoch, step) in the opposite order.
        """
        g = self.graph_at(epoch, step)
        return None if g is None else compile_graph(g)

    def period_at(self, epoch: int = 0) -> int:
        """Steps before the program repeats within an epoch (1 = static)."""
        if self.sequence is not None:
            return self.sequence.period_steps()
        if self.ada is not None:
            return self.ada.period_at(epoch)
        return 1

    def distinct_programs(
        self, n_epochs: int = 1
    ) -> list[tuple[tuple[int, int], GossipProgram]]:
        """((first_epoch, step_phase), program) for every distinct compiled
        program over a run."""
        if self.centralized:
            return []
        out: list[tuple[tuple[int, int], GossipProgram]] = []
        seen = set()
        for e in range(max(int(n_epochs), 1)):
            for s in range(self.period_at(e)):
                prog = self.program_at(step=s, epoch=e)
                if prog is not None and prog.cache_key not in seen:
                    seen.add(prog.cache_key)
                    out.append(((e, s), prog))
        return out

    @property
    def time_varying(self) -> bool:
        """Does the graph (possibly) change within an epoch?"""
        if self.sequence is not None:
            return self.sequence.period_steps() > 1
        return self.ada is not None and self.ada.k_floor == "one_peer"

    def degree_at(self, epoch: int = 0, step: int = 0) -> int:
        g = self.graph_at(epoch, step)
        return self.n_nodes - 1 if g is None else g.degree

    def describe(self) -> str:
        if self.centralized:
            return f"{self.name}: centralized all-reduce over {self.n_nodes} nodes"
        if self.ada is not None:
            return (
                f"{self.name}: Ada ring-lattice k0={self.ada.k0} "
                f"gamma_k={self.ada.gamma_k} k_floor={self.ada.k_floor} "
                f"over {self.n_nodes} nodes"
            )
        if self.sequence is not None:
            return (
                f"{self.name}: time-varying "
                f"{type(self.sequence).__name__} (period "
                f"{self.sequence.period_steps()}) over {self.n_nodes} nodes"
            )
        return f"{self.name}: static {self.static_graph.describe()}"


def make_topology(
    name: str,
    n_nodes: int,
    *,
    k: int | None = None,
    k0: int | None = None,
    gamma_k: float | None = None,
    k_floor: int | str = 2,
    seed: int = 0,
    pool: int = 8,
    mix_order: str = "post",
    torus_grid: tuple[int, int] | None = None,
    adjacency: Any = None,
    consensus_target: float | None = None,
    consensus_probe_every: int = 1,
    consensus_spike: float | None = None,
    fault_model: Any = None,
) -> Topology:
    """Build one of the benchmarked topologies (arguments as in the
    reference ``make_topology``)."""
    if mix_order not in ("post", "pre"):
        raise ValueError(f"mix_order must be 'post'|'pre', got {mix_order!r}")
    if consensus_target is not None or consensus_spike is not None:
        raise ValueError(
            "closed-loop Ada (consensus_target / consensus_spike) is not "
            "ported yet: ROADMAP queue 1 step 7 (core/consensus.py)"
        )
    if fault_model is not None:
        raise ValueError(
            "fault models are not ported yet: ROADMAP queue 1 step 10 "
            "(core/faults.py)"
        )
    base = dict(name=name, n_nodes=n_nodes, mix_order=mix_order)
    if name == "c_complete":
        return Topology(centralized=True, **base)
    if name == "d_complete":
        return Topology(static_graph=make_graph("complete", n_nodes), **base)
    if name == "d_ring":
        return Topology(static_graph=make_graph("ring", n_nodes), **base)
    if name == "d_torus":
        return Topology(
            static_graph=make_graph("torus", n_nodes, grid=torus_grid), **base
        )
    if name == "d_exponential":
        return Topology(static_graph=make_graph("exponential", n_nodes), **base)
    if name == "d_ring_lattice":
        if k is None:
            raise ValueError("d_ring_lattice requires k")
        return Topology(static_graph=make_graph("ring_lattice", n_nodes, k=k), **base)
    if name == "d_ada":
        sched = AdaSchedule(
            n_nodes=n_nodes,
            k0=k0 if k0 is not None else default_k0(n_nodes),
            gamma_k=0.02 if gamma_k is None else gamma_k,
            k_floor=k_floor,
        )
        return Topology(ada=sched, **base)
    if name == "d_one_peer_exp":
        return Topology(sequence=OnePeerSequence(n_nodes), **base)
    if name == "d_random_matching":
        return Topology(
            sequence=MatchingSequence(n_nodes, seed=seed, pool=pool), **base
        )
    if name == "d_star":
        return Topology(static_graph=make_graph("star", n_nodes), **base)
    if name == "d_custom":
        if adjacency is None:
            raise ValueError("d_custom requires adjacency")
        g = make_graph("from_adjacency", n_nodes, adjacency=adjacency)
        if g.n != n_nodes:
            # edge lists infer n from the max index; a mismatch would make
            # the mixing program and the replica axis silently disagree
            raise ValueError(
                f"adjacency describes {g.n} nodes but n_nodes={n_nodes}; "
                "pass an (n, n) matrix to include trailing isolated nodes"
            )
        return Topology(static_graph=g, **base)
    raise ValueError(f"unknown topology {name!r}; one of {TOPOLOGIES}")

"""Topology registry for (de)centralized SGD (paper §3.1.2).

The PyTorch counterpart of ``repro/core/dsgd.py``.  The eleven
implementations:

  c_complete        centralized: all-reduce *gradients* (PyTorch-DDP analogue)
  d_complete        decentralized: average *parameters* over the complete graph
  d_ring            decentralized, ring
  d_torus           decentralized, torus
  d_exponential     decentralized, directed exponential graph
  d_ring_lattice    decentralized, static ring lattice (coordination number k)
  d_ada             decentralized, Ada adaptive ring lattice (Algorithm 1);
                    ``k_floor="one_peer"`` decays onto the one-peer family;
                    ``consensus_target=`` closes the loop: the measured
                    consensus distance (core/consensus.py) drives the decay
                    and the handoff instead of the epoch law
  d_one_peer_exp    decentralized, one-peer time-varying exponential
  d_random_matching decentralized, seeded random pairwise averaging rotating
                    through a precompiled pool of matchings
  d_star            decentralized, star graph (MH weights)
  d_custom          decentralized, arbitrary undirected graph (``adjacency=``)

A ``Topology`` answers one question per (epoch, step): *which compiled
mixing program is in force* (``program_at``; ``None`` for the centralized
implementation, which mixes gradients globally instead).  Time-varying
topologies rotate through a small program set that ``distinct_programs``
enumerates up front; ``fused_program_at`` fuses H consecutive schedule
steps into one program per gossip round.

A ``fault_model`` (``core/faults.py``) rides on the topology: its
permanent memberships fold their degraded programs into
``distinct_programs``, and ``resized`` re-derives the family at another n
for an elastic join.

Update order (paper §2.1):
  ``post``: local SGD update, then gossip-average parameters (default)
  ``pre`` : gossip-average parameters, then local SGD update
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.ada import AdaSchedule, default_k0
from repro_torch.core.consensus import ConsensusController
from repro_torch.core.graphs import (
    CommGraph, make_graph, one_peer_exponential, one_peer_period,
    random_matching,
)
from repro_torch.core.schedule import (
    GossipProgram, compile_graph, maybe_hub_balanced,
)

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
    controller: Optional[ConsensusController] = None
    fault_model: Any = None  # core/faults.py FaultModel, or None
    mix_order: str = "post"  # "post" | "pre"
    # (name, kwargs) recipe make_topology records so the same family can be
    # re-derived at another n (elastic joins); not part of equality
    spec: Any = dataclasses.field(default=None, compare=False)

    def graph_at(self, epoch: int = 0, step: int = 0) -> Optional[CommGraph]:
        """The parameter-mixing graph in force; None => centralized.  With a
        ``controller`` (closed-loop Ada) the graph follows its current rung."""
        if self.centralized:
            return None
        if self.controller is not None:
            return self.controller.graph_at(epoch, step)
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

    def fused_program_at(
        self, *, step: int = 0, epoch: int = 0, rounds: int = 1,
        hub_balance: bool = False,
    ) -> Optional[GossipProgram]:
        """The program of gossip round ``step`` when every round applies
        ``rounds`` consecutive schedule steps fused (``GossipProgram.fuse``):
        a time-varying family advances its phase by ``rounds`` per round.
        ``hub_balance`` reschedules a static multi-matching program's
        matchings over the rounds (``maybe_hub_balanced``)."""
        if rounds <= 1:
            return self.program_at(step=step, epoch=epoch)
        progs = [
            self.program_at(step=step * rounds + r, epoch=epoch)
            for r in range(rounds)
        ]
        if any(p is None for p in progs):
            return None
        if hub_balance:
            balanced = maybe_hub_balanced(progs, rounds)
            if balanced is not None:
                return balanced
        return GossipProgram.fuse(progs)

    def period_at(self, epoch: int = 0) -> int:
        """Steps before the program repeats within an epoch (1 = static)."""
        if self.controller is not None:
            return self.controller.period_steps()
        if self.sequence is not None:
            return self.sequence.period_steps()
        if self.ada is not None:
            return self.ada.period_at(epoch)
        return 1

    def distinct_programs(
        self, n_epochs: int = 1
    ) -> list[tuple[tuple[int, int], GossipProgram]]:
        """((first_epoch, step_phase), program) for every distinct compiled
        program over a run.  For a closed-loop controller the first key
        component is the *rung*: each rung of its ladder is pinned in turn,
        so the set is the ladder's programs whatever the measured walk.
        A fault model's permanent memberships add each base program's
        degraded variant; an elastic model's growth schedule adds the
        family's programs at every size the joins reach."""
        if self.centralized:
            return []
        out: list[tuple[tuple[int, int], GossipProgram]] = []
        seen = set()

        def add(key, prog):
            if prog is not None and prog.cache_key not in seen:
                seen.add(prog.cache_key)
                out.append((key, prog))

        if self.controller is not None:
            for r in range(len(self.controller.ladder)):
                with self.controller.pinned(r):
                    for s in range(self.period_at(0)):
                        add((r, s), self.program_at(step=s, epoch=0))
        else:
            for e in range(max(int(n_epochs), 1)):
                for s in range(self.period_at(e)):
                    add((e, s), self.program_at(step=s, epoch=e))
        if self.fault_model is not None:
            from repro_torch.core.faults import fold_degraded_programs

            key_of = {p.cache_key: k for k, p in out}
            for base_p, deg in fold_degraded_programs([p for _, p in out], self.fault_model):
                out.append((key_of[base_p.cache_key], deg))
            if self.fault_model.elastic:
                # the resized topology drops the model: its masks are sized
                # for the initial n, and grown sizes realize all-ones anyway
                for m in self.fault_model.membership_sizes():
                    if m == self.n_nodes:
                        continue
                    grown = dataclasses.replace(self.resized(m), fault_model=None)
                    for gk, p in grown.distinct_programs(n_epochs):
                        if p.cache_key not in seen:
                            seen.add(p.cache_key)
                            out.append((gk, p))
        return out

    def resized(self, n_new: int) -> "Topology":
        """The same family re-derived at ``n_new`` nodes from the ``spec``
        recipe ``make_topology`` recorded (elastic joins); the fault model
        is carried over, the controller is new (it should ``adopt`` the
        old one's run state)."""
        if self.spec is None:
            raise ValueError(
                "topology has no spec recipe (hand-constructed?); build via "
                "make_topology to support elastic resizing"
            )
        name, kwargs = self.spec
        if name == "d_custom":
            raise ValueError(
                "d_custom has no size-parameterized family to re-derive; "
                "elastic membership needs a named topology"
            )
        return make_topology(name, int(n_new), fault_model=self.fault_model, **kwargs)

    @property
    def adaptive(self) -> bool:
        return self.ada is not None

    @property
    def closed_loop(self) -> bool:
        """Is the schedule driven by measured consensus distance?"""
        return self.controller is not None

    @property
    def time_varying(self) -> bool:
        """Does the graph (possibly) change within an epoch?  Always for a
        closed-loop controller: rungs change at measured steps."""
        if self.controller is not None:
            return True
        if self.sequence is not None:
            return self.sequence.period_steps() > 1
        return self.ada is not None and self.ada.k_floor == "one_peer"

    def degree_at(self, epoch: int = 0, step: int = 0) -> int:
        g = self.graph_at(epoch, step)
        return self.n_nodes - 1 if g is None else g.degree

    def describe(self) -> str:
        suffix = (
            f" [faults: {self.fault_model.describe()}]"
            if self.fault_model is not None else ""
        )
        return self._describe_base() + suffix

    def _describe_base(self) -> str:
        if self.centralized:
            return f"{self.name}: centralized all-reduce over {self.n_nodes} nodes"
        if self.controller is not None:
            return (
                f"{self.name}: closed-loop Ada ({self.controller.describe()}) "
                f"over {self.n_nodes} nodes"
            )
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
    reference ``make_topology``).  ``consensus_target`` closes ``d_ada``'s
    loop (probe cadence ``consensus_probe_every`` steps; ``consensus_spike``
    re-densifies on a Ξ spike); ``gamma_k`` is the open-loop law and is
    rejected beside it.  ``fault_model`` (``core/faults.make_fault_model``)
    is decentralized only and covers ``n_nodes`` (an elastic model its
    initial size)."""
    if mix_order not in ("post", "pre"):
        raise ValueError(f"mix_order must be 'post'|'pre', got {mix_order!r}")
    if consensus_target is not None and name != "d_ada":
        raise ValueError(
            f"consensus_target is a d_ada (closed-loop Ada) option; got {name!r}"
        )
    if consensus_spike is not None and consensus_target is None:
        raise ValueError(
            "consensus_spike re-densifies the closed loop and requires "
            "consensus_target"
        )
    if fault_model is not None:
        if name == "c_complete":
            raise ValueError("fault injection is decentralized-only")
        if fault_model.n != n_nodes and not fault_model.elastic:
            raise ValueError(
                f"fault model covers {fault_model.n} nodes but n_nodes={n_nodes}"
            )
    base = dict(
        name=name, n_nodes=n_nodes, mix_order=mix_order, fault_model=fault_model,
        # the resize recipe: everything size-independent (torus_grid and
        # adjacency are size-specific)
        spec=(name, dict(
            k=k, k0=k0, gamma_k=gamma_k, k_floor=k_floor, seed=seed, pool=pool,
            mix_order=mix_order, consensus_target=consensus_target,
            consensus_probe_every=consensus_probe_every,
            consensus_spike=consensus_spike,
        )),
    )
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
        if consensus_target is not None and gamma_k is not None:
            raise ValueError(
                "gamma_k is the open-loop time law and is unused with "
                "consensus_target; pass one or the other"
            )
        sched = AdaSchedule(
            n_nodes=n_nodes,
            k0=k0 if k0 is not None else default_k0(n_nodes),
            gamma_k=0.02 if gamma_k is None else gamma_k,
            k_floor=k_floor,
        )
        ctl = (
            ConsensusController(
                schedule=sched,
                target=consensus_target,
                probe_every=consensus_probe_every,
                spike=consensus_spike,
            )
            if consensus_target is not None
            else None
        )
        return Topology(ada=sched, controller=ctl, **base)
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

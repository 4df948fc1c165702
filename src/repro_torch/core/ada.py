"""Ada — adaptive ring-lattice scheduling (paper §4, Algorithm 1).

Ada starts training on a highly-connected ring lattice (coordination number
``k0``) and linearly decays the coordination number per epoch:

    k(epoch) = max(k0 - int(gamma_k * epoch), 2)          (Algorithm 1, l.2)

so the communication graph evolves from (near-)complete to a sparse ring,
capturing the paper's Observation 5: high connectivity helps early, sparse
graphs are free later.

Beyond-paper extension (``k_floor="one_peer"``): instead of stopping at the
k=2 ring, Ada can decay onto the *one-peer time-varying exponential* family
(arXiv:2410.11998) — degree 1 per step, cycling hop 2^m per step — the
cheapest per-step gossip that still mixes like an expander over a cycle.
The schedule then becomes step-granular; ``graph_at(epoch, step)`` /
``distinct_programs`` expose it, and both engines cache one executable per
distinct ``GossipProgram`` (a handful per run, compiled at first use).

Closed-loop variant (``core/consensus.py``): this module's schedule is the
*open-loop* time law.  Passing ``consensus_target=`` to ``make_topology``
wraps the same schedule in a ``ConsensusController`` that walks the ladder
``k0, k0-1, …, 2[, one_peer]`` on a measured trigger instead — each probe
compares the on-device consensus distance Ξ_t = √(1/n Σ_i ‖x_i - x̄‖²)
(arXiv:2102.04828) against ``target · Ξ_0`` and steps down one rung when it
crosses, so both the k-decay *and* the one-peer handoff epoch come from the
run's own variance signal, not the γ·epoch constant.  The controller can
only select among the ladder's pre-enumerated programs, preserving the
zero-mid-run-recompiles invariant.

Paper defaults (Table 4):
    ResNet20 / DenseNet100 / LSTM @ 96 GPUs : k0 = 10,  gamma_k = 0.02
    ResNet50 @ 1008 GPUs                    : k0 = 112, gamma_k = 1

The paper's heuristic initialization (Table 2) is k0 = max(#GPUs // 9, 2);
``default_k0`` implements it.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Union

import numpy as np

from repro_torch.core.graphs import (
    CommGraph, RingLattice, one_peer_exponential, one_peer_period,
)

__all__ = ["AdaSchedule", "default_k0"]


def default_k0(n_nodes: int) -> int:
    """Paper Table 2 heuristic: k(ours) = max(#GPUs // 9, 2)."""
    return max(n_nodes // 9, 2)


@dataclasses.dataclass(frozen=True)
class AdaSchedule:
    """Maps (epoch, step) -> communication graph (Algorithm 1 + extension).

    k_floor: the decay floor.  An int (paper: 2) keeps the final graph a
      static ring lattice; the string ``"one_peer"`` hands off to the
      time-varying one-peer exponential family once the lattice would
      decay below k=2.
    """

    n_nodes: int
    k0: int
    gamma_k: float = 0.02
    k_floor: Union[int, str] = 2  # Algorithm 1 line 2, or "one_peer"

    @classmethod
    def auto(cls, n_nodes: int, gamma_k: float = 0.02) -> "AdaSchedule":
        return cls(n_nodes=n_nodes, k0=default_k0(n_nodes), gamma_k=gamma_k)

    # -- schedule ------------------------------------------------------------
    def _k_raw(self, epoch: int) -> int:
        return self.k0 - int(self.gamma_k * epoch)

    def one_peer_at(self, epoch: int) -> bool:
        """True once the schedule has handed off to the one-peer family."""
        return self.k_floor == "one_peer" and self._k_raw(epoch) < 2

    def k_at(self, epoch: int) -> int:
        """Coordination number at an epoch (0-indexed); 1 in one-peer mode."""
        if self.one_peer_at(epoch):
            return 1
        floor = 2 if self.k_floor == "one_peer" else int(self.k_floor)
        # A node cannot have more neighbors than n-1.
        return int(np.clip(self._k_raw(epoch), floor, max(self.n_nodes - 1, 1)))

    def graph_at(self, epoch: int, step: int = 0) -> CommGraph:
        if self.one_peer_at(epoch):
            return one_peer_exponential(self.n_nodes, step)
        return _lattice(self.n_nodes, self.k_at(epoch))

    def mixing_matrix_at(self, epoch: int, step: int = 0) -> np.ndarray:
        """Dense W per Algorithm 1 lines 3-8 (uniform 1/(k+1) weights)."""
        return self.graph_at(epoch, step).mixing_matrix()

    def period_at(self, epoch: int) -> int:
        """Steps before the graph repeats within an epoch (1 when static)."""
        return one_peer_period(self.n_nodes) if self.one_peer_at(epoch) else 1

    # -- up-front enumeration (zero mid-run recompiles) ----------------------
    def distinct_graphs(self, n_epochs: int) -> list[tuple[int, CommGraph]]:
        """(first_epoch, graph) for each distinct k over a run.

        For ``k_floor="one_peer"`` the one-peer phase contributes its step-0
        graph only; use ``distinct_programs`` for the full step-granular set.
        """
        out: list[tuple[int, CommGraph]] = []
        last_k = None
        for e in range(n_epochs):
            k = self.k_at(e)
            if k != last_k:
                out.append((e, self.graph_at(e)))
                last_k = k
        return out

    def distinct_programs(
        self, n_epochs: int
    ) -> list[tuple[tuple[int, int], "object"]]:
        """((first_epoch, step_phase), GossipProgram) for every distinct
        compiled mixing program over a run — the executables an engine needs.

        Delegates to ``Topology.distinct_programs`` (the single enumeration
        implementation).
        """
        from repro_torch.core.dsgd import Topology

        topo = Topology(name="d_ada", n_nodes=self.n_nodes, ada=self)
        return topo.distinct_programs(n_epochs)


@lru_cache(maxsize=256)
def _lattice(n: int, k: int) -> CommGraph:
    return RingLattice(n, k)

"""Consensus distance and the closed-loop Ada controller (arXiv:2102.04828).

The counterpart of ``repro/core/consensus.py``.  The control signal is the
consensus distance

    Ξ_t = sqrt( 1/n · Σ_i ‖x_i - x̄‖² ),    x̄ = 1/n Σ_i x_i,

the RMS disagreement between the replicas and their average, computed on
the device:

  * ``consensus_sq_stacked`` / ``consensus_distance_stacked`` — over the
    stacked state (all nodes on one device): a flat (n, P) buffer or a dict
    of (n, ...) tensors;
  * ``consensus_sq_shard`` / ``consensus_distance_shard`` — on one rank of
    the one-rank-per-node engine: one ``pmean`` for x̄, a local reduction
    for ‖x_i - x̄‖², a second ``pmean`` over the nodes.

Both accumulate in float32 and never turn the whole state into float32:
they work through it in column chunks of ``CHUNK`` elements, so at
granite-8b width (a (4, 838,881,280) bfloat16 state) the float32
temporaries stay a few hundred MB.

``ConsensusController`` replaces Ada's open-loop law
``k(epoch) = k0 - int(γ·epoch)`` with a measured trigger: whenever the
probed ratio Ξ_t / Ξ_0 falls to ``target`` the schedule steps one rung
down the pre-enumerated ladder ``k0, k0-1, …, floor[, one_peer]``; with
``spike`` a disagreement spike walks one rung back up.  Its ``transitions``,
``trace`` and ``events`` lists are the reference's, entry for entry, and
``bind_recorder`` mirrors every transition, rearm and redensify into the
run's telemetry (``repro_torch.telemetry``).

Under faults the engines probe Ξ over the *members* only
(``consensus_distance_masked`` stacked, ``consensus_distance_masked_shard``
on a rank): a dead node's frozen replica or a ghost is not part of the
training population.  The mask is the membership (``alive != 0``), never
a float drain boost.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.ada import AdaSchedule
from repro_torch.core.graphs import (
    CommGraph, RingLattice, one_peer_exponential, one_peer_period,
)
from repro_torch.telemetry import coalesce_into

__all__ = [
    "consensus_sq_stacked",
    "consensus_distance_stacked",
    "consensus_distance_masked",
    "consensus_distance_masked_shard",
    "consensus_sq_shard",
    "consensus_distance_shard",
    "ConsensusController",
    "CHUNK",
]

# elements of one node's state per reduction chunk: bounds the float32
# temporaries to a few of (n, CHUNK)
CHUNK = 1 << 24


def _columns(stacked):
    """(n, k) column blocks of a stacked state: a flat (n, P) buffer, a
    dict of (n, ...) tensors, or one (n, ...) tensor."""
    leaves = list(stacked.values()) if isinstance(stacked, dict) else [stacked]
    if not leaves:
        raise ValueError("consensus distance of an empty state")
    for x in leaves:
        x2 = x.reshape(x.shape[0], -1)
        for a in range(0, x2.shape[1], CHUNK):
            yield x2[:, a:a + CHUNK]


def consensus_sq_stacked(stacked) -> torch.Tensor:
    """Per-node squared consensus distance ‖x_i - x̄‖²: (n,) float32.

    The values are taken relative to node 0's before the mean (Ξ does not
    change under a common shift), so identical replicas give exactly 0
    whatever order the device sums the mean in: the controller skips zero
    probes, and a rounding residue must not arm its reference."""
    total = None
    for x in _columns(stacked):
        xf = x.float()
        d = xf - xf[:1]
        d = d - d.mean(dim=0, keepdim=True)
        sq = d.square().sum(dim=1)
        total = sq if total is None else total + sq
    return total


def consensus_distance_stacked(stacked) -> torch.Tensor:
    """Ξ = sqrt(1/n Σ_i ‖x_i - x̄‖²) over the leading node axis (scalar)."""
    return consensus_sq_stacked(stacked).mean().sqrt()


def _mask(alive, device) -> torch.Tensor:
    return torch.as_tensor(alive, device=device).to(torch.float32).reshape(-1)


def consensus_distance_masked(stacked, alive) -> torch.Tensor:
    """Ξ over the members only: sqrt(1/|A| Σ_{i∈A} ‖x_i − x̄_A‖²), with
    ``alive`` an (n,) 0/1 membership mask.  Centred on the first member's
    row first, as ``consensus_sq_stacked`` on node 0's; with every node a
    member it is ``consensus_distance_stacked``."""
    total = count = None
    for x in _columns(stacked):
        if total is None:
            af = _mask(alive, x.device)
            count = af.sum().clamp_min(1.0)
            ref = int(torch.nonzero(af).reshape(-1)[0]) if bool(af.any()) else 0
            acol = af[:, None]
        xf = x.float()
        d = xf - xf[ref:ref + 1]
        d = (d - (d * acol).sum(dim=0, keepdim=True) / count) * acol
        sq = d.square().sum(dim=1)
        total = sq if total is None else total + sq
    return (total.sum() / count).sqrt()


def consensus_distance_masked_shard(local, alive, comm) -> torch.Tensor:
    """``consensus_distance_masked`` on a rank: the member mean from one
    ``pmean`` per chunk of the masked values, this rank's ‖x_i − x̄_A‖² if
    it is a member, and a second ``pmean`` over the ranks; the same scalar
    on every rank, every rank joining."""
    flat = ({k: v[None] for k, v in local.items()} if isinstance(local, dict)
            else local[None])
    total = None
    for x in _columns(flat):
        xf = x[0].float().contiguous()
        if total is None:
            af = _mask(alive, xf.device)
            scale = comm.world / af.sum().clamp_min(1.0)
            mine = af[comm.rank]
            total = torch.zeros((), dtype=torch.float32, device=xf.device)
        mean = comm.pmean(xf * mine) * scale
        total = total + mine * (xf - mean).square().sum()
    return (comm.pmean(total.reshape(1).contiguous())[0] * scale).sqrt()


def consensus_sq_shard(local, comm) -> torch.Tensor:
    """This rank's ‖x_i - x̄‖² (a float32 scalar): one ``pmean`` of each
    chunk of its own values over ``comm`` (``launch/comm.py``)."""
    flat = ({k: v[None] for k, v in local.items()} if isinstance(local, dict)
            else local[None])
    total = None
    for x in _columns(flat):
        xf = x[0].float().contiguous()
        mean = comm.pmean(xf.clone())
        sq = (xf - mean).square().sum()
        total = sq if total is None else total + sq
    return total


def consensus_distance_shard(local, comm) -> torch.Tensor:
    """Ξ on a rank: the same scalar on every rank (two ``pmean``s)."""
    sq = consensus_sq_shard(local, comm).reshape(1).contiguous()
    return comm.pmean(sq)[0].sqrt()


# ---------------------------------------------------------------------------
# The closed-loop controller
# ---------------------------------------------------------------------------

Rung = Union[int, str]  # a coordination number, or the terminal "one_peer"


@dataclasses.dataclass(eq=False)
class ConsensusController:
    """Consensus-distance-triggered Ada scheduling (closed loop).

    Walks the fixed ladder ``k0, k0-1, …, floor[, "one_peer"]`` (odd k
    equals k-1 on a RingLattice, so graph-identical rungs collapse).  Each
    probe calls ``observe(Ξ_t, step)``: Ξ_0 is the peak Ξ of the current
    rung (zero probes are skipped); Ξ_t ≤ target · Ξ_0 steps down one rung
    and re-arms the reference.  With ``spike`` (a ratio > 1), Ξ_t ≥ spike ×
    the phase's running peak walks one rung back up (a ``"redensify"``
    event).  The walk stays on the ladder, so an engine needs only the
    ladder's programs (``Topology.distinct_programs`` pins each rung).
    Mutable run state; ``reset()`` re-arms it, ``rung_at(step)`` replays
    the realized schedule.
    """

    schedule: AdaSchedule
    target: float = 0.5      # trigger ratio Ξ_t / Ξ_0 (2102.04828's fraction)
    probe_every: int = 1     # probe cadence in raw training steps
    spike: Optional[float] = None  # Ξ_t / peak ratio that re-densifies (>1)

    # -- run state (mutated by observe) -------------------------------------
    xi0: Optional[float] = None
    rung: int = 0
    transitions: list = dataclasses.field(default_factory=list)  # [(step, rung)]
    trace: list = dataclasses.field(default_factory=list)  # [(step, xi, rung)]
    events: list = dataclasses.field(default_factory=list)  # [(step, reason)]

    def __post_init__(self):
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.spike is not None and not float(self.spike) > 1.0:
            raise ValueError(
                f"spike is a re-densify ratio and must be > 1, got {self.spike}"
            )
        self.probe_every = max(int(self.probe_every), 1)
        # the re-densify reference: the current phase's peak Ξ, kept through
        # rearm() (unlike xi0) so a membership event cannot hide its spike
        self._spike_ref: Optional[float] = None
        # the run's telemetry recorder (bind_recorder), None until bound
        self._recorder = None
        n = self.schedule.n_nodes
        floor = (
            2
            if self.schedule.k_floor == "one_peer"
            else max(int(self.schedule.k_floor), 2)
        )
        start = int(np.clip(self.schedule.k0, floor, max(n - 1, floor)))
        # one rung per distinct graph, labelled by the sparser k
        ladder: list[Rung] = []
        prev_sig = None
        for k in range(start, floor - 1, -1):
            g = RingLattice(n, k)
            sig = (g.offsets, g.mult)
            if ladder and sig == prev_sig:
                ladder[-1] = k
            else:
                ladder.append(k)
            prev_sig = sig
        if self.schedule.k_floor == "one_peer":
            ladder.append("one_peer")
        self._ladder: tuple[Rung, ...] = tuple(ladder)

    # -- the ladder ----------------------------------------------------------
    @property
    def ladder(self) -> tuple[Rung, ...]:
        """The pre-enumerated rungs the controller may select among."""
        return self._ladder

    @property
    def current(self) -> Rung:
        return self._ladder[self.rung]

    @property
    def one_peer_active(self) -> bool:
        return self.current == "one_peer"

    @property
    def handoff_step(self) -> Optional[int]:
        """Step at which the one-peer handoff fired (None before it does)."""
        for step, rung in self.transitions:
            if self._ladder[rung] == "one_peer":
                return step
        return None

    # -- probing -------------------------------------------------------------
    def should_probe(self, step: int) -> bool:
        return step % self.probe_every == 0

    def observe(self, xi: float, step: int) -> bool:
        """Feed one measured Ξ_t; returns True iff the schedule stepped down.

        Ξ_0 is the running peak of the current phase: the first strictly
        positive finite observation seeds it, larger ones raise it.  A
        transition fires iff ``xi <= target * Ξ_0`` with a sparser rung
        available, and re-arms the reference; at most one rung per
        observation.  With ``spike`` set, ``xi >= spike * peak`` with a
        denser rung available first walks one rung UP and re-seeds the
        phase at the spiked level.
        """
        xi = float(xi)
        if (
            self.spike is not None
            and self.rung > 0
            and math.isfinite(xi)
            and self._spike_ref is not None
            and xi >= float(self.spike) * self._spike_ref
        ):
            self.rung -= 1
            self.transitions.append((int(step), self.rung))
            self._emit_transition(step)
            self._log_event(step, "redensify")
            # both references restart, so this spike is consumed
            self.xi0 = None
            self._spike_ref = None
            self.trace.append((int(step), xi, self.rung))
            return False
        if xi > 0.0 and math.isfinite(xi):
            self._spike_ref = (
                xi if self._spike_ref is None else max(self._spike_ref, xi)
            )
        if self.xi0 is None:
            if xi > 0.0 and math.isfinite(xi):
                self.xi0 = xi
            self.trace.append((int(step), xi, self.rung))
            return False
        if math.isfinite(xi):
            self.xi0 = max(self.xi0, xi)
        fired = (
            math.isfinite(xi)
            and xi <= self.target * self.xi0
            and self.rung < len(self._ladder) - 1
        )
        if fired:
            self.rung += 1
            self.transitions.append((int(step), self.rung))
            self._emit_transition(step)
            self.xi0 = None  # re-arm the phase reference on the new rung
            self._spike_ref = None  # sparser graphs run hotter: new baseline
        self.trace.append((int(step), xi, self.rung))
        return fired

    def rearm(self, step: int, reason: str = "fault") -> None:
        """Re-arm the phase peak Ξ_0 on a membership event (the rung stays;
        the spike reference survives, so the spike the event causes still
        compares against the pre-event level).  Same-step events coalesce
        into one ``events`` entry."""
        self.xi0 = None
        self._log_event(step, reason)

    def bind_recorder(self, recorder) -> None:
        """Attach the run's :class:`repro_torch.telemetry.MetricsRecorder`:
        every transition/rearm/redensify log entry is mirrored as a
        telemetry event.  Both engines bind at construction, so the event
        stream, coalescing included, does not depend on the engine."""
        self._recorder = recorder

    def _emit_transition(self, step: int) -> None:
        if self._recorder is not None:
            self._recorder.event(
                "transition", int(step),
                data={"rung": int(self.rung), "k": str(self.current)},
            )

    def _log_event(self, step: int, reason: str) -> None:
        """Append to ``events``, merging distinct same-step reasons into one
        ``"a+b"`` entry (``telemetry.coalesce_into``, the one coalescing
        implementation); when the entry changes, the merged reason is
        re-emitted as a ``controller`` telemetry event (consumers keep the
        last emission per step)."""
        merged = coalesce_into(self.events, int(step), str(reason))
        if merged is not None and self._recorder is not None:
            self._recorder.event(
                "controller", int(step), data={"reason": merged}
            )

    # -- resume / adoption ----------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable run state (for crash-consistent resume)."""
        return {
            "xi0": self.xi0,
            "spike_ref": self._spike_ref,
            "rung": int(self.rung),
            "transitions": [[int(s), int(r)] for s, r in self.transitions],
            "trace": [[int(s), float(x), int(r)] for s, x, r in self.trace],
            "events": [[int(s), str(r)] for s, r in self.events],
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore ``state_dict`` output: the same phase reference, rung
        walk and logs as the uninterrupted run."""
        self.xi0 = None if d.get("xi0") is None else float(d["xi0"])
        self._spike_ref = (
            None if d.get("spike_ref") is None else float(d["spike_ref"])
        )
        self.rung = min(int(d["rung"]), len(self._ladder) - 1)
        self.transitions[:] = [(int(s), int(r)) for s, r in d["transitions"]]
        self.trace[:] = [
            (int(s), float(x), int(r)) for s, x, r in d["trace"]
        ]
        self.events[:] = [(int(s), str(r)) for s, r in d["events"]]

    def adopt(self, other: "ConsensusController") -> None:
        """Continue another controller's run state on THIS ladder (rung
        clamped to it, history carried over)."""
        self.load_state_dict(other.state_dict())

    def reset(self) -> None:
        """Re-arm for a fresh run (clears Ξ_0, rung, and the logs)."""
        self.xi0 = None
        self._spike_ref = None
        self.rung = 0
        self.transitions.clear()
        self.trace.clear()
        self.events.clear()

    # -- schedule interface (what Topology delegates to) ----------------------
    def graph_at(self, epoch: int = 0, step: int = 0) -> CommGraph:
        """The graph the *current* rung selects (the epoch is ignored: the
        measured signal drives the schedule)."""
        cur = self.current
        if cur == "one_peer":
            return one_peer_exponential(self.schedule.n_nodes, step)
        return RingLattice(self.schedule.n_nodes, int(cur))

    def period_steps(self) -> int:
        """Steps before the current rung's graph repeats (1 = static)."""
        if self.one_peer_active:
            return one_peer_period(self.schedule.n_nodes)
        return 1

    @contextlib.contextmanager
    def pinned(self, rung: int):
        """Temporarily force a rung: enumerates the bounded program set and
        replays a recorded run without disturbing the live state."""
        if not 0 <= rung < len(self._ladder):
            raise ValueError(f"rung {rung} outside ladder of {len(self._ladder)}")
        old = self.rung
        self.rung = rung
        try:
            yield self
        finally:
            self.rung = old

    def rung_at(self, step: int) -> int:
        """The rung in force at ``step``, replayed from the transition log
        (a transition observed at step s governs step s onward)."""
        rung = 0
        for s, r in self.transitions:
            if s <= step:
                rung = r
            else:
                break
        return rung

    def describe(self) -> str:
        ks = ",".join(str(r) for r in self._ladder)
        sp = "" if self.spike is None else f", spike={self.spike}"
        return (
            f"ConsensusController(target={self.target}, "
            f"probe_every={self.probe_every}{sp}, ladder=[{ks}])"
        )

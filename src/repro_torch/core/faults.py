"""Fault models and elastic membership: the counterpart of
``repro/core/faults.py``.

The fault models are the reference's, copied: seeded, step-deterministic
processes whose realization at step t is a pure function of
``(seed, t)``, so the simulator, the stacked trainer and every rank of
the ranks engine draw the same masks with no communication (``_rng`` is
the reference's exactly, and so are the streams):

  * ``crash`` (``PermanentCrash``): a seeded victim dies at a seeded step
    (and rejoins after ``down_steps``); the engines select the
    pre-enumerated degraded program (``GossipProgram.degrade``);
  * ``concurrent`` (``ConcurrentCrash``): k victims with overlapping down
    windows, composed as runtime masks over the base program (or, with
    ``enumerate_programs``, as pre-enumerated degraded programs);
  * ``preempt`` (``Preemption``): an announced drain whose edges carry a
    float ``boost`` > 1, then the mean-preserving ``drain_handoff`` and a
    clean departure;
  * ``join`` (``Join``): mid-run growth (simulator only): a new node
    enters with its neighbours' average (``admit_node``) and the topology
    is re-derived at the new n (``Topology.resized``);
  * ``deadline`` (``GossipDeadline``): seeded round latencies; a node that
    misses the deadline sits the round out with exponential-backoff
    readmission, keeping its local step;
  * ``spare`` (``SparePool``): spare ranks ride as alive-masked ghosts
    from step 0; an inner ``join`` activates one at its join step;
  * ``dropout``, ``link``, ``straggler``: per-step i.i.d. node dropouts,
    symmetric link failures and skipped local updates.

How the masks act in both engines: ``update`` gates the local optimizer
step per node, ``alive`` and ``link_up`` degrade the mixing exactly as
``degraded_matrix`` (the masked interpreters, and the fused kernels'
fault rows), and ``rejoin``/``depart``/``joins`` are membership events
handled before the step.  A membership change re-arms the consensus
controller (``track_membership``).

The port's state is flat (``core/flat.py``: (n, P) buffers per parameter
and optimizer slot), so the membership handoffs work on buffer rows:
``adopt_neighbor_average`` and ``drain_handoff`` write rows IN PLACE (on
a rank's (1, P) buffer they gather the column chunks they need from
every rank, every rank joining), and ``admit_node`` returns a buffer one
row taller.  Every row sum they take runs in node order in float32, so
the stacked engine and the ranks engine compute the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.schedule import degraded_matrix  # noqa: F401  (re-export)

__all__ = [
    "FAULT_MODELS",
    "ConcurrentCrash",
    "FaultModel",
    "FaultRealization",
    "GossipDeadline",
    "Join",
    "LinkFailure",
    "NoFaults",
    "PermanentCrash",
    "Preemption",
    "SparePool",
    "Straggler",
    "TransientDropout",
    "admit_node",
    "adopt_neighbor_average",
    "degraded_matrix",
    "drain_handoff",
    "fold_degraded_programs",
    "make_fault_model",
    "membership_events",
    "realization_arrays",
    "rejoin_neighbors",
    "track_membership",
]

# columns per chunk of a membership handoff: bounds its float32 temporaries
# (and, on a rank, each gathered message) whatever the state size
HANDOFF_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True, eq=False)
class FaultRealization:
    """What the fault model says about ONE training step (numpy, host-side).

    alive:         (n,) — node participates in this step's gossip.  Usually
        bool; float values are *weight multipliers* on the node's edges
        (the masked interpreters are linear in the mask): 0 removes the
        edge, 1 keeps it, and a preemption drain up-weights the departing
        node with values > 1 — still symmetric, so W stays doubly
        stochastic and the mean is preserved.
    update:        (n,) bool — node performs its local optimizer update.
    program_alive: (n,) bool — the slowly-varying TRUE membership (all
        ones except permanent crashes/departures).  Drives
        ``membership_key`` and hence controller re-arming.
    select_alive:  optional (n,) bool — the mask used for degraded-program
        *selection* when it differs from the true membership.  The composed
        concurrent-crash path keeps it all-ones (base program + runtime
        masks realize the multi-node degradation), while ``program_alive``
        still records who is actually dead.  ``None`` => ``program_alive``.
    link_up:       optional (n, n) bool, symmetric — per-link liveness.
    rejoin:        nodes re-entering at this step (adopt neighbor average).
    depart:        nodes leaving cleanly AT this step (after a drain): the
        engines run the mean-preserving ``drain_handoff`` before the step.
    joins:         new node indices entering at this step (elastic growth;
        realization arrays from this step on are sized for the grown n).
    """

    alive: np.ndarray
    update: np.ndarray
    program_alive: np.ndarray
    link_up: Optional[np.ndarray] = None
    rejoin: tuple[int, ...] = ()
    select_alive: Optional[np.ndarray] = None
    depart: tuple[int, ...] = ()
    joins: tuple[int, ...] = ()

    @property
    def faulty(self) -> bool:
        # `alive == 1` (not `.all()`): a float drain boost (alive > 1) must
        # also route through the masked step even though every node is up
        return (
            not (self.alive == 1).all()
            or not self.update.all()
            or (self.link_up is not None and not self.link_up.all())
        )

    def membership_key(self) -> tuple:
        """Hashable TRUE-membership identity (drives controller re-arming).

        Always derived from ``program_alive`` — even when the composed
        concurrent-crash path selects the base program (``select_alive``
        all-ones), a real membership change must still re-arm the
        controller's phase reference.
        """
        return tuple(bool(a) for a in self.program_alive)

    def selection_mask(self) -> np.ndarray:
        """The membership mask engines select the degraded program by."""
        return (
            self.program_alive if self.select_alive is None
            else self.select_alive
        )


def _rng(seed: int, step: int, salt: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, salt, step]))


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Base: a seeded, step-deterministic fault process over n nodes."""

    n: int
    rate: float
    seed: int = 0
    name: str = "none"

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"fault model needs >=1 node, got n={self.n}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")

    def _ones(self) -> np.ndarray:
        return np.ones(self.n, dtype=bool)

    def at(self, step: int) -> FaultRealization:  # pragma: no cover - base
        raise NotImplementedError

    def program_masks(self) -> tuple[tuple[bool, ...], ...]:
        """Every membership mask this model can realize beyond all-alive —
        the alive-sets ``Topology.distinct_programs`` pre-enumerates
        degraded programs for (empty for purely transient models)."""
        return ()

    @property
    def has_link_faults(self) -> bool:
        """Whether realizations may carry a per-edge ``link_up`` mask —
        models that never do skip the (n, n) link operand entirely."""
        return False

    @property
    def elastic(self) -> bool:
        """Whether membership can EXCEED the initial n (mid-run joins).
        Elastic models are simulator-only — a device mesh is fixed."""
        return False

    def describe(self) -> str:
        return f"{self.name}(n={self.n}, rate={self.rate}, seed={self.seed})"


@dataclasses.dataclass(frozen=True)
class NoFaults(FaultModel):
    name: str = "none"

    def at(self, step: int) -> FaultRealization:
        ones = self._ones()
        return FaultRealization(alive=ones, update=ones, program_alive=ones)


@dataclasses.dataclass(frozen=True)
class PermanentCrash(FaultModel):
    """One seeded victim crashes at a seeded step (single-node-out).

    The victim and crash step derive from the seed: the crash step is a
    geometric draw with parameter ``rate`` (expected onset ~1/rate steps).
    ``down_steps`` (elastic membership) brings the victim back after that
    many dead steps — it rejoins by adopting its neighbors' average.
    Exactly one node is ever out at a time, so the degraded-program set the
    engines must cache is bounded by one extra program per base program.
    """

    name: str = "crash"
    down_steps: Optional[int] = None

    def __post_init__(self):
        super().__post_init__()
        if self.down_steps is not None and int(self.down_steps) < 1:
            # 0 would fire a rejoin for a node that never went down
            # (neighbor-average overwrites healthy state); negative values
            # would silently empty the crash window
            raise ValueError(
                f"down_steps must be >= 1, got {self.down_steps}"
            )
        r = _rng(self.seed, 0, salt=101)
        victim = int(r.integers(self.n))
        # first success of a Bernoulli(rate) sequence; rate 0 => never
        crash_step = int(r.geometric(self.rate)) if self.rate > 0 else None
        object.__setattr__(self, "_victim", victim)
        object.__setattr__(self, "_crash_step", crash_step)

    @property
    def victim(self) -> int:
        return self._victim

    @property
    def crash_step(self) -> Optional[int]:
        return self._crash_step

    @property
    def rejoin_step(self) -> Optional[int]:
        if self._crash_step is None or self.down_steps is None:
            return None
        return self._crash_step + int(self.down_steps)

    def at(self, step: int) -> FaultRealization:
        ones = self._ones()
        c, r = self._crash_step, self.rejoin_step
        down = c is not None and c <= step and (r is None or step < r)
        if not down:
            return FaultRealization(
                alive=ones, update=ones, program_alive=ones,
                rejoin=(self._victim,) if (r is not None and step == r) else (),
            )
        alive = ones.copy()
        alive[self._victim] = False
        return FaultRealization(
            alive=alive, update=alive.copy(), program_alive=alive.copy()
        )

    def program_masks(self):
        if self._crash_step is None:
            return ()
        mask = [True] * self.n
        mask[self._victim] = False
        return (tuple(mask),)


@dataclasses.dataclass(frozen=True)
class ConcurrentCrash(FaultModel):
    """k >= 2 seeded victims crash in overlapping windows.

    Each victim gets an independent geometric onset (parameter ``rate``),
    so down windows overlap — including simultaneous same-step crashes
    (the coalesced-rearm case).  ``down_steps`` brings each victim back
    that many steps after its own onset (elastic rejoin, per victim).

    Execution modes:

      * composed (default): ``select_alive`` stays all-ones — the engines
        keep the BASE program and the realized multi-node dead set rides
        the runtime alive mask.  By the mask-composition identity this
        realizes exactly ``degraded_matrix(W, dead-set)``, and the run
        compiles no more executables than the fault-free run (the
        acceptance bar pinned by ``tests/faults_spmd_script.py``).
      * ``enumerate_programs=True``: the bounded enumeration fast path —
        ``program_masks`` walks the crash/rejoin timeline and returns every
        membership mask the model actually realizes (<= 2k distinct, NOT
        the C(n, k) combinatorial set).  Engines then select the exact
        degraded program, so dead-edge sends leave the wire; the masks are
        pre-enumerated, so zero mid-run recompiles still holds.
    """

    name: str = "concurrent"
    k: int = 2
    down_steps: Optional[int] = None
    enumerate_programs: bool = False

    def __post_init__(self):
        super().__post_init__()
        if not 2 <= int(self.k) < self.n:
            raise ValueError(
                f"concurrent crash needs 2 <= k < n, got k={self.k}, n={self.n}"
            )
        if self.down_steps is not None and int(self.down_steps) < 1:
            raise ValueError(f"down_steps must be >= 1, got {self.down_steps}")
        r = _rng(self.seed, 0, salt=105)
        victims = tuple(int(v) for v in r.choice(self.n, int(self.k), False))
        onsets = tuple(
            int(r.geometric(self.rate)) if self.rate > 0 else None
            for _ in victims
        )
        object.__setattr__(self, "_victims", victims)
        object.__setattr__(self, "_onsets", onsets)

    @property
    def victims(self) -> tuple[int, ...]:
        return self._victims

    @property
    def onsets(self) -> tuple[Optional[int], ...]:
        return self._onsets

    def _window(self, i: int) -> tuple[Optional[int], Optional[int]]:
        on = self._onsets[i]
        if on is None:
            return None, None
        off = None if self.down_steps is None else on + int(self.down_steps)
        return on, off

    def at(self, step: int) -> FaultRealization:
        ones = self._ones()
        alive = ones.copy()
        rejoin = []
        for i, v in enumerate(self._victims):
            on, off = self._window(i)
            if on is None:
                continue
            if on <= step and (off is None or step < off):
                alive[v] = False
            elif off is not None and step == off:
                rejoin.append(v)
        return FaultRealization(
            alive=alive,
            update=alive.copy(),
            program_alive=alive.copy(),
            rejoin=tuple(rejoin),
            # composed mode: base program + runtime masks (select stays
            # all-ones); enumeration mode selects the realized membership
            select_alive=None if self.enumerate_programs else ones.copy(),
        )

    def program_masks(self):
        if not self.enumerate_programs:
            return ()  # composed: the dead set rides the runtime mask
        events = sorted(
            {s for i in range(len(self._victims))
             for s in self._window(i) if s is not None}
        )
        masks, seen = [], set()
        for s in events:
            mask = tuple(bool(a) for a in self.at(s).program_alive)
            if not all(mask) and mask not in seen:
                seen.add(mask)
                masks.append(mask)
        return tuple(masks)


@dataclasses.dataclass(frozen=True)
class Preemption(FaultModel):
    """Planned preemption: announce, drain, hand off, leave cleanly.

    A seeded victim is preempted at a seeded step (geometric onset with
    parameter ``rate``) but — unlike a hard crash — it announces departure
    ``drain_steps`` ahead.  During the drain its edges carry a float
    ``boost`` > 1 in the runtime alive mask: the masked interpreters are
    linear in the mask, so every edge touching the victim moves ``boost``×
    its weight while receivers subtract the excess from their self weight.
    The boosted W stays symmetric and doubly stochastic (mean preserved
    every drain step); neighbors absorb the departing replica's state
    faster than the base graph would diffuse it.

    At the departure step the realization carries ``depart=(victim,)`` and
    the engines apply the exact mean-preserving handoff
    (``drain_handoff``): the survivors' post-departure mean equals the
    pre-departure global mean, so Xi_t sees no membership spike — the
    clean-leave contrast to ``crash`` that ``benchmarks/faults.py``'s
    elastic sweep measures.  From then on the victim is a permanent
    single-node-out membership (one pre-enumerated degraded program, as
    for ``crash``).

    The default ``boost=1.5`` keeps every receiver's self weight
    nonnegative for the uniform circulant families and Metropolis–Hastings
    leaf drains (self weight >= 0.5 × boosted incoming mass there); larger
    boosts stay mean-preserving but may push a self weight negative.
    """

    name: str = "preempt"
    drain_steps: int = 5
    boost: float = 1.5

    def __post_init__(self):
        super().__post_init__()
        if int(self.drain_steps) < 1:
            raise ValueError(
                f"drain_steps must be >= 1, got {self.drain_steps}"
            )
        if not float(self.boost) >= 1.0:
            raise ValueError(f"boost must be >= 1, got {self.boost}")
        r = _rng(self.seed, 0, salt=106)
        victim = int(r.integers(self.n))
        announce = int(r.geometric(self.rate)) if self.rate > 0 else None
        object.__setattr__(self, "_victim", victim)
        object.__setattr__(self, "_announce_step", announce)

    @property
    def victim(self) -> int:
        return self._victim

    @property
    def announce_step(self) -> Optional[int]:
        return self._announce_step

    @property
    def depart_step(self) -> Optional[int]:
        if self._announce_step is None:
            return None
        return self._announce_step + int(self.drain_steps)

    def at(self, step: int) -> FaultRealization:
        ones = self._ones()
        a, d = self._announce_step, self.depart_step
        if a is None or step < a:
            return FaultRealization(
                alive=ones, update=ones.copy(), program_alive=ones.copy()
            )
        if step < d:  # draining: still training, edges boosted
            boosted = np.ones(self.n, dtype=np.float64)
            boosted[self._victim] = float(self.boost)
            return FaultRealization(
                alive=boosted, update=ones.copy(), program_alive=ones.copy()
            )
        dead = ones.copy()
        dead[self._victim] = False
        return FaultRealization(
            alive=dead,
            update=dead.copy(),
            program_alive=dead.copy(),
            depart=(self._victim,) if step == d else (),
        )

    def program_masks(self):
        if self._announce_step is None:
            return ()
        mask = [True] * self.n
        mask[self._victim] = False
        return (tuple(mask),)


@dataclasses.dataclass(frozen=True)
class Join(FaultModel):
    """True mid-run growth: membership exceeds the initial n (simulator-only).

    ``join_steps`` pre-declares when each new node enters (one per step
    listed; the new node's index is ``n + i`` for the i-th join).  When not
    given, one seeded geometric onset (parameter ``rate``) is drawn — still
    a pure function of the seed, so both a run and its resume replay the
    same growth.  A joining node enters by adopting its (new) neighbors'
    average (``admit_node``); the engine re-derives the topology at the new
    n via ``Topology.resized`` and the controller re-arms through
    ``track_membership`` (the membership key changes length).

    Programs for every pre-declared size are enumerable up front
    (``Topology.distinct_programs`` folds the growth schedule in), so joins
    compile nothing beyond that bounded set.
    """

    name: str = "join"
    join_steps: Optional[tuple[int, ...]] = None

    def __post_init__(self):
        super().__post_init__()
        js = self.join_steps
        if js is None:
            r = _rng(self.seed, 0, salt=107)
            js = (int(r.geometric(self.rate)),) if self.rate > 0 else ()
        js = tuple(sorted(int(s) for s in js))
        if js and js[0] < 1:
            raise ValueError(f"join steps must be >= 1, got {js}")
        object.__setattr__(self, "join_steps", js)

    @property
    def elastic(self) -> bool:
        return True

    def membership_sizes(self) -> tuple[int, ...]:
        """Every n the run can reach (the pre-declared growth schedule)."""
        return tuple(self.n + i for i in range(len(self.join_steps) + 1))

    def n_at(self, step: int) -> int:
        """Membership size in force AT ``step`` (joins land at their step)."""
        return self.n + sum(1 for s in self.join_steps if s <= step)

    def at(self, step: int) -> FaultRealization:
        m = self.n_at(step)
        ones = np.ones(m, dtype=bool)
        joins = tuple(
            self.n + i for i, s in enumerate(self.join_steps) if s == step
        )
        return FaultRealization(
            alive=ones, update=ones.copy(), program_alive=ones.copy(),
            joins=joins,
        )


@dataclasses.dataclass(frozen=True)
class TransientDropout(FaultModel):
    """Per-step i.i.d. node dropout: skips gossip, keeps the local update."""

    name: str = "dropout"

    def at(self, step: int) -> FaultRealization:
        ones = self._ones()
        drop = _rng(self.seed, step, salt=1).random(self.n) < self.rate
        if drop.all():  # keep at least one node in the round
            drop[int(_rng(self.seed, step, salt=2).integers(self.n))] = False
        return FaultRealization(alive=~drop, update=ones, program_alive=ones)


@dataclasses.dataclass(frozen=True)
class LinkFailure(FaultModel):
    """Per-step i.i.d. symmetric link failures (both directions die)."""

    name: str = "link"

    @property
    def has_link_faults(self) -> bool:
        return True

    def at(self, step: int) -> FaultRealization:
        ones = self._ones()
        u = _rng(self.seed, step, salt=3).random((self.n, self.n))
        up = np.triu(u >= self.rate, k=1)
        link_up = up | up.T
        np.fill_diagonal(link_up, True)
        return FaultRealization(
            alive=ones, update=ones.copy(), program_alive=ones.copy(),
            link_up=link_up,
        )


@dataclasses.dataclass(frozen=True)
class Straggler(FaultModel):
    """Per-step stragglers: skip the local update but still mix."""

    name: str = "straggler"

    def at(self, step: int) -> FaultRealization:
        ones = self._ones()
        slow = _rng(self.seed, step, salt=4).random(self.n) < self.rate
        return FaultRealization(
            alive=ones, update=~slow, program_alive=ones.copy()
        )


@dataclasses.dataclass(frozen=True)
class GossipDeadline(FaultModel):
    """Per-round gossip deadline with exponential-backoff readmission.

    Each (node, step) draws a lognormal round latency
    ``mean_ms · exp(sigma · Z)``; with probability ``rate`` the node
    additionally suffers a straggler spike (``spike_mult``× the draw).  A
    node whose latency exceeds ``deadline_ms`` MISSES the round: it is
    masked out of gossip (``alive = 0`` — its neighbors renormalize onto
    self, its own row degrades to identity) but keeps its local optimizer
    step (``update = 1``) — graceful degradation to partial participation
    with a local-step fallback (arXiv:2506.00961) instead of the whole
    round stalling on the straggler.

    Readmission is under exponential backoff: a fresh miss benches the
    node for ``penalty`` further rounds (masked out, still local-stepping)
    and multiplies the penalty by ``backoff`` (1, 2, 4, … up to
    ``backoff_cap``); an on-time *participated* round resets the penalty
    to 1.  This prevents a persistently slow node from thrashing the
    deadline every round while guaranteeing it is re-probed at growing
    intervals.

    The timeline is a pure function of ``(seed, step)``: it is replayed
    incrementally from step 0 and cached, so out-of-order queries and
    resumed runs see the identical stream (the backoff state machine is
    deterministic given the seeded latency draws).  ``program_alive``
    stays all-ones — a miss is transient, never a membership event — and
    all masks are runtime fault-row values: zero extra executables.

    The seeded latencies stand in for wall-clock measurement so both
    engines and any resume stay bit-identical; the engines separately
    record measured wall-clock round durations (``round_ms``) and count
    overruns against this same ``deadline_ms`` as an observational trace.
    """

    name: str = "deadline"
    deadline_ms: float = 30.0
    mean_ms: float = 20.0
    sigma: float = 0.25
    spike_mult: float = 10.0
    backoff: float = 2.0
    backoff_cap: int = 64

    def __post_init__(self):
        super().__post_init__()
        if not float(self.deadline_ms) > 0.0:
            raise ValueError(f"deadline_ms must be > 0, got {self.deadline_ms}")
        if not 0.0 < float(self.mean_ms):
            raise ValueError(f"mean_ms must be > 0, got {self.mean_ms}")
        if not float(self.backoff) >= 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        if int(self.backoff_cap) < 1:
            raise ValueError(
                f"backoff_cap must be >= 1, got {self.backoff_cap}"
            )
        # incremental replay cache: _participates[t] is the (n,) bool mask
        # of nodes that made round t; the penalty/suspension state machine
        # advances with it (deterministic given the seeded draws, so two
        # same-seed instances — or a resume — replay the identical stream)
        object.__setattr__(self, "_participates", [])
        object.__setattr__(self, "_penalty", np.ones(self.n))
        object.__setattr__(self, "_suspend", np.zeros(self.n, dtype=np.int64))

    def latency_ms(self, step: int) -> np.ndarray:
        """The seeded per-node round latency draw for ``step`` (ms)."""
        r = _rng(self.seed, step, salt=108)
        base = self.mean_ms * np.exp(self.sigma * r.standard_normal(self.n))
        spiked = r.random(self.n) < self.rate
        return np.where(spiked, base * self.spike_mult, base)

    def _advance_to(self, step: int) -> None:
        while len(self._participates) <= step:
            t = len(self._participates)
            miss = self.latency_ms(t) > self.deadline_ms
            benched = self._suspend > 0
            part = ~(miss | benched)
            self._suspend[benched] -= 1
            # a fresh miss (not already benched) earns a sit-out window of
            # the current penalty, then the penalty grows geometrically
            fresh = miss & ~benched
            self._suspend[fresh] += np.round(self._penalty[fresh]).astype(
                np.int64
            )
            self._penalty[fresh] = np.minimum(
                self._penalty[fresh] * self.backoff, float(self.backoff_cap)
            )
            self._penalty[part] = 1.0  # on-time round: backoff resets
            self._participates.append(part)

    def at(self, step: int) -> FaultRealization:
        self._advance_to(step)
        ones = self._ones()
        return FaultRealization(
            alive=self._participates[step].copy(),
            update=ones,  # local-step fallback: a benched node keeps training
            program_alive=ones.copy(),
        )

    def describe(self) -> str:
        return (
            f"{self.name}(n={self.n}, rate={self.rate}, seed={self.seed}, "
            f"deadline_ms={self.deadline_ms}, backoff={self.backoff})"
        )


@dataclasses.dataclass(frozen=True)
class SparePool(FaultModel):
    """Over-provisioned spare-rank pool: elastic membership on a FIXED mesh.

    ``n`` is the FULL gossip size the mesh (and topology) is built at;
    the last ``spares`` ranks ride from step 0 as alive-masked, zero-weight
    *ghosts*: their ``alive``/``update`` masks are 0, so ``degraded_matrix``
    renormalizes their edge mass onto the active receivers' self weight and
    degrades each ghost's own row to the identity — a zero-weight
    participant whose replica stays frozen at init.  ``select_alive`` is
    ALWAYS all-ones and ``program_masks`` is empty: every realization —
    ghosts, inner faults, activations — rides the base program's runtime
    fault row, so a spare pool compiles exactly as many executables as the
    fault-free run (the invariant ``tests/faults_spmd_script.py`` pins).

    ``inner`` is an optional fault model over the ``n - spares`` initially
    active ranks.  A ``Join`` inner turns pre-declared joins into spare
    ACTIVATIONS: inner join i lands on outer rank ``(n - spares) + i``,
    surfaced through ``rejoin`` — the engines' existing rejoin path adopts
    the spare's state from its alive neighbors' average (``admit_node``
    semantics without growing any array) and the membership-key flip
    re-arms the consensus controller.  Non-elastic inners (deadline,
    preempt, crash, dropout, link, straggler) compose unchanged on the
    active ranks; an inner's own pre-enumerated program masks are
    deliberately dropped — the pool forces the composed runtime-mask
    execution for everything.

    The pool itself is NOT elastic (membership never exceeds ``n``), which
    is exactly why — unlike ``join`` — it runs on the SPMD trainer.
    """

    name: str = "spare"
    spares: int = 1
    inner: Optional[FaultModel] = None

    def __post_init__(self):
        super().__post_init__()
        if not 1 <= int(self.spares) < self.n:
            raise ValueError(
                f"spare pool needs 1 <= spares < n, got spares={self.spares}, "
                f"n={self.n}"
            )
        n0 = self.n - int(self.spares)
        if self.inner is not None:
            if isinstance(self.inner, SparePool):
                raise ValueError("spare pools do not nest")
            if self.inner.n != n0:
                raise ValueError(
                    f"inner fault model covers {self.inner.n} nodes but the "
                    f"pool has {n0} initially-active ranks "
                    f"(n={self.n} - spares={self.spares})"
                )
            if self.inner.elastic:
                js = getattr(self.inner, "join_steps", ())
                if len(js) > int(self.spares):
                    raise ValueError(
                        f"{len(js)} pre-declared joins exceed the "
                        f"{self.spares} spare rank(s)"
                    )

    @property
    def n_active0(self) -> int:
        """Initially-active rank count (the inner model's n)."""
        return self.n - int(self.spares)

    @property
    def has_link_faults(self) -> bool:
        return self.inner is not None and self.inner.has_link_faults

    @property
    def deadline_ms(self) -> Optional[float]:
        """The inner deadline (ms) when wrapping a ``GossipDeadline``."""
        return getattr(self.inner, "deadline_ms", None)

    def activation_steps(self) -> tuple[int, ...]:
        """Steps at which a spare activates (the inner join schedule)."""
        if self.inner is not None and self.inner.elastic:
            return tuple(self.inner.join_steps)
        return ()

    def at(self, step: int) -> FaultRealization:
        n0 = self.n_active0
        if self.inner is None:
            m = n0
            ones = np.ones(m, dtype=bool)
            base = FaultRealization(
                alive=ones, update=ones.copy(), program_alive=ones.copy()
            )
        else:
            base = self.inner.at(step)
            m = len(base.program_alive)  # grows as inner joins land
        base_alive = np.asarray(base.alive)
        alive = np.zeros(self.n, dtype=base_alive.dtype)  # ghosts: 0
        alive[:m] = base_alive
        update = np.zeros(self.n, dtype=bool)  # ghosts: frozen at init
        update[:m] = base.update
        palive = np.zeros(self.n, dtype=bool)  # drives membership_key/rearm
        palive[:m] = base.program_alive
        link = None
        if base.link_up is not None:
            link = np.ones((self.n, self.n), dtype=bool)
            link[:m, :m] = base.link_up
        return FaultRealization(
            alive=alive,
            update=update,
            program_alive=palive,
            link_up=link,
            # inner joins become spare activations at the SAME index: the
            # rejoin path adopts the spare's row from its alive neighbors
            rejoin=tuple(base.rejoin) + tuple(base.joins),
            depart=tuple(base.depart),
            # zero-recompile invariant: the base program + runtime fault
            # row realize every ghost/inner degradation (never select a
            # degraded program, never enumerate one)
            select_alive=np.ones(self.n, dtype=bool),
        )

    def program_masks(self):
        return ()

    def describe(self) -> str:
        inner = "none" if self.inner is None else self.inner.describe()
        return (
            f"{self.name}(n={self.n}, spares={self.spares}, inner={inner})"
        )


FAULT_MODELS = (
    "none", "crash", "concurrent", "preempt", "join", "deadline", "dropout",
    "link", "straggler",
)


def make_fault_model(
    kind: str,
    n: int,
    *,
    rate: float = 0.1,
    seed: int = 0,
    down_steps: Optional[int] = None,
    k: int = 2,
    drain_steps: int = 5,
    boost: float = 1.5,
    join_steps: Optional[tuple[int, ...]] = None,
    enumerate_programs: bool = False,
    spare_ranks: int = 0,
    deadline_ms: float = 30.0,
    deadline_mean_ms: float = 20.0,
    deadline_backoff: float = 2.0,
) -> Optional[FaultModel]:
    """Factory: ``make_fault_model("dropout", 16, rate=0.05, seed=3)``.

    ``kind="none"`` (or rate 0 for transient models) returns ``None`` so
    engines keep their exact fault-free hot path.  Elastic/permanent kinds:
    ``crash`` (one victim; ``down_steps`` rejoins it), ``concurrent``
    (``k`` victims, overlapping windows; ``enumerate_programs`` switches
    from the composed runtime-mask default to the bounded pre-enumerated
    degraded-program fast path), ``preempt`` (``drain_steps`` of ``boost``-
    weighted drain, then a clean mean-preserving departure), ``join``
    (``join_steps`` pre-declared growth; simulator-only unless wrapped in a
    spare pool), and ``deadline`` (per-round gossip deadline ``deadline_ms``
    with latency-spike probability ``rate`` and exponential
    ``deadline_backoff`` readmission).

    ``spare_ranks=S`` wraps ANY kind in a ``SparePool`` over a mesh of
    ``n`` total ranks whose last S ride as alive-masked zero-weight ghosts:
    the inner model is built at ``n - S`` active ranks, and a ``join``
    inner's pre-declared joins become spare *activations* — elastic
    membership that runs on the fixed-mesh SPMD trainer.  With spares a
    pool is always returned (the ghost masks alone make the run faulty)
    even when the inner kind realizes nothing.
    """
    if int(spare_ranks or 0) > 0:
        inner = make_fault_model(
            kind, n - int(spare_ranks), rate=rate, seed=seed,
            down_steps=down_steps, k=k, drain_steps=drain_steps, boost=boost,
            join_steps=join_steps, enumerate_programs=enumerate_programs,
            deadline_ms=deadline_ms, deadline_mean_ms=deadline_mean_ms,
            deadline_backoff=deadline_backoff,
        )
        return SparePool(
            n=n, rate=0.0, seed=seed, spares=int(spare_ranks), inner=inner
        )
    if kind in (None, "none"):
        return None
    if kind == "crash":
        m = PermanentCrash(n=n, rate=rate, seed=seed, down_steps=down_steps)
        # rate 0 => crash_step None: the model can never realize a fault;
        # keep the documented contract that engines stay on the exact
        # fault-free hot path instead of paying the mask plumbing for nothing
        return m if m.crash_step is not None else None
    if kind == "concurrent":
        m = ConcurrentCrash(
            n=n, rate=rate, seed=seed, k=k, down_steps=down_steps,
            enumerate_programs=enumerate_programs,
        )
        return m if any(o is not None for o in m.onsets) else None
    if down_steps is not None:
        raise ValueError(
            "down_steps is a crash/concurrent (permanent-fault) option"
        )
    if kind == "preempt":
        m = Preemption(
            n=n, rate=rate, seed=seed, drain_steps=drain_steps, boost=boost,
        )
        return m if m.announce_step is not None else None
    if kind == "join":
        m = Join(n=n, rate=rate, seed=seed, join_steps=join_steps)
        return m if m.join_steps else None
    if kind == "deadline":
        if rate == 0.0:
            return None
        return GossipDeadline(
            n=n, rate=rate, seed=seed, deadline_ms=deadline_ms,
            mean_ms=deadline_mean_ms, backoff=deadline_backoff,
        )
    if rate == 0.0:
        return None
    if kind == "dropout":
        return TransientDropout(n=n, rate=rate, seed=seed)
    if kind == "link":
        return LinkFailure(n=n, rate=rate, seed=seed)
    if kind == "straggler":
        return Straggler(n=n, rate=rate, seed=seed)
    raise ValueError(f"unknown fault model {kind!r}; one of {FAULT_MODELS}")


def fold_degraded_programs(programs, fault_model: FaultModel):
    """(base, degraded) pairs for every membership mask the model can
    realize over the given base programs, deduped against the bases and
    each other by cache key.

    The single enumeration used by both ``Topology.distinct_programs`` and
    ``SPMDTrainer.precompile_programs`` — crash semantics (e.g. a future
    multi-node mask set) must change in exactly one place or the trainer's
    precompiled set drifts from the Topology's asserted cache bound.
    """
    programs = list(programs)
    seen = {p.cache_key for p in programs}
    out = []
    for mask in fault_model.program_masks():
        for p in programs:
            d = p.degrade(mask)
            if d.cache_key not in seen:
                seen.add(d.cache_key)
                out.append((p, d))
    return out


# ---------------------------------------------------------------------------
# Elastic rejoin
# ---------------------------------------------------------------------------

def rejoin_neighbors(topology, fr: FaultRealization, node: int, *,
                     step: int, epoch: int, mix_every: int = 1) -> list[int]:
    """The alive peers a recovering node averages over: its neighborhood in
    the graph in force at the rejoin step (every alive node for the
    centralized/no-graph case).  Shared by both engines — the rejoin
    semantics must stay in lockstep or the engine-equivalence guarantee
    breaks."""
    graph = topology.graph_at(epoch, step // max(int(mix_every), 1))
    if graph is None:
        return [i for i in range(len(fr.alive)) if fr.alive[i] and i != node]
    return [i for i in graph.neighbors(node) if fr.alive[i] and i != node]


def track_membership(last, fr: FaultRealization, controller, step: int):
    """Fold one step's realization into the engine's membership tracking.

    Returns the new membership key; on a change after the first step it
    re-arms the consensus controller's phase reference (a crash/rejoin
    spikes Ξ — comparing it against the pre-fault peak would ratchet the
    ladder on a stale reference).  Shared by both engines.  This is the
    single per-step re-arm entry point: a k-node concurrent crash changes
    the key ONCE, and ``ConsensusController.rearm`` coalesces any further
    same-step events into one log entry.
    """
    membership = fr.membership_key()
    if membership != last and last is not None and controller is not None:
        controller.rearm(step, reason="membership")
    return membership


def membership_events(fr: FaultRealization, bufs, topology, last, *, step: int, epoch: int,
                      mix_every: int = 1, telemetry=None, comm=None):
    """A step's membership events before the step, shared by both engines:
    each node of ``fr.rejoin`` adopts its alive neighbours' average and
    each of ``fr.depart`` hands its state off (``drain_handoff``), IN
    PLACE on every flat buffer of ``bufs`` (θ and each optimizer slot;
    this rank's rows with ``comm``, every rank joining); then the
    membership is tracked (``track_membership``: the controller re-arms on
    a change).  ``telemetry`` (a ``MetricsRecorder``, or None) gets the
    rejoin, depart and membership events.  Returns the new membership
    key."""
    active = telemetry is not None and telemetry.active
    for kind, nodes in (("rejoin", fr.rejoin), ("depart", fr.depart)):
        for node in nodes:
            nbrs = rejoin_neighbors(topology, fr, node, step=step, epoch=epoch,
                                    mix_every=mix_every)
            if active:
                telemetry.event(kind, step, data={"node": int(node)})
            for buf in bufs:
                if kind == "rejoin":
                    adopt_neighbor_average(buf, node, nbrs, comm=comm)
                else:
                    drain_handoff(buf, node, nbrs, fr.alive, comm=comm)
    membership = track_membership(last, fr, topology.controller, step)
    if active and last is not None and membership != last:
        telemetry.event("membership", step, data={"alive": [bool(b) for b in membership]})
    return membership


def _rows2d(buf: torch.Tensor) -> torch.Tensor:
    """A state buffer as (rows, columns): a per-node counter (rows,) (AdamW's
    step count) as one column."""
    return buf if buf.dim() == 2 else buf.reshape(buf.shape[0], -1)


def _node_rows(x: torch.Tensor, nodes, a: int, b: int, comm) -> torch.Tensor:
    """float32 (len(nodes), b - a): columns a:b of the given nodes' rows of a
    flat buffer; stacked (``comm`` None) a read of the rows, on a rank an
    ``all_gather`` of this rank's chunk (every rank must call it)."""
    if comm is None:
        idx = torch.as_tensor(list(nodes), dtype=torch.long, device=x.device)
        return x[:, a:b].index_select(0, idx).float()
    gathered = comm.all_gather(x[0, a:b].contiguous())
    return gathered[list(nodes)].float()


def _row_sum(rows: torch.Tensor) -> torch.Tensor:
    """Σ of the rows in node order, in float32: the same bits whichever
    engine gathered them."""
    acc = rows[0].clone()
    for r in rows[1:]:
        acc += r
    return acc


def _set_row(x, node: int, a: int, b: int, value, comm, *, add: bool = False) -> None:
    """Write (or add) ``value`` into columns a:b of ``node``'s row; on a
    rank only the owner of ``node`` writes."""
    if comm is None:
        row = x[node, a:b]
    elif comm.rank == node:
        row = x[0, a:b]
    else:
        return
    if add:
        row += value.to(x.dtype)
    else:
        row.copy_(value.to(x.dtype))


def adopt_neighbor_average(buf: torch.Tensor, node: int, neighbors, *, comm=None) -> None:
    """Elastic re-entry, IN PLACE: ``node``'s row of the flat buffer
    ``buf`` (the stacked (n, P) state, or with ``comm`` this rank's (1, P)
    row) becomes the float32 mean of its ``neighbors``' rows, rounded to
    the buffer's dtype; with no neighbour it keeps its own.  Call it on θ
    and on every optimizer slot."""
    nbrs = [int(i) for i in neighbors]
    if not nbrs:
        return
    x = _rows2d(buf)
    for a in range(0, x.shape[1], HANDOFF_CHUNK):
        b = min(a + HANDOFF_CHUNK, x.shape[1])
        mean = _row_sum(_node_rows(x, nbrs, a, b, comm)) / len(nbrs)
        _set_row(x, int(node), a, b, mean, comm)


def drain_handoff(buf: torch.Tensor, node: int, neighbors, alive, *, comm=None) -> None:
    """The exact mean-preserving handoff at a drained node's departure,
    IN PLACE: with ``n_surv`` survivors (``alive != 0`` less ``node``) and
    ``m`` neighbours, each neighbour's row gains

        Δ = n_surv · (θ_d − x̄_surv) / (m · (n_surv + 1)),

    so the survivors' mean afterwards is the global mean before.  With no
    surviving neighbour the buffer is left as it is.  ``comm`` as in
    ``adopt_neighbor_average``."""
    nbrs = [int(i) for i in neighbors]
    surv = np.asarray(alive) != 0
    surv = surv.copy()
    surv[node] = False
    n_surv = int(surv.sum())
    if not nbrs or n_surv == 0:
        return
    sidx = [int(i) for i in np.nonzero(surv)[0]]
    m = len(nbrs)
    x = _rows2d(buf)
    for a in range(0, x.shape[1], HANDOFF_CHUNK):
        b = min(a + HANDOFF_CHUNK, x.shape[1])
        rows = _node_rows(x, sidx + [int(node)], a, b, comm)
        mean_surv = _row_sum(rows[:-1]) / n_surv
        delta = (n_surv * (rows[-1] - mean_surv)) / (m * (n_surv + 1))
        for j in nbrs:
            _set_row(x, j, a, b, delta, comm, add=True)


def admit_node(buf: torch.Tensor, neighbors) -> torch.Tensor:
    """Elastic growth: a new buffer one row taller (the stacked state),
    its last row the float32 mean of the ``neighbors``' rows (of every row
    when the list is empty), rounded to the buffer's dtype."""
    nbrs = [int(i) for i in neighbors] or list(range(buf.shape[0]))
    out = torch.empty((buf.shape[0] + 1,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                      device=buf.device)
    out[:-1].copy_(buf)
    x, y = _rows2d(buf), _rows2d(out)
    for a in range(0, x.shape[1], HANDOFF_CHUNK):
        b = min(a + HANDOFF_CHUNK, x.shape[1])
        y[-1, a:b] = (_row_sum(_node_rows(x, nbrs, a, b, None)) / len(nbrs)).to(buf.dtype)
    return out


def realization_arrays(fr: FaultRealization, device) -> dict:
    """The runtime masks a fault-aware step consumes, as float32 tensors on
    ``device``: ``update`` (n,), ``alive`` (n,) and ``link`` (n, n), or
    ``"link": None`` where the realization carries no link mask (the
    all-ones matrix would be moved and multiplied for nothing)."""
    f32 = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)
    return {
        "update": f32(fr.update),
        "alive": f32(fr.alive),
        "link": None if fr.link_up is None else f32(fr.link_up),
    }

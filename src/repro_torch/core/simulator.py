"""Paper-faithful multi-node simulator (the DBench engine): the counterpart
of ``repro/core/simulator.py``.

Simulates an n-node (de)centralized data-parallel run on one device.  The
state is flat: parameters as one (n, P) buffer in the model's dtype and
each optimizer-state slot as one (n, P) float32 buffer (``core/flat.py``),
with every node's leaves as views into them, in the reference's leaf
order; the DBench probe (kernel K3) and the consensus probe read the
buffers in place.  A model of mixed leaf dtypes (the bf16 hybrid's float32
``a_log``/``d_skip``) is held in float32, as in the trainer: every update
and gossip round leaves each narrower leaf holding values of its own dtype
(the leaf-by-leaf path updates and mixes each leaf in its dtype, the
bucketed path rounds the leaf's columns after the update and each round),
so the probes, ``mean_params`` and checkpoints read the values the
reference's per-leaf state holds.  Mixing interprets the same compiled
``GossipProgram`` as the trainers: the dense-matrix interpreter (the
paper's equation, §2.2) by default, so this engine is the port's
correctness oracle.

One step:
  0. closed-loop Ada: before a probe step, the consensus distance Ξ_t of
     the state is fed to the topology's controller, which may change the
     rung, and so the program, of this very step;
  1. per-node loss and gradients on the node's batch shard: ``torch.func``
     (``grad_and_value``) under ``vmap`` over the node axis, or with
     ``node_loop`` one node at a time through autograd, exactly as the
     trainer takes them (the trainer's numbers bit for bit, and one node's
     activations alive at a time: the choice for full-width models and
     for losses ``vmap`` cannot batch; in bfloat16 ``torch.func.grad`` and
     autograd round a few gradient elements differently); losses that
     draw random numbers (``has_rng``) always run the loop, each node
     drawing from the one explicit generator in node order;
  2. the DBench probe: per-node, per-leaf L2 norms *before* mixing (K3);
  3. centralized: average the gradients, identical update everywhere;
     decentralized: the local optimizer update (vmapped over the nodes,
     leaf by leaf) with the gossip round θ ← Wθ after it (``"post"``) or
     before it (``"pre"``).

``mix_every`` gossips once every H steps and ``mix_rounds`` fuses H
consecutive schedule steps into each gossip round (``hub_balance``
spreads a static multi-matching program's matchings over them).

``bucket_mb`` runs a mixing step's update and gossip bucket by bucket
(``core/buckets.py``: column ranges of the flat state, the program's
interpreter per bucket, as in the reference; a mixed state's narrower
leaves mixed in their own dtype) instead of leaf by leaf, bit for bit the
same numbers, and folds Ξ² into the buckets when the next
step probes (``XiFold``), so that probe reads the fold: an eager
reduction over each bucket after its mix, about the standalone probe's
cost until a fused fold kernel exists.  ``telemetry``
takes a ``repro_torch.telemetry.MetricsRecorder``: comm billed at
dispatch, the loss, lr, Ξ (and, on the bucketed path, gradient-norm)
gauges, round and bucket spans, the streamed DBench variance and the
controller's events.

A topology with a ``fault_model`` (``core/faults.py``) runs the
fault-aware step, as the reference's: the step's realization is drawn from
``(seed, step)``; joins grow the state (``_admit``: the topology
re-derived at the new n, the new rows their neighbours' average), rejoins
adopt their neighbours' average and departures hand their state off
(``drain_handoff``) before the step; a membership change re-arms the
controller, whose probe is over the members only; a permanent membership
selects its degraded program; stragglers and dead nodes skip their local
update and the mix runs under the runtime masks (``apply_masked``).

A checkpoint holds ``checkpoint_tree(state)`` (the reference's ``{"p",
"o"}`` tree of (n, ...) views) and ``snapshot_extra()``: the run
configuration, ``n`` (outside the validated configuration: joins grow it,
and ``restore_extra`` resizes the topology to match), the membership
tracking, the controller's and the recorder's state and a pending Ξ fold;
fault realizations are pure in ``(seed, step)``, so a resumed run replays
the uninterrupted one bit for bit.

``debug_no_retrace`` is the reference's rebuild guard
(``repro_torch.analysis.recompile``): every step is keyed by its program
(``_step_cache``), and a step whose key was seen before must build
nothing (no nvcc build, no new device table, no new program key) or it
raises ``RetraceError``.

``shard_nodes`` is the reference's virtual-node sharding: the node axis
split over the largest count ``d`` of cards that divides n
(``core/node_split.split_devices``), the simulator's route past one card's
memory.  With ``d > 1`` θ, every optimizer slot and the gradient buffer
are ``NodeBlocks``: block j holds nodes [j·n/d, (j+1)·n/d) as an (n/d, P)
buffer on card j.  The gradients, the update and the DBench probe (one K3
launch a block) run on each block's card; the mix reads the sender rows
each block needs (the program's row-block interpreter); the centralized
mean, the consensus probe and the membership handoffs reduce column
chunks gathered to the first card; losses and norms come back in node
order on the simulator's device.  A join or an elastic resume re-derives
the split at the new n and moves the rows to their new blocks (n 8 → 10
on 4 cards becomes 2 blocks).  With one node's gradients at a time
(``node_loop``, and always with ``has_rng``) the numbers are the unsplit
run's bit for bit, matrix products aside; these round apart, within
1e-6 relative: the dense interpreter's per-block product
(``split_matmul``), a GatherRow op's or a masked fallback's product on
column chunks, and the gradients under vmap, batched over a block's n/d
nodes.  With one device (always on the CPU) nothing changes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Mapping, Optional

import numpy as np
import torch

from repro_torch.analysis import recompile
from repro_torch.core import dbench, node_split
from repro_torch.checkpoint.ckpt import validate_run_config
from repro_torch.core.buckets import (
    BucketLayout, XiFold, build_bucket_step, check_bucketable,
)
from repro_torch.core.consensus import (
    consensus_distance_masked, consensus_distance_stacked,
)
from repro_torch.core.dsgd import Topology
from repro_torch.core.faults import (
    admit_node, membership_events, realization_arrays, rejoin_neighbors,
)
from repro_torch.core.flat import (
    FlatLayout, checkpoint_tree, node_grads_into, opt_buffers, update_leaves,
)
from repro_torch.core.node_split import as_blocks, blocks_of, cat_nodes, like, place
from repro_torch.device import resolve_device
from repro_torch.models.common import flatten_tree
from repro_torch.optim.sgd import Optimizer
from repro_torch.telemetry import MetricsRecorder

__all__ = ["SimState", "DecentralizedSimulator"]

_ENGINES = {"dense": "dense", "shift": "stacked", "stacked": "stacked"}


@dataclasses.dataclass
class SimState:
    """Flat simulator state: ``theta`` (n, P) in the layout's state dtype
    (the model's, float32 for mixed leaf dtypes), ``opt`` one (n, P)
    float32 buffer per optimizer slot (and ``"t"``, (n,) int32, for a
    step-counted optimizer), laid out by ``layout``; under a split over
    several cards each of them a ``NodeBlocks`` (``to_full()`` reads it
    whole)."""

    theta: torch.Tensor
    opt: dict
    layout: FlatLayout
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """(n, ...) views of every leaf, in leaf order (split: NodeBlocks of
        the blocks' views)."""
        return self.layout.stacked_views(self.theta)

    def node_params(self, i: int) -> dict[str, torch.Tensor]:
        return self.layout.views(as_blocks(self.theta).row(i))

    def mean_params(self) -> dict[str, torch.Tensor]:
        """The final model θ = average over all θ_i (paper §2.2), each leaf
        in its own dtype (of a split leaf, on its first card)."""
        return {k: _node_mean(v, v.dtype)[0][0]
                for k, v in self.layout.stacked_leaf_views(self.theta).items()}


def _node_mean(x, dtype) -> list[torch.Tensor]:
    """The float32 mean over every node of a leaf's rows, cast to
    ``dtype``: per block, a (1, ...) tensor on its device (column chunks
    gathered to the first card, ``node_split.over_nodes``)."""
    parts = node_split.over_nodes(
        x, lambda c: c.float().mean(dim=0, keepdim=True).to(dtype))
    return [p.reshape((1,) + tuple(x.shape[1:])) for p in parts]


def _centralized_mean(g, dtype):
    """A leaf's gradients replaced by their mean over every node, taken in
    float32 and cast to ``dtype``; every block receives the mean."""
    return like(g, [m.expand_as(blk) for m, blk in zip(_node_mean(g, dtype), blocks_of(g))])


class DecentralizedSimulator:
    """Engine for centralized/decentralized training of n nodes, on one
    device or (``shard_nodes``) split over several cards."""

    def __init__(
        self,
        loss_fn: Callable[..., torch.Tensor],
        optimizer: Optimizer,
        topology: Topology,
        *,
        mixing: str = "dense",  # "dense" (paper equation) | "shift" (stacked)
        mix_every: int = 1,
        mix_rounds: int = 1,
        hub_balance: bool = False,
        collect_norms: bool = False,
        has_rng: bool = False,
        node_loop: bool = False,
        device=None,
        shard_nodes: bool = False,
        bucket_mb: Optional[float] = None,
        debug_no_retrace: bool = False,
        telemetry=None,
    ):
        """Args:
          loss_fn: per-node ``loss_fn(params, batch)`` (with a
            ``torch.Generator`` as third argument when ``has_rng``) on one
            node's flat dotted-path parameter dict, returning a scalar.
          optimizer: per-node optimizer (``optim/sgd.py``).
          topology: which SGD implementation to simulate.
          mixing: "dense" (the matrix product) or "shift" (gathers of
            the sender rows over the node axis).
          mix_every / mix_rounds / hub_balance: as in the reference.
          node_loop: gradients one node at a time instead of under vmap.
          device: the current CUDA card by default; ``"cpu"`` on request.
          shard_nodes: virtual-node sharding, the node axis split into
            row blocks over the largest count of cards dividing n
            (``node_split.split_devices``), each block on its card; bit
            for bit the unsplit run one node at a time (within 1e-6 under
            vmap or with a matrix product over every node), and on one
            device nothing changes.
          bucket_mb: run each mixing step bucket by bucket, ~bucket_mb MiB
            of float32 per bucket; SGD-family optimizers, decentralized
            topologies and ``mix_order="post"`` only.
          debug_no_retrace: raise ``RetraceError`` when a warm step (one
            whose program key ran before) builds anything.
          telemetry: the run's ``MetricsRecorder`` (an inert one by
            default, which costs nothing).
        """
        if mixing not in _ENGINES:
            raise ValueError(
                f"mixing must be one of {sorted(_ENGINES)}, got {mixing!r}"
            )
        if bucket_mb is not None:
            check_bucketable(optimizer, topology)
        self.bucket_mb = bucket_mb
        self.debug_no_retrace = bool(debug_no_retrace)
        # every step's program key (``analysis.recompile``): a step whose
        # key is here is warm and, under debug_no_retrace, builds nothing
        self._step_cache: dict = {}
        self.fault_model = topology.fault_model
        self._last_membership = None
        self.telemetry = telemetry if telemetry is not None else MetricsRecorder()
        self.telemetry.configure(deadline_ms=getattr(self.fault_model, "deadline_ms", None))
        if topology.controller is not None:
            topology.controller.bind_recorder(self.telemetry)
        self._fold = XiFold()
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.topology = topology
        self.n = topology.n_nodes
        self.mixing = mixing
        self.mix_every = max(int(mix_every), 1)
        self.mix_rounds = max(int(mix_rounds), 1)
        self.hub_balance = bool(hub_balance)
        self.collect_norms = collect_norms
        self.has_rng = has_rng
        self.node_loop = bool(node_loop) or has_rng
        self.device = resolve_device(device)
        self.shard_nodes = bool(shard_nodes)
        self.devices = self._split(self.n)
        self._update = torch.func.vmap(optimizer.update, in_dims=(0, 0, 0, None))

    def _split(self, n: int) -> list[torch.device]:
        """The devices the n rows lie on: under ``shard_nodes`` the
        reference's rule (``node_split.split_devices``), else the
        simulator's device."""
        if not self.shard_nodes:
            return [self.device]
        return node_split.split_devices(n, self.device)

    # -- state ----------------------------------------------------------------
    def init(self, params: Mapping) -> SimState:
        """Broadcast one replica (a nested or flat dict of tensors or
        arrays) to all nodes (paper: identical replicas).  Leaves of mixed
        dtypes make a float32 state (``FlatLayout.state_dtype``)."""
        flat = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                for k, v in flatten_tree(params).items()}
        layout = FlatLayout.from_shapes({k: tuple(v.shape) for k, v in flat.items()},
                                        {k: v.dtype for k, v in flat.items()})
        theta = node_split.empty(self.n, (layout.size,), layout.state_dtype, self.devices)
        first, *rest = blocks_of(theta)
        for name, view in layout.views(first[0]).items():
            view.copy_(flat[name])
        first[1:].copy_(first[:1].expand(first.shape[0] - 1, -1))
        for blk in rest:
            blk.copy_(first[:1].to(blk.device).expand_as(blk))
        opt = opt_buffers(self.optimizer, layout, theta)
        return SimState(theta, opt, layout, 0)

    # -- one training step ------------------------------------------------------
    def _grads(self, state: SimState, batch, rng):
        """(losses (n,) float32 on the simulator's device, grads {leaf: (n,
        ...)}, the flat (n, P) gradient buffer the grads are views of, or
        None under vmap); a split state's block by block, each on its card
        with its nodes' batch rows.  A split run's node loop hands ``rng``'s
        state to a generator on each block's card and takes it back after
        the block, so the nodes draw the unsplit run's numbers in node
        order."""
        theta = as_blocks(state.theta)
        fn = torch.func.vmap(torch.func.grad_and_value(self.loss_fn))
        per, grad = [], []
        for (a, b), blk in zip(theta.ranges, theta.blocks):
            rows = {k: v[a:b].to(blk.device) for k, v in batch.items()}
            if not self.node_loop:
                per.append(fn(state.layout.stacked_leaf_views(blk), rows))
                continue
            grad.append(torch.empty_like(blk))
            gen = rng
            if self.has_rng and len(theta.blocks) > 1:
                gen = torch.Generator(device=blk.device)
                gen.set_state(rng.get_state())
            extra = (gen,) if self.has_rng else ()
            per.append((None, node_grads_into(self.loss_fn, state.layout, blk, grad[-1],
                                              rows, *extra)))
            if gen is not rng:
                rng.set_state(gen.get_state())
        losses = cat_nodes([loss.float() for _, loss in per], self.device)
        if not self.node_loop:
            return losses, {k: like(state.theta, [g[k] for g, _ in per])
                            for k in state.layout.names}, None
        grad = like(state.theta, grad)
        return losses, state.layout.stacked_views(grad), grad

    def _resolve_program(self, step: int, epoch: int, program_alive=None):
        """This gossip round's (fused) program, degraded for a permanent
        membership ``program_alive``."""
        program = self.topology.fused_program_at(
            step=step, epoch=epoch, rounds=self.mix_rounds,
            hub_balance=self.hub_balance,
        )
        if program is not None and program_alive is not None:
            program = program.degrade(program_alive)
        return program

    # -- the deadline trace (views of the recorder's) ---------------------------
    @property
    def round_ms(self) -> list:
        return self.telemetry.round_ms

    @property
    def deadline_overruns(self) -> int:
        return self.telemetry.deadline_overruns

    # -- faults and elastic membership -------------------------------------------
    def _membership_events(self, state: SimState, epoch: int):
        """The step's realization and its membership events, before the
        step: joins grow the state (``_admit``), then rejoins, departures
        and the membership tracking (``faults.membership_events``).
        Returns (state, realization)."""
        tel = self.telemetry
        fr = self.fault_model.at(state.step)
        if fr.joins:
            if tel.active:
                tel.event("join", state.step, data={"nodes": sorted(int(j) for j in fr.joins)})
            state = self._admit(state, fr, epoch)
        self._last_membership = membership_events(
            fr, [state.theta] + list(state.opt.values()), self.topology,
            self._last_membership, step=state.step, epoch=epoch, mix_every=self.mix_every,
            telemetry=tel, narrow=state.layout.narrow_leaves())
        return state, fr

    def _admit(self, state: SimState, fr, epoch: int) -> SimState:
        """Grow membership to ``len(fr.program_alive)``: the topology family
        re-derived at the new n (the new controller adopts the old one's
        run state and keeps the run's recorder), and one new row per joining
        node, in index order, seeded with its neighbourhood's average."""
        m = len(fr.program_alive)
        old_ctl = self.topology.controller
        topo = self.topology.resized(m)
        if topo.controller is not None:
            if old_ctl is not None:
                topo.controller.adopt(old_ctl)
            topo.controller.bind_recorder(self.telemetry)
        self.topology = topo
        self.n = m
        theta, opt = state.theta, dict(state.opt)
        rows = m - len(fr.joins)
        for node in sorted(fr.joins):
            # a later joiner of the same step is not a row yet
            nbrs = [i for i in rejoin_neighbors(topo, fr, node, step=state.step, epoch=epoch,
                                                mix_every=self.mix_every) if i < rows]
            theta = admit_node(theta, nbrs, narrow=state.layout.narrow_leaves())
            opt = {k: admit_node(v, nbrs) for k, v in opt.items()}
            rows += 1
        # the split re-derived at the new n, the rows moved to their blocks
        self.devices = self._split(m)
        theta = place(theta, self.devices)
        opt = {k: place(v, self.devices) for k, v in opt.items()}
        return SimState(theta, opt, state.layout, state.step)

    def train_step(
        self,
        state: SimState,
        batch: Mapping,
        lr: float,
        *,
        epoch: int = 0,
        rng: Optional[torch.Generator] = None,
    ) -> tuple[SimState, torch.Tensor, torch.Tensor]:
        """Run one iteration; updates the state's buffers IN PLACE.

        Args:
          batch: arrays or tensors with leading (n_nodes, per_node_batch, ...) dims.
        Returns:
          (new_state, per_node_loss (n,), per_node_norms (n, n_leaves)).
        """
        tel = self.telemetry
        t_start = tel.round_start()
        fr = fault = None
        if self.fault_model is not None:
            state, fr = self._membership_events(state, epoch)
            fault = realization_arrays(fr, self.device)
            # the membership mask, not the raw alive mask: a float drain
            # boost must not weight the draining node in the probe
            members = np.asarray(fr.alive) != 0
            probe = lambda: consensus_distance_masked(state.theta, members)
        else:
            probe = lambda: consensus_distance_stacked(state.theta)
        topo = self.topology
        self._fold.probe(topo.controller, tel, state.step, probe)
        mix = (state.step + 1) % self.mix_every == 0
        # time-varying schedules advance per gossip round, not per raw step;
        # a permanent membership selects its degraded program
        program = None
        if mix and not topo.centralized:
            sel = None if fr is None else fr.selection_mask()
            palive = sel if sel is not None and not sel.all() else None
            program = self._resolve_program(state.step // self.mix_every, epoch, palive)
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if self.has_rng and rng is None:
            rng = torch.Generator(device=self.device).manual_seed(0)
        bucketed = self.bucket_mb is not None and program is not None
        warm = self._note_step(program, faulty=fault is not None, bucketed=bucketed,
                               has_m="mom" in state.opt)
        with recompile.guard(self.debug_no_retrace and warm, f"sim step {state.step}"):
            losses, grads, flat_grad = self._grads(state, batch, rng)
            with torch.no_grad():
                norms = (
                    dbench.param_l2_norms(state.theta, state.layout).to(self.device)
                    if self.collect_norms
                    else torch.zeros((self.n, 0), dtype=torch.float32, device=self.device)
                )
                if program is not None:
                    tel.comm(program, state.layout.row_bytes,
                             step=state.step, alive=None if fr is None else fr.alive,
                             link_up=None if fr is None else fr.link_up)
                engine = _ENGINES[self.mixing]
                bucket_grad = None   # the gradient buffer of a bucketed step
                if bucketed:
                    bucket_grad = self._bucketed_update(state, grads, flat_grad, lr, program,
                                                        engine, fault)
                else:
                    if topo.centralized:
                        # C_complete: average gradients globally, each leaf's mean in
                        # its dtype (a split leaf's rows gathered to the first card);
                        # replicas stay identical
                        dts = dict(zip(state.layout.names, state.layout.dtypes))
                        grads = {k: _centralized_mean(g, dts[k]) for k, g in grads.items()}
                    if program is None:
                        mix_fn = None
                    elif fault is None:
                        mix_fn = lambda x: program.apply(x, engine=engine)
                    else:
                        mix_fn = lambda x: program.apply_masked(
                            x, fault["alive"], link_up=fault["link"], engine=engine)
                    update_leaves(
                        self.optimizer, self._update, state.layout, state.theta, state.opt, grads,
                        lr, mix_order=topo.mix_order, mix=mix_fn,
                        gate=None if fault is None else fault["update"],
                    )
        self._finish_round(losses, norms, t_start, step=state.step, mix=mix, lr=lr,
                           grads=bucket_grad)
        return SimState(state.theta, state.opt, state.layout, state.step + 1), losses, norms

    def _note_step(self, program, *, faulty: bool, bucketed: bool, has_m: bool) -> bool:
        """Key this step as the reference keys its executables (the program,
        ``("__local__", n)`` or ``("__centralized__", n)``; bucketed steps
        ``("__bucket__", key, has_m, faulty)``, fault steps ``(key,
        "faulty")``) in ``_step_cache``; returns whether the key was there
        (a warm step).  A new key is a rebuild event."""
        if self.topology.centralized:
            key, faulty = ("__centralized__", self.n), False
        else:
            key = ("__local__", self.n) if program is None else program.cache_key
        if bucketed:
            key = ("__bucket__", key, has_m, faulty)
        elif faulty:
            key = (key, "faulty")
        warm = key in self._step_cache
        if not warm:
            self._step_cache[key] = program
            recompile.note("programs")
        return warm

    def _bucketed_update(self, state: SimState, grads, flat_grad, lr, program, engine,
                         fault=None):
        """A mixing step's update and gossip bucket by bucket, IN PLACE on
        the buckets' column views of θ, m and the gradient buffer (under
        the runtime masks ``fault``); on a fault-free step whose successor
        probes, each bucket's Ξ² partial sum is folded into a running (n,)
        token for it.  Returns the flat gradient buffer."""
        grad = flat_grad if flat_grad is not None else state.layout.flatten(grads)
        mom = state.opt.get("mom")
        fn = build_bucket_step(program, hyper=self.optimizer.hyper,
                               has_momentum=mom is not None, engine=engine, fault=fault)
        layout = BucketLayout.for_stacked(state.params, self.bucket_mb)
        runs = layout.dtype_runs(state.layout.dtypes) if state.layout.mixed else None
        self._fold.run(fn, layout, state.theta, mom, grad, lr,
                       controller=self.topology.controller, telemetry=self.telemetry,
                       step=state.step, fold=fault is None, runs=runs)
        return grad

    def _finish_round(self, losses, norms, t_start, *, step: int, mix: bool, lr: float,
                      grads=None) -> None:
        """Post-step telemetry: closes the ``round`` span (after a device
        synchronize, only when the recorder times rounds) and, at the
        metrics cadence, emits the loss/lr/variance (and gradient-norm)
        sample, reading each device value once."""
        tel = self.telemetry
        tel.round_end(t_start, step=step, mix=mix, device=list(dict.fromkeys(self.devices)))
        if tel.due(step):
            tel.step_metrics(step, loss=losses, lr=lr,
                             norms=norms if self.collect_norms else None, grads=grads)

    # -- crash-consistent resume -------------------------------------------------
    def checkpoint_tree(self, state: SimState) -> dict:
        """The state as the reference's ``{"p", "o"}`` tree of (n, ...)
        views into its buffers (``checkpoint.save_checkpoint`` writes it,
        ``checkpoint.restore_checkpoint`` fills it in place)."""
        return checkpoint_tree(self.optimizer, state.layout, state.theta, state.opt)

    def snapshot_extra(self) -> dict:
        """Engine run state a crash-consistent checkpoint must carry beyond
        the arrays: the run configuration (topology, bucket layout), ``n``
        (outside ``run_config``: elastic joins grow it), the membership
        tracking, the controller's and the recorder's state, and a pending
        Ξ fold.  JSON-serializable."""
        d: dict = {
            "run_config": {
                "topology": self.topology.name,
                "bucket_mb": None if self.bucket_mb is None else float(self.bucket_mb),
            },
            "n": int(self.n),
            "last_membership": (None if self._last_membership is None
                                else [bool(b) for b in self._last_membership]),
        }
        ctl = self.topology.controller
        if ctl is not None:
            d["controller"] = ctl.state_dict()
        d["telemetry"] = self.telemetry.state_dict()
        fold = self._fold.state_dict()
        if fold is not None:
            d["xi_fold"] = fold
        return d

    def restore_extra(self, d: dict) -> None:
        """Inverse of ``snapshot_extra`` on a freshly built engine: the
        recorded ``run_config`` (topology and bucket layout, not n) is
        validated first; a grown ``n`` resizes the topology (an elastic
        resume), so that ``init`` then builds the state at that size."""
        validate_run_config(d.get("run_config") or {}, topology=self.topology.name,
                            bucket_mb=self.bucket_mb)
        n = int(d.get("n", self.n))
        if n != self.n:
            self.devices = self._split(n)
            self.topology = self.topology.resized(n)
            self.n = n
            if self.topology.controller is not None:
                self.topology.controller.bind_recorder(self.telemetry)
        lm = d.get("last_membership")
        self._last_membership = None if lm is None else tuple(bool(b) for b in lm)
        ctl = self.topology.controller
        if ctl is not None and d.get("controller") is not None:
            ctl.load_state_dict(d["controller"])
        if d.get("telemetry") is not None:
            self.telemetry.load_state_dict(d["telemetry"])
        self._fold.load_state_dict(d.get("xi_fold"), self.device)

    # -- full run helper ---------------------------------------------------------
    def run(
        self,
        params0: Mapping,
        batches: Iterator[Mapping],
        *,
        n_steps: int,
        lr_schedule: Callable[[float], float],
        steps_per_epoch: int = 1,
        record_every: int = 1,
        recorder: Optional[dbench.DBenchRecorder] = None,
        eval_fn: Optional[Callable[[dict], float]] = None,
        eval_every: int = 0,
        rng: Optional[torch.Generator] = None,
    ) -> tuple[SimState, dict]:
        state = self.init(params0)
        if rng is None:
            rng = torch.Generator(device=self.device).manual_seed(17)
        history = {"step": [], "loss": [], "eval_step": [], "eval": []}
        for t in range(n_steps):
            state, loss, norms = self.train_step(
                state, next(batches), lr_schedule(t), epoch=t // steps_per_epoch,
                rng=rng,
            )
            if t % record_every == 0:
                history["step"].append(t)
                history["loss"].append(float(loss.mean()))
                if recorder is not None:
                    recorder.record(t, loss.cpu().numpy(), norms.cpu().numpy())
            if eval_fn is not None and eval_every and (t + 1) % eval_every == 0:
                history["eval_step"].append(t + 1)
                history["eval"].append(float(eval_fn(state.mean_params())))
        return state, history

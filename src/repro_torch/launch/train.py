"""Decentralized training engine and CLI: the counterpart of
``repro/launch/train.py``.

``SPMDTrainer`` has the reference's two realizations of one step:

* **stacked** — all G gossip nodes on one card (the reference's GSPMD
  engine);
* **ranks** — one ``torch.distributed`` rank per node (the reference's
  shard_map engine, ``_node_step``), taken as the reference takes
  shard_map: whenever a process group of world size G > 1 is up.  The
  collectives go through ``launch/comm.py``: NCCL with a card per rank,
  gloo through pinned host chunks on a machine with fewer cards, gloo on
  the CPU when asked.

The state is flat (rows, P) buffers (``core/flat.py``) in the reference's
leaf order — parameters (model dtype), gradients (model dtype) and one
float32 buffer per optimizer-state slot (momentum; AdamW's ``mu``, ``nu``
and its (rows,) step count) — with rows = G stacked, 1 (the rank's own
node) for ranks; every node's parameters are views into them.  A model of
mixed leaf dtypes (the bf16 hybrid's float32 ``a_log``/``d_skip``) holds
parameters and gradients in float32, its narrower leaves rounded to their
dtype after every update and round, as the reference's fused step casts
each leaf back after its float32 kernel; checkpoints write each leaf in
its own dtype.  One
iteration (paper §2.1 order):

  0. closed-loop Ada: before a probe step the consensus distance Ξ_t
     (stacked: over the state; ranks: two ``pmean``s) goes to the
     topology's controller, before the step's program is resolved;
  1. per-node forward and backward, one node at a time (only one node's
     activations are alive), into the gradient buffer;
  2. the DBench probe: per-leaf L2 norms *before* mixing (kernel K3);
  3. c_complete: average gradients over the nodes (ranks: ``pmean``);
     d_*: the local optimizer update and gossip mixing θ ← Wθ through the
     step's compiled ``GossipProgram`` — with ``mix_rounds`` H, the H
     schedule steps of the gossip round fused (``hub_balance`` spreads a
     static multi-matching program's matchings over them).

With ``fused_apply`` (plain momentum-SGD) a program whose first round is
all-PPermute runs the update and that round as one pass of a fused kernel
(``kernels/gossip_update.py``) in place on the state buffers — K1 over the
stacked nodes, K2 on a rank after one permute per op — and the program's
interpreter runs its later rounds over the flat buffer in column chunks
(the reference's ``_fused_split``).  Programs with AllReduce or GatherRow
first rounds (the complete graph, ``mixing="dense"``), ``mix_order="pre"``
with H > 1 and non-mixing steps take the interpreter, exactly as the
reference does.  Without it the optimizer (vmapped over the rows) and the
program's stacked (or, for ranks, shard) interpreter run leaf by leaf,
which keeps their float32 temporaries to one leaf at a time.

``bucket_mb`` runs a mixing step of the stacked engine bucket by bucket
(``core/buckets.py``: column ranges of the flat state): with
``fused_apply`` K1 launches once per bucket, in place on the bucket's
column views, and the later rounds of a multi-round program follow on the
same columns; without it the optimizer and the interpreter run per
bucket.  Either way the numbers are the monolithic step's, bit for bit,
and when the next step probes, Ξ² is folded into the buckets
(``XiFold``) and that probe reads the fold: an eager reduction over each
bucket after its mix, which reads the state as the standalone probe
would and costs about as much until a fused fold kernel exists.  The
ranks engine keeps the monolithic step under
``bucket_mb``, as the reference's shard_map realization does (its
per-bucket overlap is a later slice).

``telemetry`` takes a ``repro_torch.telemetry.MetricsRecorder``: comm
billed once per program application at dispatch, the loss, lr, Ξ (and,
bucketed, gradient-norm) gauges, round and bucket spans, the streamed
DBench variance and the controller's events.  On the ranks engine rank 0
alone writes records; on a metrics step every rank joins one ``pmean`` of
the loss and one ``all_gather`` of the norms, so a run of G ranks writes
the stacked run's record stream, spans aside.

A topology with a ``fault_model`` (``core/faults.py``) runs the
reference's fault-aware step in both engines.  Every engine (every rank)
draws the step's realization from ``(seed, step)`` with no
communication; rejoins adopt their neighbours' average and departures
hand their state off before the step (on a rank through gathers of the
column chunks, every rank joining); a membership change re-arms the
controller, whose probe is over the members only; a permanent membership
selects its degraded program (a composed concurrent crash and a spare
pool keep the base program); stragglers and dead nodes skip their local
update.  The kernels take the realization's fault rows (K1 over all
nodes, once a step even when bucketed; K2 this rank's row), the
interpreters the runtime masks.  Elastic ``Join`` models grow past the
fixed set of nodes and are refused: ``SparePool`` takes joins as spare
activations instead.

``loss_fn`` replaces the transformer's loss (a function of one node's flat
parameter dict and batch); ``accum_steps`` k splits every node's batch into
k microbatches whose loss and gradients are averaged as the reference's
``_grads_of`` does, the gradients accumulated in place in the gradient
buffer, on every path (fused or not, both engines).  The model's ``remat``
checkpoints each layer (``models/transformer.py``).

Checkpoints are the reference's files (``checkpoint/ckpt.py``): the state
as the ``{"p": params, "o": opt_state}`` tree of (G, ...) leaves, saved from
and restored into the flat buffers in place, with ``snapshot_extra`` (the
run configuration, G included, the membership tracking, the controller's
and the recorder's state, a pending Ξ fold) in the same file.  The ranks
engine writes the stacked engine's file: every leaf is gathered to rank
0's host memory column chunk by column chunk, and restored by the inverse
scatter, each rank receiving only its own row; rank 0 alone touches the
file.  The CLI's ``--ckpt-dir``/``--ckpt-every``/``--resume`` drive it, and
a resumed run continues the uninterrupted one bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
import zipfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import (
    checkpoint_path, flatten, held, leaf_shapes, load_checkpoint_extra, map_leaves, read_leaf,
    resolve_step, restore_checkpoint, save_checkpoint, validate_run_config,
)
from repro_torch.core import dbench
from repro_torch.core.buckets import (
    BucketLayout, XiFold, build_bucket_step, check_bucketable,
)
from repro_torch.core.consensus import (
    consensus_distance_masked, consensus_distance_masked_shard,
    consensus_distance_shard, consensus_distance_stacked,
)
from repro_torch.core.dsgd import Topology
from repro_torch.core.faults import (
    fold_degraded_programs, membership_events, realization_arrays,
)
from repro_torch.core.flat import (
    FlatLayout, checkpoint_tree, node_grads_into, opt_buffers, update_leaves,
)
from repro_torch.core.schedule import (
    FusedProgram, GossipProgram, compile_graph, dense_program, maybe_hub_balanced,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.gossip_update import (
    fused_apply_shard, fused_apply_stacked, mix_in_place,
)
from repro_torch.launch.comm import Comm, rank_device
from repro_torch.models import transformer as tfm
from repro_torch.optim.sgd import Optimizer
from repro_torch.telemetry import MetricsRecorder

__all__ = ["SPMDTrainer", "TrainState", "main"]


@dataclasses.dataclass
class TrainState:
    """Training state as flat buffers: G rows stacked, one row on a rank."""

    theta: torch.Tensor   # (rows, P) parameters, model dtype
    opt: dict             # slot -> (rows, P) float32; "t" -> (rows,) int32
    step: int = 0

    @property
    def mom(self) -> Optional[torch.Tensor]:
        """The momentum buffer (momentum-SGD, LARS); None without one."""
        return self.opt.get("mom")

    def clone(self) -> "TrainState":
        return TrainState(self.theta.clone(), {k: v.clone() for k, v in self.opt.items()},
                          self.step)


class SPMDTrainer:
    """Runs the decentralized train step for one (arch × topology): all
    nodes on one card, or this rank's node when a process group is up."""

    def __init__(
        self,
        cfg,
        topology: Topology,
        optimizer: Optimizer,
        *,
        loss_fn=None,
        accum_steps: int = 1,
        collect_norms: bool = False,
        mixing: str = "ppermute",  # ppermute (compiled program) | dense
        mix_every: int = 1,
        mix_rounds: int = 1,
        hub_balance: bool = False,
        fused_apply: bool = False,
        bucket_mb: Optional[float] = None,
        telemetry=None,
        device=None,
    ):
        """loss_fn: ``loss_fn(params, batch)`` of one node's flat parameter
        dict and batch (the transformer's loss by default).  accum_steps:
        average the loss and gradients over this many microbatches of each
        node's batch.  mix_every: gossip once every H optimizer steps (the H−1 local
        steps run no mixing).  mix_rounds: fuse H consecutive schedule
        steps into each gossip round.  hub_balance: with mix_rounds > 1 on
        a static multi-matching program, rotate its matchings over the H
        rounds.  fused_apply: run the optimizer update and the first gossip
        round as one pass of a fused kernel (K1 stacked, K2 on a rank)
        whenever that round is all-PPermute; requires plain momentum-SGD.
        bucket_mb: run the stacked engine's mixing steps bucket by bucket,
        ~bucket_mb MiB of float32 per bucket (SGD family, decentralized,
        ``mix_order="post"``, one leaf dtype); the ranks engine keeps the
        monolithic step.
        telemetry: the run's ``MetricsRecorder`` (an inert one by default,
        which costs nothing); on the ranks engine give rank 0 the sinks.
        ``device``: the current card by default; ``"cpu"`` runs every
        kernel's plain twin.  With an initialised process group of world
        size > 1 the trainer is one rank of the ranks engine, which raises
        unless the world size equals the topology's node count."""
        if mixing not in ("ppermute", "dense"):
            raise ValueError(f"mixing must be 'ppermute'|'dense', got {mixing!r}")
        hyper = optimizer.hyper or {}
        self.fused_apply = bool(fused_apply)
        if self.fused_apply and (hyper.get("kind") != "sgd" or hyper.get("nesterov")
                                 or hyper.get("weight_decay")):
            raise ValueError(
                "fused_apply re-implements the update inside the kernel and "
                f"supports plain momentum-SGD only; got {optimizer.name}"
            )
        self.fault_model = topology.fault_model
        if self.fault_model is not None and self.fault_model.elastic:
            raise ValueError(
                "elastic (join) fault models grow membership past the mesh's "
                "gossip size; the SPMD trainer's device mesh is fixed — "
                "over-provision the mesh with spare ranks instead "
                "(--spare-ranks / faults.SparePool: joins activate "
                "alive-masked ghost ranks with zero recompiles), or use the "
                "DecentralizedSimulator for true mid-run growth"
            )
        self._last_membership = None
        self.cfg = cfg
        self.topology = topology
        self.optimizer = optimizer
        self.loss_fn = loss_fn or (lambda p, b: tfm.loss_fn(p, cfg, b))
        self.accum_steps = max(int(accum_steps), 1)
        self.beta = float(hyper.get("momentum", 0.0))
        self.collect_norms = collect_norms
        self.mixing = mixing
        self.mix_every = max(int(mix_every), 1)
        self.mix_rounds = max(int(mix_rounds), 1)
        self.hub_balance = bool(hub_balance)
        self._update = torch.func.vmap(optimizer.update, in_dims=(0, 0, 0, None))
        self.g = topology.n_nodes
        self.device = resolve_device(device)
        self.comm = None
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            self.comm = Comm(self.device)
            if self.comm.world != self.g:
                raise ValueError(
                    f"topology has {self.g} nodes but the process group has "
                    f"{self.comm.world} ranks"
                )
        self.engine = "stacked" if self.comm is None else "ranks"
        self.rows = self.g if self.comm is None else 1
        self.defs = tfm.model_defs(cfg)
        self.layout = FlatLayout.of_defs(self.defs)
        if bucket_mb is not None:
            check_bucketable(optimizer, topology)
            if self.layout.mixed:
                # the bucketed step would run its later rounds and the Ξ fold
                # on unrounded float32 columns of the narrower leaves
                raise ValueError(
                    "bucket_mb needs one leaf dtype; this model mixes "
                    f"{sorted({str(d) for d in self.layout.dtypes})}: drop bucket_mb"
                )
        self.bucket_mb = bucket_mb
        self._bucket_layout = (
            None if bucket_mb is None
            else BucketLayout(self.layout.sizes, BucketLayout.elems_for_mb(bucket_mb))
        )
        self._fold = XiFold()
        self.telemetry = telemetry if telemetry is not None else MetricsRecorder()
        self.telemetry.configure(deadline_ms=getattr(self.fault_model, "deadline_ms", None))
        if topology.controller is not None:
            topology.controller.bind_recorder(self.telemetry)
        self._metrics_every = self.telemetry.metrics_every if self.telemetry.active else 0
        if self.comm is not None:
            # every rank joins the metrics steps' collectives: rank 0's
            # recorder (the one with sinks) sets the cadence for all
            mine = torch.tensor([self._metrics_every], dtype=torch.float32,
                                device=self.device)
            self._metrics_every = int(self.comm.all_gather(mine)[0, 0])

    # -- mixing program -------------------------------------------------------
    def _one_program(self, step: int, epoch: int) -> Optional[GossipProgram]:
        graph = self.topology.graph_at(epoch, step)
        if graph is None:
            return None
        if self.mixing == "dense":
            return dense_program(graph)
        return compile_graph(graph)

    def _program_at(self, step: int, epoch: int) -> Optional[GossipProgram]:
        """Gossip round ``step``'s program: schedule steps step·H … step·H+H−1
        fused (hub-balanced when eligible)."""
        if self.mix_rounds <= 1:
            return self._one_program(step, epoch)
        progs = [self._one_program(step * self.mix_rounds + r, epoch)
                 for r in range(self.mix_rounds)]
        if any(p is None for p in progs):
            return None
        if self.hub_balance:
            balanced = maybe_hub_balanced(progs, self.mix_rounds)
            if balanced is not None:
                return balanced
        return GossipProgram.fuse(progs)

    def precompile_programs(self, n_epochs: int = 1) -> list[GossipProgram]:
        """Every distinct program a run will rotate through; a closed-loop
        controller's rungs are pinned in turn."""
        progs, seen = [], set()
        ctl = self.topology.controller
        for (e, s), _ in self.topology.distinct_programs(n_epochs):
            if ctl is not None:
                # closed-loop keys are (rung, phase)
                with ctl.pinned(e):
                    p = self._program_at(s, 0)
            else:
                p = self._program_at(s, e)
            if p is not None and p.cache_key not in seen:
                seen.add(p.cache_key)
                progs.append(p)
        if self.fault_model is not None:
            # permanent memberships select degraded variants of these programs
            progs += [d for _, d in fold_degraded_programs(progs, self.fault_model)]
        return progs

    def _fused_split(self, program: Optional[GossipProgram]):
        """(kernel round, interpreter rounds) when the fused kernel can run
        this program's first round, else None: not for non-PPermute first
        rounds, non-mixing steps, or multi-round ``mix_order="pre"`` (the
        descent must follow ALL rounds there)."""
        if not self.fused_apply or program is None or self.topology.centralized:
            return None
        if isinstance(program, FusedProgram):
            if self.topology.mix_order != "post":
                return None
            first, rest = program.stages[0], program.stages[1:]
        else:
            first, rest = program, ()
        if first.permute_tables() is None:
            return None
        return first, rest

    def _use_fused(self, program: Optional[GossipProgram]) -> bool:
        return self._fused_split(program) is not None

    # -- state ----------------------------------------------------------------
    def init_state(self, seed: int = 0, params: Optional[dict] = None) -> TrainState:
        """Identical replicas on every node (paper §2.2): random weights from
        ``seed``, or one replica's ``params`` (e.g. ``tfm.params_from_jax``)."""
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = tfm.init_model(self.cfg, gen, self.device)
        theta = torch.empty((self.rows, self.layout.size),
                            dtype=self.layout.state_dtype, device=self.device)
        for name, view in self.layout.views(theta[0]).items():
            if tuple(params[name].shape) != tuple(view.shape):
                raise ValueError(
                    f"{name}: shape {tuple(params[name].shape)} != {tuple(view.shape)}"
                )
            view.copy_(params[name])
        theta[1:].copy_(theta[:1].expand(self.rows - 1, -1))
        opt = opt_buffers(self.optimizer, self.layout, theta)
        return TrainState(theta, opt, 0)

    def stacked_params(self, state: TrainState) -> dict[str, torch.Tensor]:
        """(rows, ...) views of every leaf of the state's parameters."""
        return self.layout.stacked_views(state.theta)

    # -- the step ------------------------------------------------------------------
    def _grads_into(self, theta, grad, batch) -> torch.Tensor:
        """Per-node loss and gradients, one node (row) at a time; returns
        (rows,) losses."""
        return node_grads_into(self.loss_fn, self.layout, theta, grad, batch,
                               accum_steps=self.accum_steps)

    def _mix(self, program: GossipProgram, x: torch.Tensor, fault=None) -> torch.Tensor:
        """One program's mix of ``x``: stacked or on this rank, under the
        runtime masks ``fault`` when given."""
        if fault is None:
            if self.comm is None:
                return program.apply_stacked(x)
            return program.apply_shard(x, self.comm)
        if self.comm is None:
            return program.apply_masked(x, fault["alive"], link_up=fault["link"])
        return program.apply_shard_masked(x, self.comm, fault["alive"], link_up=fault["link"])

    def consensus_distance(self, state: TrainState, members=None) -> torch.Tensor:
        """Ξ of the state: over the stacked rows, or across the ranks; over
        the ``members`` ((G,) 0/1 mask) only when given."""
        if members is not None:
            if self.comm is None:
                return consensus_distance_masked(state.theta, members)
            return consensus_distance_masked_shard(state.theta[0], members, self.comm)
        if self.comm is None:
            return consensus_distance_stacked(state.theta)
        return consensus_distance_shard(state.theta[0], self.comm)

    # -- the deadline trace (views of the recorder's) ---------------------------
    @property
    def round_ms(self) -> list:
        return self.telemetry.round_ms

    @property
    def deadline_overruns(self) -> int:
        return self.telemetry.deadline_overruns

    @property
    def _bucketed(self) -> bool:
        return self.bucket_mb is not None and self.g > 1 and self.engine == "stacked"

    def train_step(self, state: TrainState, batch, lr: float, *, epoch: int = 0):
        """One iteration; updates the state's buffers in place and returns
        ``(state, losses (rows,), norms (rows, n_leaves))``: every node's
        stacked, this rank's own on a rank.  ``batch`` holds (G, B, S)
        token arrays (numpy or tensors); a rank moves only its own row."""
        tel = self.telemetry
        t_start = tel.round_start()
        own = slice(None) if self.comm is None else slice(self.comm.rank, self.comm.rank + 1)
        batch = {k: torch.as_tensor(v[own], device=self.device) for k, v in batch.items()}
        topo = self.topology
        fr = fault = members = None
        with torch.no_grad():
            if self.fault_model is not None and self.g > 1:
                fr = self.fault_model.at(state.step)
                self._last_membership = membership_events(
                    fr, [state.theta] + list(state.opt.values()), topo,
                    self._last_membership, step=state.step, epoch=epoch,
                    mix_every=self.mix_every, telemetry=tel, comm=self.comm)
                fault = realization_arrays(fr, self.device)
                # the membership mask, not the raw alive mask: a float drain
                # boost must not weight the draining node in the probe
                members = torch.as_tensor(fr.alive != 0, dtype=torch.float32,
                                          device=self.device)
            self._fold.probe(topo.controller if self.g > 1 else None, tel, state.step,
                             lambda: self.consensus_distance(state, members))
        mix = (state.step + 1) % self.mix_every == 0
        # time-varying schedules advance per gossip round, not per raw step;
        # a permanent membership selects its degraded program (the selection
        # mask of a composed concurrent crash or a spare pool stays all-ones)
        program = (
            self._program_at(state.step // self.mix_every, epoch)
            if mix and not topo.centralized else None
        )
        sel = None if fr is None else fr.selection_mask()
        if program is not None and sel is not None and not sel.all():
            program = program.degrade(sel)
        grad = torch.empty_like(state.theta)
        losses = self._grads_into(state.theta, grad, batch)
        bucket_grad = None   # the gradient buffer of a bucketed step
        with torch.no_grad():
            norms = (
                dbench.param_l2_norms(state.theta, self.layout)
                if self.collect_norms
                else torch.zeros((self.rows, 0), dtype=torch.float32, device=self.device)
            )
            if program is not None and self.g > 1:
                tel.comm(program, self.layout.row_bytes,
                         step=state.step, alive=None if fr is None else fr.alive,
                         link_up=None if fr is None else fr.link_up)
            if topo.centralized:
                # C_complete: average gradients globally (float32, leaf by
                # leaf); replicas stay identical
                for g in self.layout.stacked_views(grad).values():
                    if self.comm is None:
                        g.copy_(g.float().mean(dim=0, keepdim=True).to(g.dtype).expand_as(g))
                    else:
                        g.copy_(self.comm.pmean(g.float().contiguous()))
                self.layout.round_leaves_(grad)
            split = self._fused_split(program)
            if self._bucketed and program is not None:
                self._bucketed_update(state, grad, lr, program, split, fault)
                bucket_grad = grad
            elif split is None:
                update_leaves(
                    self.optimizer, self._update, self.layout, state.theta, state.opt,
                    self.layout.stacked_views(grad), lr,
                    mix=None if program is None else (lambda x: self._mix(program, x, fault)),
                    mix_order=topo.mix_order,
                    gate=None if fault is None else self._own(fault["update"]),
                )
            else:
                first, rest = split
                if self.comm is not None:
                    fused_apply_shard(
                        first, state.theta[0], grad[0],
                        None if state.mom is None else state.mom[0], self.comm,
                        lr=lr, beta=self.beta, fault=fault, mix_order=topo.mix_order,
                    )
                else:
                    fused_apply_stacked(
                        first, state.theta, grad, state.mom,
                        lr=lr, beta=self.beta, fault=fault, mix_order=topo.mix_order,
                    )
                self._later_rounds(rest, state.theta, fault)
            del grad
            self._finish_round(losses, norms, t_start, step=state.step, mix=mix, lr=lr,
                               grads=bucket_grad)
        return TrainState(state.theta, state.opt, state.step + 1), losses, norms

    def _later_rounds(self, rest, theta, fault) -> None:
        """The rounds after the fused one, IN PLACE; a mixed layout rounds
        its narrower leaves after the kernel's round and after each later
        one, as the reference mixes those leaves in their own dtype."""
        mix = lambda st, x: self._mix(st, x, fault)
        if not self.layout.mixed:
            mix_in_place(rest, theta, mix)
            return
        self.layout.round_leaves_(theta)
        for stage in rest:
            mix_in_place((stage,), theta, mix)
            self.layout.round_leaves_(theta)

    def _own(self, mask: torch.Tensor) -> torch.Tensor:
        """The rows of a (G,) per-node mask that this engine holds."""
        return mask if self.comm is None else mask[self.comm.rank:self.comm.rank + 1]

    def _bucketed_update(self, state: TrainState, grad, lr, program, split,
                         fault=None) -> None:
        """A mixing step's update and gossip bucket by bucket, IN PLACE on
        the buckets' column views of θ, m and ``grad``: K1 once per bucket
        with ``split`` (then the later rounds on the same columns), else
        the optimizer and the stacked interpreter, under the runtime masks
        ``fault`` (the kernel's fault rows built once for the step).  On a
        fault-free step whose successor probes, each bucket's Ξ² partial
        sum is folded for it."""
        fn = build_bucket_step(program, hyper=self.optimizer.hyper,
                               has_momentum=state.mom is not None, kernel_split=split,
                               fault=fault)
        self._fold.run(fn, self._bucket_layout, state.theta, state.mom, grad, lr,
                       controller=self.topology.controller, telemetry=self.telemetry,
                       step=state.step, fold=fault is None)

    def _finish_round(self, losses, norms, t_start, *, step: int, mix: bool, lr: float,
                      grads=None) -> None:
        """Post-step telemetry: closes the ``round`` span (after a device
        synchronize, only when the recorder times rounds) and, on a metrics
        step, emits the loss/lr/variance (and gradient-norm) sample.  A
        rank joins the ``pmean`` of the loss and the ``all_gather`` of the
        norms on every metrics step; rank 0 emits them."""
        tel = self.telemetry
        tel.round_end(t_start, step=step, mix=mix, device=self.device)
        if not (self._metrics_every and step % self._metrics_every == 0):
            return
        if self.comm is not None:
            losses = self.comm.pmean(losses.float().clone())
            norms = self.comm.all_gather(norms[0].contiguous()) if self.collect_norms else norms
        if tel.active:
            tel.step_metrics(step, loss=losses, lr=lr,
                             norms=norms if self.collect_norms else None, grads=grads)


    # -- crash-consistent resume -------------------------------------------------
    def checkpoint_tree(self, state: TrainState) -> dict:
        """The state as the reference's ``{"p", "o"}`` tree of (rows, ...)
        views into its flat buffers."""
        return checkpoint_tree(self.optimizer, self.layout, state.theta, state.opt)

    def snapshot_extra(self) -> dict:
        """Engine run state a crash-consistent checkpoint must carry beyond
        the arrays: ``run_config`` (topology, the gossip size G, the bucket
        layout: a mismatched resume fails fast), the membership tracking,
        the controller's and the recorder's state, and a pending Ξ fold.
        Fault realizations are pure in ``(seed, step)`` and a
        ``GossipDeadline`` rebuilds its backoff by replay: neither needs
        persisting."""
        d: dict = {
            "run_config": {
                "topology": self.topology.name,
                "n": int(self.g),
                "bucket_mb": None if self.bucket_mb is None else float(self.bucket_mb),
            },
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
        """Inverse of ``snapshot_extra`` on a freshly built trainer; the
        recorded ``run_config`` is validated first."""
        validate_run_config(d.get("run_config") or {}, topology=self.topology.name,
                            n=int(self.g), bucket_mb=self.bucket_mb,
                            n_label="mesh gossip size")
        lm = d.get("last_membership")
        self._last_membership = None if lm is None else tuple(bool(b) for b in lm)
        ctl = self.topology.controller
        if ctl is not None and d.get("controller") is not None:
            ctl.load_state_dict(d["controller"])
        if d.get("telemetry") is not None:
            # resumed counters and span totals continue instead of restarting
            self.telemetry.load_state_dict(d["telemetry"])
        self._fold.load_state_dict(d.get("xi_fold"), self.device)

    def save_checkpoint(self, directory: str, state: TrainState, *, keep: int = 3):
        """Write ``state`` at its step with ``snapshot_extra`` (the
        reference's file).  On the ranks engine every rank must call it:
        each leaf is gathered to rank 0's host memory, column chunk by
        column chunk, and rank 0 alone writes.  Returns the file's path
        (None on the other ranks)."""
        tree = self.checkpoint_tree(state)
        if self.comm is None:
            return save_checkpoint(directory, state.step, tree, keep=keep,
                                   extra=self.snapshot_extra())
        comm = self.comm
        gathered = map_leaves(
            lambda v: lambda: _gathered(comm.gather_host(v), v.shape[1:]), tree)
        if comm.rank == 0:
            return save_checkpoint(directory, state.step, gathered, keep=keep,
                                   extra=self.snapshot_extra())
        for _, gather in flatten(gathered):
            held(gather)()
        return None

    def restore_checkpoint(self, directory: str, state: TrainState,
                           step: Optional[int] = None) -> int:
        """Restore a checkpoint (the latest by default) into ``state``'s
        buffers IN PLACE: first the run state (``restore_extra``, whose
        validation fails a mismatched resume before anything is restored),
        then every leaf, shapes checked first.  On the ranks engine every
        rank must call it: rank 0 alone reads the file, the run state goes
        to every rank, and each leaf is scattered column chunk by column
        chunk, every rank receiving only its own row.  Returns the step
        (``state.step`` is left to the caller)."""
        if self.comm is None:
            step = resolve_step(directory, step)
            self.restore_extra(load_checkpoint_extra(directory, step) or {})
            return restore_checkpoint(directory, self.checkpoint_tree(state), step)
        comm = self.comm
        leaves = [(k, held(v)) for k, v in flatten(self.checkpoint_tree(state))]
        head = [None, None, None]   # step, extra, a shape error
        if comm.rank == 0:
            head[0] = resolve_step(directory, step)
            head[1] = load_checkpoint_extra(directory, head[0]) or {}
            with zipfile.ZipFile(checkpoint_path(directory, head[0])) as zf:
                shapes = leaf_shapes(zf)
            bad = [f"checkpoint leaf {k}: shape {shapes.get(k)} != template "
                   f"{(self.g,) + tuple(v.shape[1:])}" for k, v in leaves
                   if shapes.get(k) != (self.g,) + tuple(v.shape[1:])]
            head[2] = bad[0] if bad else None
        dist.broadcast_object_list(head, src=0)
        step, extra, bad = head
        self.restore_extra(extra)
        if bad:
            raise ValueError(bad)
        zf = zipfile.ZipFile(checkpoint_path(directory, step)) if comm.rank == 0 else None
        try:
            for key, v in leaves:
                rows = None
                if zf is not None:
                    rows = read_leaf(zf, key, v.dtype).reshape(comm.world, -1)
                comm.scatter_host(v, rows)
        finally:
            if zf is not None:
                zf.close()
        return step


def _gathered(rows: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    """A leaf gathered by ``Comm.gather_host`` as its (world, *shape) tree
    leaf (None off rank 0)."""
    return None if rows is None else rows.view((rows.shape[0],) + tuple(shape))


# ---------------------------------------------------------------------------
# CLI launcher:  PYTHONPATH=src python -m repro_torch.launch.train --reduced
# ---------------------------------------------------------------------------

def _parser():
    import argparse

    ap = argparse.ArgumentParser(
        description="decentralized training launcher (PyTorch port; a model "
                    "axis in --mesh is rejected until tensor parallelism is ported)"
    )
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-scale reduced config (default on CPU)")
    ap.add_argument("--topology", default="d_ada")
    ap.add_argument("--mixing", default="ppermute", choices=["ppermute", "dense"])
    ap.add_argument("--mix-every", type=int, default=1)
    ap.add_argument("--mix-rounds", type=int, default=1,
                    help="fuse H consecutive schedule steps into each gossip round")
    ap.add_argument("--hub-balance", action="store_true",
                    help="with --mix-rounds > 1, rotate a static multi-matching "
                         "program's matchings across the rounds")
    ap.add_argument("--fused-apply", action="store_true",
                    help="run optimizer+gossip as one pass of the fused CUDA "
                         "kernel for all-PPermute programs (plain momentum-SGD)")
    ap.add_argument("--bucket-mb", type=float, default=None,
                    help="run each mixing step bucket by bucket, ~this many MiB "
                         "of float32 per bucket (the stacked engine; SGD family "
                         "and post-mixing only; folds the next probe's Xi into "
                         "the buckets)")
    ap.add_argument("--fault-model", default="none",
                    choices=["none", "crash", "concurrent", "preempt", "join",
                             "deadline", "dropout", "link", "straggler"],
                    help="seeded fault injection (core/faults.py): a permanent "
                         "crash, k concurrent crashes, a preemption drain, joins "
                         "(with --spare-ranks), gossip deadlines with backoff, "
                         "node dropout, link failure or stragglers")
    ap.add_argument("--fault-rate", type=float, default=0.1,
                    help="per-step fault probability (crash/concurrent/preempt: "
                         "geometric onset)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="realization seed: every engine and rank draws the same masks")
    ap.add_argument("--fault-down-steps", type=int, default=None,
                    help="crash/concurrent: steps until a victim rejoins with its "
                         "neighbours' average (default: never)")
    ap.add_argument("--fault-k", type=int, default=2,
                    help="concurrent: number of victims")
    ap.add_argument("--fault-drain-steps", type=int, default=5,
                    help="preempt: the drain window before the clean departure")
    ap.add_argument("--fault-enumerate", action="store_true",
                    help="concurrent: pre-enumerate the degraded programs instead "
                         "of composing runtime masks")
    ap.add_argument("--fault-join-steps", default="",
                    help="join: comma-separated steps at which a spare rank activates")
    ap.add_argument("--spare-ranks", type=int, default=0,
                    help="ghost ranks riding from step 0 as alive-masked "
                         "zero-weight nodes; joins activate them (faults.SparePool)")
    ap.add_argument("--gossip-deadline-ms", type=float, default=30.0,
                    help="deadline: nodes whose seeded round latency misses it sit "
                         "the round out and keep their local step")
    ap.add_argument("--deadline-backoff", type=float, default=2.0,
                    help="deadline: exponential readmission backoff base")
    ap.add_argument("--k-floor", default="2",
                    help="Ada decay floor: an int, or 'one_peer'")
    ap.add_argument("--consensus-target", type=float, default=None,
                    help="closed-loop d_ada: step down one rung whenever the "
                         "measured consensus distance falls to this fraction "
                         "of its phase peak")
    ap.add_argument("--consensus-every", type=int, default=1,
                    help="consensus-distance probe cadence in steps")
    ap.add_argument("--consensus-spike", type=float, default=None,
                    help="re-densify one rung when Xi reaches this multiple of "
                         "the phase peak (needs --consensus-target)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--per-node-batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--lr-scaling", default="sqrt", choices=["none", "linear", "sqrt"])
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw", "lars"])
    ap.add_argument("--mesh", default="4,1",
                    help="data,model: G gossip nodes (on one card, or one per "
                         "rank under torch.distributed.run); model must be 1")
    ap.add_argument("--ckpt-dir", default="",
                    help="write checkpoints here (the reference's step_<n>.npz files)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every this many steps (with --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir: parameters, "
                         "optimizer state, the controller's run state, membership "
                         "tracking and telemetry totals; fault realizations are pure "
                         "in (seed, step), so the run continues bit for bit")
    ap.add_argument("--telemetry", default="",
                    help="stream structured run telemetry (JSONL) to this path: "
                         "round spans, comm-bytes counters, loss/xi/lr gauges, "
                         "streamed DBench variance, controller and checkpoint "
                         "events; read it with python -m repro_torch.telemetry "
                         "summarize PATH (with --resume the file is appended and "
                         "the counters continue from the checkpoint)")
    ap.add_argument("--metrics-every", type=int, default=10,
                    help="gauge/variance emission cadence in steps (with "
                         "--telemetry; spans and counters are per step)")
    return ap


def _join_group(device):
    """Under ``torch.distributed.run`` (WORLD_SIZE > 1 in the environment)
    join the process group: the rank's own card over NCCL when the machine
    has a card per rank, the one card over gloo-host when it has fewer, the
    CPU over gloo when ``device="cpu"``.  Returns (device, whether this
    call initialised the group)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return resolve_device(device), False
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dev, backend = rank_device(local, local_world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend)
    return dev, True


def main(argv=None, *, device=None) -> dict:
    """Run the CLI; ``device`` (a keyword, not a flag) selects the CPU for
    tests.  Under ``torch.distributed.run --nproc-per-node G`` every process
    is one rank of the ranks engine.  Returns ``{"losses": [mean loss over
    the nodes per step run], "trainer", "state"}``."""
    args = _parser().parse_args(argv)
    try:
        shape = tuple(int(x) for x in args.mesh.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2:
        raise SystemExit(f"--mesh must be 'data,model', got {args.mesh!r}")
    g, tp = shape
    if tp != 1:
        raise SystemExit(
            f"not ported yet:\n  --mesh {args.mesh}: a model axis > 1 (tensor "
            "parallelism inside a node) comes after the queue, ROADMAP queue 1 item 8"
        )
    if args.k_floor == "one_peer":
        k_floor = "one_peer"
    else:
        try:
            k_floor = int(args.k_floor)
        except ValueError:
            raise SystemExit(
                f"--k-floor must be an integer or 'one_peer', got {args.k_floor!r}"
            )
    dev, own_group = _join_group(device)
    try:
        return _train(args, g, tp, k_floor, dev)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, g, tp, k_floor, dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.faults import make_fault_model
    from repro_torch.data import SyntheticLM
    from repro_torch.optim.schedules import lr_scale
    from repro_torch.optim.sgd import get_optimizer

    cfg = get_config(args.arch + ("-reduced" if args.reduced or dev.type == "cpu" else ""))
    cfg = dataclasses.replace(cfg, name=args.arch)
    join_steps = tuple(int(x) for x in args.fault_join_steps.split(",") if x.strip()) or None
    fault_model = make_fault_model(
        args.fault_model, g, rate=args.fault_rate, seed=args.fault_seed,
        down_steps=args.fault_down_steps, k=args.fault_k,
        drain_steps=args.fault_drain_steps, join_steps=join_steps,
        enumerate_programs=args.fault_enumerate, spare_ranks=args.spare_ranks,
        deadline_ms=args.gossip_deadline_ms, deadline_backoff=args.deadline_backoff,
    )
    topo = make_topology(
        args.topology, g, k_floor=k_floor,
        consensus_target=args.consensus_target,
        consensus_spike=args.consensus_spike,
        consensus_probe_every=args.consensus_every,
        fault_model=fault_model,
    )
    recorder = None
    if args.telemetry:
        from repro_torch.telemetry import JsonlSink, MetricsRecorder

        # rank 0 alone writes the stream
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        recorder = MetricsRecorder(
            sinks=[JsonlSink(args.telemetry, append=args.resume)] if rank0 else [],
            metrics_every=args.metrics_every, record_spans=True,
        )
    trainer = SPMDTrainer(
        cfg, topo, get_optimizer(args.optimizer), collect_norms=True,
        mixing=args.mixing, mix_every=args.mix_every,
        mix_rounds=args.mix_rounds, hub_balance=args.hub_balance,
        fused_apply=args.fused_apply, bucket_mb=args.bucket_mb, telemetry=recorder,
        device=dev,
    )
    comm = trainer.comm
    say = print if comm is None or comm.rank == 0 else (lambda *a, **k: None)
    trainer.telemetry.manifest({
        "engine": trainer.engine,
        "config": {k: v for k, v in sorted(vars(args).items())},
        "topology": topo.describe(),
        "mesh": {"data": g, "model": tp},
        "seed": 0,
        "resumed": bool(args.resume),
    })
    # report the apply path the step will ACTUALLY take: fused_apply takes
    # the interpreter for non-PPermute programs (complete, dense)
    apply_mode = "interpreter"
    if args.fused_apply and trainer._use_fused(trainer._program_at(0, 0)):
        apply_mode = "fused kernel " + ("K1" if comm is None else "K2")
    elif args.fused_apply:
        apply_mode = "interpreter (program not fused-eligible)"
    if trainer._bucketed:
        apply_mode += f" | bucketed {args.bucket_mb}MiB"
    engine = "stacked" if comm is None else f"ranks | transport {comm.transport}"
    say(topo.describe(), "| mesh", {"data": g, "model": tp}, "| mixing",
        args.mixing, "| engine", engine, "| rounds", args.mix_rounds, "| apply",
        apply_mode, "| optimizer", trainer.optimizer.name, "| device", dev)
    n_progs = len(trainer.precompile_programs(args.steps // args.steps_per_epoch + 1))
    say(f"{n_progs} distinct mixing program(s) over the run")
    state = trainer.init_state(seed=0)
    start_step = 0
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt-dir")
        start_step = trainer.restore_checkpoint(args.ckpt_dir, state)
        state = TrainState(state.theta, state.opt, start_step)
        trainer.telemetry.event("checkpoint_restore", start_step, data={"dir": args.ckpt_dir})
        say(f"resumed from {args.ckpt_dir} at step {start_step}")
    src = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, seed=0)
    scale = lr_scale(
        args.lr_scaling, global_batch=g * args.per_node_batch,
        base_batch=max(g * args.per_node_batch, 1), graph_degree=topo.degree_at(0),
    )
    losses = []
    t0 = time.time()
    for t in range(start_step, args.steps):
        batch = src.stacked(g, t, args.per_node_batch)
        epoch = t // args.steps_per_epoch
        state, loss, norms = trainer.train_step(state, batch, args.lr * scale, epoch=epoch)
        if comm is not None:   # every node's loss, for the printout
            loss = comm.all_gather(loss).reshape(-1)
        losses.append(float(loss.mean()))
        if not math.isfinite(losses[-1]):
            raise SystemExit(f"step {t}: loss is not finite ({losses[-1]})")
        if t % 5 == 0 or t == args.steps - 1:
            say(f"step {t:4d} k={topo.degree_at(epoch, t)} loss={losses[-1]:.4f} "
                f"spread={float(loss.max() - loss.min()):.4f}")
        if args.ckpt_dir and args.ckpt_every and (t + 1) % args.ckpt_every == 0:
            trainer.save_checkpoint(args.ckpt_dir, state)
            trainer.telemetry.event("checkpoint_save", t + 1, data={"dir": args.ckpt_dir})
    say(f"{args.steps} steps in {time.time() - t0:.1f}s")
    if topo.controller is not None:
        ctl = topo.controller
        rungs = " -> ".join(str(ctl.ladder[r]) for _, r in [(0, 0)] + ctl.transitions)
        say(f"consensus controller: xi0={ctl.xi0} rungs {rungs} "
            f"handoff_step={ctl.handoff_step}")
    if args.telemetry:
        trainer.telemetry.close()
        say(f"telemetry: {args.telemetry} "
            f"(python -m repro_torch.telemetry summarize {args.telemetry})")
    return {"losses": losses, "trainer": trainer, "state": state}


if __name__ == "__main__":
    main()

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
dtype after every update and round (bucketed too) and after every
membership handoff, as the reference's fused step casts each leaf back
after its float32 kernel and its handoffs cast each leaf's float32 mean;
checkpoints write each leaf in its own dtype.  One
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
bucket.  On a mixed-dtype state each bucket rounds (fused) or mixes in
their own dtype (interpreter) the runs of its columns that hold narrower
leaves (``BucketLayout.dtype_runs``), where the monolithic step does.
Either way the numbers are the monolithic step's, bit for bit,
and when the next step probes, Ξ² is folded into the buckets
(``XiFold``) and that probe reads the fold: an eager reduction over each
bucket after its mix, which reads the state as the standalone probe
would and costs about as much until a fused fold kernel exists.  The
ranks engine keeps the monolithic step under ``bucket_mb``, as the
reference's shard_map realization does (a per-bucket overlap of its
collectives is performance work, not a part of the reference to port).

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

``debug_no_retrace`` is the reference's rebuild guard
(``repro_torch.analysis.recompile``): every step is keyed by its program
(``_step_cache``, the reference's executable keys), and a step whose key
ran before must build nothing (no nvcc build, no new device table, no new
program key) or it raises ``RetraceError``; ``precompile_programs`` is the
set those keys must come from.

``loss_fn`` replaces the transformer's loss (a function of one node's flat
parameter dict and batch); ``accum_steps`` k splits every node's batch into
k microbatches whose loss and gradients are averaged as the reference's
``_grads_of`` does, the gradients accumulated in place in the gradient
buffer, on every path (fused or not, both engines).  The model's ``remat``
checkpoints each layer (``models/transformer.py``).

``mesh`` (a ``launch/mesh.Mesh``; None for ``{"data": G, "model": 1}``)
places each node over a model axis of m ranks, the reference's tensor and
expert parallelism inside a node.  On one card (stacked) the model axis
carries no devices and only sets the model's padded heads (the reference's
stacked GSPMD realization computes the padded model whole, masked).  On
the ranks engine the world is G × m ranks (``launch/comm.mesh_comms``):
rank (i, j) holds shard j of node i — each leaf sliced along the dim its
validated spec puts on "model" (``launch/sharding.py``), the other leaves
whole — and its flat state is that shard row.  Gossip (K2 included) runs
on the shard rows between the ranks of one shard index, unchanged, since
it is elementwise; the forward's collectives run over the node's model
group (``launch/tensor_parallel.py``), which leaves every replicated leaf
the same bits on every rank of a node.  Ξ and the DBench norms count a
replicated leaf once and sum a sharded leaf's squares over the model
group; checkpoints gather and scatter the shards (the file is the
reference's: full padded leaves stacked over G).  Every family trains
there: RWKV6 and Mamba2 blocks own their heads' shards
(``models/rwkv6.py``, ``models/mamba2.py``), and a mixed-dtype state
(zamba2's float32 ``a_log``/``d_skip`` beside bf16 leaves) is a float32
shard row whose replicated float32 leaves Ξ and the norms count once.
Faults and elastic membership run there as on one rank a node: every rank
of node i reads node i's realization (pure in ``(seed, step)``), K2 takes
the node's weight and fault row on each shard row, and the handoffs
(rejoin, drain, spare activation) run per shard index over its gossip
group, each of a node's m ranks rebuilding its own shard row; masked Ξ
sums its shard rows' partial sums over the node's ranks.

The gossip axes are the reference's ``gossip_axes_for`` the config's name
when a mesh is given: kimi-k2's replica needs a whole pod, so on
``single`` it is one gossip node (G = 1) of 16 data × 16 model ranks and on
``multi`` two.  A node that spans data axes has a third group, its data
group (``launch/comm.node_comms``), and the reference trainer's placement
(``fsdp=not stacked``, ``launch/sharding.node_shards``): at G = 1 every
leaf FSDP-sharded over the data axes, at G > 1 the leaves whole on them
except the experts' d_ff under ``moe_shard_ff``.  A rank stores its slice
and gathers it at use (``launch/tensor_parallel.DataParallel``), one
layer's leaves at a time, the gradient reduce-scattered back.  At G = 1
the batch is split over the data ranks (the reference's ``batch_sharding(...,
stacked=False)``), a MoE layer routes the tokens of the whole batch
gathered over the data group, and the node's gradient is the mean of its
data ranks' shares; there is no gossip, no Ξ and no fault (the
reference's G = 1 step), and the optimizer's plain update runs on the
shard row (the reference builds no fused step at G = 1).  At G > 1 the
node's data ranks all hold the node's batch.

``lower_step`` is the dry run of one step (``launch/dryrun.py``): this
trainer's configuration run once on ``meta`` under the op accounting
(``launch/hlo_analysis.py``), a ranks engine's collectives recorded by a
``RecordingComm`` of its rank; nothing is allocated or computed, and the
live trainer's run state is left alone.

Checkpoints are the reference's files (``checkpoint/ckpt.py``): the state
as the ``{"p": params, "o": opt_state}`` tree of (G, ...) leaves (at G = 1
the reference's unstacked leaves), saved from
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

import contextlib
import dataclasses
import math
import os
import time
import zipfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.analysis import recompile
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
    consensus_distance_shard, consensus_distance_stacked, consensus_sq_shard,
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
from repro_torch.launch.comm import Comm, RecordingComm, node_comms, rank_device
from repro_torch.launch.mesh import (Mesh, data_axes_for, gossip_axes_for, gossip_size,
                                     make_mesh)
from repro_torch.launch.sharding import node_shards, shard_leaf, unshard
from repro_torch.launch.tensor_parallel import DataParallel, ModelParallel
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
        debug_no_retrace: bool = False,
        device=None,
        mesh: Optional[Mesh] = None,
        comm: Optional[Comm] = None,
        model_comm: Optional[Comm] = None,
        data_comm: Optional[Comm] = None,
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
        ``mix_order="post"``); the ranks engine keeps the monolithic step.
        telemetry: the run's ``MetricsRecorder`` (an inert one by default,
        which costs nothing); on the ranks engine give rank 0 the sinks.
        debug_no_retrace: raise ``RetraceError`` when a warm step (one whose
        program key ran before) builds anything: an nvcc build, a device
        table, a program key (``analysis.recompile``).
        ``device``: the current card by default; ``"cpu"`` runs every
        kernel's plain twin.  With an initialised process group of world
        size > 1 the trainer is one rank of the ranks engine, which raises
        unless the world size equals the topology's node count.  ``comm``
        (keyword only): the ``Comm`` of that rank, given in place of the
        process group's; the dry run gives a ``RecordingComm``, rank 0 of a
        world that exists only on paper.  ``mesh``: a ``launch/mesh.Mesh``
        whose non-"model" axes hold the G gossip nodes and whose "model"
        axis m splits each node (None: ``{"data": G, "model": 1}``); with
        m > 1 a process group of G × m ranks runs the tensor-parallel ranks
        engine, else the stacked engine pads the heads at m.
        ``model_comm`` (keyword only, with ``comm``): the ``Comm`` of this
        rank's model group (the dry run's ``RecordingComm``); ``data_comm``
        that of its node's data group, where the mesh has data axes that
        are not gossip axes (kimi-k2: the gossip axes are ``gossip_axes_for``
        the config's name; G = 1 on one pod)."""
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
        # the model group is read at call time: the dry run swaps it
        self.loss_fn = loss_fn or (lambda p, b: tfm.loss_fn(p, cfg, b, tp=self.tp))
        self.accum_steps = max(int(accum_steps), 1)
        self.beta = float(hyper.get("momentum", 0.0))
        self.collect_norms = collect_norms
        self.mixing = mixing
        self.mix_every = max(int(mix_every), 1)
        self.mix_rounds = max(int(mix_rounds), 1)
        self.hub_balance = bool(hub_balance)
        self._update = torch.func.vmap(optimizer.update, in_dims=(0, 0, 0, None))
        self.device = resolve_device(device)
        if mesh is None:
            self.mesh = make_mesh((topology.n_nodes, 1), ("data", "model"))
            self.gossip_axes = ("data",)
        else:
            self.mesh = mesh
            self.gossip_axes = gossip_axes_for(cfg.name, mesh)
        self.g = gossip_size(self.mesh, self.gossip_axes)
        if topology.n_nodes != self.g:
            raise ValueError(f"topology has {topology.n_nodes} nodes but the mesh "
                             f"{self.mesh.shape} has {self.g} gossip nodes (gossip axes "
                             f"{self.gossip_axes})")
        self.tp_size = self.mesh.shape.get("model", 1)
        self.data_axes = data_axes_for(self.mesh, self.gossip_axes)
        self.dp_size = self.mesh.axis_size(self.data_axes) if self.data_axes else 1
        self.comm, self.model_comm, self.data_comm = comm, model_comm, data_comm
        self.world_comm = comm
        node = self.tp_size * self.dp_size
        if comm is None and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            self.world_comm = Comm(self.device)
            self.comm = self.world_comm
            if node > 1 and self.world_comm.world == self.mesh.size:
                self.comm, self.model_comm, self.data_comm = node_comms(
                    self.world_comm, self.g, self.dp_size, self.tp_size)
        if self.comm is not None:
            if self.comm.world != self.g:
                raise ValueError(
                    f"topology has {self.g} nodes but the process group has "
                    f"{self.comm.world} ranks"
                )
            if node > 1 and (self.model_comm is None
                             or (self.dp_size > 1) != (self.data_comm is not None)):
                raise ValueError(
                    f"a node of {self.dp_size} data x {self.tp_size} model ranks needs a "
                    f"world of {self.mesh.size} ranks (G × d × m), or a model_comm (and a "
                    "data_comm) with comm"
                )
        self.engine = "stacked" if self.comm is None else "ranks"
        self.rows = self.g if self.comm is None else 1
        self.full_defs = tfm.model_defs(cfg, self.tp_size)
        # the rank's view of its node's model (and data) group
        self.tp = None
        self.defs = self.full_defs
        self.shardings = None
        self.node_mesh = None
        if self.model_comm is not None:
            self.node_mesh, self.shardings, self.defs = node_shards(
                self.full_defs, self.mesh, self.gossip_axes)
            dp = None
            if self.data_comm is not None:
                dims = {k: sh.dim_of_any(self.data_axes) for k, sh in self.shardings.items()}
                dp = DataParallel(self.data_comm, {k: d for k, d in dims.items()
                                                   if d is not None},
                                  split_batch=self.g == 1)
            self.tp = ModelParallel(self.model_comm, data=dp)
        self.layout = FlatLayout.of_defs(self.defs)
        if bucket_mb is not None:
            check_bucketable(optimizer, topology)
        self.bucket_mb = bucket_mb
        self._bucket_layout = (
            None if bucket_mb is None
            else BucketLayout(self.layout.sizes, BucketLayout.elems_for_mb(bucket_mb))
        )
        # a mixed state's buckets mix each narrower leaf's columns in its dtype
        self._bucket_runs = (
            self._bucket_layout.dtype_runs(self.layout.dtypes)
            if self._bucket_layout is not None and self.layout.mixed else None
        )
        self.debug_no_retrace = bool(debug_no_retrace)
        # every step's program key (``analysis.recompile``): a step whose
        # key is here is warm and, under debug_no_retrace, builds nothing
        self._step_cache: dict = {}
        self._fold = XiFold()
        self.telemetry = telemetry if telemetry is not None else MetricsRecorder()
        self.telemetry.configure(deadline_ms=getattr(self.fault_model, "deadline_ms", None))
        if topology.controller is not None:
            topology.controller.bind_recorder(self.telemetry)
        self._metrics_every = self.telemetry.metrics_every if self.telemetry.active else 0
        if self.comm is not None:
            # every rank joins the metrics steps' collectives: rank 0's
            # recorder (the one with sinks) sets the cadence for all
            self._metrics_every = self.comm.rank0_value(self._metrics_every)

    @property
    def model_rank(self) -> int:
        """This rank's index on its node's model axis (0 off a model axis)."""
        return 0 if self.tp is None else self.tp.rank

    @property
    def data_rank(self) -> int:
        """This rank's index in its node's data group (0 without one)."""
        return 0 if self.data_comm is None else self.data_comm.rank

    def _node_coords(self) -> dict:
        """This rank's coordinates on its node's mesh (data axes, "model")."""
        return self.node_mesh.coords(self.data_rank * self.tp_size + self.model_rank)

    def _replicated(self) -> list[bool]:
        """Per leaf, whether the model axis leaves it whole."""
        if self.shardings is None:
            return [True] * len(self.layout.sizes)
        return [self.shardings[k].dim_of("model") is None for k in self.defs]

    def _data_whole(self) -> list[bool]:
        """Per leaf, whether the node's data axes leave it whole."""
        if self.shardings is None:
            return [True] * len(self.layout.sizes)
        return [self.shardings[k].dim_of_any(self.data_axes) is None for k in self.defs]

    def _counted(self) -> list[bool]:
        """Per leaf, whether this rank counts it in a sum over its node's
        ranks: a leaf whole on an axis counts on that axis's rank 0 only."""
        return [(not rm or self.model_rank == 0) and (not rd or self.data_rank == 0)
                for rm, rd in zip(self._replicated(), self._data_whole())]

    def _node_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the node's model and data groups (IN PLACE)."""
        for c in (self.model_comm, self.data_comm):
            if c is not None:
                c.all_reduce(x)
        return x

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
        if (not self.fused_apply or program is None or self.topology.centralized
                or self.g == 1):   # the reference builds no fused step at G = 1
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
        ``seed``, or one replica's ``params`` (e.g. ``tfm.params_from_jax``:
        the full tree, heads padded at the mesh's model size; numpy arrays
        or tensors).  A tensor-parallel rank keeps its shard of each leaf."""
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = tfm.init_model(self.cfg, gen, self.device, self.tp_size)
        theta = torch.empty((self.rows, self.layout.size),
                            dtype=self.layout.state_dtype, device=self.device)
        for name, view in self.layout.views(theta[0]).items():
            leaf = torch.as_tensor(params[name])
            want = self.full_defs[name].shape
            if tuple(leaf.shape) != tuple(want):
                raise ValueError(f"{name}: shape {tuple(leaf.shape)} != {tuple(want)}")
            if self.shardings is not None:
                leaf = shard_leaf(leaf, self.shardings[name], self._node_coords())
            view.copy_(leaf)
        theta[1:].copy_(theta[:1].expand(self.rows - 1, -1))
        opt = opt_buffers(self.optimizer, self.layout, theta)
        return TrainState(theta, opt, 0)

    def stacked_params(self, state: TrainState) -> dict[str, torch.Tensor]:
        """(rows, ...) views of every leaf of the state's parameters (a
        tensor-parallel rank's: its shards)."""
        return self.layout.stacked_views(state.theta)

    def full_params(self, state: TrainState) -> dict[str, torch.Tensor]:
        """(rows, ...) full leaves of the state's parameters: on a
        tensor-parallel rank its node's, the shards all-gathered over the
        node's model and data groups (every rank of the node must call it);
        else the views of ``stacked_params``."""
        return self.full_leaves(state.theta)

    def full_leaves(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        """``full_params`` of any (rows, P) buffer of the layout (θ, the
        momentum, a gradient)."""
        views = self.layout.stacked_views(buf)
        if self.tp is None:
            return views
        out = {}
        for k, v in views.items():
            parts = v.contiguous()
            if self.data_comm is not None:
                parts = self.data_comm.all_gather(parts)        # (d, rows, ...)
            parts = self.model_comm.all_gather(parts.contiguous())  # (m, [d,] rows, ...)
            parts = parts.transpose(0, 1) if self.data_comm is not None else parts[:, None]
            out[k] = self._unshard_rows(k, parts.reshape((-1,) + tuple(v.shape)))
        return out

    def _unshard_rows(self, name: str, parts: torch.Tensor) -> torch.Tensor:
        """(node ranks, rows, ...) shards of a leaf in the node's rank order
        (data index, then model index) -> (rows, ...)."""
        return torch.stack([unshard(list(parts[:, r]), self.shardings[name])
                            for r in range(parts.shape[1])])

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
        the ``members`` ((G,) 0/1 mask) only when given.  On a
        tensor-parallel rank each rank's ‖x_i − x̄‖² over its shard row (a
        leaf whole on an axis counted on that axis's rank 0 only) is summed
        over the node's model and data groups before the gossip group's
        mean, masked or not."""
        if self.tp is not None:
            local = {k: v for (k, v), mine in zip(self.layout.views(state.theta[0]).items(),
                                                  self._counted()) if mine}
            if members is not None:
                return consensus_distance_masked_shard(local, members, self.comm,
                                                       reduce=self._node_sum)
            sq = self._node_sum(consensus_sq_shard(local, self.comm).reshape(1))
            return self.comm.pmean(sq)[0].sqrt()
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
        token arrays (numpy or tensors); a rank moves only its own row.  At
        G = 1 it is the reference's: the batch is (B, S) and the loss a
        scalar, the norms (n_leaves,); a node split over data ranks splits
        B over them (each rank moves its own rows) and its loss, gradients
        and norms are the whole batch's."""
        tel = self.telemetry
        t_start = tel.round_start()
        if self.g == 1:
            batch = {k: self._data_rows(v)[None] for k, v in batch.items()}
        else:
            own = (slice(None) if self.comm is None
                   else slice(self.comm.rank, self.comm.rank + 1))
            batch = {k: torch.as_tensor(v[own], device=self.device) for k, v in batch.items()}
        topo = self.topology
        fr = fault = members = None
        with torch.no_grad():
            if self.fault_model is not None and self.g > 1:
                fr = self.fault_model.at(state.step)
                self._last_membership = membership_events(
                    fr, [state.theta] + list(state.opt.values()), topo,
                    self._last_membership, step=state.step, epoch=epoch,
                    mix_every=self.mix_every, telemetry=tel, comm=self.comm,
                    narrow=self.layout.narrow_leaves())
                fault = realization_arrays(fr, self.device)
                # the membership mask, not the raw alive mask: a float drain
                # boost must not weight the draining node in the probe
                members = torch.as_tensor(fr.alive != 0, dtype=torch.float32,
                                          device=self.device)
            # the closed loop's probe reads Ξ on the host: the dry run
            # (``lower_step``, on meta) builds the step without it
            probing = self.g > 1 and self.device.type != "meta"
            self._fold.probe(topo.controller if probing else None, tel, state.step,
                             lambda: self.consensus_distance(state, members))
        mix = (state.step + 1) % self.mix_every == 0
        # time-varying schedules advance per gossip round, not per raw step;
        # a permanent membership selects its degraded program (the selection
        # mask of a composed concurrent crash or a spare pool stays all-ones)
        program = (
            self._program_at(state.step // self.mix_every, epoch)
            if mix and not topo.centralized and self.g > 1 else None
        )
        sel = None if fr is None else fr.selection_mask()
        if program is not None and sel is not None and not sel.all():
            program = program.degrade(sel)
        bucketed = self._bucketed and program is not None
        warm = self._note_step(program, faulty=fault is not None, bucketed=bucketed,
                               has_m=state.mom is not None)
        with recompile.guard(self.debug_no_retrace and warm, f"train step {state.step}"):
            grad = torch.empty_like(state.theta)
            losses = self._grads_into(state.theta, grad, batch)
            if self.data_comm is not None:
                losses = self._data_mean(losses, grad)
            bucket_grad = None   # the gradient buffer of a bucketed step
            with torch.no_grad():
                norms = (
                    self._norms(state.theta)
                    if self.collect_norms
                    else torch.zeros((self.rows, 0), dtype=torch.float32, device=self.device)
                )
                if program is not None and self.g > 1:
                    tel.comm(program, self.layout.row_bytes,
                             step=state.step, alive=None if fr is None else fr.alive,
                             link_up=None if fr is None else fr.link_up)
                if topo.centralized and self.g > 1:
                    # C_complete: average gradients globally (float32, leaf by
                    # leaf); replicas stay identical
                    for g in self.layout.stacked_views(grad).values():
                        if self.comm is None:
                            g.copy_(g.float().mean(dim=0, keepdim=True).to(g.dtype).expand_as(g))
                        else:
                            g.copy_(self.comm.pmean(g.float().contiguous()))
                    self.layout.round_leaves_(grad)
                split = self._fused_split(program)
                if bucketed:
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
        if self.g == 1:   # the reference's G = 1 step: a scalar loss
            losses, norms = losses[0], norms[0]
        return TrainState(state.theta, state.opt, state.step + 1), losses, norms

    def _data_rows(self, x) -> torch.Tensor:
        """This rank's rows of a G = 1 batch leaf (B, ...): B over the node's
        data ranks, all of it without a data group."""
        x = torch.as_tensor(x)
        if x.dim() < 2:
            raise ValueError(f"a G = 1 batch is (B, S); got a leaf of shape {tuple(x.shape)}")
        if self.data_comm is not None:
            b = x.shape[0] // self.dp_size
            if b * self.dp_size != x.shape[0]:
                raise ValueError(f"batch of {x.shape[0]} rows over {self.dp_size} data ranks")
            x = x[self.data_rank * b:(self.data_rank + 1) * b]
        return x.to(self.device)

    def _data_mean(self, losses: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        """The node's loss and gradients from its data ranks' shares, IN
        PLACE on ``grad``: a leaf the data group shards arrives summed by its
        gather's reduce-scatter, a whole leaf's gradient is summed over the
        group here; both then divided by the group's size (the mean over the
        ranks' equal shares).  Returns the mean loss (the same on every data
        rank)."""
        comm, d = self.data_comm, float(self.dp_size)
        for view, whole in zip(self.layout.views(grad[0]).values(), self._data_whole()):
            if whole:
                comm.all_reduce(view)
        grad.div_(d)
        return comm.all_reduce(losses.float().contiguous().clone()).div_(d)

    def _norms(self, theta: torch.Tensor) -> torch.Tensor:
        """The DBench probe (K3): per-leaf L2 norms of every row; on a
        tensor-parallel rank a sharded leaf's squares summed over the model
        group (one all-reduce), a replicated leaf's norm as it is; where the
        node spans data ranks, a leaf the data group shards has its squares
        summed over that group first."""
        norms = dbench.param_l2_norms(theta, self.layout)
        if self.tp is None:
            return norms
        sq = norms.square()
        sharded = torch.tensor([not r for r in self._replicated()], device=norms.device)
        split = sharded
        if self.data_comm is not None:
            on_data = torch.tensor([not w for w in self._data_whole()], device=norms.device)
            sq = torch.where(on_data,
                             self.data_comm.all_reduce(torch.where(on_data, sq, 0.0)), sq)
            split = sharded | on_data
        sq = torch.where(sharded, self.model_comm.all_reduce(torch.where(sharded, sq, 0.0)), sq)
        return torch.where(split, sq.sqrt(), norms)

    def _note_step(self, program, *, faulty: bool, bucketed: bool, has_m: bool) -> bool:
        """Key this step as the reference keys its executables (the
        program's ``cache_key``, None without a program; bucketed steps
        ``("__bucket__", key, has_m, faulty)``, fault steps ``(key,
        "faulty")``) in ``_step_cache``; returns whether the key was there
        (a warm step).  A new key is a rebuild event."""
        key = None if program is None else program.cache_key
        if bucketed:
            key = ("__bucket__", key, has_m, faulty)
        elif faulty:
            key = (key, "faulty")
        warm = key in self._step_cache
        if not warm:
            self._step_cache[key] = program
            recompile.note("programs")
        return warm

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
                       step=state.step, fold=fault is None, runs=self._bucket_runs)

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

    # -- the dry run ----------------------------------------------------------------
    def abstract_state(self, step: int = 0) -> TrainState:
        """The state's flat buffers on ``meta``: θ and the optimizer slots
        of this engine's rows, no device byte allocated."""
        theta = torch.empty((self.rows, self.layout.size), dtype=self.layout.state_dtype,
                            device="meta")
        return TrainState(theta, opt_buffers(self.optimizer, self.layout, theta), step)

    @contextlib.contextmanager
    def _on_meta(self):
        """This trainer's configuration on ``meta``: a ranks engine swaps
        its ``Comm`` for a ``RecordingComm`` of the same rank and world, an
        inert recorder takes the telemetry, and nothing of the run state
        (program keys, membership, a pending Ξ fold) is touched."""
        saved = (self.device, self.comm, self.model_comm, self.data_comm, self.tp,
                 self.telemetry, self._step_cache, self._last_membership, self._fold,
                 self._metrics_every)

        def recording(c):
            if c is None or (isinstance(c, RecordingComm) and c.device.type == "meta"):
                return c
            return RecordingComm(c.rank, c.world)

        self.device = torch.device("meta")
        self.comm = recording(self.comm)
        if self.tp is not None and (self.model_comm.device.type != "meta"
                                    or self.data_comm is not None
                                    and self.data_comm.device.type != "meta"):
            self.model_comm, self.data_comm = (recording(self.model_comm),
                                               recording(self.data_comm))
            dp = self.tp.data
            if dp is not None:
                dp = DataParallel(self.data_comm, dp.dims, split_batch=dp.split_batch)
            self.tp = ModelParallel(self.model_comm, data=dp)
        self.telemetry, self._step_cache, self._fold = MetricsRecorder(), {}, XiFold()
        self._metrics_every = 0
        try:
            yield
        finally:
            (self.device, self.comm, self.model_comm, self.data_comm, self.tp,
             self.telemetry, self._step_cache, self._last_membership, self._fold,
             self._metrics_every) = saved

    def lower_step(self, shape, *, epoch: int = 0, step: int = 0) -> dict:
        """The dry run of one step (the reference's abstract lowering):
        this trainer's step — fused or not, stacked or one rank, under its
        fault model's realization of ``step`` — run once on ``meta`` under
        the op accounting (``launch/hlo_analysis.py``), on the data of
        ``shape`` (``configs.input_specs``: its global batch over the G
        nodes).  No device byte is allocated and nothing is computed; the
        closed loop's Ξ probe (a host read) is left out.  Returns the
        record: ``memory`` (``argument_bytes``: θ and the optimizer slots
        of this engine's rows, updated in place, so also ``alias_bytes``;
        ``temp_bytes``: the step's peak of live intermediates), ``cost``,
        ``hlo`` and ``collectives`` (this rank's, on a ranks engine) and
        ``lower_s``."""
        from repro_torch.configs.base import input_specs
        from repro_torch.launch.hlo_analysis import step_record

        with self._on_meta():
            state = self.abstract_state(step)
            # (G, B, S) batches; at G = 1 the reference's flat (B, S) one
            batch = input_specs(self.cfg, shape, n_nodes=self.g)
            return step_record(
                self.train_step, state, batch, 1e-2, epoch=epoch,
                arguments=[state.theta, *state.opt.values()],
                outputs=lambda out: [out[0].theta, *out[0].opt.values(), out[1], out[2]],
            )

    # -- crash-consistent resume -------------------------------------------------
    def checkpoint_tree(self, state: TrainState) -> dict:
        """The state as the reference's ``{"p", "o"}`` tree of (rows, ...)
        views into its flat buffers; at G = 1 the reference's unstacked
        leaves (its trainer holds no node axis there), row 0's views."""
        tree = checkpoint_tree(self.optimizer, self.layout, state.theta, state.opt)
        return map_leaves(lambda v: v[0], tree) if self.g == 1 else tree

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
        if self.tp_size > 1:
            d["run_config"]["model"] = int(self.tp_size)
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
        run_config = d.get("run_config") or {}
        validate_run_config(run_config, topology=self.topology.name,
                            n=int(self.g), bucket_mb=self.bucket_mb,
                            n_label="mesh gossip size")
        # the reference records no model axis: a file without one is any size's
        if "model" in run_config and int(run_config["model"]) != self.tp_size:
            raise ValueError(
                f"resume config mismatch: model axis {run_config.get('model')} in the "
                f"checkpoint, {self.tp_size} now")
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
        if self.tp is not None:
            return self._save_sharded(directory, state, tree, keep)
        comm = self.comm
        gathered = map_leaves(
            lambda v: lambda: _gathered(comm.gather_host(v.contiguous()), v.shape[1:]), tree)
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
        comm = self.world_comm
        leaves = [(k, held(v)) for k, v in flatten(self.checkpoint_tree(state))]
        names = self._leaf_names(state)
        head = [None, None, None]   # step, extra, a shape error
        if comm.rank == 0:
            head[0] = resolve_step(directory, step)
            head[1] = load_checkpoint_extra(directory, head[0]) or {}
            with zipfile.ZipFile(checkpoint_path(directory, head[0])) as zf:
                shapes = leaf_shapes(zf)
            want = {k: self._file_shape(names.get(v.data_ptr()), v) for k, v in leaves}
            bad = [f"checkpoint leaf {k}: shape {shapes.get(k)} != template {want[k]}"
                   for k, v in leaves if shapes.get(k) != want[k]]
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
                    rows = self._shard_rows(read_leaf(zf, key, v.dtype),
                                            names.get(v.data_ptr()))
                comm.scatter_host(v, rows)
        finally:
            if zf is not None:
                zf.close()
        return step

    # -- the tensor-parallel ranks' checkpoint -------------------------------------
    def _leaf_names(self, state: TrainState) -> dict:
        """data_ptr -> parameter name of every per-leaf view of θ and the
        optimizer's parameter-like slots (a (rows,) counter has none)."""
        names = {}
        for buf in [state.theta, *state.opt.values()]:
            if buf.dim() == 2:
                for name, view in self.layout.stacked_views(buf).items():
                    names[view.data_ptr()] = name
        return names

    def _node_shape(self, name: Optional[str], v: torch.Tensor) -> tuple:
        """A checkpoint leaf's per-node shape in the file: the full leaf."""
        if name is None or self.shardings is None:
            return tuple(v.shape[1:]) if self.g > 1 else tuple(v.shape)
        return tuple(self.full_defs[name].shape)

    def _file_shape(self, name: Optional[str], v: torch.Tensor) -> tuple:
        """A checkpoint leaf's shape in the file: (G, *node) stacked, the
        node's leaf itself at G = 1 (the reference's unstacked leaves)."""
        node = self._node_shape(name, v)
        return node if self.g == 1 else (self.g,) + node

    def _shard_rows(self, full: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        """A file leaf (G, *full), or (*full) at G = 1 -> (world, local numel):
        the row of global rank n·r + k is node-rank k (data index, then model
        index) of node n, r ranks a node."""
        rows = self.world_comm.world
        if self.g == 1:
            full = full[None]
        if self.tp is None:
            return full.reshape(rows, -1)
        r = self.node_mesh.size
        if name is None:   # a per-node leaf (AdamW's step count): every rank of the node
            return full.repeat_interleave(r, dim=0).reshape(rows, -1)
        sh = self.shardings[name]
        return torch.stack([shard_leaf(full[n], sh, self.node_mesh.coords(k)).reshape(-1)
                            for n in range(self.g) for k in range(r)])

    def _save_sharded(self, directory: str, state: TrainState, tree, keep: int):
        """``save_checkpoint`` of a tensor-parallel world: every leaf gathered
        to global rank 0's host memory and its shards put together into the
        reference's full (G, ...) leaf (the full leaf at G = 1); rank 0
        alone writes."""
        comm, names = self.world_comm, self._leaf_names(state)
        r = self.node_mesh.size

        def assemble(v):
            def run():
                rows = comm.gather_host(v.contiguous())
                if rows is None:
                    return None
                name = names.get(v.data_ptr())
                local = tuple(v.shape[1:]) if self.g > 1 else tuple(v.shape)
                parts = rows.view((self.g, r) + local)
                if name is None or self.shardings is None:
                    out = parts[:, 0].contiguous()
                else:
                    out = torch.stack([unshard(list(parts[i]), self.shardings[name])
                                       for i in range(self.g)])
                return out[0] if self.g == 1 else out
            return run

        gathered = map_leaves(assemble, tree)
        if comm.rank == 0:
            return save_checkpoint(directory, state.step, gathered, keep=keep,
                                   extra=self.snapshot_extra())
        for _, gather in flatten(gathered):
            held(gather)()
        return None


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
        description="decentralized training launcher (PyTorch port)"
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
                    help="data,model: G gossip nodes, each split over a model axis "
                         "of m ranks (tensor and expert parallelism) under "
                         "torch.distributed.run with G x m processes; on one "
                         "card the G nodes are stacked and m pads the heads.  As "
                         "in the reference, G is the first entry, and kimi-k2 "
                         "(which gossips over pods only) runs at 1,m")
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
        device=dev, mesh=make_mesh((g, tp), ("data", "model")),
    )
    comm = trainer.comm
    rank0 = comm is None or trainer.world_comm.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
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
    if trainer.tp is not None:
        engine += f" | tensor parallel x{tp}"
    if trainer.data_comm is not None:
        engine += f" | data group x{trainer.dp_size} (G = {trainer.g})"
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
        if trainer.g == 1:   # the reference's G = 1 step takes the flat (B, S) batch
            batch = {k: v[0] for k, v in batch.items()}
        epoch = t // args.steps_per_epoch
        state, loss, norms = trainer.train_step(state, batch, args.lr * scale, epoch=epoch)
        if comm is not None:   # every node's loss, for the printout
            loss = comm.all_gather(loss.reshape(-1)).reshape(-1)
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

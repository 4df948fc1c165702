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
node) for ranks; every node's parameters are views into them.  One
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

Faults and checkpoints are later slices; the CLI rejects their flags and
names the ROADMAP item that brings each.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import dbench
from repro_torch.core.buckets import (
    BucketLayout, XiFold, build_bucket_step, check_bucketable,
)
from repro_torch.core.consensus import (
    consensus_distance_shard, consensus_distance_stacked,
)
from repro_torch.core.dsgd import Topology
from repro_torch.core.flat import (
    FlatLayout, node_grads_into, opt_buffers, update_leaves,
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
        """mix_every: gossip once every H optimizer steps (the H−1 local
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
        self.cfg = cfg
        self.topology = topology
        self.optimizer = optimizer
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
        self.layout = FlatLayout.from_shapes({k: d.shape for k, d in self.defs.items()})
        if bucket_mb is not None:
            check_bucketable(optimizer, topology)
        self.bucket_mb = bucket_mb
        self._bucket_layout = (
            None if bucket_mb is None
            else BucketLayout(self.layout.sizes, BucketLayout.elems_for_mb(bucket_mb))
        )
        self._fold = XiFold()
        self.telemetry = telemetry if telemetry is not None else MetricsRecorder()
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
        theta = torch.empty((self.rows, self.layout.size), dtype=self.cfg.dtype,
                            device=self.device)
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
        return node_grads_into(lambda p, b: tfm.loss_fn(p, self.cfg, b), self.layout,
                               theta, grad, batch)

    def _mix(self, program: GossipProgram, x: torch.Tensor) -> torch.Tensor:
        if self.comm is None:
            return program.apply_stacked(x)
        return program.apply_shard(x, self.comm)

    def consensus_distance(self, state: TrainState) -> torch.Tensor:
        """Ξ of the state: over the stacked rows, or across the ranks."""
        if self.comm is None:
            return consensus_distance_stacked(state.theta)
        return consensus_distance_shard(state.theta[0], self.comm)

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
        with torch.no_grad():
            self._fold.probe(topo.controller if self.g > 1 else None, tel, state.step,
                             lambda: self.consensus_distance(state))
        mix = (state.step + 1) % self.mix_every == 0
        # time-varying schedules advance per gossip round, not per raw step
        program = (
            self._program_at(state.step // self.mix_every, epoch)
            if mix and not topo.centralized else None
        )
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
                tel.comm(program, self.layout.size * state.theta.element_size(),
                         step=state.step)
            if topo.centralized:
                # C_complete: average gradients globally (float32, leaf by
                # leaf); replicas stay identical
                for g in self.layout.stacked_views(grad).values():
                    if self.comm is None:
                        g.copy_(g.float().mean(dim=0, keepdim=True).to(g.dtype).expand_as(g))
                    else:
                        g.copy_(self.comm.pmean(g.float().contiguous()))
            split = self._fused_split(program)
            if self._bucketed and program is not None:
                self._bucketed_update(state, grad, lr, program, split)
                bucket_grad = grad
            elif split is None:
                update_leaves(
                    self.optimizer, self._update, self.layout, state.theta, state.opt,
                    self.layout.stacked_views(grad), lr,
                    mix=None if program is None else (lambda x: self._mix(program, x)),
                    mix_order=topo.mix_order,
                )
            else:
                first, rest = split
                if self.comm is not None:
                    fused_apply_shard(
                        first, state.theta[0], grad[0],
                        None if state.mom is None else state.mom[0], self.comm,
                        lr=lr, beta=self.beta, mix_order=topo.mix_order,
                    )
                else:
                    fused_apply_stacked(
                        first, state.theta, grad, state.mom,
                        lr=lr, beta=self.beta, mix_order=topo.mix_order,
                    )
                mix_in_place(rest, state.theta, self._mix)
            del grad
            self._finish_round(losses, norms, t_start, step=state.step, mix=mix, lr=lr,
                               grads=bucket_grad)
        return TrainState(state.theta, state.opt, state.step + 1), losses, norms

    def _bucketed_update(self, state: TrainState, grad, lr, program, split) -> None:
        """A mixing step's update and gossip bucket by bucket, IN PLACE on
        the buckets' column views of θ, m and ``grad``: K1 once per bucket
        with ``split`` (then the later rounds on the same columns), else
        the optimizer and the stacked interpreter.  When the next step
        probes, each bucket's Ξ² partial sum is folded for it."""
        fn = build_bucket_step(program, hyper=self.optimizer.hyper,
                               has_momentum=state.mom is not None, kernel_split=split)
        self._fold.run(fn, self._bucket_layout, state.theta, state.mom, grad, lr,
                       controller=self.topology.controller, telemetry=self.telemetry,
                       step=state.step)

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


# ---------------------------------------------------------------------------
# CLI launcher:  PYTHONPATH=src python -m repro_torch.launch.train --reduced
# ---------------------------------------------------------------------------

def _parser():
    import argparse

    ap = argparse.ArgumentParser(
        description="decentralized training launcher (PyTorch port; flags of "
                    "later slices are parsed and rejected)"
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
                             "deadline", "dropout", "link", "straggler"])
    ap.add_argument("--fault-rate", type=float, default=0.1)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-down-steps", type=int, default=None)
    ap.add_argument("--fault-k", type=int, default=2)
    ap.add_argument("--fault-drain-steps", type=int, default=5)
    ap.add_argument("--fault-enumerate", action="store_true")
    ap.add_argument("--fault-join-steps", default="")
    ap.add_argument("--spare-ranks", type=int, default=0)
    ap.add_argument("--gossip-deadline-ms", type=float, default=30.0)
    ap.add_argument("--deadline-backoff", type=float, default=2.0)
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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--telemetry", default="",
                    help="stream structured run telemetry (JSONL) to this path: "
                         "round spans, comm-bytes counters, loss/xi/lr gauges, "
                         "streamed DBench variance and controller events; read "
                         "it with python -m repro_torch.telemetry summarize PATH")
    ap.add_argument("--metrics-every", type=int, default=10,
                    help="gauge/variance emission cadence in steps (with "
                         "--telemetry; spans and counters are per step)")
    return ap


def _unsupported(args) -> list[str]:
    """Messages for every flag of a later slice that this run sets."""
    out = []
    if args.fault_model != "none" or args.spare_ranks:
        out.append("--fault-model / --spare-ranks (fault injection): "
                   "ROADMAP queue 1 item 3 (faults)")
    if args.ckpt_dir or args.ckpt_every or args.resume:
        out.append("--ckpt-dir / --ckpt-every / --resume (checkpoints): "
                   "ROADMAP queue 1 item 4 (checkpoint)")
    return out


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
    the nodes per step], "trainer", "state"}``."""
    args = _parser().parse_args(argv)
    rejected = _unsupported(args)
    try:
        shape = tuple(int(x) for x in args.mesh.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2:
        raise SystemExit(f"--mesh must be 'data,model', got {args.mesh!r}")
    g, tp = shape
    if tp != 1:
        rejected.append(
            f"--mesh {args.mesh}: a model axis > 1 (tensor parallelism inside a "
            "node) comes after the queue, ROADMAP queue 1 item 8"
        )
    if rejected:
        raise SystemExit("not ported yet:\n  " + "\n  ".join(rejected))
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
    from repro_torch.data import SyntheticLM
    from repro_torch.optim.schedules import lr_scale
    from repro_torch.optim.sgd import get_optimizer

    cfg = get_config(args.arch + ("-reduced" if args.reduced or dev.type == "cpu" else ""))
    cfg = dataclasses.replace(cfg, name=args.arch)
    topo = make_topology(
        args.topology, g, k_floor=k_floor,
        consensus_target=args.consensus_target,
        consensus_spike=args.consensus_spike,
        consensus_probe_every=args.consensus_every,
    )
    recorder = None
    if args.telemetry:
        from repro_torch.telemetry import JsonlSink, MetricsRecorder

        # rank 0 alone writes the stream
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        recorder = MetricsRecorder(
            sinks=[JsonlSink(args.telemetry)] if rank0 else [],
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
        "resumed": False,
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
    src = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, seed=0)
    scale = lr_scale(
        args.lr_scaling, global_batch=g * args.per_node_batch,
        base_batch=max(g * args.per_node_batch, 1), graph_degree=topo.degree_at(0),
    )
    losses = []
    t0 = time.time()
    for t in range(args.steps):
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

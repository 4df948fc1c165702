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
leaf order — parameters (model dtype), gradients (model dtype) and
momentum (float32) — with rows = G stacked, 1 (the rank's own node) for
ranks; every node's parameters are views into them.  One iteration
(paper §2.1 order):

  1. per-node forward and backward, one node at a time (only one node's
     activations are alive), into the gradient buffer;
  2. the DBench probe: per-leaf L2 norms *before* mixing (kernel K3);
  3. c_complete: average gradients over the nodes (ranks: ``pmean``);
     d_*: local momentum-SGD update and gossip mixing θ ← Wθ through the
     step's compiled ``GossipProgram``.

With ``fused_apply`` an all-PPermute program runs update and mixing as one
pass of a fused kernel (``kernels/gossip_update.py``) in place on the
state buffers: K1 over the stacked nodes, K2 on a rank after one permute
per op; programs with AllReduce or GatherRow ops (the complete graph,
``mixing="dense"``) and non-mixing steps take the interpreter, exactly as
the reference does.  Without it the optimizer and the program's stacked
(or, for ranks, shard) interpreter run leaf by leaf, which keeps their
float32 temporaries to one leaf at a time.

Faults, buckets, checkpoints, telemetry, closed-loop Ada and multi-round
fusion are later slices; the CLI rejects their flags and names the ROADMAP
step that brings each.
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
from repro_torch.core.dsgd import Topology
from repro_torch.core.flat import FlatLayout
from repro_torch.core.schedule import GossipProgram, compile_graph, dense_program
from repro_torch.device import resolve_device
from repro_torch.kernels.gossip_update import fused_apply_shard, fused_apply_stacked
from repro_torch.launch.comm import Comm, rank_device
from repro_torch.models import transformer as tfm
from repro_torch.optim.sgd import Optimizer

__all__ = ["SPMDTrainer", "TrainState", "main"]


@dataclasses.dataclass
class TrainState:
    """Training state as flat buffers: G rows stacked, one row on a rank."""

    theta: torch.Tensor            # (rows, P) parameters, model dtype
    mom: Optional[torch.Tensor]    # (rows, P) float32 momentum; None without momentum
    step: int = 0

    def clone(self) -> "TrainState":
        return TrainState(
            self.theta.clone(),
            None if self.mom is None else self.mom.clone(),
            self.step,
        )


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
        fused_apply: bool = False,
        device=None,
    ):
        """mix_every: gossip once every H optimizer steps (the H−1 local
        steps run no mixing).  fused_apply: run optimizer update + gossip
        averaging as one pass of a fused kernel (K1 stacked, K2 on a rank)
        whenever the step's program is all-PPermute; requires plain momentum-SGD.  ``device``: the current
        card by default; ``"cpu"`` runs every kernel's plain twin.  With an
        initialised process group of world size > 1 the trainer is one rank
        of the ranks engine, which raises unless the world size equals the
        topology's node count."""
        if mixing not in ("ppermute", "dense"):
            raise ValueError(f"mixing must be 'ppermute'|'dense', got {mixing!r}")
        hyper = optimizer.hyper or {}
        if hyper.get("kind") != "sgd":
            raise ValueError(
                f"optimizer {optimizer.name} is not ported yet (sgd only): "
                "ROADMAP queue 1 step 3"
            )
        self.fused_apply = bool(fused_apply)
        if self.fused_apply and (hyper.get("nesterov") or hyper.get("weight_decay")):
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

    # -- mixing program -------------------------------------------------------
    def _program_at(self, step: int, epoch: int) -> Optional[GossipProgram]:
        graph = self.topology.graph_at(epoch, step)
        if graph is None:
            return None
        if self.mixing == "dense":
            return dense_program(graph)
        return compile_graph(graph)

    def precompile_programs(self, n_epochs: int = 1) -> list[GossipProgram]:
        """Every distinct program a run will rotate through."""
        progs, seen = [], set()
        for (e, s), _ in self.topology.distinct_programs(n_epochs):
            p = self._program_at(s, e)
            if p is not None and p.cache_key not in seen:
                seen.add(p.cache_key)
                progs.append(p)
        return progs

    def _use_fused(self, program: Optional[GossipProgram]) -> bool:
        """K1 runs one all-PPermute round; everything else takes the
        interpreter (the reference's ``_fused_split``)."""
        return (
            self.fused_apply
            and program is not None
            and not self.topology.centralized
            and program.permute_tables() is not None
        )

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
        mom = None
        if self.beta != 0.0:
            mom = torch.zeros(theta.shape, dtype=torch.float32, device=self.device)
        return TrainState(theta, mom, 0)

    def stacked_params(self, state: TrainState) -> dict[str, torch.Tensor]:
        """(rows, ...) views of every leaf of the state's parameters."""
        return self.layout.stacked_views(state.theta)

    # -- the step ------------------------------------------------------------------
    def _grads_into(self, theta, grad, batch) -> torch.Tensor:
        """Per-node loss and gradients, one node (row) at a time; returns
        (rows,) losses."""
        losses = torch.empty(self.rows, dtype=torch.float32, device=self.device)
        for i in range(self.rows):
            params = {
                k: v.detach().requires_grad_()
                for k, v in self.layout.views(theta[i]).items()
            }
            loss = tfm.loss_fn(params, self.cfg, {k: v[i] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, list(params.values()))
            for view, gi in zip(self.layout.views(grad[i]).values(), grads):
                view.copy_(gi)
            losses[i] = loss.detach()
        return losses

    def _mix(self, program: GossipProgram, x: torch.Tensor) -> torch.Tensor:
        if self.comm is None:
            return program.apply_stacked(x)
        return program.apply_shard(x, self.comm)

    def _interpreted_update(self, state: TrainState, grad, lr, program) -> None:
        """Optimizer update + program interpreter (stacked, or shard on a
        rank), leaf by leaf, written back into the state buffers."""
        order = self.topology.mix_order
        p_views = self.layout.stacked_views(state.theta)
        g_views = self.layout.stacked_views(grad)
        m_views = None if state.mom is None else self.layout.stacked_views(state.mom)
        for name in self.layout.names:
            p = p_views[name]
            if order == "pre" and program is not None:
                p_in = self._mix(program, p)
            else:
                p_in = p
            m_in = () if m_views is None else {name: m_views[name]}
            new_p, new_m = self.optimizer.update(
                {name: g_views[name]}, m_in, {name: p_in}, lr
            )
            out = new_p[name]
            if order == "post" and program is not None:
                out = self._mix(program, out)
            p.copy_(out)
            if m_views is not None:
                m_views[name].copy_(new_m[name])

    def train_step(self, state: TrainState, batch, lr: float, *, epoch: int = 0):
        """One iteration; updates the state's buffers in place and returns
        ``(state, losses (rows,), norms (rows, n_leaves))``: every node's
        stacked, this rank's own on a rank.  ``batch`` holds (G, B, S)
        token arrays (numpy or tensors); a rank moves only its own row."""
        own = slice(None) if self.comm is None else slice(self.comm.rank, self.comm.rank + 1)
        batch = {k: torch.as_tensor(v[own], device=self.device) for k, v in batch.items()}
        topo = self.topology
        mix = (state.step + 1) % self.mix_every == 0
        # time-varying schedules advance per gossip round, not per raw step
        program = (
            self._program_at(state.step // self.mix_every, epoch)
            if mix and not topo.centralized else None
        )
        grad = torch.empty_like(state.theta)
        losses = self._grads_into(state.theta, grad, batch)
        with torch.no_grad():
            norms = (
                dbench.param_l2_norms(state.theta, self.layout)
                if self.collect_norms
                else torch.zeros((self.rows, 0), dtype=torch.float32, device=self.device)
            )
            if topo.centralized:
                # C_complete: average gradients globally (float32, leaf by
                # leaf); replicas stay identical
                for g in self.layout.stacked_views(grad).values():
                    if self.comm is None:
                        g.copy_(g.float().mean(dim=0, keepdim=True).to(g.dtype).expand_as(g))
                    else:
                        g.copy_(self.comm.pmean(g.float().contiguous()))
            if self._use_fused(program) and self.comm is not None:
                fused_apply_shard(
                    program, state.theta[0], grad[0],
                    None if state.mom is None else state.mom[0], self.comm,
                    lr=lr, beta=self.beta, mix_order=topo.mix_order,
                )
            elif self._use_fused(program):
                fused_apply_stacked(
                    program, state.theta, grad, state.mom,
                    lr=lr, beta=self.beta, mix_order=topo.mix_order,
                )
            else:
                self._interpreted_update(state, grad, lr, program)
        del grad
        return TrainState(state.theta, state.mom, state.step + 1), losses, norms


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
    ap.add_argument("--mix-rounds", type=int, default=1)
    ap.add_argument("--hub-balance", action="store_true")
    ap.add_argument("--fused-apply", action="store_true",
                    help="run optimizer+gossip as one pass of the fused CUDA "
                         "kernel for all-PPermute programs (plain momentum-SGD)")
    ap.add_argument("--bucket-mb", type=float, default=None)
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
    ap.add_argument("--consensus-target", type=float, default=None)
    ap.add_argument("--consensus-every", type=int, default=1)
    ap.add_argument("--consensus-spike", type=float, default=None)
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
    ap.add_argument("--telemetry", default="")
    ap.add_argument("--metrics-every", type=int, default=10)
    return ap


def _unsupported(args) -> list[str]:
    """Messages for every flag of a later slice that this run sets."""
    out = []
    if args.mix_rounds != 1 or args.hub_balance:
        out.append("--mix-rounds > 1 / --hub-balance (fused multi-round gossip): "
                   "ROADMAP queue 1 step 8")
    if args.bucket_mb is not None:
        out.append("--bucket-mb (overlap-scheduled buckets): ROADMAP queue 1 step 10")
    if args.fault_model != "none" or args.spare_ranks:
        out.append("--fault-model / --spare-ranks (fault injection): "
                   "ROADMAP queue 1 step 10")
    if args.ckpt_dir or args.ckpt_every or args.resume:
        out.append("--ckpt-dir / --ckpt-every / --resume (checkpoints): "
                   "ROADMAP queue 1 step 10")
    if args.telemetry:
        out.append("--telemetry (run telemetry): ROADMAP queue 1 step 11")
    if (args.consensus_target is not None or args.consensus_spike is not None
            or args.consensus_every != 1):
        out.append("--consensus-* (closed-loop Ada): ROADMAP queue 1 step 7")
    if args.optimizer != "sgd":
        out.append(f"--optimizer {args.optimizer}: ROADMAP queue 1 step 3")
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
            "node) comes after ROADMAP queue 1 step 13"
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
    topo = make_topology(args.topology, g, k_floor=k_floor)
    trainer = SPMDTrainer(
        cfg, topo, get_optimizer(args.optimizer), collect_norms=True,
        mixing=args.mixing, mix_every=args.mix_every,
        fused_apply=args.fused_apply, device=dev,
    )
    comm = trainer.comm
    say = print if comm is None or comm.rank == 0 else (lambda *a, **k: None)
    # report the apply path the step will ACTUALLY take: fused_apply takes
    # the interpreter for non-PPermute programs (complete, dense)
    apply_mode = "interpreter"
    if args.fused_apply and trainer._use_fused(trainer._program_at(0, 0)):
        apply_mode = "fused kernel " + ("K1" if comm is None else "K2")
    elif args.fused_apply:
        apply_mode = "interpreter (program not fused-eligible)"
    engine = "stacked" if comm is None else f"ranks | transport {comm.transport}"
    say(topo.describe(), "| mesh", {"data": g, "model": tp}, "| mixing",
        args.mixing, "| engine", engine, "| rounds 1 | apply", apply_mode,
        "| device", dev)
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
    return {"losses": losses, "trainer": trainer, "state": state}


if __name__ == "__main__":
    main()

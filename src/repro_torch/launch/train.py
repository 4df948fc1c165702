"""Decentralized training engine and CLI: the counterpart of
``repro/launch/train.py``.

``SPMDTrainer`` is the reference's *stacked* realization with all G gossip
nodes held on one card.  The state is three flat (G, P) buffers
(``core/flat.py``) in the reference's leaf order — parameters (model dtype),
gradients (model dtype) and momentum (float32) — and every node's
parameters are views into them.  One iteration (paper §2.1 order):

  1. per-node forward and backward, one node at a time (only one node's
     activations are alive), into the gradient buffer;
  2. the DBench probe: per-leaf L2 norms *before* mixing (kernel K3);
  3. c_complete: average gradients over the nodes;
     d_*: local momentum-SGD update and gossip mixing θ ← Wθ through the
     step's compiled ``GossipProgram``.

With ``fused_apply`` an all-PPermute program runs update and mixing as one
pass of kernel K1 (``kernels/gossip_update.py``), in place on the state
buffers; programs with AllReduce or GatherRow ops (the complete graph,
``mixing="dense"``) and non-mixing steps take the interpreter, exactly as
the reference does.  Without it the optimizer and the program's stacked
interpreter run leaf by leaf, which keeps their float32 temporaries to one
leaf at a time.

The multi-card trainer (one rank per node over NCCL), faults, buckets,
checkpoints, telemetry, closed-loop Ada and multi-round fusion are later
slices; the CLI rejects their flags and names the ROADMAP step that brings
each.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from repro_torch.core import dbench
from repro_torch.core.dsgd import Topology
from repro_torch.core.flat import FlatLayout
from repro_torch.core.schedule import GossipProgram, compile_graph, dense_program
from repro_torch.device import resolve_device
from repro_torch.kernels.gossip_update import fused_apply_stacked
from repro_torch.models import transformer as tfm
from repro_torch.optim.sgd import Optimizer

__all__ = ["SPMDTrainer", "TrainState", "main"]


@dataclasses.dataclass
class TrainState:
    """Gossip-stacked training state as flat buffers."""

    theta: torch.Tensor            # (G, P) parameters, model dtype
    mom: Optional[torch.Tensor]    # (G, P) float32 momentum; None without momentum
    step: int = 0

    def clone(self) -> "TrainState":
        return TrainState(
            self.theta.clone(),
            None if self.mom is None else self.mom.clone(),
            self.step,
        )


class SPMDTrainer:
    """Runs the decentralized train step for one (arch × topology) on one card."""

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
        averaging as one pass of kernel K1 whenever the step's program is
        all-PPermute; requires plain momentum-SGD.  ``device``: the card by
        default; ``"cpu"`` runs every kernel's plain twin."""
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
        theta = torch.empty((self.g, self.layout.size), dtype=self.cfg.dtype,
                            device=self.device)
        for name, view in self.layout.views(theta[0]).items():
            if tuple(params[name].shape) != tuple(view.shape):
                raise ValueError(
                    f"{name}: shape {tuple(params[name].shape)} != {tuple(view.shape)}"
                )
            view.copy_(params[name])
        theta[1:].copy_(theta[:1].expand(self.g - 1, -1))
        mom = None
        if self.beta != 0.0:
            mom = torch.zeros(theta.shape, dtype=torch.float32, device=self.device)
        return TrainState(theta, mom, 0)

    def stacked_params(self, state: TrainState) -> dict[str, torch.Tensor]:
        """(G, ...) views of every leaf of the state's parameters."""
        return self.layout.stacked_views(state.theta)

    # -- the step ------------------------------------------------------------------
    def _grads_into(self, theta, grad, batch) -> torch.Tensor:
        """Per-node loss and gradients, one node at a time; returns (G,) losses."""
        losses = torch.empty(self.g, dtype=torch.float32, device=self.device)
        for i in range(self.g):
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

    def _interpreted_update(self, state: TrainState, grad, lr, program) -> None:
        """Optimizer update + program interpreter, leaf by leaf, written back
        into the state buffers."""
        order = self.topology.mix_order
        p_views = self.layout.stacked_views(state.theta)
        g_views = self.layout.stacked_views(grad)
        m_views = None if state.mom is None else self.layout.stacked_views(state.mom)
        for name in self.layout.names:
            p = p_views[name]
            if order == "pre" and program is not None:
                p_in = program.apply_stacked(p)
            else:
                p_in = p
            m_in = () if m_views is None else {name: m_views[name]}
            new_p, new_m = self.optimizer.update(
                {name: g_views[name]}, m_in, {name: p_in}, lr
            )
            out = new_p[name]
            if order == "post" and program is not None:
                out = program.apply_stacked(out)
            p.copy_(out)
            if m_views is not None:
                m_views[name].copy_(new_m[name])

    def train_step(self, state: TrainState, batch, lr: float, *, epoch: int = 0):
        """One iteration; updates the state's buffers in place and returns
        ``(state, losses (G,), norms (G, n_leaves))``.  ``batch`` holds
        (G, B, S) token arrays (numpy or tensors)."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
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
                else torch.zeros((self.g, 0), dtype=torch.float32, device=self.device)
            )
            if topo.centralized:
                # C_complete: average gradients globally; replicas stay identical
                for g in self.layout.stacked_views(grad).values():
                    g.copy_(g.float().mean(dim=0, keepdim=True).to(g.dtype).expand_as(g))
            if self._use_fused(program):
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
                    help="data,model: G gossip nodes on one card; model must be 1")
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


def main(argv=None, *, device=None) -> dict:
    """Run the CLI; ``device`` (a keyword, not a flag) selects the CPU for
    tests.  Returns ``{"losses": [mean loss per step], "trainer", "state"}``."""
    from repro_torch.configs import get_config
    from repro_torch.core.dsgd import make_topology
    from repro_torch.data import SyntheticLM
    from repro_torch.optim.schedules import lr_scale
    from repro_torch.optim.sgd import get_optimizer

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
            "node) comes after ROADMAP queue 1 step 13; the multi-card "
            "one-rank-per-node trainer is step 9"
        )
    if rejected:
        raise SystemExit("not ported yet:\n  " + "\n  ".join(rejected))
    dev = resolve_device(device)
    cfg = get_config(args.arch + ("-reduced" if args.reduced or dev.type == "cpu" else ""))
    cfg = dataclasses.replace(cfg, name=args.arch)
    if args.k_floor == "one_peer":
        k_floor = "one_peer"
    else:
        try:
            k_floor = int(args.k_floor)
        except ValueError:
            raise SystemExit(
                f"--k-floor must be an integer or 'one_peer', got {args.k_floor!r}"
            )
    topo = make_topology(args.topology, g, k_floor=k_floor)
    trainer = SPMDTrainer(
        cfg, topo, get_optimizer(args.optimizer), collect_norms=True,
        mixing=args.mixing, mix_every=args.mix_every,
        fused_apply=args.fused_apply, device=dev,
    )
    # report the apply path the step will ACTUALLY take: fused_apply takes
    # the interpreter for non-PPermute programs (complete, dense)
    apply_mode = "interpreter"
    if args.fused_apply and trainer._use_fused(trainer._program_at(0, 0)):
        apply_mode = "fused kernel K1"
    elif args.fused_apply:
        apply_mode = "interpreter (program not fused-eligible)"
    print(topo.describe(), "| mesh", {"data": g, "model": tp}, "| mixing",
          args.mixing, "| engine stacked | rounds 1 | apply", apply_mode,
          "| device", dev)
    n_progs = len(trainer.precompile_programs(args.steps // args.steps_per_epoch + 1))
    print(f"{n_progs} distinct mixing program(s) over the run")
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
        losses.append(float(loss.mean()))
        if not math.isfinite(losses[-1]):
            raise SystemExit(f"step {t}: loss is not finite ({losses[-1]})")
        if t % 5 == 0 or t == args.steps - 1:
            print(f"step {t:4d} k={topo.degree_at(epoch, t)} loss={losses[-1]:.4f} "
                  f"spread={float(loss.max() - loss.min()):.4f}")
    print(f"{args.steps} steps in {time.time() - t0:.1f}s")
    return {"losses": losses, "trainer": trainer, "state": state}


if __name__ == "__main__":
    main()

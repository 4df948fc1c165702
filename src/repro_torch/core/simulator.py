"""Paper-faithful multi-node simulator (the DBench engine): the counterpart
of ``repro/core/simulator.py``.

Simulates an n-node (de)centralized data-parallel run on one device.  The
state is flat: parameters as one (n, P) buffer in the model's dtype and
each optimizer-state slot as one (n, P) float32 buffer (``core/flat.py``),
with every node's leaves as views into them, in the reference's leaf
order; the DBench probe (kernel K3) and the consensus probe read the
buffers in place.  Mixing interprets the same compiled ``GossipProgram``
as the trainers: the dense-matrix interpreter (the paper's equation,
§2.2) by default, so this engine is the port's correctness oracle.

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
interpreter per bucket, as in the reference) instead of leaf by leaf, bit
for bit the same numbers, and folds Ξ² into the buckets when the next
step probes (``XiFold``), so that probe reads the fold: an eager
reduction over each bucket after its mix, about the standalone probe's
cost until a fused fold kernel exists.  ``telemetry``
takes a ``repro_torch.telemetry.MetricsRecorder``: comm billed at
dispatch, the loss, lr, Ξ (and, on the bucketed path, gradient-norm)
gauges, round and bucket spans, the streamed DBench variance and the
controller's events.

Faults and elastic membership, node sharding and the retrace guard are
later slices (ROADMAP queue 1 items 3 and 7); their arguments raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import dbench
from repro_torch.core.buckets import (
    BucketLayout, XiFold, build_bucket_step, check_bucketable,
)
from repro_torch.core.consensus import consensus_distance_stacked
from repro_torch.core.dsgd import Topology
from repro_torch.core.flat import (
    FlatLayout, node_grads_into, opt_buffers, update_leaves,
)
from repro_torch.device import resolve_device
from repro_torch.models.common import flatten_tree
from repro_torch.optim.sgd import Optimizer
from repro_torch.telemetry import MetricsRecorder

__all__ = ["SimState", "DecentralizedSimulator"]

_ENGINES = {"dense": "dense", "shift": "stacked", "stacked": "stacked"}


@dataclasses.dataclass
class SimState:
    """Flat simulator state: ``theta`` (n, P) in the model dtype, ``opt``
    one (n, P) float32 buffer per optimizer slot (and ``"t"``, (n,) int32,
    for a step-counted optimizer), laid out by ``layout``."""

    theta: torch.Tensor
    opt: dict
    layout: FlatLayout
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """(n, ...) views of every leaf, in leaf order."""
        return self.layout.stacked_views(self.theta)

    def node_params(self, i: int) -> dict[str, torch.Tensor]:
        return self.layout.views(self.theta[i])

    def mean_params(self) -> dict[str, torch.Tensor]:
        """The final model θ = average over all θ_i (paper §2.2)."""
        return {k: v.float().mean(dim=0).to(v.dtype) for k, v in self.params.items()}


def _later_slice(arg: str, item: str) -> ValueError:
    return ValueError(f"{arg} is not ported yet: ROADMAP queue 1 item {item}")


class DecentralizedSimulator:
    """Engine for centralized/decentralized training of n nodes on one device."""

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
          mixing: "dense" (the matrix product) or "shift" (rolls and
            gathers over the node axis).
          mix_every / mix_rounds / hub_balance: as in the reference.
          node_loop: gradients one node at a time instead of under vmap.
          device: the current CUDA card by default; ``"cpu"`` on request.
          bucket_mb: run each mixing step bucket by bucket, ~bucket_mb MiB
            of float32 per bucket; SGD-family optimizers, decentralized
            topologies and ``mix_order="post"`` only.
          telemetry: the run's ``MetricsRecorder`` (an inert one by
            default, which costs nothing).
        """
        if mixing not in _ENGINES:
            raise ValueError(
                f"mixing must be one of {sorted(_ENGINES)}, got {mixing!r}"
            )
        if getattr(topology, "fault_model", None) is not None:
            raise _later_slice("a fault model", "3 (faults)")
        if shard_nodes:
            raise _later_slice("shard_nodes=True (virtual-node sharding)", "7 (tooling)")
        if debug_no_retrace:
            raise _later_slice("debug_no_retrace=True (the recompile guard)", "7 (tooling)")
        if bucket_mb is not None:
            check_bucketable(optimizer, topology)
        self.bucket_mb = bucket_mb
        self.telemetry = telemetry if telemetry is not None else MetricsRecorder()
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
        self._update = torch.func.vmap(optimizer.update, in_dims=(0, 0, 0, None))

    # -- state ----------------------------------------------------------------
    def init(self, params: Mapping) -> SimState:
        """Broadcast one replica (a nested or flat dict of tensors or
        arrays, one dtype) to all nodes (paper: identical replicas)."""
        flat = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                for k, v in flatten_tree(params).items()}
        dtypes = {v.dtype for v in flat.values()}
        if len(dtypes) != 1:
            raise ValueError(f"the flat state holds one dtype; got {sorted(map(str, dtypes))}")
        layout = FlatLayout.from_shapes({k: tuple(v.shape) for k, v in flat.items()})
        theta = torch.empty((self.n, layout.size), dtype=dtypes.pop(), device=self.device)
        for name, view in layout.views(theta[0]).items():
            view.copy_(flat[name])
        theta[1:].copy_(theta[:1].expand(self.n - 1, -1))
        opt = opt_buffers(self.optimizer, layout, theta)
        return SimState(theta, opt, layout, 0)

    # -- one training step ------------------------------------------------------
    def _grads(self, state: SimState, batch, rng):
        """(losses (n,) float32, grads {leaf: (n, ...)}, the flat (n, P)
        gradient buffer the grads are views of, or None under vmap)."""
        if not self.node_loop:
            grads, losses = torch.func.vmap(torch.func.grad_and_value(self.loss_fn))(
                state.params, batch)
            return losses.float(), grads, None
        grad = torch.empty_like(state.theta)
        extra = (rng,) if self.has_rng else ()
        losses = node_grads_into(self.loss_fn, state.layout, state.theta, grad, batch, *extra)
        return losses, state.layout.stacked_views(grad), grad

    def _resolve_program(self, step: int, epoch: int):
        """This gossip round's (fused) program."""
        return self.topology.fused_program_at(
            step=step, epoch=epoch, rounds=self.mix_rounds,
            hub_balance=self.hub_balance,
        )

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
        topo = self.topology
        self._fold.probe(topo.controller, tel, state.step,
                         lambda: consensus_distance_stacked(state.theta))
        mix = (state.step + 1) % self.mix_every == 0
        # time-varying schedules advance per gossip round, not per raw step
        program = None
        if mix and not topo.centralized:
            program = self._resolve_program(state.step // self.mix_every, epoch)
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if self.has_rng and rng is None:
            rng = torch.Generator(device=self.device).manual_seed(0)
        losses, grads, flat_grad = self._grads(state, batch, rng)
        with torch.no_grad():
            norms = (
                dbench.param_l2_norms(state.theta, state.layout)
                if self.collect_norms
                else torch.zeros((self.n, 0), dtype=torch.float32, device=self.device)
            )
            if program is not None:
                tel.comm(program, state.theta.shape[1] * state.theta.element_size(),
                         step=state.step)
            engine = _ENGINES[self.mixing]
            bucket_grad = None   # the gradient buffer of a bucketed step
            if self.bucket_mb is not None and program is not None:
                bucket_grad = self._bucketed_update(state, grads, flat_grad, lr, program,
                                                    engine)
            else:
                if topo.centralized:
                    # C_complete: average gradients globally; replicas stay identical
                    grads = {k: g.float().mean(dim=0, keepdim=True).to(g.dtype).expand_as(g)
                             for k, g in grads.items()}
                update_leaves(
                    self.optimizer, self._update, state.layout, state.theta, state.opt, grads,
                    lr, mix_order=topo.mix_order,
                    mix=None if program is None else (lambda x: program.apply(x, engine=engine)),
                )
        self._finish_round(losses, norms, t_start, step=state.step, mix=mix, lr=lr,
                           grads=bucket_grad)
        return SimState(state.theta, state.opt, state.layout, state.step + 1), losses, norms

    def _bucketed_update(self, state: SimState, grads, flat_grad, lr, program, engine):
        """A mixing step's update and gossip bucket by bucket, IN PLACE on
        the buckets' column views of θ, m and the gradient buffer; when the
        next step probes, each bucket's Ξ² partial sum is folded into a
        running (n,) token for it.  Returns the flat gradient buffer."""
        grad = flat_grad if flat_grad is not None else state.layout.flatten(grads)
        mom = state.opt.get("mom")
        fn = build_bucket_step(program, hyper=self.optimizer.hyper,
                               has_momentum=mom is not None, engine=engine)
        self._fold.run(fn, BucketLayout.for_stacked(state.params, self.bucket_mb),
                       state.theta, mom, grad, lr, controller=self.topology.controller,
                       telemetry=self.telemetry, step=state.step)
        return grad

    def _finish_round(self, losses, norms, t_start, *, step: int, mix: bool, lr: float,
                      grads=None) -> None:
        """Post-step telemetry: closes the ``round`` span (after a device
        synchronize, only when the recorder times rounds) and, at the
        metrics cadence, emits the loss/lr/variance (and gradient-norm)
        sample, reading each device value once."""
        tel = self.telemetry
        tel.round_end(t_start, step=step, mix=mix, device=self.device)
        if tel.due(step):
            tel.step_metrics(step, loss=losses, lr=lr,
                             norms=norms if self.collect_norms else None, grads=grads)

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

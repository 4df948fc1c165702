"""End-to-end decentralized training with tensor parallelism inside each
node: the counterpart of ``examples/train_100m.py``.

A (4 data × 2 model) world of 8 ranks: 4 gossip nodes, each split over 2
ranks (``SPMDTrainer``'s tensor-parallel ranks engine), the Ada graph
schedule (k0 3, gamma_k 0.5), DBench probes, checkpoints (a run resumes
from the latest one in ``--ckpt-dir``) and warmup + multistep LR with the
paper's sqrt scaling policy.  Each rank's update and first gossip round
run fused (K2; its plain twin on the CPU).  ``main`` spawns the world on
this machine (``launch/comm.spawn_world``): gloo on the CPU
(``device="cpu"``), NCCL with a card per rank, else gloo through pinned
host buffers on the one card.

  PYTHONPATH=src python -m repro_torch.examples.train_100m              # smoke
  PYTHONPATH=src python -m repro_torch.examples.train_100m --preset 100m \\
      --steps 300                                                       # ~134M

The 100m preset is the reference's "train a ~100M model for a few hundred
steps" configuration; the smoke preset runs the same code path at toy
scale.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs.base import ArchConfig
from repro_torch.core.dbench import DBenchRecorder
from repro_torch.core.dsgd import make_topology
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.comm import spawn_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import SPMDTrainer, TrainState
from repro_torch.models.common import param_count
from repro_torch.optim.schedules import lr_scale, warmup_multistep
from repro_torch.optim.sgd import sgd

MESH = (4, 2)   # (data, model): 4 gossip nodes, each split over 2 ranks

PRESETS = {
    "smoke": dict(d_model=128, n_layers=4, d_ff=512, vocab=512, seq=64,
                  heads=4, kv=2, per_node_batch=4, base_lr=0.3),
    "100m": dict(d_model=768, n_layers=12, d_ff=3072, vocab=32000, seq=256,
                 heads=12, kv=4, per_node_batch=4, base_lr=0.1),
}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="smoke", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--topology", default="d_ada")
    ap.add_argument("--mixing", default="ppermute", choices=["ppermute", "dense"])
    ap.add_argument("--ckpt-dir", default="build/repro_torch/train_100m_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds the world may run before it is ended")
    return ap


def run(argv=None, *, comm) -> dict:
    """The example on this rank of an initialised world (``comm``: its
    ``Comm``).  Returns ``{"start", "losses", "step_ms", "gini", "theta",
    "n_params", "launches", "trainer", "state"}``: the step it began from,
    the mean loss over the nodes per step, the step times, the first and
    last mean Gini of the parameter norms (None when no step ran), this
    rank's final shard row, the model's parameter count and the kernel
    launches of its steps."""
    args = _parser().parse_args(argv)
    p = PRESETS[args.preset]
    g, tp = MESH
    say = print if comm.rank == 0 else (lambda *a, **k: None)
    cfg = ArchConfig(
        name="granite-8b",  # dense family code path; gossip over "data"
        family="dense", n_layers=p["n_layers"], d_model=p["d_model"], d_ff=p["d_ff"],
        vocab=p["vocab"], n_heads=p["heads"], n_kv=p["kv"], dtype=torch.float32,
        remat=False,
    )
    topo = make_topology(
        args.topology, g, **({"k0": 3, "gamma_k": 0.5} if args.topology == "d_ada" else {}))
    trainer = SPMDTrainer(cfg, topo, sgd(momentum=0.9), collect_norms=True,
                          mixing=args.mixing, fused_apply=True,
                          mesh=make_mesh((g, tp), ("data", "model")), device=comm.device)
    n_params = param_count(trainer.full_defs)
    say(f"model: {n_params / 1e6:.1f}M params | mesh {trainer.mesh.shape} | "
        f"{topo.describe()} | mixing={args.mixing} | transport {comm.transport}")

    state = trainer.init_state(seed=0)
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        start = trainer.restore_checkpoint(args.ckpt_dir, state)
        state = TrainState(state.theta, state.opt, start)
        say(f"resumed from step {start}")

    # paper Table 2: sqrt LR scaling by global batch and graph degree (Obs. 3)
    scale = lr_scale("sqrt", global_batch=g * p["per_node_batch"], base_batch=32,
                     graph_degree=topo.degree_at(0))
    sched = warmup_multistep(p["base_lr"], steps_per_epoch=args.steps_per_epoch,
                             warmup_epochs=1, milestones=(30, 60, 80), scale=scale)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=p["seq"], seed=0, structure=0.9)
    rec = DBenchRecorder(impl=args.topology, n_nodes=g)
    gossip = trainer.comm
    losses, step_ms = [], []
    ops.reset_launch_counts()
    t_start = time.time()
    for t in range(start, args.steps):
        batch = src.stacked(g, t, p["per_node_batch"])
        epoch = t // args.steps_per_epoch
        t1 = time.perf_counter()
        state, loss, norms = trainer.train_step(state, batch, sched(t), epoch=epoch)
        if comm.device.type == "cuda":
            torch.cuda.synchronize(comm.device)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        # every node's loss and norms (each shard index's gossip group gathers)
        loss = gossip.all_gather(loss).reshape(-1).cpu().numpy()
        rec.record(t, loss, gossip.all_gather(norms[0].contiguous()).cpu().numpy())
        losses.append(float(loss.mean()))
        if t % 5 == 0 or t == args.steps - 1:
            say(f"step {t:4d} epoch {epoch} k={topo.degree_at(epoch)} lr={sched(t):.4f} "
                f"loss={loss.mean():.4f} spread={loss.max() - loss.min():.4f}")
        if args.ckpt_every and (t + 1) % args.ckpt_every == 0:
            path = trainer.save_checkpoint(args.ckpt_dir, state)
            if path:
                say(f"  checkpoint -> {path}")
    launches = ops.launch_counts()
    dt = time.time() - t_start
    n_steps = args.steps - start
    say(f"\n{n_steps} steps in {dt:.1f}s ({dt / max(n_steps, 1):.2f}s/step)")
    gini = None
    if rec.norms:
        series = rec.metric_series("gini")
        gini = (float(series[0].mean()), float(series[-1].mean()))
        say(f"gini(param norms): first={gini[0]:.5f} last={gini[1]:.5f}")
    return {"start": start, "losses": losses, "step_ms": step_ms, "gini": gini,
            "theta": state.theta[0].cpu().numpy(), "n_params": n_params,
            "launches": launches, "trainer": trainer, "state": state}


def _rank_main(comm, argv):
    res = run(argv, comm=comm)
    res.pop("trainer")
    res.pop("state")
    return res


def main(argv=None, *, device=None) -> list:
    """Spawn the (data × model) world on this machine and run the example
    on every rank (on the card unless ``device="cpu"``); returns every
    rank's result, in rank order (rank i·m + j is shard j of node i)."""
    args = _parser().parse_args(argv)
    return spawn_world(_rank_main, MESH[0] * MESH[1], (argv,), timeout=args.timeout,
                       device=device)


if __name__ == "__main__":
    main()

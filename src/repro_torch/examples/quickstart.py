"""Quickstart: decentralized data-parallel training in a page, the
counterpart of ``examples/quickstart.py``.

Trains a small transformer LM on 8 simulated gossip nodes with the Ada
adaptive communication graph and prints the DBench variance probe as the
graph anneals from dense to sparse.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 60]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.dbench import DBenchRecorder, gini
from repro_torch.core.dsgd import make_topology
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.data import SyntheticLM, node_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.optim import constant, get_optimizer

N_NODES = 8
STEPS_PER_EPOCH = 10


def main(argv=None, *, device=None) -> dict:
    """Run the quickstart (on the card unless ``device`` says otherwise);
    returns ``{"history", "recorder", "state"}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    # a small dense-family config (same code path as the 8B assigned arch)
    cfg = dataclasses.replace(
        get_config("granite-8b-reduced"),
        d_model=128, n_heads=4, n_kv=2, d_head=32, d_ff=256, vocab=256,
        dtype=torch.float32, remat=False,
    )

    # Ada: start densely connected, anneal to a ring (paper Algorithm 1)
    topology = make_topology("d_ada", N_NODES, k0=6, gamma_k=1.0)
    print(topology.describe())

    sim = DecentralizedSimulator(
        loss_fn=lambda p, b: tfm.loss_fn(p, cfg, b),
        optimizer=get_optimizer("adamw", weight_decay=0.0),
        topology=topology,
        collect_norms=True,
        device=dev,
    )

    src = SyntheticLM(vocab=cfg.vocab, seq_len=32, seed=0, structure=0.9)
    params0 = tfm.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    recorder = DBenchRecorder(impl="d_ada", n_nodes=N_NODES)

    state, hist = sim.run(
        params0,
        node_batch_iterator(src, N_NODES, per_node_batch=4, device=dev),
        n_steps=args.steps,
        lr_schedule=constant(1e-2),
        steps_per_epoch=STEPS_PER_EPOCH,
        recorder=recorder,
    )

    print(f"\n{'step':>5} {'loss':>8} {'gini(param norms)':>18} {'graph degree':>13}")
    for i, t in enumerate(recorder.iterations):
        if t % 10 == 0:
            g = float(gini(recorder.norms[i]).mean())
            deg = topology.degree_at(t // STEPS_PER_EPOCH)
            print(f"{t:5d} {recorder.losses[i].mean():8.4f} {g:18.5f} {deg:13d}")

    print(f"\nfinal mean-replica loss: {hist['loss'][-1]:.4f} "
          f"(from {hist['loss'][0]:.4f})")
    spread = max(float((v - v.mean(dim=0)).abs().max()) for v in state.params.values())
    print("replica consensus spread:", spread)
    return {"history": hist, "recorder": recorder, "state": state,
            "final_loss": float(np.asarray(hist["loss"][-1]))}


if __name__ == "__main__":
    main()

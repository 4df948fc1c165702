"""Step times of the port's mixing interpreters on the card, to compare two
trees of the package in one call:

    python3 tools/interpreter_step_times.py --src SRC [--steps N]

imports ``repro_torch`` from ``SRC`` (this tree's ``src`` by default, or an
unpacked older commit's) and, on the current CUDA card, times N steps (at
most 6 of the granite runs) after two warm-up steps, the card synchronized
after each, of:

* phase 15's simulator runs (``chip_smoke.py``): the mini-ResNet closed-loop
  Ada and the LSTM on d_ring, 16 nodes, dense mixing, norms on K3;
* the same ResNet run with shift mixing (the stacked interpreter) and with
  shift mixing under dropout faults (the masked interpreter);
* phase 13's trainer through the interpreter: granite-8b ×2 layers, G 4,
  d_ring, ``ppermute`` mixing (``apply_stacked``), ``fused_apply=False``;
* phase 16's interpreter run: that trainer with dense mixing, bucket_mb 64;
* phase 36's granite-8b simulator, unsplit: G 4, shift mixing, one node's
  gradients at a time;
* the interpreters alone on 20 small leaves (16, 8, 4) float32 with the
  ResNet run's first program (d_ada, 16 nodes, 12 offsets): stacked,
  masked (one node dead) and dense, the host's dispatch more than the
  card's work ("call" entries, ms a call).

The inputs and settings are ``chip_smoke.py``'s.  Prints the card's name
and power limit, then one JSON line: each run's step times and median.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def timed(step, state, inputs, warm=2):
    """Run ``step(state, t, x) -> state`` over ``inputs``; the ms of each
    step after the first ``warm``, the card synchronized after each."""
    import torch

    out = []
    for t, x in enumerate(inputs):
        t1 = time.perf_counter()
        state = step(state, t, x)
        torch.cuda.synchronize()
        if t >= warm:
            out.append((time.perf_counter() - t1) * 1e3)
    return out


def sim_runs(cs, dev, steps):
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.faults import make_fault_model
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.models.paper_models import lstm_loss, mini_resnet_loss
    from repro_torch.optim.sgd import sgd

    out = {}
    for label, name, mixing, fault in (
            ("phase 15 resnet closed-loop Ada, dense", "resnet closed-loop Ada", "dense", None),
            ("phase 15 lstm d_ring, dense", "lstm variance d_ring", "dense", None),
            ("resnet closed-loop Ada, shift", "resnet closed-loop Ada", "shift", None),
            ("resnet closed-loop Ada, shift, dropout 0.3", "resnet closed-loop Ada", "shift",
             "dropout")):
        params, batches = cs.paper_inputs(name, steps + 2)
        fm = None if fault is None else make_fault_model(fault, cs.PAPER_N, rate=0.3, seed=3)
        if name.startswith("resnet"):
            topo = make_topology("d_ada", cs.PAPER_N, k0=12, k_floor="one_peer",
                                 consensus_target=0.7, consensus_probe_every=5,
                                 fault_model=fm)
            loss = mini_resnet_loss
        else:
            topo, loss = make_topology("d_ring", cs.PAPER_N), lstm_loss
        sim = DecentralizedSimulator(loss, sgd(momentum=0.9), topo, collect_norms=True,
                                     device=dev, mixing=mixing)
        lr = cs.PAPER_RUNS[name]["lr"]
        out[label] = timed(lambda s, t, b: sim.train_step(s, b, lr, epoch=t // 5)[0],
                           sim.init(params), batches)
    return out


def granite_runs(cs, dev, steps):
    import torch
    from repro_torch.core.dsgd import make_topology
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import SPMDTrainer
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.sgd import sgd

    cfg, _ = cs.granite_layout()
    src = SyntheticLM(vocab=cfg.vocab, seq_len=cs.SEQ, seed=0)
    batches = [src.stacked(cs.G, t, cs.BATCH) for t in range(steps + 2)]
    tag = f"granite-8b x{cfg.n_layers} {str(cfg.dtype).replace('torch.', '')} G {cs.G}"
    out = {}
    for label, kw in ((f"phase 13 trainer {tag}, ppermute, interpreter", {}),
                      (f"phase 16 trainer {tag}, dense, bucket_mb 64, interpreter",
                       {"mixing": "dense", "bucket_mb": 64})):
        trainer = SPMDTrainer(cfg, make_topology("d_ring", cs.G), sgd(momentum=0.9),
                              collect_norms=True, fused_apply=False, **kw)
        out[label] = timed(lambda s, t, b: trainer.train_step(s, b, cs.LR)[0],
                           trainer.init_state(seed=0), batches)
        del trainer
        torch.cuda.empty_cache()
    sim = DecentralizedSimulator(lambda p, b: tfm.loss_fn(p, cfg, b), sgd(momentum=0.9),
                                 make_topology("d_ring", cs.G), mixing="shift",
                                 collect_norms=True, node_loop=True, device=dev)
    state = sim.init(tfm.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev))
    gpu = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()} for b in batches]
    out[f"phase 36 simulator {tag}, shift, node loop, unsplit"] = timed(
        lambda s, t, b: sim.train_step(s, b, cs.LR)[0], state, gpu)
    return out


def interpreter_calls(dev, calls):
    import numpy as np
    import torch
    from repro_torch.core.dsgd import make_topology

    topo = make_topology("d_ada", 16, k0=12, k_floor="one_peer", consensus_target=0.7)
    prog = topo.fused_program_at(step=0, epoch=0, rounds=1, hub_balance=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = {f"l{i}": torch.randn((16, 8, 4), generator=gen, device=dev) for i in range(20)}
    alive = np.ones(16, np.float32)
    alive[2] = 0.0
    out = {}
    for label, fn in (("stacked", lambda: prog.apply_stacked(leaves)),
                      ("masked", lambda: prog.apply_masked(leaves, alive)),
                      ("dense", lambda: prog.apply_dense(leaves))):
        name = f"call {label}, {len(prog.ops)} ops, 20 leaves"
        out[name] = timed(lambda s, t, x: fn(), None, range(calls + 2))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory whose repro_torch is timed")
    ap.add_argument("--steps", type=int, default=30, help="timed steps a run")
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        sys.exit("interpreter_step_times.py needs a CUDA card")
    import chip_smoke as cs
    import repro_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0])
    dev = torch.device("cuda", torch.cuda.current_device())
    runs = sim_runs(cs, dev, args.steps)
    runs.update(granite_runs(cs, dev, min(args.steps, 6)))
    runs.update(interpreter_calls(dev, args.steps))
    print(json.dumps({"src": str(Path(repro_torch.__file__).parents[1]),
                      "median_ms": {k: statistics.median(v) for k, v in runs.items()},
                      "step_ms": runs}))


if __name__ == "__main__":
    main()

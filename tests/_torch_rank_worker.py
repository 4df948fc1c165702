"""Rank-side half of ``tests/test_torch_ranks.py``.

Spawned ranks import this module, not the test file, so that they load
torch and the port only (no jax, no reference package).
"""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.dsgd import make_topology
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.train import SPMDTrainer
from repro_torch.optim.sgd import get_optimizer


def run_cases(comm, cases, params, steps, seq, batch, lr):
    """Each case ``name -> (topology, fused, mix_order, mixing[, extra])``
    trained ``steps`` steps on this rank from ``params`` (numpy leaves);
    ``extra`` may hold make_topology kwargs (``topo_kw``), trainer kwargs
    (``engine_kw``), the optimizer (``opt``: name, kwargs) and ``lr``.
    Returns ``name -> {"params", "losses", "norms", "engine", "launches",
    "transitions"}`` with this rank's final parameters, per-step losses and
    norms, the launch counts of the run and the controller's transitions
    (None without one)."""
    cfg = get_config("granite-8b-reduced")
    out = {}
    for name, (topology, fused, mix_order, mixing, *extra) in cases.items():
        extra = extra[0] if extra else {}
        opt_name, opt_kw = extra.get("opt", ("sgd", {"momentum": 0.9}))
        topo = make_topology(topology, comm.world, mix_order=mix_order,
                             **extra.get("topo_kw", {}))
        trainer = SPMDTrainer(
            cfg, topo, get_optimizer(opt_name, **opt_kw), collect_norms=True,
            fused_apply=fused, mixing=mixing, device=comm.device,
            **extra.get("engine_kw", {}),
        )
        state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in params.items()})
        src = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0)
        ops.reset_launch_counts()
        losses, norms = [], []
        for t in range(steps):
            state, loss, nrm = trainer.train_step(state, src.stacked(comm.world, t, batch),
                                                  extra.get("lr", lr))
            losses.append(loss.numpy().copy())
            norms.append(nrm.numpy().copy())
        out[name] = {
            "params": {k: v.numpy().copy() for k, v in trainer.stacked_params(state).items()},
            "losses": np.concatenate(losses),
            "norms": np.concatenate(norms),
            "engine": (trainer.engine, comm.transport),
            "launches": ops.launch_counts(),
            "transitions": None if topo.controller is None else topo.controller.transitions,
        }
    return out


def telemetry_cases(comm, cases, params, steps, seq, batch, lr, metrics_every):
    """Each case ``name -> (topology, topo_kw, engine_kw)`` trained
    ``steps`` steps with run telemetry: rank 0's recorder writes to a
    ``MemorySink``, the other ranks' recorders have no sink.  Returns
    ``name -> records`` (empty on ranks other than 0)."""
    from repro_torch.telemetry import MemorySink, MetricsRecorder

    cfg = get_config("granite-8b-reduced")
    out = {}
    for name, (topology, topo_kw, engine_kw) in cases.items():
        sink = MemorySink()
        rec = MetricsRecorder(sinks=[sink] if comm.rank == 0 else [],
                              metrics_every=metrics_every)
        trainer = SPMDTrainer(cfg, make_topology(topology, comm.world, **topo_kw),
                              get_optimizer("sgd", momentum=0.9), collect_norms=True,
                              telemetry=rec, device=comm.device, **engine_kw)
        state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in params.items()})
        src = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0)
        for t in range(steps):
            state, _, _ = trainer.train_step(state, src.stacked(comm.world, t, batch), lr)
        out[name] = sink.records
    return out


def shard_bucketed_cases(comm, cases):
    """Each case ``name -> (graph, x, sizes, bucket_elems)``: this rank's
    row of the stacked numpy ``x`` through ``apply_shard_bucketed`` over
    ``BucketLayout(sizes, bucket_elems)`` and through ``apply_shard``.
    Returns ``name -> (bucketed row, monolithic row)``."""
    from repro_torch.core import graphs
    from repro_torch.core.buckets import BucketLayout
    from repro_torch.core.schedule import compile_graph

    out = {}
    for name, (graph, x, sizes, bucket_elems) in cases.items():
        program = compile_graph(getattr(graphs, graph[0])(*graph[1:]))
        row = torch.from_numpy(x[comm.rank].copy())
        got = program.apply_shard_bucketed(row, comm, BucketLayout(sizes, bucket_elems))
        out[name] = (got.numpy().copy(), program.apply_shard(row, comm).numpy().copy())
    return out


def fused_shard_cases(comm, cases):
    """Each case ``name -> (graph, inputs, kw)``: ``fused_apply_shard`` on
    this rank's rows of the stacked numpy ``inputs`` (theta, grad, mom or
    None).  Returns ``name -> (theta row, mom row or None)``."""
    from repro_torch.core import graphs
    from repro_torch.core.schedule import compile_graph
    from repro_torch.kernels.gossip_update import fused_apply_shard

    out = {}
    for name, (graph, (theta, grad, mom), kw) in cases.items():
        program = compile_graph(getattr(graphs, graph[0])(*graph[1:]))
        row = lambda a: None if a is None else torch.from_numpy(a[comm.rank].copy())
        t, m = fused_apply_shard(program, row(theta), row(grad), row(mom), comm, **kw)
        out[name] = (t.numpy().copy(), None if m is None else m.numpy().copy())
    return out


def consensus_shard(comm, tree, chunk):
    """This rank's (‖x_i - x̄‖², Ξ) from its rows of the stacked numpy
    ``tree``, in chunks of ``chunk`` elements."""
    from repro_torch.core import consensus

    consensus.CHUNK = chunk
    local = {k: torch.from_numpy(v[comm.rank].copy()) for k, v in tree.items()}
    return (float(consensus.consensus_sq_shard(local, comm)),
            float(consensus.consensus_distance_shard(local, comm)))


def mix_ppermute_cases(comm, cases):
    """Each case ``name -> (graph, x, kw)``: ``mix_ppermute`` of this rank's
    row of the stacked numpy ``x``.  Returns ``name -> row``."""
    from repro_torch.core import graphs
    from repro_torch.core.mixing import mix_ppermute

    out = {}
    for name, (graph, x, kw) in cases.items():
        g = getattr(graphs, graph[0])(*graph[1:])
        row = torch.from_numpy(x[comm.rank].copy())
        out[name] = mix_ppermute({"x": row}, g, comm, **kw)["x"].numpy().copy()
    return out


def _rank_values(rank, n, device):
    return torch.arange(n, dtype=torch.float32, device=device) % 4096 + 10000.0 * (rank + 1)


def comm_checks(comm, n):
    """``permute`` along a partial permutation (0 -> 1, 1 -> 2) into a
    NaN-filled buffer, ``pmean`` and ``all_gather`` of (n,) rank-valued
    tensors, each held against what this rank must see (all sums exact in
    float32).  Returns ``{collective: equal}``."""
    dev = comm.device
    x = _rank_values(comm.rank, n, dev)
    landed = comm.permute(x, [(0, 1), (1, 2)], out=torch.full_like(x, float("nan")))
    want = (_rank_values(comm.rank - 1, n, dev) if comm.rank in (1, 2)
            else torch.zeros_like(x))   # ranks that are no destination land zeros
    mean = sum(_rank_values(r, n, dev) for r in range(comm.world)) / comm.world
    gathered = torch.stack([_rank_values(r, n, dev) for r in range(comm.world)])
    return {
        "transport": comm.transport,
        "permute": bool(torch.equal(landed, want)),
        "pmean": bool(torch.equal(comm.pmean(x.clone()), mean)),
        "all_gather": bool(torch.equal(comm.all_gather(x), gathered)),
    }


def fail_on_rank_1(comm):
    """Rank 1 raises; the others wait for it in a collective."""
    if comm.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    comm.pmean(torch.zeros(1))


def sleep_forever(comm):
    import time

    while True:
        time.sleep(1)

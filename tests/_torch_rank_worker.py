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


def zoo_rows(comm, arch, dtype_name, steps, seq, batch, lr, ckpt_dir=None):
    """``arch``'s reduced config in ``dtype_name`` on d_ring with fused
    apply, ``steps`` steps from the seed-0 weights; with ``ckpt_dir`` the
    state is then checkpointed there and restored into a seed-1 state.
    Returns this rank's (θ row, m row, the trainer's engine)."""
    import dataclasses

    cfg = dataclasses.replace(get_config(arch + "-reduced"), remat=False,
                              dtype=getattr(torch, dtype_name))
    trainer = SPMDTrainer(cfg, make_topology("d_ring", comm.world),
                          get_optimizer("sgd", momentum=0.9), fused_apply=True,
                          device=comm.device)
    state = trainer.init_state(seed=0)
    src = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0)
    for t in range(steps):
        state, _, _ = trainer.train_step(state, src.stacked(comm.world, t, batch), lr)
    if ckpt_dir is not None:
        trainer.save_checkpoint(ckpt_dir, state)
        state = trainer.init_state(seed=1)
        trainer.restore_checkpoint(ckpt_dir, state)
    return state.theta[0].numpy().copy(), state.mom[0].numpy().copy(), trainer.engine


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


def host_gather_checks(comm, n, dtype, chunk_bytes):
    """``gather_host`` of every rank's (n,) rank-valued tensor into rank 0's
    host memory, and ``scatter_host`` of those rows times two back, in
    chunks of ``chunk_bytes`` (the transport's default when None).  Returns
    ``{collective: equal}``."""
    from repro_torch.launch import comm as comm_mod

    if chunk_bytes is not None:
        comm_mod.CHUNK_BYTES = chunk_bytes
    dt = getattr(torch, dtype)
    x = _rank_values(comm.rank, n, comm.device).to(dt)
    # the device's values (its arange rounds past 2^24 as the CPU's may not)
    want = torch.stack([_rank_values(r, n, comm.device).to(dt) for r in range(comm.world)]).cpu()
    rows = comm.gather_host(x)
    gather = rows is None if comm.rank else (rows.device.type == "cpu" and torch.equal(rows, want))
    out = torch.full_like(x, float("nan"))
    comm.scatter_host(out, None if comm.rank else rows * 2)
    return {"transport": comm.transport, "gather": bool(gather),
            "scatter": bool(torch.equal(out, x * 2))}


def run_main(comm, argv):
    """The CLI on this rank (the group is up, so it runs the ranks engine);
    returns its per-step losses."""
    from repro_torch.launch.train import main

    return main(argv, device=comm.device)["losses"]


def fail_on_rank_1(comm):
    """Rank 1 raises; the others wait for it in a collective."""
    if comm.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    comm.pmean(torch.zeros(1))


def sleep_forever(comm):
    import time

    while True:
        time.sleep(1)


def fault_cases(comm, cases, params, steps, seq, batch, lr):
    """Each case ``name -> (topology, fused, fault kind, fault kwargs)``
    trained ``steps`` steps on this rank under the fault model, from
    ``params``.  Returns ``name -> {"params", "mom", "losses", "launches",
    "events"}``: this rank's final flat θ and momentum rows, per-step
    losses, launch counts and the controller's events (None without
    one)."""
    from repro_torch.core.faults import make_fault_model

    cfg = get_config("granite-8b-reduced")
    out = {}
    for name, (topology, fused, kind, fkw, *topo_kw) in cases.items():
        fm = make_fault_model(kind, comm.world, **fkw)
        topo = make_topology(topology, comm.world, fault_model=fm, **(topo_kw[0] if topo_kw else {}))
        trainer = SPMDTrainer(cfg, topo, get_optimizer("sgd", momentum=0.9),
                              collect_norms=True, fused_apply=fused, device=comm.device)
        state = trainer.init_state(params={k: torch.from_numpy(v) for k, v in params.items()})
        src = SyntheticLM(vocab=cfg.vocab, seq_len=seq, seed=0)
        losses = []
        for t in range(steps):
            state, loss, _ = trainer.train_step(state, src.stacked(comm.world, t, batch), lr)
            losses.append(float(loss[0]))
        out[name] = {
            "params": state.theta[0].numpy().copy(),
            "mom": state.mom[0].numpy().copy(),
            "losses": np.array(losses),
            "events": None if topo.controller is None else list(topo.controller.events),
        }
    return out


def masked_shard_cases(comm, cases):
    """Each case ``name -> (graph, x, alive, link, bucket)``: this rank's
    row of the stacked numpy ``x`` through ``apply_shard_masked`` (and,
    with ``bucket`` ``(sizes, bucket_elems)``, ``apply_shard_masked_bucketed``).
    Returns ``name -> (row, bucketed row or None)``."""
    from repro_torch.core import graphs
    from repro_torch.core.buckets import BucketLayout
    from repro_torch.core.schedule import compile_graph

    out = {}
    for name, (graph, x, alive, link, bucket) in cases.items():
        program = compile_graph(getattr(graphs, graph[0])(*graph[1:]))
        row = torch.from_numpy(x[comm.rank].copy())
        got = program.apply_shard_masked(row, comm, alive, link_up=link)
        bucketed = None
        if bucket is not None:
            bucketed = program.apply_shard_masked_bucketed(
                row, comm, alive, link_up=link, layout=BucketLayout(*bucket)).numpy().copy()
        out[name] = (got.numpy().copy(), bucketed)
    return out


def handoff_cases(comm, x, alive, chunk):
    """This rank's row of the stacked numpy ``x`` after
    ``adopt_neighbor_average(node 1, [0, 2])`` and after
    ``drain_handoff(node 3, [2, 0], alive)``, both on the rank's (1, P)
    row (gathers in chunks of ``chunk`` columns), and the member Ξ under
    ``alive``."""
    from repro_torch.core import faults
    from repro_torch.core.consensus import consensus_distance_masked_shard

    faults.HANDOFF_CHUNK = chunk
    row = torch.from_numpy(x[comm.rank:comm.rank + 1].copy())
    faults.adopt_neighbor_average(row, 1, [0, 2], comm=comm)
    adopted = row.numpy().copy()
    row = torch.from_numpy(x[comm.rank:comm.rank + 1].copy())
    faults.drain_handoff(row, 3, [2, 0], alive, comm=comm)
    xi = float(consensus_distance_masked_shard(torch.from_numpy(x[comm.rank].copy()),
                                               alive != 0, comm))
    return adopted, row.numpy().copy(), xi


def fault_world(comm, cases, mask_cases, x, alive, params, steps, seq, batch, lr):
    """``tests/test_torch_elastic_ranks.py``'s world: ``fault_cases``,
    ``masked_shard_cases`` and ``handoff_cases`` (chunks of 8 columns) in
    one spawn."""
    return (fault_cases(comm, cases, params, steps, seq, batch, lr),
            masked_shard_cases(comm, mask_cases),
            handoff_cases(comm, x, alive, 8))


def quad_loss(params, batch):
    """A loss whose gradient is ``x - batch[leaf]`` in float32, rounded to
    each leaf's dtype: both packages take the same gradients from it."""
    return 0.5 * sum(torch.sum((x.float() - batch[k]) ** 2) for k, x in params.items())


def quad_batch(layout, n, step):
    """Seeded (n, *shape) float32 targets of ``quad_loss`` for every leaf."""
    r = np.random.default_rng(1000 + step)
    return {k: (0.1 * r.standard_normal((n,) + tuple(s))).astype(np.float32)
            for k, s in zip(layout.names, layout.shapes)}


def mixed_cfg():
    """zamba2-reduced in bfloat16: its Mamba2 ``a_log``/``d_skip`` stay float32."""
    import dataclasses

    return dataclasses.replace(get_config("zamba2-7b-reduced"), remat=False,
                               dtype=torch.bfloat16)


def mixed_fault_rows(comm, fault, steps, lr):
    """bf16 zamba2-reduced under ``fault`` (``make_fault_model`` args and
    kwargs) on d_ring with fused apply and ``quad_loss``, ``steps`` steps
    from the seed-0 weights.  Returns this rank's (θ row, m row, whether
    every narrow leaf held bfloat16 values after each step, engine)."""
    from repro_torch.core.faults import make_fault_model

    name, kw = fault
    topo = make_topology("d_ring", comm.world,
                         fault_model=make_fault_model(name, comm.world, **kw))
    trainer = SPMDTrainer(mixed_cfg(), topo, get_optimizer("sgd", momentum=0.9),
                          loss_fn=quad_loss, fused_apply=True, device=comm.device)
    state = trainer.init_state(seed=0)
    narrow, exact = trainer.layout.narrow_leaves(), []
    for t in range(steps):
        state, _, _ = trainer.train_step(state, quad_batch(trainer.layout, comm.world, t), lr)
        exact.append(all(torch.equal(state.theta[:, a:b], state.theta[:, a:b].to(dt).float())
                         for a, b, dt in narrow))
    return state.theta[0].numpy().copy(), state.mom[0].numpy().copy(), exact, trainer.engine


def comm_record(comm):
    """Every collective of ``Comm`` once under ``Comm.recording``.  Returns
    (the record before, the record after the block, what was recorded as
    (kind, pairs, bytes))."""
    x = torch.arange(6, dtype=torch.float32) + comm.rank
    before = comm.ops
    with comm.recording() as ops:
        comm.permute(x, ((0, 1), (1, 0)))
        comm.pmean(x.clone())
        comm.all_gather(x)
        comm.gather_host(x)
        comm.scatter_host(x.clone(), torch.zeros(comm.world, 6) if comm.rank == 0 else None)
    return before, comm.ops, [(op.kind, op.pairs, op.nbytes) for op in ops]

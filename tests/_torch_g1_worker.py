"""Rank-side half of ``tests/test_torch_g1.py`` and
``tests/test_torch_tp_faults.py``.

Spawned ranks import this module, not the test files, so that they load
torch and the port only (no jax, no reference package).
"""
import numpy as np
import torch

from _torch_tp_worker import port_cfg
from repro_torch.core.dsgd import make_topology
from repro_torch.core.faults import make_fault_model
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.mesh import gossip_axes_for, gossip_size, make_mesh
from repro_torch.launch.train import SPMDTrainer, TrainState
from repro_torch.models.moe import counting_drops
from repro_torch.optim.sgd import get_optimizer


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def g1_trainer(device, arch, replace, shape, axes, fault=None, topology="d_ring",
               fused=False):
    """``arch`` (reduced, float32, no remat, ``replace``'s fields) on a mesh
    of ``shape`` over ``axes``, its gossip axes the reference's for the
    name; ``fault``: make_fault_model's (kind, kwargs) or None;
    ``topology``: a name, or (name, make_topology's keyword pairs)."""
    cfg = port_cfg(arch, replace)
    mesh = make_mesh(shape, axes)
    g = gossip_size(mesh, gossip_axes_for(cfg.name, mesh))
    fm = None if fault is None else make_fault_model(fault[0], g, **dict(fault[1]))
    name, kw = (topology, ()) if isinstance(topology, str) else topology
    topo = make_topology(name, g, fault_model=fm, **dict(kw))
    return SPMDTrainer(cfg, topo, get_optimizer("sgd", momentum=0.9), collect_norms=True,
                       fused_apply=fused, device=device, mesh=mesh)


def batch_at(trainer, src, t, batch):
    """Step ``t``'s batch: (G, b, S) from ``batch`` rows a node, or at G = 1
    the reference's flat (B, S) of ``batch`` rows."""
    b = src.stacked(trainer.g, t, batch)
    return {k: v[0] for k, v in b.items()} if trainer.g == 1 else b


def run(trainer, params, steps, seq, batch, lr, *, ckpt_dir=None, save_at=None, state=None,
        start=0):
    """Train ``steps`` steps from ``params`` (or ``state`` at ``start``);
    with ``ckpt_dir`` save after step ``save_at``.  Returns ``{"full",
    "mom", "local", "losses", "norms", "drops", "launches", "whole"}``:
    the node's gathered parameters and momentum, this rank's shards, per
    step losses, norms and dropped-assignment counts (per MoE layer), the
    launch counts and, per leaf, whether the model axis and the data axes
    leave it whole."""
    if state is None:
        state = trainer.init_state(params=params)
    src = SyntheticLM(vocab=trainer.cfg.vocab, seq_len=seq, seed=0)
    ops.reset_launch_counts()
    losses, norms, drops = [], [], []
    for t in range(start, steps):
        with counting_drops() as dr:
            state, loss, nrm = trainer.train_step(state, batch_at(trainer, src, t, batch), lr)
        losses.append(loss.numpy().copy())
        norms.append(nrm.numpy().copy())
        drops.append([int(x) for x in dr])
        if ckpt_dir is not None and t + 1 == save_at:
            trainer.save_checkpoint(ckpt_dir, state)
    return {
        "full": _np(trainer.full_params(state)),
        "mom": _np(trainer.full_leaves(state.mom)),
        "local": _np(trainer.stacked_params(state)),
        "losses": np.stack(losses),
        "norms": np.stack(norms),
        "drops": drops,
        "launches": ops.launch_counts(),
        "whole": {k: (m, d) for k, m, d in zip(trainer.defs, trainer._replicated(),
                                               trainer._data_whole())},
        "engine": (trainer.engine, trainer.g, trainer.dp_size, trainer.tp_size),
        "transitions": (None if trainer.topology.controller is None
                        else list(trainer.topology.controller.transitions)),
        "state": state,
    }


def world_cases(comm, cases, params, steps, seq, batch, lr, shape, axes, ckpt=None):
    """Each case ``name -> (arch, cfg replace, fault, topology, fused)`` on
    this rank of a world laid out as the mesh ``shape``/``axes``.  ``ckpt``
    maps case names to checkpoint directories: the case named "ckpt" saves
    there at step ``steps // 2`` and a fresh seed-1 trainer restored from
    that file runs to ``steps`` (``"resumed"``: its gathered parameters);
    the case named "restore" starts from the file there instead of
    ``params``."""
    ckpt = ckpt or {}
    out = {}
    for name, (arch, replace, fault, topology, fused) in cases.items():
        tr = g1_trainer(comm.device, arch, replace, shape, axes, fault, topology, fused)
        kw = {}
        if name == "ckpt":
            kw = dict(ckpt_dir=ckpt[name], save_at=steps // 2)
        if name == "restore":
            st = tr.init_state(seed=1)
            start = tr.restore_checkpoint(ckpt[name], st)
            kw = dict(state=TrainState(st.theta, st.opt, start), start=start)
        res = run(tr, params.get(name), steps, seq, batch, lr, **kw)
        res.pop("state")
        if name == "ckpt":
            fresh = g1_trainer(comm.device, arch, replace, shape, axes, fault, topology, fused)
            st = fresh.init_state(seed=1)
            start = fresh.restore_checkpoint(ckpt[name], st)
            res["resumed"] = run(fresh, None, steps, seq, batch, lr,
                                 state=TrainState(st.theta, st.opt, start), start=start)["full"]
        out[name] = res
    return out


def stacked(arch, replace, shape, axes, params, steps, seq, batch, lr, fault=None,
            topology="d_ring", fused=False, ckpt_dir=None, save_at=None):
    """The same case on the stacked engine in this process, on the CPU."""
    tr = g1_trainer("cpu", arch, replace, shape, axes, fault, topology, fused)
    res = run(tr, params, steps, seq, batch, lr, ckpt_dir=ckpt_dir, save_at=save_at)
    res.pop("state")
    res["trainer"] = tr
    return res


def worlds(comm, runs):
    """``world_cases`` for each ``(label, cases, params, steps, seq, batch,
    lr, shape, axes, ckpt)`` of ``runs``, in order, on this rank of one
    world: ``label -> world_cases(...)``."""
    return {label: world_cases(comm, *args) for label, *args in runs}

"""Rank-side half of ``tests/test_torch_tp_ranks.py``.

Spawned ranks import this module, not the test files, so that they load
torch and the port only (no jax, no reference package).
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.dsgd import make_topology
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import SPMDTrainer, TrainState
from repro_torch.optim.sgd import get_optimizer


def port_cfg(arch, replace):
    """The reduced ``arch`` in float32 without remat, ``replace``'s fields set."""
    return dataclasses.replace(get_config(arch + "-reduced"), dtype=torch.float32,
                               remat=False, **dict(replace))


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _trainer(device, case, g, tp):
    arch, replace, topology, topo_kw, engine_kw, fused, mixing = case[:7]
    cfg = port_cfg(arch, replace)
    topo = make_topology(topology, g, **dict(topo_kw))
    return SPMDTrainer(cfg, topo, get_optimizer("sgd", momentum=0.9), collect_norms=True,
                       fused_apply=fused, mixing=mixing, device=device,
                       mesh=make_mesh((g, tp), ("data", "model")), **dict(engine_kw)), topo


def stacked_case(case, params, steps, seq, batch, lr, g, tp):
    """``case`` on the stacked engine in this process, on the CPU, with a
    (g data × tp model) mesh: the model axis carries no devices and only
    sets the padded heads.  Returns ``{"params", "losses", "norms",
    "engine", "launches", "transitions"}`` (parameters (g, ...) a leaf)."""
    trainer, topo = _trainer("cpu", case, g, tp)
    state = trainer.init_state(params=params)
    src = SyntheticLM(vocab=trainer.cfg.vocab, seq_len=seq, seed=0)
    ops.reset_launch_counts()
    losses, norms = [], []
    for t in range(steps):
        state, loss, nrm = trainer.train_step(state, src.stacked(g, t, batch), lr)
        losses.append(loss.numpy().copy())
        norms.append(nrm.numpy().copy())
    return {
        "params": _np(trainer.stacked_params(state)),
        "losses": losses,
        "norms": norms,
        "engine": (trainer.engine, trainer.tp_size, trainer.tp is None),
        "launches": ops.launch_counts(),
        "transitions": None if topo.controller is None else topo.controller.transitions,
    }


def tp_cases(comm, cases, params, steps, seq, batch, lr, tp, ckpt_dir=None):
    """Each case ``name -> (arch, cfg replace, topology, topology kwargs,
    engine kwargs, fused, mixing)`` trained ``steps`` steps on this rank of
    a (world/tp data × tp model) world from ``params[name]`` (the full
    padded numpy leaves).  Returns ``name -> {"full", "local", "replicated",
    "losses", "norms", "engine", "launches", "transitions"}``: the
    node's gathered parameters, this rank's shards, which leaves are whole
    on every rank, per-step losses and norms, the launch counts and the
    controller's transitions.  With ``ckpt_dir`` the case named "ckpt"
    also saves at step ``steps // 2`` (``"saved"``: the node's gathered
    parameters and momentum then) and a fresh seed-1 trainer restored from
    that file runs to ``steps`` (``"resumed"``: its gathered parameters)."""
    g = comm.world // tp
    out = {}
    for name, case in cases.items():
        trainer, topo = _trainer(comm.device, case, g, tp)
        state = trainer.init_state(params=params[name])
        src = SyntheticLM(vocab=trainer.cfg.vocab, seq_len=seq, seed=0)
        ops.reset_launch_counts()
        losses, norms, extra = [], [], {}
        for t in range(steps):
            state, loss, nrm = trainer.train_step(state, src.stacked(g, t, batch), lr)
            losses.append(loss.numpy().copy())
            norms.append(nrm.numpy().copy())
            if ckpt_dir is not None and name == "ckpt" and t + 1 == steps // 2:
                trainer.save_checkpoint(ckpt_dir, state)
                extra["saved"] = (_np(trainer.full_params(state)),
                                  _np(trainer.full_leaves(state.mom)))
        out[name] = {
            "full": _np(trainer.full_params(state)),
            "local": _np(trainer.stacked_params(state)),
            "replicated": [k for k, r in zip(trainer.defs, trainer._replicated()) if r],
            "losses": np.concatenate(losses),
            "norms": np.concatenate(norms),
            "engine": (trainer.engine, comm.transport, trainer.tp is not None),
            "launches": ops.launch_counts(),
            "transitions": None if topo.controller is None else topo.controller.transitions,
            **extra,
        }
        if "saved" in extra:
            fresh, _ = _trainer(comm.device, case, g, tp)
            st = fresh.init_state(seed=1)
            start = fresh.restore_checkpoint(ckpt_dir, st)
            st = TrainState(st.theta, st.opt, start)
            for t in range(start, steps):
                st, _, _ = fresh.train_step(st, src.stacked(g, t, batch), lr)
            out[name]["resumed"] = _np(fresh.full_params(st))
    return out


def manual_ep_check(comm, ffn, x, top_k, capacity_factor):
    """``apply_moe_manual_ep`` on this rank's experts (E/world of them) of
    the numpy ``ffn`` leaves, forward and backward of the output's sum of
    squares.  Returns (output, aux loss, this rank's expert gradients)."""
    from repro_torch.launch.tensor_parallel import ModelParallel
    from repro_torch.models.moe import apply_moe_manual_ep

    tp = ModelParallel(comm)
    e_local = ffn["w_gate"].shape[0] // comm.world
    mine = slice(comm.rank * e_local, (comm.rank + 1) * e_local)
    params = {k: torch.from_numpy(v[mine] if k != "router" else v).requires_grad_()
              for k, v in ffn.items()}
    out, aux = apply_moe_manual_ep(params, torch.from_numpy(x), top_k=top_k,
                                   capacity_factor=capacity_factor, tp=tp)
    (out.square().sum() + aux).backward()
    grads = {k: p.grad.numpy().copy() for k, p in params.items()}
    return out.detach().numpy().copy(), float(aux), grads

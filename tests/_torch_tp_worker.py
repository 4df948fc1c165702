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
    """The reduced ``arch`` in float32 without remat, ``replace``'s fields
    set (a ``dtype`` by its name, e.g. "bfloat16")."""
    replace = dict(replace)
    dtype = getattr(torch, replace.pop("dtype", "float32"))
    return dataclasses.replace(get_config(arch + "-reduced"), dtype=dtype, remat=False,
                               **replace)


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _np32(d):
    return {k: v.detach().float().numpy().copy() for k, v in d.items()}


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
    "losses", "norms", "engine", "launches", "transitions", "trail"}``: the
    node's gathered parameters, this rank's shards, which leaves are whole
    on every rank, per-step losses and norms, the launch counts, the
    controller's transitions and, for the ssm and hybrid families, the
    node's gathered parameters and momentum (float32) after every step.  With ``ckpt_dir``
    the case named "ckpt"
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
        trail = [] if trainer.cfg.family in ("ssm", "hybrid") else None
        for t in range(steps):
            state, loss, nrm = trainer.train_step(state, src.stacked(g, t, batch), lr)
            losses.append(loss.numpy().copy())
            norms.append(nrm.numpy().copy())
            if trail is not None:
                trail.append((_np32(trainer.full_params(state)),
                              _np32(trainer.full_leaves(state.mom))))
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
            "trail": trail,
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


def stacked_step(case, theta, mom, t, seq, batch, lr, g, dtype=None):
    """One step of ``case`` on the stacked engine (one card, no model axis)
    from the state ``theta``/``mom`` ({name: (g, ...) float32}) on step
    ``t``'s batch, in the case's dtype or ``dtype`` (a name): (parameters,
    momentum, losses, norms) as float64 numpy."""
    if dtype is not None:
        # the kernels' twins take float32 and bfloat16: the plain update and
        # program, no norms
        case = (case[0], tuple(dict(case[1], dtype=dtype).items())) + tuple(case[2:5]) \
            + (False,) + tuple(case[6:])
    trainer, _ = _trainer("cpu", case, g, 1)
    trainer.collect_norms = dtype is None
    state = trainer.init_state(params={k: v[0] for k, v in theta.items()})
    for buf, src in ((state.theta, theta), (state.mom, mom)):
        for k, v in trainer.layout.stacked_views(buf).items():
            v.copy_(torch.from_numpy(src[k]))
    data = SyntheticLM(vocab=trainer.cfg.vocab, seq_len=seq, seed=0)
    state, loss, nrm = trainer.train_step(TrainState(state.theta, state.opt, t),
                                          data.stacked(g, t, batch), lr)
    f64 = lambda d: {k: v.detach().double().numpy() for k, v in d.items()}
    return (f64(trainer.stacked_params(state)), f64(trainer.layout.stacked_views(state.mom)),
            loss.double().numpy(), nrm.double().numpy() if trainer.collect_norms else None)


def _f64_cfg(case):
    return port_cfg(case[0], tuple(dict(case[1], dtype="float64").items()))


def tp_grads(comm, case, flat, batch):
    """The loss and this rank's gradients of ``case``'s model in float64 on
    a model group of ``comm.world`` (this rank: shard ``comm.rank`` of the
    full numpy leaves ``flat``) for the (B, S) numpy ``batch``: (loss,
    {name: gradient}, {name: the dim split over the group or None})."""
    from repro_torch.launch.sharding import model_axis_shards, shard_leaf
    from repro_torch.launch.tensor_parallel import ModelParallel
    from repro_torch.models import transformer as tfm

    cfg = _f64_cfg(case)
    shard, _ = model_axis_shards(tfm.model_defs(cfg, comm.world), comm.world)
    params = {k: shard_leaf(torch.from_numpy(v), shard[k], {"model": comm.rank})
              .clone().requires_grad_() for k, v in flat.items()}
    loss = tfm.loss_fn(params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()},
                       tp=ModelParallel(comm))
    loss.backward()
    return (float(loss), {k: p.grad.numpy().copy() for k, p in params.items()},
            {k: s.dim_of("model") for k, s in shard.items()})


def one_card_grads(case, flat, batch):
    """``tp_grads`` on one card: (loss, {name: gradient})."""
    from repro_torch.models import transformer as tfm

    params = {k: torch.from_numpy(v).clone().requires_grad_() for k, v in flat.items()}
    loss = tfm.loss_fn(params, _f64_cfg(case), {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    return float(loss), {k: p.grad.numpy().copy() for k, p in params.items()}


def serve_cases(comm, cases, params, prompts, patches, n_dec, n_new, data, model):
    """Each serving case ``name -> (arch, cfg replace)`` on this rank of a
    (data × model) world through ``ServeEngine(cfg, mesh=...)`` from the
    full numpy leaves ``params[name]``: the whole batch's prefill logits,
    ``n_dec`` decode steps' logits (after the prefill's patches for a VLM,
    its caches grown; else from an empty state over the prompt's first
    tokens), ``n_new`` greedy tokens, and the shapes of this rank's decode
    state.  ``patches``: (B, n_patches, D) for the VLM cases, else None."""
    from repro_torch.launch.comm import mesh_comms
    from repro_torch.launch.serve import ServeEngine, grow_caches
    from torch.utils._pytree import tree_leaves

    data_comm, model_comm = mesh_comms(comm, data, model)
    out = {}
    for name, (arch, replace) in cases.items():
        cfg = port_cfg(arch, replace)
        eng = ServeEngine(cfg, device=comm.device, mesh=make_mesh((data, model),
                                                                  ("data", "model")),
                          model_comm=model_comm, data_comm=data_comm)
        p = eng.shard_params(params[name])
        pe = None if cfg.input_kind != "vlm" else torch.from_numpy(patches)
        toks = torch.from_numpy(prompts)
        b, s = toks.shape
        last, state = eng.prefill(p, toks, patch_embeds=pe)
        shapes = [tuple(x.shape) for x in tree_leaves(state) if isinstance(x, torch.Tensor)]
        if pe is not None:
            state, pos, feed = grow_caches(state, cfg.n_patches + s + n_dec), cfg.n_patches + s, \
                toks[:, :n_dec]
        else:
            state, pos, feed = eng.init_decode_state(b, n_dec), 0, toks[:, :n_dec]
        chain = []
        for t in range(n_dec):
            logits, state = eng.decode_step(p, feed[:, t:t + 1], pos + t, state)
            chain.append(logits.numpy().copy())
        gen = eng.generate(p, toks, n_new, patch_embeds=pe)
        out[name] = {"prefill": last.numpy().copy(), "chain": np.stack(chain),
                     "tokens": gen.numpy().copy(), "state_shapes": shapes,
                     "engine": (eng.tp_size, eng.tp is not None, eng.data_size)}
    return out

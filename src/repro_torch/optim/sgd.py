"""Optimizers: the counterpart of ``repro/optim/sgd.py``.

``Optimizer`` keeps the reference's (init, update, name, hyper) shape: pure
functions of ONE node's parameters, as dicts of tensors.  The engines run
them over the stacked node axis with ``torch.func.vmap`` (the reference
vmaps them), so LARS's per-layer norms stay per node.  State is float32
whatever the parameter dtype: momentum-SGD and LARS keep one params-like
dict, AdamW ``{"mu": dict, "nu": dict, "t": int32 step count}``.

``slots`` names the state's params-like float32 parts and ``counted``
whether it carries the step count; ``state_from`` and ``state_parts``
convert between the state and those parts, so the engines can hold each
slot as one flat (rows, P) buffer (``core/flat.py``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

__all__ = ["Optimizer", "sgd", "adamw", "lars", "get_optimizer",
           "state_from", "state_parts"]


class Optimizer(NamedTuple):
    """init(params) -> state; update(grads, state, params, lr) -> (new_params, new_state)."""

    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict, float], tuple[dict, Any]]
    name: str
    hyper: Any = None
    """Introspectable hyperparameters (``{"kind": ..., ...}``) for engines
    that re-implement the update inside a fused kernel (``fused_apply``)."""
    slots: tuple[str, ...] = ()
    """Names of the state's params-like float32 parts."""
    counted: bool = False
    """Whether the state carries an int32 step count ``"t"``."""


def state_from(opt: Optimizer, parts: dict[str, dict], t: Optional[torch.Tensor] = None):
    """The optimizer state from its parts: ``parts[slot]`` a params-like
    dict per slot, ``t`` the step count when ``opt.counted``."""
    if not opt.slots:
        return ()
    if opt.counted:
        return {**{s: parts[s] for s in opt.slots}, "t": t}
    (slot,) = opt.slots
    return parts[slot]


def state_parts(opt: Optimizer, state) -> tuple[dict[str, dict], Optional[torch.Tensor]]:
    """Inverse of ``state_from``: (parts per slot, step count or None)."""
    if not opt.slots:
        return {}, None
    if opt.counted:
        return {s: state[s] for s in opt.slots}, state["t"]
    (slot,) = opt.slots
    return {slot: state}, None


def _zeros_like_f32(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def sgd(momentum: float = 0.9, weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD + heavy-ball momentum (+ optional decoupled weight decay)."""

    def init(params):
        if momentum == 0.0:
            return ()
        return _zeros_like_f32(params)

    def update(grads, state, params, lr):
        lr = float(lr)

        def upd(g, m, p):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            if momentum == 0.0:
                step = g
                new_m = m
            else:
                new_m = momentum * m + g
                step = g + momentum * new_m if nesterov else new_m
            return (p.float() - lr * step).to(p.dtype), new_m

        if momentum == 0.0:
            return {k: upd(grads[k], None, params[k])[0] for k in params}, state
        new_p, new_m = {}, {}
        for k in params:
            new_p[k], new_m[k] = upd(grads[k], state[k], params[k])
        return new_p, new_m

    return Optimizer(
        init, update, f"sgd(m={momentum},wd={weight_decay})",
        hyper={
            "kind": "sgd", "momentum": momentum,
            "weight_decay": weight_decay, "nesterov": nesterov,
        },
        slots=() if momentum == 0.0 else ("mom",),
    )


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    """AdamW with decoupled weight decay."""

    def init(params):
        dev = next(iter(params.values())).device
        return {
            "mu": _zeros_like_f32(params),
            "nu": _zeros_like_f32(params),
            "t": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def update(grads, state, params, lr):
        t = state["t"] + 1
        lr = float(lr)
        tf = t.float()
        c1 = 1.0 - torch.pow(torch.full_like(tf, b1), tf)
        c2 = 1.0 - torch.pow(torch.full_like(tf, b2), tf)

        def upd(g, mu, nu, p):
            g = g.float()
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            step = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            p32 = p.float()
            if weight_decay:
                step = step + weight_decay * p32
            return (p32 - lr * step).to(p.dtype), mu, nu

        new_p, new_mu, new_nu = {}, {}, {}
        for k in params:
            new_p[k], new_mu[k], new_nu[k] = upd(
                grads[k], state["mu"][k], state["nu"][k], params[k])
        return new_p, {"mu": new_mu, "nu": new_nu, "t": t}

    return Optimizer(
        init, update, f"adamw(b1={b1},b2={b2},wd={weight_decay})",
        hyper={"kind": "adamw", "b1": b1, "b2": b2, "eps": eps,
               "weight_decay": weight_decay},
        slots=("mu", "nu"), counted=True,
    )


def lars(
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    trust_coefficient: float = 0.001,
    eps: float = 1e-9,
) -> Optimizer:
    """Layer-wise Adaptive Rate Scaling (You et al., 2017): per-tensor trust
    ratio ‖p‖ / ‖g‖ on a heavy-ball step."""

    def init(params):
        return _zeros_like_f32(params)

    def update(grads, state, params, lr):
        lr = float(lr)

        def upd(g, m, p):
            g = g.float()
            p32 = p.float()
            g = g + weight_decay * p32
            p_norm = torch.linalg.vector_norm(p32)
            g_norm = torch.linalg.vector_norm(g)
            ratio = trust_coefficient * p_norm / (g_norm + eps)
            trust = torch.where((p_norm > 0) & (g_norm > 0), ratio,
                                torch.ones_like(ratio))
            new_m = momentum * m + trust * g
            return (p32 - lr * new_m).to(p.dtype), new_m

        new_p, new_m = {}, {}
        for k in params:
            new_p[k], new_m[k] = upd(grads[k], state[k], params[k])
        return new_p, new_m

    return Optimizer(
        init, update, f"lars(m={momentum},wd={weight_decay})",
        hyper={"kind": "lars", "momentum": momentum, "weight_decay": weight_decay,
               "trust_coefficient": trust_coefficient, "eps": eps},
        slots=("mom",),
    )


def get_optimizer(name: str, **kw) -> Optimizer:
    try:
        return {"sgd": sgd, "adamw": adamw, "lars": lars}[name](**kw)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}") from None

"""SGD with heavy-ball momentum: the counterpart of ``repro/optim/sgd.py``.

``Optimizer`` keeps the reference's (init, update, name, hyper) shape: pure
functions over dicts of tensors.  Momentum state is float32 whatever the
parameter dtype.  AdamW and LARS are not ported yet (ROADMAP queue 1
step 3); ``get_optimizer`` rejects them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "sgd", "get_optimizer"]


class Optimizer(NamedTuple):
    """init(params) -> state; update(grads, state, params, lr) -> (new_params, new_state)."""

    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict, float], tuple[dict, Any]]
    name: str
    hyper: Any = None
    """Introspectable hyperparameters (``{"kind": ..., ...}``) for engines
    that re-implement the update inside a fused kernel (``fused_apply``)."""


def sgd(momentum: float = 0.9, weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD + heavy-ball momentum (+ optional decoupled weight decay)."""

    def init(params):
        if momentum == 0.0:
            return ()
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

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
    )


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(**kw)
    if name in ("adamw", "lars"):
        raise ValueError(
            f"optimizer {name!r} is not ported yet: ROADMAP queue 1 step 3"
        )
    raise ValueError(f"unknown optimizer {name!r}")

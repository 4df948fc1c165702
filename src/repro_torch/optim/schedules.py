"""Learning-rate schedules and graph-aware scaling policies (paper Table 2).

The paper's central LR finding (Observation 3): the *linear* batch-size
scaling convention breaks decentralized training earlier than centralized —
*square-root* scaling rescues convergence at large scale (tuned_* runs,
§3.2).  Both policies are first-class here, parameterized by the
communication-graph degree exactly as Table 2 does:

    linear:  s = global_batch * (k + 1) / base_batch
    sqrt:    s = sqrt(global_batch * (k + 1) / base_batch)

where k is the node degree of the graph in force (k = n-1 for complete /
centralized).  Schedules are pure ``step -> lr`` callables (float step ok).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

__all__ = [
    "lr_scale",
    "warmup_multistep",
    "one_cycle",
    "constant",
    "Schedule",
]

Schedule = Callable[[float], float]


def lr_scale(
    policy: str,
    *,
    global_batch: int,
    base_batch: int = 256,
    graph_degree: int = 0,
) -> float:
    """Table 2 scaling factor ``s`` (linear or sqrt; Obs. 3)."""
    s = global_batch * (graph_degree + 1) / base_batch
    if policy == "linear":
        return s
    if policy == "sqrt":
        return math.sqrt(s)
    if policy == "none":
        return 1.0
    raise ValueError(f"unknown lr scaling policy {policy!r}")


def constant(lr: float) -> Schedule:
    return lambda step: lr


def warmup_multistep(
    base_lr: float,
    steps_per_epoch: int,
    warmup_epochs: float = 5,
    milestones: Sequence[float] = (30, 60, 80),
    decay: float = 0.1,
    scale: float = 1.0,
) -> Schedule:
    """Warmup + multi-step decay (the paper's ResNet50/LSTM recipe)."""
    peak = base_lr * scale
    warm = warmup_epochs * steps_per_epoch

    def f(step: float) -> float:
        if warm > 0 and step < warm:
            return peak * (step + 1) / warm
        epoch = step / steps_per_epoch
        mult = 1.0
        for m in milestones:
            if epoch >= m:
                mult *= decay
        return peak * mult

    return f


def one_cycle(
    base_lr: float,
    steps_per_epoch: int,
    phases: Sequence[tuple[float, float]] = ((1, 23), (23, 46), (46, 300)),
    lrs: Sequence[tuple[float, float]] = ((0.15, 3.0), (3.0, 0.15), (0.15, 0.015)),
    scale: float = 1.0,
) -> Schedule:
    """One-cycle schedule (the paper's ResNet20/DenseNet100 recipe).

    ``phases[i] = (e0, e1)`` epochs map linearly from ``lrs[i][0]*scale`` to
    ``lrs[i][1]*scale`` (the paper applies the graph scale ``s`` to selected
    endpoints; applying it uniformly keeps the shape identical).
    """

    def f(step: float) -> float:
        epoch = step / steps_per_epoch
        for (e0, e1), (l0, l1) in zip(phases, lrs):
            if epoch < e1 or (e0, e1) == tuple(phases[-1]):
                e = min(max(epoch, e0), e1)
                t = 0.0 if e1 == e0 else (e - e0) / (e1 - e0)
                return (l0 + (l1 - l0) * t) * scale
        l_last = lrs[-1][1] * scale
        return l_last

    return f

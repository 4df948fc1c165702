"""Shared model machinery: param definitions, norms, RoPE.

The counterpart of ``repro/models/common.py``.  Parameters are declared as
``ParamDef`` (shape, initializer, dtype), one per leaf of a dict, or of a
nested dict as the reference's trees are; initializers draw from an
explicit ``torch.Generator`` (their bits differ from ``jax.random``'s —
parity tests carry the reference's weights across instead).
``flatten_tree`` names a nested tree's leaves by their dotted paths in
``jax.tree.leaves``' order (keys sorted at each level, depth first), the
order of the engines' flat state.  Mesh partition specs are not ported:
the port holds all gossip nodes on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch

__all__ = [
    "ParamDef",
    "init_params",
    "param_count",
    "flatten_tree",
    "unflatten_tree",
    "at_least_f32",
    "rms_norm",
    "layer_norm",
    "rope",
    "apply_rope",
    "he_normal",
    "normal_init",
    "zeros_init",
    "ones_init",
]


# ---------------------------------------------------------------------------
# Param declaration
# ---------------------------------------------------------------------------

# init(generator, shape, dtype, device) -> tensor
Initializer = Callable[[torch.Generator, tuple, Any, Any], torch.Tensor]


def _normal(gen, shape, dtype, device, std: float) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def normal_init(stddev: float = 0.02) -> Initializer:
    return lambda gen, shape, dtype, device: _normal(gen, shape, dtype, device, stddev)


def he_normal(fan_in_axes: tuple[int, ...] = (-2,)) -> Initializer:
    def init(gen, shape, dtype, device):
        fan_in = 1
        for a in fan_in_axes:
            fan_in *= shape[a]
        return _normal(gen, shape, dtype, device, math.sqrt(2.0 / max(fan_in, 1)))

    return init


def zeros_init() -> Initializer:
    return lambda gen, shape, dtype, device: torch.zeros(shape, dtype=dtype, device=device)


def ones_init() -> Initializer:
    return lambda gen, shape, dtype, device: torch.ones(shape, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one weight tensor."""

    shape: tuple[int, ...]
    init: Initializer = normal_init()
    dtype: Any = torch.float32


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> flat dict keyed by dotted paths, in the reference's
    leaf order (sorted keys at each level, depth first)."""
    out: dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, path + "."))
        else:
            out[path] = v
    return out


def unflatten_tree(flat: Mapping[str, Any]) -> dict:
    """Inverse of ``flatten_tree``: a flat dict keyed by dotted paths ->
    the nested dict."""
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split(".")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def init_params(defs: Mapping, gen: torch.Generator, device, dtype=None) -> dict:
    """Materialize a ParamDef dict into tensors of the same structure.  A
    flat dict draws in its own order, a nested tree in leaf order; ``dtype``
    overrides every leaf's."""

    def make(d: ParamDef):
        return d.init(gen, d.shape, dtype if dtype is not None else d.dtype, device)

    if any(isinstance(v, Mapping) for v in defs.values()):
        return {k: (init_params(v, gen, device, dtype) if isinstance(v, Mapping)
                    else make(v))
                for k, v in sorted(defs.items())}
    return {k: make(d) for k, d in defs.items()}


def param_count(tree: Mapping) -> int:
    """Elements over every leaf of a (nested) dict of ParamDefs or tensors."""
    return sum(math.prod(x.shape) for x in flatten_tree(tree).values())


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or as it is if it is wider (a float64 run of a model,
    as the precision checks take one, stays float64 throughout)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = at_least_f32(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * at_least_f32(gamma)).to(x.dtype)


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    xf = at_least_f32(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * at_least_f32(gamma) + at_least_f32(beta)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(positions: torch.Tensor, d_head: int, theta: float = 10000.0,
         dtype: torch.dtype = torch.float32):
    """(sin, cos) tables for ``positions`` (any leading shape) -> (..., d_head/2),
    in ``dtype`` (float32, as the reference's; float64 for a float64 run)."""
    half = d_head // 2
    exps = torch.arange(0, half, dtype=dtype, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=dtype), exps)
    angles = positions.to(dtype)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate (..., S, H, Dh) by per-position (.., S, Dh/2) tables."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]  # broadcast over heads
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

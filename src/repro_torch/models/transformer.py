"""Dense transformer: the counterpart of ``repro/models/transformer.py``.

Token embeddings → pre-norm GQA attention blocks with a gated MLP → final
norm → LM head, for the dense family.  Parameters are one flat dict keyed
by the reference tree's paths joined with dots ("blocks.ffn.w_up"), in the
reference's leaf order (sorted keys, depth first); layer parameters carry a
leading L axis as ``stack_defs`` makes them, and the reference's
``lax.scan`` over layers is a Python loop.  ``remat`` is a memory knob of
the reference and is not needed at the port's depths.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (
    ParamDef,
    apply_rope,
    he_normal,
    init_params,
    layer_norm,
    normal_init,
    ones_init,
    rms_norm,
    rope,
    zeros_init,
)
from repro_torch.models.mlp import apply_mlp, mlp_defs

__all__ = [
    "model_defs",
    "init_model",
    "forward",
    "loss_fn",
    "cross_entropy",
    "params_from_jax",
]


def _flatten_sorted(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> flat dotted-path dict in reference leaf order."""
    out: dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten_sorted(v, path + "."))
        else:
            out[path] = v
    return out


def stack_defs(defs: dict[str, ParamDef], n: int) -> dict[str, ParamDef]:
    """Prepend a layer axis (n, ...) to every ParamDef.  The initializers'
    fan-in axes are negative, so they read the per-layer shape unchanged."""
    return {k: ParamDef((n,) + d.shape, d.init, d.dtype) for k, d in defs.items()}


def _norm_defs(cfg: ArchConfig, d: int):
    if cfg.norm == "layernorm":
        return {
            "b": ParamDef((d,), zeros_init(), cfg.dtype),
            "g": ParamDef((d,), ones_init(), cfg.dtype),
        }
    return {"g": ParamDef((d,), ones_init(), cfg.dtype)}


def _apply_norm(cfg: ArchConfig, p: Mapping, prefix: str, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p[prefix + ".g"], p[prefix + ".b"])
    return rms_norm(x, p[prefix + ".g"])


def attn_block_defs(cfg: ArchConfig) -> dict:
    d, dh, dt = cfg.d_model, cfg.head_dim, cfg.dtype
    h, kv = cfg.n_heads, cfg.n_kv
    defs = {
        "ln1": _norm_defs(cfg, d),
        "wq": ParamDef((d, h, dh), he_normal((-3,)), dt),
        "wk": ParamDef((d, kv, dh), he_normal((-3,)), dt),
        "wv": ParamDef((d, kv, dh), he_normal((-3,)), dt),
        "wo": ParamDef((h, dh, d), he_normal((-3, -2)), dt),
        "ln2": _norm_defs(cfg, d),
        "ffn": mlp_defs(d, cfg.d_ff, dtype=dt),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, dh), zeros_init(), dt)
        defs["bk"] = ParamDef((kv, dh), zeros_init(), dt)
        defs["bv"] = ParamDef((kv, dh), zeros_init(), dt)
    return defs


def model_defs(cfg: ArchConfig) -> dict[str, ParamDef]:
    """Flat ParamDef dict of the dense family, in reference leaf order."""
    if cfg.family != "dense" or cfg.n_experts:
        raise ValueError(
            f"family {cfg.family!r} is not ported yet (dense only); the model "
            "zoo is ROADMAP queue 1 step 12"
        )
    dt = cfg.dtype
    block = _flatten_sorted(attn_block_defs(cfg))
    nested = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), normal_init(0.02), dt),
        "final_norm": _norm_defs(cfg, cfg.d_model),
        "head": ParamDef((cfg.d_model, cfg.vocab), normal_init(0.02), dt),
        "blocks": stack_defs(block, cfg.n_layers),
    }
    return _flatten_sorted(nested)


def init_model(cfg: ArchConfig, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    return init_params(model_defs(cfg), gen, device)


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Carry reference parameters across: nested dicts of numpy arrays keyed
    like the reference tree -> the port's flat dict (CPU tensors, same
    dtype; bfloat16 arrays are carried bit for bit)."""
    out = {}
    for k, v in _flatten_sorted(tree).items():
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out[k] = t
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def apply_attn_block(p: Mapping, cfg: ArchConfig, h: torch.Tensor, *,
                     positions: torch.Tensor, window: Optional[int]):
    """One pre-norm attention + MLP block. h: (B, S, D); positions: (B, S)."""
    hn = _apply_norm(cfg, p, "ln1", h)
    q = torch.einsum("bsd,dhk->bshk", hn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", hn, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", hn, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    sin, cos = rope(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = attn_lib.multihead_attention(
        q, k, v, q_positions=positions, k_positions=positions,
        causal=True, window=window, impl=cfg.attn_impl,
    )
    h = h + torch.einsum("bshk,hkd->bsd", out, p["wo"])
    hn2 = _apply_norm(cfg, p, "ln2", h)
    ffn = {name[len("ffn."):]: t for name, t in p.items() if name.startswith("ffn.")}
    return h + apply_mlp(ffn, hn2, act=cfg.act)


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------

def _logits(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = _apply_norm(cfg, params, "final_norm", h)
    return torch.einsum("bsd,dv->bsv", h, params["head"])


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid (target >= 0) positions; f32 math."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.clamp_min(0).long()[..., None])[..., 0]
    valid = (targets >= 0).float()
    return torch.sum((lse - tgt) * valid) / torch.clamp(valid.sum(), min=1.0)


def forward(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, *,
            window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, V)."""
    h = params["embed"][tokens.long()]
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device)[None].expand(b, s)
    layers = {
        name[len("blocks."):]: t.unbind(0)
        for name, t in params.items() if name.startswith("blocks.")
    }
    for li in range(cfg.n_layers):
        lp = {name: ts[li] for name, ts in layers.items()}
        h = apply_attn_block(lp, cfg, h, positions=positions, window=window)
    return _logits(params, cfg, h)


def loss_fn(params: Mapping, cfg: ArchConfig, batch: Mapping) -> torch.Tensor:
    """Next-token CE.  batch: tokens/targets (B, S)."""
    logits = forward(params, cfg, batch["tokens"])
    return cross_entropy(logits, batch["targets"])

"""Dense transformer: the counterpart of ``repro/models/transformer.py``.

Token embeddings → pre-norm GQA attention blocks with a gated MLP → final
norm → LM head, for the dense family: training forward and loss, and
serving (``prefill`` into a KV cache, ``decode_step`` one token at a time
against it).  Parameters are one flat dict keyed by the reference tree's
paths joined with dots ("blocks.ffn.w_up"), in the reference's leaf order
(sorted keys, depth first); layer parameters carry a leading L axis as
``stack_defs`` makes them, and the reference's ``lax.scan`` over layers is
a Python loop.  ``remat`` (per-layer activation checkpointing in the
reference) is ignored here today: serving keeps no activations, but both
trainers backprop through ``loss_fn`` and keep every layer's, which at
full depth decides what fits one card; ``torch.utils.checkpoint`` per
layer is ROADMAP queue 1 item 6.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (
    ParamDef,
    apply_rope,
    flatten_tree,
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
    "attn_dims",
    "DecodeState",
    "init_decode_state",
    "prefill",
    "decode_step",
]


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


def attn_dims(cfg: ArchConfig) -> tuple[int, int]:
    """(query heads, KV heads).  The reference pads heads for tensor
    parallelism (``cfg.pad_heads``); the port runs no model axis yet."""
    return cfg.n_heads, cfg.n_kv


def attn_block_defs(cfg: ArchConfig) -> dict:
    d, dh, dt = cfg.d_model, cfg.head_dim, cfg.dtype
    h, kv = attn_dims(cfg)
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
            "zoo is ROADMAP queue 1 item 6"
        )
    dt = cfg.dtype
    block = flatten_tree(attn_block_defs(cfg))
    nested = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), normal_init(0.02), dt),
        "final_norm": _norm_defs(cfg, cfg.d_model),
        "head": ParamDef((cfg.d_model, cfg.vocab), normal_init(0.02), dt),
        "blocks": stack_defs(block, cfg.n_layers),
    }
    return flatten_tree(nested)


def init_model(cfg: ArchConfig, gen: torch.Generator, device) -> dict[str, torch.Tensor]:
    return init_params(model_defs(cfg), gen, device)


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Carry reference parameters across: nested dicts of numpy arrays keyed
    like the reference tree -> the port's flat dict (CPU tensors, same
    dtype; bfloat16 arrays are carried bit for bit)."""
    out = {}
    for k, v in flatten_tree(tree).items():
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

def _qkv(p: Mapping, cfg: ArchConfig, hn: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", hn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", hn, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", hn, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _ffn(p: Mapping, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    hn2 = _apply_norm(cfg, p, "ln2", h)
    ffn = {name[len("ffn."):]: t for name, t in p.items() if name.startswith("ffn.")}
    return h + apply_mlp(ffn, hn2, act=cfg.act)


def apply_attn_block(p: Mapping, cfg: ArchConfig, h: torch.Tensor, *,
                     positions: torch.Tensor, window: Optional[int],
                     collect_cache: bool = False):
    """One pre-norm attention + MLP block. h: (B, S, D); positions: (B, S).

    Returns (h', (k, v, positions) after RoPE when ``collect_cache`` else None)."""
    hn = _apply_norm(cfg, p, "ln1", h)
    q, k, v = _qkv(p, cfg, hn)
    sin, cos = rope(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = attn_lib.multihead_attention(
        q, k, v, q_positions=positions, k_positions=positions,
        causal=True, window=window, impl=cfg.attn_impl, chunk_size=cfg.attn_chunk,
    )
    h = _ffn(p, cfg, h + torch.einsum("bshk,hkd->bsd", out, p["wo"]))
    return h, ((k, v, positions) if collect_cache else None)


def decode_attn_block(p: Mapping, cfg: ArchConfig, h: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      cache_pos: torch.Tensor, *, pos: int, window: Optional[int]):
    """Single-token attention + MLP block against a cache (updated in place).

    h: (B, 1, D); cache_k/v: (B, slots, KV, Dh); cache_pos: (B, slots).
    """
    hn = _apply_norm(cfg, p, "ln1", h)
    q, k, v = _qkv(p, cfg, hn)
    posb = torch.full((h.shape[0], 1), pos, dtype=torch.int32, device=h.device)
    sin, cos = rope(posb, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    attn_lib.cache_update(cache_k, cache_v, cache_pos, k, v, pos, ring=window is not None)
    out = attn_lib.decode_attention(q, cache_k, cache_v, cache_pos, pos=pos, window=window)
    return _ffn(p, cfg, h + torch.einsum("bshk,hkd->bsd", out, p["wo"]))


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


def _layers(params: Mapping, n_layers: int):
    """Per-layer views of the stacked block parameters."""
    stacked = {
        name[len("blocks."):]: t.unbind(0)
        for name, t in params.items() if name.startswith("blocks.")
    }
    return [{name: ts[li] for name, ts in stacked.items()} for li in range(n_layers)]


def forward(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, *,
            window: Optional[int] = None, collect_cache: bool = False):
    """Full-sequence forward: tokens (B, S) -> logits (B, S, V).

    With ``collect_cache`` it returns (logits, (k, v, positions)): every
    layer's keys (after RoPE) and values stacked to (L, B, S, KV, Dh), and
    the positions to (L, B, S)."""
    h = params["embed"][tokens.long()]
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device)[None].expand(b, s)
    entries = []
    for lp in _layers(params, cfg.n_layers):
        h, entry = apply_attn_block(lp, cfg, h, positions=positions, window=window,
                                    collect_cache=collect_cache)
        entries.append(entry)
    logits = _logits(params, cfg, h)
    if not collect_cache:
        return logits
    return logits, tuple(torch.stack(xs) for xs in zip(*entries))


def loss_fn(params: Mapping, cfg: ArchConfig, batch: Mapping) -> torch.Tensor:
    """Next-token CE.  batch: tokens/targets (B, S)."""
    logits = forward(params, cfg, batch["tokens"])
    return cross_entropy(logits, batch["targets"])


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Decode state of the dense family: ``kv`` = (k, v, positions), k and v
    (L, B, slots, KV, Dh), positions (L, B, slots) with -1 for an empty slot.
    The reference's rwkv and hybrid fields come with those families."""

    kv: tuple


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.n_experts:
        raise ValueError(
            f"family {cfg.family!r} is not ported yet (dense only); the model "
            "zoo is ROADMAP queue 1 item 6"
        )


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, *,
                      window: Optional[int] = None, device=None) -> DecodeState:
    """Empty decode state sized for a ``seq_len`` context (``window`` slots
    in a ring when a window is given)."""
    _dense_only(cfg)
    slots = min(window, seq_len) if window else seq_len
    _, kv = attn_dims(cfg)
    shape = (cfg.n_layers, batch, slots, kv, cfg.head_dim)
    return DecodeState(kv=(
        torch.zeros(shape, dtype=cfg.dtype, device=device),
        torch.zeros(shape, dtype=cfg.dtype, device=device),
        torch.full(shape[:3], -1, dtype=torch.int32, device=device),
    ))


def prefill(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor):
    """Process a prompt; returns (last-token logits (B, V), DecodeState)."""
    _dense_only(cfg)
    logits, (k, v, p) = forward(params, cfg, tokens, collect_cache=True)
    return logits[:, -1], DecodeState(kv=(k, v, p))


def decode_step(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, pos: int,
                state: DecodeState, *, window: Optional[int] = None):
    """One token for every sequence in the batch.

    tokens: (B, 1); pos: the current absolute position.  The state's cache
    is updated IN PLACE (the reference returns a new one).
    Returns (logits (B, V), the DecodeState).
    """
    _dense_only(cfg)
    pos = int(pos)
    h = params["embed"][tokens.long()]  # (B, 1, D)
    k, v, p = state.kv
    for li, lp in enumerate(_layers(params, cfg.n_layers)):
        h = decode_attn_block(lp, cfg, h, k[li], v[li], p[li], pos=pos, window=window)
    return _logits(params, cfg, h)[:, 0], state

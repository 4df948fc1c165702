"""Model assembly for every family: the counterpart of
``repro/models/transformer.py``.

Families:
  dense / moe / audio / vlm : token embeddings (a VLM prepends its
      precomputed patch embeddings) → pre-norm GQA attention blocks with a
      gated MLP or a mixture of experts → final norm → LM head.
  ssm    : RWKV6 blocks (attention-free).
  hybrid : Mamba2 blocks with one shared-weight attention block after
      every ``attn_every - 1`` of them (the Zamba2 pattern: the same
      ``shared_attn`` parameters run in every group, so their gradients
      sum over the groups), then the tail's Mamba2 blocks.

Parameters are one flat dict keyed by the reference tree's paths joined
with dots ("blocks.ffn.w_up", "mamba_groups.a_log"), in the reference's
leaf order (sorted keys, depth first); layer parameters carry the leading
axes ``stack_defs`` gives them ((L, ...) for blocks, (groups, group − 1,
...) for the hybrid's Mamba2 groups), and the reference's ``lax.scan``
over layers is a Python loop.  A hybrid model keeps its Mamba2 ``a_log``
and ``d_skip`` in float32 whatever ``cfg.dtype`` is.

``cfg.remat`` checkpoints every block (attention, RWKV6 and Mamba2 alike),
as the reference's ``_maybe_remat`` does: each runs under
``torch.utils.checkpoint.checkpoint`` (non reentrant), which keeps the
block's input and recomputes its activations in the backward pass; the
numbers are those without remat, bit for bit.  ``remat_policy="dots"``
keeps the outputs of the matrix products (``mm``/``bmm``/``addmm``, which
the blocks' products lower to) through a selective-checkpoint policy and
recomputes the rest: the closest torch form of
``jax.checkpoint_policies.dots_saveable``, which keeps every dot with no
batch dimension, where this keeps the lowered products, batched or not.
Remat applies only where autograd records the forward, and not under a
``torch.func`` transform (the simulator's vmapped gradients), which cannot
run the saved-tensor hooks it needs; there the blocks run as they are.

Serving: ``prefill`` runs the prompt and returns the family's
``DecodeState`` (KV caches, RWKV states or the hybrid's both);
``decode_step`` advances it by one token, IN PLACE.
"""
from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (
    ParamDef,
    apply_rope,
    at_least_f32,
    flatten_tree,
    he_normal,
    init_params,
    layer_norm,
    normal_init,
    ones_init,
    rms_norm,
    rope,
    unflatten_tree,
    zeros_init,
)
from repro_torch.models.mamba2 import (
    MambaState,
    apply_mamba_block,
    mamba_block_decode,
    mamba_block_defs,
    mamba_n_heads,
)
from repro_torch.models.mlp import apply_mlp, mlp_defs
from repro_torch.models.moe import apply_moe, apply_moe_manual_ep, moe_defs
from repro_torch.models.rwkv6 import (
    RWKVState,
    apply_rwkv_block,
    rwkv_block_decode,
    rwkv_block_defs,
)

__all__ = [
    "FAMILIES",
    "model_defs",
    "init_model",
    "forward",
    "forward_full",
    "loss_fn",
    "cross_entropy",
    "params_from_jax",
    "attn_dims",
    "DecodeState",
    "init_decode_state",
    "prefill",
    "decode_step",
]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; one of {FAMILIES}")
    if cfg.n_experts and cfg.moe_impl == "manual_ep":
        apply_moe_manual_ep()   # raises: not ported


def stack_defs(defs: Mapping, n: int) -> dict:
    """Prepend a layer axis (n, ...) to every ParamDef of a (nested) dict.
    The initializers' fan-in axes are negative, so they read the per-layer
    shape unchanged."""
    return {k: (stack_defs(d, n) if isinstance(d, Mapping)
                else ParamDef((n,) + d.shape, d.init, d.dtype))
            for k, d in defs.items()}


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


def attn_dims(cfg: ArchConfig, tp_size: int = 1) -> tuple[int, int]:
    """(query heads, KV heads) as materialized.  The reference pads GQA
    groups (``cfg.pad_heads``/``pad_kv``) so heads shard on its model
    axis; at the port's tensor-parallel size of 1 that pads nothing."""
    if not (cfg.pad_heads or cfg.pad_kv):
        return cfg.n_heads, cfg.n_kv
    h_pad, kv_pad, _ = attn_lib.head_padding(cfg.n_heads, cfg.n_kv, tp_size,
                                             pad_kv=cfg.pad_kv)
    if (h_pad, kv_pad) != (cfg.n_heads, cfg.n_kv):
        raise ValueError(
            f"head padding to ({h_pad}, {kv_pad}) at tensor-parallel size {tp_size} "
            "is not ported: tensor parallelism is ROADMAP queue 1 item 8"
        )
    return h_pad, kv_pad


def attn_block_defs(cfg: ArchConfig, *, with_ffn: bool = True) -> dict:
    d, dh, dt = cfg.d_model, cfg.head_dim, cfg.dtype
    h, kv = attn_dims(cfg)
    defs = {
        "ln1": _norm_defs(cfg, d),
        "wq": ParamDef((d, h, dh), he_normal((-3,)), dt),
        "wk": ParamDef((d, kv, dh), he_normal((-3,)), dt),
        "wv": ParamDef((d, kv, dh), he_normal((-3,)), dt),
        "wo": ParamDef((h, dh, d), he_normal((-3, -2)), dt),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, dh), zeros_init(), dt)
        defs["bk"] = ParamDef((kv, dh), zeros_init(), dt)
        defs["bv"] = ParamDef((kv, dh), zeros_init(), dt)
    if with_ffn:
        defs["ln2"] = _norm_defs(cfg, d)
        if cfg.n_experts:
            defs["ffn"] = moe_defs(d, cfg.d_ff, cfg.n_experts, n_shared=cfg.n_shared_experts,
                                   dtype=dt)
        else:
            defs["ffn"] = mlp_defs(d, cfg.d_ff, dtype=dt)
    return defs


def _rwkv_heads(cfg: ArchConfig) -> int:
    return cfg.n_heads or cfg.d_model // 64


def model_defs(cfg: ArchConfig) -> dict[str, ParamDef]:
    """Flat ParamDef dict of the model, in reference leaf order."""
    _check_family(cfg)
    dt = cfg.dtype
    nested = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), normal_init(0.02), dt),
        "final_norm": _norm_defs(cfg, cfg.d_model),
        "head": ParamDef((cfg.d_model, cfg.vocab), normal_init(0.02), dt),
    }
    if cfg.family == "ssm":
        nested["blocks"] = stack_defs(
            rwkv_block_defs(cfg.d_model, _rwkv_heads(cfg), cfg.d_ff, dt), cfg.n_layers)
    elif cfg.family == "hybrid":
        group = cfg.attn_every
        n_groups, tail = divmod(cfg.n_layers, group)
        mdefs = mamba_block_defs(cfg.d_model, cfg.ssm_state, dtype=dt)
        nested["mamba_groups"] = stack_defs(stack_defs(mdefs, group - 1), n_groups)
        nested["shared_attn"] = attn_block_defs(cfg, with_ffn=True)
        if tail:
            nested["tail_mamba"] = stack_defs(mdefs, tail)
    else:  # dense | moe | audio | vlm
        nested["blocks"] = stack_defs(attn_block_defs(cfg), cfg.n_layers)
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
# Parameter views
# ---------------------------------------------------------------------------

def _sub(params: Mapping, prefix: str) -> dict:
    """The leaves under ``prefix.``, keyed by the rest of their path."""
    n = len(prefix) + 1
    return {name[n:]: t for name, t in params.items() if name.startswith(prefix + ".")}


def _unstack(flat: Mapping, n: int) -> list[dict]:
    """Per-index views along the leading axis of every leaf."""
    split = {name: t.unbind(0) for name, t in flat.items()}
    return [{name: ts[i] for name, ts in split.items()} for i in range(n)]


def _layers(params: Mapping, n_layers: int):
    """Per-layer views of the stacked block parameters."""
    return _unstack(_sub(params, "blocks"), n_layers)


def _stack_states(states: list):
    """A list of NamedTuple states -> one with every leaf stacked on axis 0."""
    return type(states[0])(*(torch.stack(xs) for xs in zip(*states)))


# ---------------------------------------------------------------------------
# Attention blocks
# ---------------------------------------------------------------------------

def _qkv(p: Mapping, cfg: ArchConfig, hn: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", hn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", hn, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", hn, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _ffn(p: Mapping, cfg: ArchConfig, h: torch.Tensor):
    """The block's feed-forward half with its residual: (h', aux loss)."""
    hn2 = _apply_norm(cfg, p, "ln2", h)
    ffn = unflatten_tree(_sub(p, "ffn"))
    if cfg.n_experts:
        ff, aux = apply_moe(ffn, hn2, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    else:
        ff = apply_mlp(ffn, hn2, act=cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ff, aux


def apply_attn_block(p: Mapping, cfg: ArchConfig, h: torch.Tensor, *,
                     positions: torch.Tensor, window: Optional[int],
                     collect_cache: bool = False):
    """One pre-norm attention + feed-forward block. h: (B, S, D);
    positions: (B, S).  Returns (h', (k, v, positions) after RoPE when
    ``collect_cache`` else None, the MoE aux loss (0 without experts))."""
    hn = _apply_norm(cfg, p, "ln1", h)
    q, k, v = _qkv(p, cfg, hn)
    sin, cos = rope(positions, cfg.head_dim, cfg.rope_theta, at_least_f32(h).dtype)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = attn_lib.multihead_attention(
        q, k, v, q_positions=positions, k_positions=positions,
        causal=True, window=window, impl=cfg.attn_impl, chunk_size=cfg.attn_chunk,
    )
    h, aux = _ffn(p, cfg, h + torch.einsum("bshk,hkd->bsd", out, p["wo"]))
    return h, ((k, v, positions) if collect_cache else None), aux


def decode_attn_block(p: Mapping, cfg: ArchConfig, h: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      cache_pos: torch.Tensor, *, pos: int, window: Optional[int]):
    """Single-token attention + feed-forward block against a cache (updated
    in place).  h: (B, 1, D); cache_k/v: (B, slots, KV, Dh); cache_pos:
    (B, slots)."""
    hn = _apply_norm(cfg, p, "ln1", h)
    q, k, v = _qkv(p, cfg, hn)
    posb = torch.full((h.shape[0], 1), pos, dtype=torch.int32, device=h.device)
    sin, cos = rope(posb, cfg.head_dim, cfg.rope_theta, at_least_f32(h).dtype)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    attn_lib.cache_update(cache_k, cache_v, cache_pos, k, v, pos, ring=window is not None)
    out = attn_lib.decode_attention(q, cache_k, cache_v, cache_pos, pos=pos, window=window)
    return _ffn(p, cfg, h + torch.einsum("bshk,hkd->bsd", out, p["wo"]))[0]


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------

def _embed(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, patch_embeds=None):
    h = params["embed"][tokens.long()]
    if cfg.input_kind == "vlm" and patch_embeds is not None:
        # decode steps carry no new patches; prefill/train prepend them
        h = torch.cat([patch_embeds.to(h.dtype), h], dim=1)
    return h


def _logits(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = _apply_norm(cfg, params, "final_norm", h)
    return torch.einsum("bsd,dv->bsv", h, params["head"])


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid (target >= 0) positions; f32 math."""
    lf = at_least_f32(logits)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.clamp_min(0).long()[..., None])[..., 0]
    valid = (targets >= 0).to(lf.dtype)
    return torch.sum((lse - tgt) * valid) / torch.clamp(valid.sum(), min=1.0)


# the matrix products a "dots" remat keeps (what the blocks' products lower to)
_DOT_OPS = ("mm", "bmm", "addmm", "baddbmm")


def _keep_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    packet = getattr(op, "overloadpacket", None)
    if packet is not None and packet.__name__ in _DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig, block):
    """``block`` under per-block activation checkpointing when ``cfg.remat``
    asks for it and autograd records outside any ``torch.func`` transform."""
    if not cfg.remat or not torch.is_grad_enabled():
        return block
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return block
    from torch.utils import checkpoint as ckpt

    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _keep_dots)
    elif cfg.remat_policy != "full":
        raise ValueError(f"remat_policy must be 'full' or 'dots', got {cfg.remat_policy!r}")
    return lambda *args, **kwargs: ckpt.checkpoint(block, *args, use_reentrant=False,
                                                   **kw, **kwargs)


def forward_full(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, *,
                 patch_embeds=None, window: Optional[int] = None,
                 collect_cache: bool = False):
    """Full-sequence forward, the reference's ``forward``: returns (logits
    (B, S_total, V), cache or states or None, aux loss).  The attention
    families return their (k, v, positions) cache stacked to (L, B, S, KV,
    Dh) with ``collect_cache``; ssm returns its RWKVState (leaves (L, B,
    ...)) and hybrid its {"mamba", "attn_cache", "tail"} states always,
    from zero states at entry."""
    _check_family(cfg)
    h = _embed(params, cfg, tokens, patch_embeds)
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    if cfg.family == "ssm":
        n_heads = _rwkv_heads(cfg)
        block = _remat(cfg, apply_rwkv_block)
        states = []
        for lp in _layers(params, cfg.n_layers):
            st0 = RWKVState.empty(b, n_heads, cfg.d_model // n_heads, cfg.d_model, h.dtype,
                                  h.device)
            h, st = block(unflatten_tree(lp), h, st0, n_heads=n_heads, chunk=cfg.rec_chunk)
            states.append(st)
        return _logits(params, cfg, h), _stack_states(states), aux

    if cfg.family == "hybrid":
        return _hybrid_forward(params, cfg, h, positions, window, collect_cache)

    block = _remat(cfg, apply_attn_block)
    entries = []
    for lp in _layers(params, cfg.n_layers):
        h, entry, a = block(lp, cfg, h, positions=positions, window=window,
                            collect_cache=collect_cache)
        aux = aux + a
        entries.append(entry)
    cache = tuple(torch.stack(xs) for xs in zip(*entries)) if collect_cache else None
    return _logits(params, cfg, h), cache, aux


def _hybrid_forward(params, cfg, h, positions, window, collect_cache):
    b = h.shape[0]
    group = cfg.attn_every
    n_groups = cfg.n_layers // group

    def mk_state():
        return MambaState.empty(b, mamba_n_heads(cfg.d_model), cfg.ssm_state,
                                cfg.d_model * 2, h.dtype, h.device)

    shared = _sub(params, "shared_attn")
    mblock = _remat(cfg, apply_mamba_block)
    ablock = _remat(cfg, apply_attn_block)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    m_states, caches = [], []
    for gp in _unstack(_sub(params, "mamba_groups"), n_groups):
        sts = []
        for lp in _unstack(gp, group - 1):
            h, st = mblock(unflatten_tree(lp), h, mk_state(), d_state=cfg.ssm_state,
                           chunk=cfg.rec_chunk)
            sts.append(st)
        h, entry, a = ablock(shared, cfg, h, positions=positions, window=window,
                             collect_cache=collect_cache)
        aux = aux + a
        m_states.append(_stack_states(sts))
        caches.append(entry)

    tail_states = None
    tail = _sub(params, "tail_mamba")
    if tail:
        sts = []
        for lp in _unstack(tail, next(iter(tail.values())).shape[0]):
            h, st = mblock(unflatten_tree(lp), h, mk_state(), d_state=cfg.ssm_state,
                           chunk=cfg.rec_chunk)
            sts.append(st)
        tail_states = _stack_states(sts)

    states = {
        "mamba": _stack_states(m_states),
        "attn_cache": (tuple(torch.stack(xs) for xs in zip(*caches))
                       if collect_cache else None),
        "tail": tail_states,
    }
    return _logits(params, cfg, h), states, aux


def forward(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, *,
            patch_embeds=None, window: Optional[int] = None,
            collect_cache: bool = False):
    """Full-sequence forward: tokens (B, S) -> logits (B, S_total, V).

    With ``collect_cache`` it returns (logits, cache or states) as
    ``forward_full`` gives them."""
    logits, st, _ = forward_full(params, cfg, tokens, patch_embeds=patch_embeds,
                                 window=window, collect_cache=collect_cache)
    return (logits, st) if collect_cache else logits


def loss_fn(params: Mapping, cfg: ArchConfig, batch: Mapping) -> torch.Tensor:
    """Next-token CE (+ the MoE aux loss, weighted by ``aux_loss_weight``).
    batch: tokens/targets (B, S), and for a VLM patch_embeds (B, n_patches,
    D), whose positions the loss skips.  A VLM batch without patch_embeds
    raises: the reference's loss slices off n_patches logits that were
    never prepended and fails on the shapes."""
    patches = batch.get("patch_embeds")
    if cfg.input_kind == "vlm" and patches is None:
        raise ValueError(
            f"{cfg.name}: a VLM training batch needs 'patch_embeds' "
            f"(B, {cfg.n_patches}, {cfg.d_model}); the loss skips the patches' "
            "positions, which a batch without them does not have"
        )
    logits, _, aux = forward_full(params, cfg, batch["tokens"], patch_embeds=patches)
    if cfg.input_kind == "vlm":
        logits = logits[:, cfg.n_patches:]
    loss = cross_entropy(logits, batch["targets"])
    return loss + cfg.aux_loss_weight * aux if cfg.n_experts else loss


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Family-polymorphic decode state (exactly one field is not None).

    ``kv``: (k, v, positions), k and v (L, B, slots, KV, Dh), positions
    (L, B, slots) with -1 for an empty slot; ``rwkv``: an RWKVState of
    (L, B, ...) leaves; ``hybrid``: {"mamba": MambaState of (groups,
    group − 1, B, ...) leaves, "attn_cache": the shared block's (k, v,
    positions) per group, (groups, B, slots, ...), "tail": MambaState of
    (tail, B, ...) leaves or None}."""

    kv: Optional[tuple] = None
    rwkv: Optional[RWKVState] = None
    hybrid: Optional[dict] = None


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, *,
                      window: Optional[int] = None, device=None) -> DecodeState:
    """Empty decode state sized for a ``seq_len`` context (``window`` slots
    in a ring when a window is given)."""
    _check_family(cfg)
    slots = min(window, seq_len) if window else seq_len
    _, kv = attn_dims(cfg)

    def mk_kv(n):
        shape = (n, batch, slots, kv, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.full(shape[:3], -1, dtype=torch.int32, device=device))

    def lead(st, dims):
        return type(st)(*(x.expand(dims + x.shape).clone() for x in st))

    if cfg.family == "ssm":
        n_heads = _rwkv_heads(cfg)
        st = RWKVState.empty(batch, n_heads, cfg.d_model // n_heads, cfg.d_model, cfg.dtype,
                             device)
        return DecodeState(rwkv=lead(st, (cfg.n_layers,)))
    if cfg.family == "hybrid":
        group = cfg.attn_every
        n_groups, tail = divmod(cfg.n_layers, group)
        mst = MambaState.empty(batch, mamba_n_heads(cfg.d_model), cfg.ssm_state,
                               cfg.d_model * 2, cfg.dtype, device)
        return DecodeState(hybrid={
            "mamba": lead(mst, (n_groups, group - 1)),
            "attn_cache": mk_kv(n_groups),
            "tail": lead(mst, (tail,)) if tail else None,
        })
    return DecodeState(kv=mk_kv(cfg.n_layers))


def prefill(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, *, patch_embeds=None):
    """Process a prompt (a VLM's patches first); returns (last-token logits
    (B, V), DecodeState over the prompt's positions)."""
    logits, st, _ = forward_full(params, cfg, tokens, patch_embeds=patch_embeds,
                                 collect_cache=True)
    last = logits[:, -1]
    if cfg.family == "ssm":
        return last, DecodeState(rwkv=st)
    if cfg.family == "hybrid":
        return last, DecodeState(hybrid=st)
    return last, DecodeState(kv=st)


def _copy_state_(dst, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def decode_step(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, pos: int,
                state: DecodeState, *, window: Optional[int] = None):
    """One token for every sequence in the batch.

    tokens: (B, 1); pos: the current absolute position.  The state is
    updated IN PLACE (the reference returns a new one).
    Returns (logits (B, V), the DecodeState).
    """
    _check_family(cfg)
    pos = int(pos)
    h = _embed(params, cfg, tokens)  # (B, 1, D)

    if cfg.family == "ssm":
        n_heads = _rwkv_heads(cfg)
        h1 = h[:, 0]
        for li, lp in enumerate(_layers(params, cfg.n_layers)):
            st = RWKVState(*(x[li] for x in state.rwkv))
            h1, st2 = rwkv_block_decode(unflatten_tree(lp), h1, st, n_heads=n_heads)
            _copy_state_(st, st2)
        return _logits(params, cfg, h1[:, None])[:, 0], state

    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, h, pos, state, window)

    k, v, p = state.kv
    for li, lp in enumerate(_layers(params, cfg.n_layers)):
        h = decode_attn_block(lp, cfg, h, k[li], v[li], p[li], pos=pos, window=window)
    return _logits(params, cfg, h)[:, 0], state


def _hybrid_decode(params, cfg, h, pos, state, window):
    group = cfg.attn_every
    shared = _sub(params, "shared_attn")
    hst = state.hybrid
    k, v, p = hst["attn_cache"]
    n_groups = k.shape[0]
    h1 = h[:, 0]
    for g, gp in enumerate(_unstack(_sub(params, "mamba_groups"), n_groups)):
        for i, lp in enumerate(_unstack(gp, group - 1)):
            st = MambaState(*(x[g, i] for x in hst["mamba"]))
            h1, st2 = mamba_block_decode(unflatten_tree(lp), h1, st, d_state=cfg.ssm_state)
            _copy_state_(st, st2)
        h1 = decode_attn_block(shared, cfg, h1[:, None], k[g], v[g], p[g], pos=pos,
                               window=window)[:, 0]
    if hst.get("tail") is not None:
        tail = _sub(params, "tail_mamba")
        for i, lp in enumerate(_unstack(tail, hst["tail"].h.shape[0])):
            st = MambaState(*(x[i] for x in hst["tail"]))
            h1, st2 = mamba_block_decode(unflatten_tree(lp), h1, st, d_state=cfg.ssm_state)
            _copy_state_(st, st2)
    return _logits(params, cfg, h1[:, None])[:, 0], state

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

Tensor parallelism (the reference's model axis): ``model_defs(cfg,
tp_size)`` declares every leaf with its logical spec and pads the heads at
``tp_size`` when ``cfg.pad_heads``/``pad_kv`` ask (padded heads are masked
out of the attention's output, ``_pad_mask``).  Head-dim sharding when the
head count divides ``tp_size``, otherwise the contraction (d_model) dim is
sharded (``_head_spec``).  One card runs the padded model whole.  On a
tensor-parallel rank (``tp``: the node's model group,
``launch/tensor_parallel.py``; the attention families only) the forward
takes the rank's shards of every leaf and realizes the placement with
explicit collectives: heads-sharded q/k/v are column parallel and ``wo``
row parallel; the contraction fallback is a row-parallel q/k/v and a
``wo`` split on its output dim; the MLP's up/gate are column and its down
row parallel; ``embed`` is split on d_model (an all-gather rebuilds the
activation) and ``head`` on the vocabulary (a vocab-parallel
log-softmax); the experts are split on E (``moe.apply_moe_manual_ep``);
RWKV6 and Mamba2 blocks own H/tp heads (``models/rwkv6.py``,
``models/mamba2.py``), and zamba2's shared block is the attention block
above, its gradient summed over the groups that share it.  Which dim a
leaf is split on follows from ``cfg`` and the group's size as the
reference's ``_validated_spec`` decides it: a dim that does not divide
stays whole.  Every family runs on a rank, in training and in serving.

Serving on a rank: ``prefill``/``decode_step`` with ``tp`` return the
rank's vocabulary columns of the logits and a decode state of the rank's
heads (``init_decode_state(..., tp_size=, tp_rank=)``): RWKV and Mamba2
states of its heads, and a KV cache sized at the padded KV count
(``attn_dims``) holding ``cache_kv_heads``: the rank's KV heads where the
KV count divides tp; else (the contraction fallback: k and v whole after
the all-reduce) the KV heads that the rank's own query heads read, all
of them where q is not head-sharded either.  The reference places such
caches differently (one dim over "model" by its rule, the head dim at
granite-8b's shapes, or the combined (data, model) axes on the slots at
B = 1: ``repro/launch/serve.py::_state_shardings``); that is a placement,
not a different number.  The decode path masks padded heads
as the reference's ``decode_attn_block`` does.
"""
from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import active_head_mask
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
    "cache_kv_heads",
    "DecodeState",
    "init_decode_state",
    "prefill",
    "decode_step",
]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; one of {FAMILIES}")


def stack_defs(defs: Mapping, n: int) -> dict:
    """Prepend a layer axis (n, ...) to every ParamDef of a (nested) dict
    (its spec gains a leading None).  The initializers' fan-in axes are
    negative, so they read the per-layer shape unchanged."""
    return {k: (stack_defs(d, n) if isinstance(d, Mapping)
                else ParamDef((n,) + d.shape, d.init, d.dtype, (None,) + d.spec))
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


def _head_spec(n: int, tp: int, tail: tuple = (None,)) -> tuple:
    """("model" on the head dim) if ``n`` divides by ``tp``, else the
    contraction-dim fallback."""
    if n % tp == 0:
        return (None, "model") + tail
    return ("model", None) + tail


def attn_dims(cfg: ArchConfig, tp_size: int = 1) -> tuple[int, int]:
    """(h, kv) as materialized — padded when ``cfg.pad_heads``/``pad_kv``
    ask, at tensor-parallel size ``tp_size`` (exact semantics through the
    active-head mask; see ``attention.head_padding``)."""
    if not (cfg.pad_heads or cfg.pad_kv):
        return cfg.n_heads, cfg.n_kv
    h_pad, kv_pad, _ = attn_lib.head_padding(cfg.n_heads, cfg.n_kv, tp_size,
                                             pad_kv=cfg.pad_kv)
    return h_pad, kv_pad


def _pad_mask(cfg: ArchConfig, h_pad: int, kv_pad: int, device) -> Optional[torch.Tensor]:
    """Active-head mask (h_pad,) or None when no head is padded."""
    if h_pad == cfg.n_heads and kv_pad == cfg.n_kv:
        return None
    return active_head_mask(cfg.n_heads, cfg.n_kv, h_pad, kv_pad, h_pad // kv_pad, device)


def attn_block_defs(cfg: ArchConfig, tp_size: int = 1, *, with_ffn: bool = True) -> dict:
    d, dh, dt = cfg.d_model, cfg.head_dim, cfg.dtype
    h, kv = attn_dims(cfg, tp_size)
    defs = {
        "ln1": _norm_defs(cfg, d),
        "wq": ParamDef((d, h, dh), he_normal((-3,)), dt, _head_spec(h, tp_size)),
        "wk": ParamDef((d, kv, dh), he_normal((-3,)), dt, _head_spec(kv, tp_size)),
        "wv": ParamDef((d, kv, dh), he_normal((-3,)), dt, _head_spec(kv, tp_size)),
        "wo": ParamDef((h, dh, d), he_normal((-3, -2)), dt,
                       ("model", None, None) if h % tp_size == 0 else (None, None, "model")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, dh), zeros_init(), dt)
        defs["bk"] = ParamDef((kv, dh), zeros_init(), dt)
        defs["bv"] = ParamDef((kv, dh), zeros_init(), dt)
    if with_ffn:
        defs["ln2"] = _norm_defs(cfg, d)
        if cfg.n_experts:
            defs["ffn"] = moe_defs(d, cfg.d_ff, cfg.n_experts, n_shared=cfg.n_shared_experts,
                                   shard_ff=cfg.moe_shard_ff, dtype=dt)
        else:
            defs["ffn"] = mlp_defs(d, cfg.d_ff, dtype=dt)
    return defs


def _rwkv_heads(cfg: ArchConfig) -> int:
    return cfg.n_heads or cfg.d_model // 64


def model_defs(cfg: ArchConfig, tp_size: int = 1) -> dict[str, ParamDef]:
    """Flat ParamDef dict of the model, in reference leaf order, the heads
    padded for a model axis of ``tp_size`` (the reference's default is 16;
    every caller of it passes the mesh's size, as the port's do)."""
    _check_family(cfg)
    dt = cfg.dtype
    nested = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), normal_init(0.02), dt, (None, "model")),
        "final_norm": _norm_defs(cfg, cfg.d_model),
        "head": ParamDef((cfg.d_model, cfg.vocab), normal_init(0.02), dt, (None, "model")),
    }
    if cfg.family == "ssm":
        nested["blocks"] = stack_defs(
            rwkv_block_defs(cfg.d_model, _rwkv_heads(cfg), cfg.d_ff, dt), cfg.n_layers)
    elif cfg.family == "hybrid":
        group = cfg.attn_every
        n_groups, tail = divmod(cfg.n_layers, group)
        mdefs = mamba_block_defs(cfg.d_model, cfg.ssm_state, dtype=dt)
        nested["mamba_groups"] = stack_defs(stack_defs(mdefs, group - 1), n_groups)
        nested["shared_attn"] = attn_block_defs(cfg, tp_size, with_ffn=True)
        if tail:
            nested["tail_mamba"] = stack_defs(mdefs, tail)
    else:  # dense | moe | audio | vlm
        nested["blocks"] = stack_defs(attn_block_defs(cfg, tp_size), cfg.n_layers)
    return flatten_tree(nested)


def init_model(cfg: ArchConfig, gen: torch.Generator, device,
               tp_size: int = 1) -> dict[str, torch.Tensor]:
    return init_params(model_defs(cfg, tp_size), gen, device)


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


def _ffn(p: Mapping, cfg: ArchConfig, h: torch.Tensor, tp=None):
    """The block's feed-forward half with its residual: (h', aux loss).  On
    a tensor-parallel rank the experts run the manual expert-parallel
    schedule (either ``moe_impl``) and the MLP is column/row parallel."""
    hn2 = _apply_norm(cfg, p, "ln2", h)
    ffn = unflatten_tree(_sub(p, "ffn"))
    if cfg.n_experts:
        kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        if tp is not None:
            # a batch split over the node's data ranks: the tokens of the
            # whole batch are routed once, identically on every data rank
            # (the reference's capacity counts them all), each rank
            # computing its share of the capacity slots and keeping its rows
            dp = tp.data if tp.data is not None and tp.data.split_batch else None
            ff, aux = apply_moe_manual_ep(
                ffn, hn2 if dp is None else dp.gather(hn2, 0), tp=tp.split(cfg.n_experts),
                shared_tp=tp.split(cfg.n_shared_experts * cfg.d_ff), dp=dp, **kw)
        elif cfg.moe_impl == "manual_ep":
            ff, aux = apply_moe_manual_ep(ffn, hn2, **kw)
        else:
            ff, aux = apply_moe(ffn, hn2, **kw)
    else:
        ff = apply_mlp(ffn, hn2, act=cfg.act, tp=None if tp is None else tp.split(cfg.d_ff))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ff, aux


def _masked(cfg: ArchConfig, out: torch.Tensor, h_pad: int, kv_pad: int,
            heads: slice = slice(None)) -> torch.Tensor:
    """The attention output (B, S, H, Dh) with padded heads zeroed (``heads``:
    which of the h_pad heads ``out`` holds)."""
    mask = _pad_mask(cfg, h_pad, kv_pad, out.device)
    if mask is None:
        return out
    return out * mask[heads][None, None, :, None].to(out.dtype)


def _tp_proj(tp, cfg: ArchConfig, hn, hin, w, bias, n: int):
    """One of q/k/v on a tensor-parallel rank: (B, S, n', Dh) and which of
    the n heads it holds.  Heads on "model": column parallel on the local
    heads (a replicated bias enters for its local heads); the contraction
    fallback: row parallel over d_model, all-reduced; else whole."""
    if w.shape[1] < n:
        heads = tp.local(n)
        y = torch.einsum("bsd,dhk->bshk", hin, w)
        return (y if bias is None else y + tp.enter(bias)[heads]), heads
    if w.shape[0] < cfg.d_model:
        y = tp.reduce(torch.einsum("bsd,dhk->bshk", hin[..., tp.local(cfg.d_model)], w))
    else:
        y = torch.einsum("bsd,dhk->bshk", hn, w)
    return (y if bias is None else y + bias), slice(0, n)


def _tp_qkv(p: Mapping, cfg: ArchConfig, hn, positions, tp):
    """q, k, v after RoPE on a tensor-parallel rank, and which of the
    padded heads q and k hold."""
    h_pad, kv_pad = attn_dims(cfg, tp.size)
    hin = tp.enter(hn)
    bias = (lambda name: p[name]) if cfg.qkv_bias else (lambda name: None)
    q, qh = _tp_proj(tp, cfg, hn, hin, p["wq"], bias("bq"), h_pad)
    k, kh = _tp_proj(tp, cfg, hn, hin, p["wk"], bias("bk"), kv_pad)
    v, _ = _tp_proj(tp, cfg, hn, hin, p["wv"], bias("bv"), kv_pad)
    sin, cos = rope(positions, cfg.head_dim, cfg.rope_theta, at_least_f32(hn).dtype)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v, qh, kh


def _tp_out(p: Mapping, cfg: ArchConfig, out, qh: slice, tp):
    """The attention output's product with ``wo`` from the rank's heads
    ``qh`` (padded heads masked), whole on every rank."""
    h_pad, kv_pad = attn_dims(cfg, tp.size)
    out = _masked(cfg, out, h_pad, kv_pad, qh)
    wo = p["wo"]
    if wo.shape[0] < h_pad:            # heads on "model": row parallel
        return tp.reduce(torch.einsum("bshk,hkd->bsd", out, wo))
    if wo.shape[2] < cfg.d_model:      # its output dim on "model"
        return tp.gather(torch.einsum("bshk,hkd->bsd", tp.enter(out), wo), -1)
    return torch.einsum("bshk,hkd->bsd", out, wo)


def cache_kv_heads(cfg: ArchConfig, tp_size: int = 1, tp_rank: int = 0) -> list[int]:
    """The padded KV heads (of ``attn_dims(cfg, tp_size)``) that rank
    ``tp_rank`` of a model group of ``tp_size`` keeps in its decode cache:
    its own where the KV count divides ``tp_size``; else those its query
    heads read (once each where its query heads cover whole groups or sit
    in one, else one per query head, the pick of ``_tp_attention``); all
    of them where q is not head-sharded either.  Its query head j reads
    cache head j // (its query heads / the cache's heads)."""
    h_pad, kv_pad = attn_dims(cfg, tp_size)
    if tp_size == 1:
        return list(range(kv_pad))
    if kv_pad % tp_size == 0:
        n = kv_pad // tp_size
        return list(range(tp_rank * n, (tp_rank + 1) * n))
    if h_pad % tp_size:
        return list(range(kv_pad))
    g, hq = h_pad // kv_pad, h_pad // tp_size
    q0 = tp_rank * hq
    if hq % g == 0 or g % hq == 0:
        return list(range(q0 // g, (q0 + hq - 1) // g + 1))
    return [(q0 + j) // g for j in range(hq)]


def _cache_pick(cfg: ArchConfig, tp, x, kh: slice):
    """k or v (B, S, n, Dh; heads ``kh`` of the padded KV heads) cut to the
    heads this rank's cache holds (``cache_kv_heads``)."""
    idx = cache_kv_heads(cfg, tp.size, tp.rank)
    if idx == list(range(kh.start, kh.stop)):
        return x
    return x.index_select(2, torch.as_tensor(idx, device=x.device) - kh.start)


def _tp_attention(p: Mapping, cfg: ArchConfig, hn, *, positions, window, tp,
                  collect_cache: bool = False):
    """(the attention half's output (B, S, D), whole on every rank of the
    node's model group ``tp``, from the rank's shards; with
    ``collect_cache`` the (k, v) its decode cache holds, else None)."""
    h_pad, kv_pad = attn_dims(cfg, tp.size)
    g_pad = h_pad // kv_pad
    q, k, v, qh, kh = _tp_qkv(p, cfg, hn, positions, tp)
    cache = (_cache_pick(cfg, tp, k, kh), _cache_pick(cfg, tp, v, kh)) if collect_cache \
        else None
    if (qh.start, qh.stop) != (kh.start * g_pad, kh.stop * g_pad):
        # the local query heads' KV heads are not the local KV block: pick
        # them from the whole k and v, which enter the local heads' attention
        idx = torch.arange(qh.start, qh.stop, device=hn.device) // g_pad - kh.start
        k, v = tp.enter(k).index_select(2, idx), tp.enter(v).index_select(2, idx)
    out = attn_lib.multihead_attention(
        q, k, v, q_positions=positions, k_positions=positions,
        causal=True, window=window, impl=cfg.attn_impl, chunk_size=cfg.attn_chunk,
    )
    return _tp_out(p, cfg, out, qh, tp), cache


def apply_attn_block(p: Mapping, cfg: ArchConfig, h: torch.Tensor, *,
                     positions: torch.Tensor, window: Optional[int],
                     collect_cache: bool = False, tp=None):
    """One pre-norm attention + feed-forward block. h: (B, S, D);
    positions: (B, S).  Returns (h', (k, v, positions) after RoPE when
    ``collect_cache`` else None, the MoE aux loss (0 without experts)).
    ``tp``: the node's model group when ``p`` holds a rank's shards; the
    cache then holds the KV heads of ``cache_kv_heads``."""
    hn = _apply_norm(cfg, p, "ln1", h)
    if tp is not None:
        attn, kv = _tp_attention(p, cfg, hn, positions=positions, window=window, tp=tp,
                                 collect_cache=collect_cache)
        h, aux = _ffn(p, cfg, h + attn, tp)
        return h, (kv + (positions,) if collect_cache else None), aux
    q, k, v = _qkv(p, cfg, hn)
    sin, cos = rope(positions, cfg.head_dim, cfg.rope_theta, at_least_f32(h).dtype)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = attn_lib.multihead_attention(
        q, k, v, q_positions=positions, k_positions=positions,
        causal=True, window=window, impl=cfg.attn_impl, chunk_size=cfg.attn_chunk,
    )
    out = _masked(cfg, out, p["wq"].shape[1], p["wk"].shape[1])
    h, aux = _ffn(p, cfg, h + torch.einsum("bshk,hkd->bsd", out, p["wo"]))
    return h, ((k, v, positions) if collect_cache else None), aux


def decode_attn_block(p: Mapping, cfg: ArchConfig, h: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      cache_pos: torch.Tensor, *, pos: int, window: Optional[int],
                      tp=None):
    """Single-token attention + feed-forward block against a cache (updated
    in place).  h: (B, 1, D); cache_k/v: (B, slots, KV, Dh); cache_pos:
    (B, slots).  Padded heads are masked out of the output, as the
    reference's decode path does.  ``tp``: the node's model group when
    ``p`` holds a rank's shards and the cache the rank's KV heads
    (``cache_kv_heads``)."""
    hn = _apply_norm(cfg, p, "ln1", h)
    posb = torch.full((h.shape[0], 1), pos, dtype=torch.int32, device=h.device)
    if tp is not None:
        q, k, v, qh, kh = _tp_qkv(p, cfg, hn, posb, tp)
        attn_lib.cache_update(cache_k, cache_v, cache_pos, _cache_pick(cfg, tp, k, kh),
                              _cache_pick(cfg, tp, v, kh), pos, ring=window is not None)
        out = attn_lib.decode_attention(q, cache_k, cache_v, cache_pos, pos=pos,
                                        window=window)
        return _ffn(p, cfg, h + _tp_out(p, cfg, out, qh, tp), tp)[0]
    q, k, v = _qkv(p, cfg, hn)
    sin, cos = rope(posb, cfg.head_dim, cfg.rope_theta, at_least_f32(h).dtype)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    attn_lib.cache_update(cache_k, cache_v, cache_pos, k, v, pos, ring=window is not None)
    out = attn_lib.decode_attention(q, cache_k, cache_v, cache_pos, pos=pos, window=window)
    out = _masked(cfg, out, p["wq"].shape[1], p["wk"].shape[1])
    return _ffn(p, cfg, h + torch.einsum("bshk,hkd->bsd", out, p["wo"]))[0]


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------

def _embed(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, patch_embeds=None,
           tp=None):
    h = params["embed"][tokens.long()]
    if tp is not None and params["embed"].shape[1] < cfg.d_model:
        h = tp.gather(h, -1)       # the embedding's d_model columns over "model"
    if cfg.input_kind == "vlm" and patch_embeds is not None:
        # decode steps carry no new patches; prefill/train prepend them
        h = torch.cat([patch_embeds.to(h.dtype), h], dim=1)
    return h


def _logits(params, cfg: ArchConfig, h: torch.Tensor, tp=None) -> torch.Tensor:
    """Logits (B, S, V); on a tensor-parallel rank whose ``head`` is split on
    the vocabulary, this rank's (B, S, V/m) columns."""
    h = _apply_norm(cfg, params, "final_norm", h)
    if tp is not None and params["head"].shape[1] < cfg.vocab:
        h = tp.enter(h)
    return torch.einsum("bsd,dv->bsv", h, params["head"])


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid (target >= 0) positions; f32 math."""
    lf = at_least_f32(logits)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.clamp_min(0).long()[..., None])[..., 0]
    valid = (targets >= 0).to(lf.dtype)
    return torch.sum((lse - tgt) * valid) / torch.clamp(valid.sum(), min=1.0)


def _cross_entropy_tp(logits: torch.Tensor, targets: torch.Tensor, tp) -> torch.Tensor:
    """``cross_entropy`` of vocab-parallel logits (this rank's (B, S, V/m)
    columns): the log-sum-exp from all-reduces of the max and of the sum of
    exponentials, the target's logit from the rank that holds it."""
    lf = at_least_f32(logits)
    vl = lf.shape[-1]
    m = tp.max(lf.amax(dim=-1))
    lse = m + torch.log(tp.reduce(torch.exp(lf - m[..., None]).sum(dim=-1)))
    t = targets.long() - tp.rank * vl
    here = (t >= 0) & (t < vl)
    tl = torch.gather(lf, -1, t.clamp(0, vl - 1)[..., None])[..., 0]
    tgt = tp.reduce(torch.where(here, tl, torch.zeros((), dtype=lf.dtype, device=lf.device)))
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


def _rwkv_local_heads(cfg: ArchConfig, tp_size: int = 1) -> int:
    """RWKV heads a rank of a model group of ``tp_size`` owns (all of them
    where d_model does not divide, as the validated specs leave it whole)."""
    n = _rwkv_heads(cfg)
    return n // tp_size if cfg.d_model % tp_size == 0 else n


def _mamba_local(cfg: ArchConfig, tp_size: int = 1) -> tuple[int, int]:
    """(SSD heads, d_inner) a rank of a model group of ``tp_size`` owns."""
    d_inner = cfg.d_model * 2
    if d_inner % tp_size:
        return mamba_n_heads(cfg.d_model), d_inner
    return mamba_n_heads(cfg.d_model) // tp_size, d_inner // tp_size


def _tp_size(tp) -> int:
    return 1 if tp is None else tp.size


def _tp_kw(tp) -> dict:
    return {} if tp is None else {"tp": tp}


def _gathered_at_entry(params: Mapping, cfg: ArchConfig, tp) -> Mapping:
    """On a rank whose node spans a data group that shards leaves (FSDP,
    ``moe_shard_ff``): the leaves no layer loop gathers, gathered at entry
    (the embedding, the final norm and the head; a stacked layer leaf split
    on its layer dim; every leaf of the ssm and hybrid families, whose
    loops run whole).  The attention family's layer leaves are gathered one
    layer at a time by ``_at_use``."""
    dp = None if tp is None else tp.data
    if dp is None or not dp.dims:
        return params
    per_layer = cfg.family not in ("ssm", "hybrid")
    out = dict(params)
    for k, d in dp.dims.items():
        if not (per_layer and k.startswith("blocks.") and d > 0):
            out[k] = dp.gather(params[k], d)
    return out


def _at_use(block, tp):
    """``block`` of a layer's views with the leaves the node's data group
    shards gathered as it starts (inside its remat region: recomputed, not
    kept, for the backward)."""
    dp = None if tp is None else tp.data
    if dp is None or not dp.dims:
        return block
    return lambda lp, *a, **k: block(dp.layer_leaves(lp, "blocks."), *a, **k)


def forward_full(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, *,
                 patch_embeds=None, window: Optional[int] = None,
                 collect_cache: bool = False, tp=None):
    """Full-sequence forward, the reference's ``forward``: returns (logits
    (B, S_total, V), cache or states or None, aux loss).  The attention
    families return their (k, v, positions) cache stacked to (L, B, S, KV,
    Dh) with ``collect_cache``; ssm returns its RWKVState (leaves (L, B,
    ...)) and hybrid its {"mamba", "attn_cache", "tail"} states always,
    from zero states at entry.  ``tp``: the node's model group when
    ``params`` are a rank's shards (every family; the logits are then the
    rank's vocabulary columns where ``head`` is split, the states and
    caches the rank's heads)."""
    _check_family(cfg)
    params = _gathered_at_entry(params, cfg, tp)
    h = _embed(params, cfg, tokens, patch_embeds, tp)
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    kw = _tp_kw(tp)

    if cfg.family == "ssm":
        n_heads = _rwkv_heads(cfg)
        local = _rwkv_local_heads(cfg, _tp_size(tp))
        block = _remat(cfg, apply_rwkv_block)
        states = []
        for lp in _layers(params, cfg.n_layers):
            st0 = RWKVState.empty(b, local, cfg.d_model // n_heads, cfg.d_model, h.dtype,
                                  h.device)
            h, st = block(unflatten_tree(lp), h, st0, n_heads=n_heads, chunk=cfg.rec_chunk,
                          d_ff=cfg.d_ff, **kw)
            states.append(st)
        return _logits(params, cfg, h, tp), _stack_states(states), aux

    if cfg.family == "hybrid":
        return _hybrid_forward(params, cfg, h, positions, window, collect_cache, tp)

    block = _remat(cfg, _at_use(apply_attn_block, tp))
    entries = []
    for lp in _layers(params, cfg.n_layers):
        h, entry, a = block(lp, cfg, h, positions=positions, window=window,
                            collect_cache=collect_cache, **kw)
        aux = aux + a
        entries.append(entry)
    cache = tuple(torch.stack(xs) for xs in zip(*entries)) if collect_cache else None
    return _logits(params, cfg, h, tp), cache, aux


def _hybrid_forward(params, cfg, h, positions, window, collect_cache, tp=None):
    b = h.shape[0]
    group = cfg.attn_every
    n_groups = cfg.n_layers // group
    heads, d_inner = _mamba_local(cfg, _tp_size(tp))
    kw = _tp_kw(tp)

    def mk_state():
        return MambaState.empty(b, heads, cfg.ssm_state, d_inner, h.dtype, h.device)

    shared = _sub(params, "shared_attn")
    mblock = _remat(cfg, apply_mamba_block)
    ablock = _remat(cfg, apply_attn_block)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    m_states, caches = [], []
    for gp in _unstack(_sub(params, "mamba_groups"), n_groups):
        sts = []
        for lp in _unstack(gp, group - 1):
            h, st = mblock(unflatten_tree(lp), h, mk_state(), d_state=cfg.ssm_state,
                           chunk=cfg.rec_chunk, **kw)
            sts.append(st)
        h, entry, a = ablock(shared, cfg, h, positions=positions, window=window,
                             collect_cache=collect_cache, **kw)
        aux = aux + a
        m_states.append(_stack_states(sts))
        caches.append(entry)

    tail_states = None
    tail = _sub(params, "tail_mamba")
    if tail:
        sts = []
        for lp in _unstack(tail, next(iter(tail.values())).shape[0]):
            h, st = mblock(unflatten_tree(lp), h, mk_state(), d_state=cfg.ssm_state,
                           chunk=cfg.rec_chunk, **kw)
            sts.append(st)
        tail_states = _stack_states(sts)

    states = {
        "mamba": _stack_states(m_states),
        "attn_cache": (tuple(torch.stack(xs) for xs in zip(*caches))
                       if collect_cache else None),
        "tail": tail_states,
    }
    return _logits(params, cfg, h, tp), states, aux


def forward(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, *,
            patch_embeds=None, window: Optional[int] = None,
            collect_cache: bool = False):
    """Full-sequence forward: tokens (B, S) -> logits (B, S_total, V).

    With ``collect_cache`` it returns (logits, cache or states) as
    ``forward_full`` gives them."""
    logits, st, _ = forward_full(params, cfg, tokens, patch_embeds=patch_embeds,
                                 window=window, collect_cache=collect_cache)
    return (logits, st) if collect_cache else logits


def loss_fn(params: Mapping, cfg: ArchConfig, batch: Mapping, tp=None) -> torch.Tensor:
    """Next-token CE (+ the MoE aux loss, weighted by ``aux_loss_weight``).
    batch: tokens/targets (B, S), and for a VLM patch_embeds (B, n_patches,
    D), whose positions the loss skips.  A VLM batch without patch_embeds
    raises: the reference's loss slices off n_patches logits that were
    never prepended and fails on the shapes.  ``tp``: the node's model
    group when ``params`` are a rank's shards (the same loss on every rank
    of the group)."""
    patches = batch.get("patch_embeds")
    if cfg.input_kind == "vlm" and patches is None:
        raise ValueError(
            f"{cfg.name}: a VLM training batch needs 'patch_embeds' "
            f"(B, {cfg.n_patches}, {cfg.d_model}); the loss skips the patches' "
            "positions, which a batch without them does not have"
        )
    logits, _, aux = forward_full(params, cfg, batch["tokens"], patch_embeds=patches, tp=tp)
    if cfg.input_kind == "vlm":
        logits = logits[:, cfg.n_patches:]
    if tp is not None and params["head"].shape[1] < cfg.vocab:
        loss = _cross_entropy_tp(logits, batch["targets"], tp)
    else:
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
                      window: Optional[int] = None, device=None, tp_size: int = 1,
                      tp_rank: Optional[int] = 0) -> DecodeState:
    """Empty decode state sized for a ``seq_len`` context (``window`` slots
    in a ring when a window is given), at the model axis ``tp_size``: the
    caches at the padded KV count, and rank ``tp_rank``'s share of every
    leaf (its KV heads, ``cache_kv_heads``; its RWKV and Mamba2 heads), or
    with ``tp_rank=None`` the whole state (the reference's
    ``init_decode_state(..., tp_size=)``)."""
    _check_family(cfg)
    slots = min(window, seq_len) if window else seq_len
    whole = tp_rank is None
    kv = attn_dims(cfg, tp_size)[1] if whole else len(cache_kv_heads(cfg, tp_size, tp_rank))
    tp_size = 1 if whole else tp_size

    def mk_kv(n):
        shape = (n, batch, slots, kv, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.full(shape[:3], -1, dtype=torch.int32, device=device))

    def lead(st, dims):
        return type(st)(*(x.expand(dims + x.shape).clone() for x in st))

    if cfg.family == "ssm":
        n_heads = _rwkv_heads(cfg)
        st = RWKVState.empty(batch, _rwkv_local_heads(cfg, tp_size), cfg.d_model // n_heads,
                             cfg.d_model, cfg.dtype, device)
        return DecodeState(rwkv=lead(st, (cfg.n_layers,)))
    if cfg.family == "hybrid":
        group = cfg.attn_every
        n_groups, tail = divmod(cfg.n_layers, group)
        heads, d_inner = _mamba_local(cfg, tp_size)
        mst = MambaState.empty(batch, heads, cfg.ssm_state, d_inner, cfg.dtype, device)
        return DecodeState(hybrid={
            "mamba": lead(mst, (n_groups, group - 1)),
            "attn_cache": mk_kv(n_groups),
            "tail": lead(mst, (tail,)) if tail else None,
        })
    return DecodeState(kv=mk_kv(cfg.n_layers))


def prefill(params: Mapping, cfg: ArchConfig, tokens: torch.Tensor, *, patch_embeds=None,
            tp=None):
    """Process a prompt (a VLM's patches first); returns (last-token logits
    (B, V), DecodeState over the prompt's positions).  ``tp``: the node's
    model group when ``params`` are a rank's shards; the logits are then
    the rank's vocabulary columns where ``head`` is split, the state its
    share (``init_decode_state(..., tp_size=, tp_rank=)``)."""
    logits, st, _ = forward_full(params, cfg, tokens, patch_embeds=patch_embeds,
                                 collect_cache=True, tp=tp)
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
                state: DecodeState, *, window: Optional[int] = None, tp=None):
    """One token for every sequence in the batch.

    tokens: (B, 1); pos: the current absolute position.  The state is
    updated IN PLACE (the reference returns a new one).
    Returns (logits (B, V), the DecodeState); with ``tp`` (a rank's shards
    and state) the logits are the rank's vocabulary columns where ``head``
    is split.
    """
    _check_family(cfg)
    pos = int(pos)
    h = _embed(params, cfg, tokens, tp=tp)  # (B, 1, D)
    kw = _tp_kw(tp)

    if cfg.family == "ssm":
        n_heads = _rwkv_heads(cfg)
        h1 = h[:, 0]
        for li, lp in enumerate(_layers(params, cfg.n_layers)):
            st = RWKVState(*(x[li] for x in state.rwkv))
            h1, st2 = rwkv_block_decode(unflatten_tree(lp), h1, st, n_heads=n_heads,
                                        d_ff=cfg.d_ff, **kw)
            _copy_state_(st, st2)
        return _logits(params, cfg, h1[:, None], tp)[:, 0], state

    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, h, pos, state, window, tp)

    k, v, p = state.kv
    for li, lp in enumerate(_layers(params, cfg.n_layers)):
        h = decode_attn_block(lp, cfg, h, k[li], v[li], p[li], pos=pos, window=window, **kw)
    return _logits(params, cfg, h, tp)[:, 0], state


def _hybrid_decode(params, cfg, h, pos, state, window, tp=None):
    group = cfg.attn_every
    shared = _sub(params, "shared_attn")
    hst = state.hybrid
    k, v, p = hst["attn_cache"]
    n_groups = k.shape[0]
    kw = _tp_kw(tp)
    h1 = h[:, 0]
    for g, gp in enumerate(_unstack(_sub(params, "mamba_groups"), n_groups)):
        for i, lp in enumerate(_unstack(gp, group - 1)):
            st = MambaState(*(x[g, i] for x in hst["mamba"]))
            h1, st2 = mamba_block_decode(unflatten_tree(lp), h1, st, d_state=cfg.ssm_state,
                                         **kw)
            _copy_state_(st, st2)
        h1 = decode_attn_block(shared, cfg, h1[:, None], k[g], v[g], p[g], pos=pos,
                               window=window, **kw)[:, 0]
    if hst.get("tail") is not None:
        tail = _sub(params, "tail_mamba")
        for i, lp in enumerate(_unstack(tail, hst["tail"].h.shape[0])):
            st = MambaState(*(x[i] for x in hst["tail"]))
            h1, st2 = mamba_block_decode(unflatten_tree(lp), h1, st, d_state=cfg.ssm_state,
                                         **kw)
            _copy_state_(st, st2)
    return _logits(params, cfg, h1[:, None], tp)[:, 0], state

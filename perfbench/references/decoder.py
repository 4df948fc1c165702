"""The plain reference of a decoder-only transformer with a dense or a
mixture-of-experts feed-forward (granite-8b, phi3.5-moe), in float32
PyTorch, written from the models' descriptions: it imports nothing of
``repro_torch``, ``repro`` or JAX.

The model: token embedding → per layer RMSNorm, GQA attention with RoPE
(rotate-half, θ = ``rope_theta``) under a causal mask, RMSNorm and a gated
SiLU MLP or a top-k mixture of experts with a capacity (first come first
served in token order; assignments past it are dropped) and the
load-balance loss E·Σ f_e p_e → final RMSNorm → output head → next-token
cross-entropy over the valid targets (+ ``aux_loss_weight`` × the layers'
load-balance losses).

What every reference module exports (``perfbench.reference.model``):
``leaf_table``, ``loss_fn``, ``model_flops_per_step``, ``arch_fields`` and
``tiny``.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import _product

__all__ = ["TINY", "TINY_MOE", "head_dim", "leaf_table", "ffn", "loss_fn",
           "matmul_params_per_token", "attention_pairs", "model_flops_per_step", "arch_fields",
           "tiny"]

_NEG = -1e30

# the CPU tests' sizes (``tiny``)
TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv": 2, "d_head": 16, "d_ff": 96,
        "vocab": 128, "dtype": "float32", "nodes": 4}
TINY_MOE = {**TINY, "n_experts": 4, "top_k": 2, "d_ff": 48}

# configuration keys that are the port's ArchConfig fields as they are
_ARCH_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv", "d_head", "d_ff", "vocab",
              "n_experts", "top_k", "capacity_factor", "aux_loss_weight", "norm",
              "rope_theta", "remat", "attn_impl")
# ArchConfig fields of mechanisms ``loss_fn`` does not compute, and the
# value each must keep
_NOT_COMPUTED = {"norm": "rmsnorm", "act": "silu", "qkv_bias": False, "n_shared_experts": 0,
                 "ssm_state": 0, "attn_every": 0, "sliding_window": None}


def head_dim(cfg: Mapping) -> int:
    return cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]


def leaf_table(cfg: Mapping) -> dict:
    """name -> (shape, std or None for ones, None: the configuration's
    dtype), in the flat order the parameters are laid out (sorted paths,
    depth first).  Matrices are drawn normal with std √(2 / fan-in), the
    embedding and the head with std 0.02, the norms' gains are ones."""
    d, f, v, n = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    h, kv, dh = cfg["n_heads"], cfg["n_kv"], head_dim(cfg)
    he = lambda fan_in: math.sqrt(2.0 / fan_in)
    if cfg.get("n_experts"):
        e = cfg["n_experts"]
        ffn_leaves = {"blocks.ffn.router": ((n, d, e), 0.02),
                      "blocks.ffn.w_down": ((n, e, f, d), he(f)),
                      "blocks.ffn.w_gate": ((n, e, d, f), he(d)),
                      "blocks.ffn.w_up": ((n, e, d, f), he(d))}
    else:
        ffn_leaves = {"blocks.ffn.w_down": ((n, f, d), he(f)),
                      "blocks.ffn.w_gate": ((n, d, f), he(d)),
                      "blocks.ffn.w_up": ((n, d, f), he(d))}
    table = {**ffn_leaves,
             "blocks.ln1.g": ((n, d), None),
             "blocks.ln2.g": ((n, d), None),
             "blocks.wk": ((n, d, kv, dh), he(d)),
             "blocks.wo": ((n, h, dh, d), he(h * dh)),
             "blocks.wq": ((n, d, h, dh), he(d)),
             "blocks.wv": ((n, d, kv, dh), he(d)),
             "embed": ((v, d), 0.02),
             "final_norm.g": ((d,), None),
             "head": ((d, v), 0.02)}
    return {k: (shape, init, None) for k, (shape, init) in table.items()}


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of (B, S, H, Dh) at positions 0..S−1."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _moe(x, p, l, cfg, mm):
    """Top-k experts with capacity on (T, D) tokens: (out, load-balance loss)."""
    t = x.shape[0]
    e, k = cfg["n_experts"], cfg["top_k"]
    logits = mm("td,de->te", x, p["blocks.ffn.router"][l])
    probs = torch.softmax(logits, dim=-1)
    top_p, ids = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    counts = torch.bincount(ids.reshape(-1), minlength=e).to(probs.dtype)
    aux = e * torch.sum(counts / (t * k) * probs.mean(dim=0))
    cap = int(max(k * t * cfg["capacity_factor"] / e, 4))
    flat_ids, flat_p = ids.reshape(-1), top_p.reshape(-1)
    out = torch.zeros_like(x)
    for ex in range(e):
        a = torch.nonzero(flat_ids == ex)[:, 0][:cap]   # token order: first come first served
        tok = a // k
        xe = x[tok]
        hid = F.silu(mm("td,df->tf", xe, p["blocks.ffn.w_gate"][l, ex])) \
            * mm("td,df->tf", xe, p["blocks.ffn.w_up"][l, ex])
        out = out.index_add(0, tok, mm("tf,fd->td", hid, p["blocks.ffn.w_down"][l, ex])
                            * flat_p[a, None])
    return out, aux


def ffn(x: torch.Tensor, p: Mapping, l: int, cfg: Mapping, mm):
    """Layer ``l``'s feed-forward of the (B, S, D) normed stream: (its
    output, the load-balance loss or None)."""
    b, s, d = x.shape
    if cfg.get("n_experts"):
        ff, a = _moe(x.reshape(b * s, d), p, l, cfg, mm)
        return ff.reshape(b, s, d), a
    hid = F.silu(mm("bsd,df->bsf", x, p["blocks.ffn.w_gate"][l])) \
        * mm("bsd,df->bsf", x, p["blocks.ffn.w_up"][l])
    return mm("bsf,fd->bsd", hid, p["blocks.ffn.w_down"][l]), None


def loss_fn(p: Mapping, cfg: Mapping, tokens: torch.Tensor, targets: torch.Tensor,
            quant: Optional[str] = None, *, ffn=ffn) -> torch.Tensor:
    """One node's loss on its (B, S) batch; ``p`` float32 leaves.  ``ffn``
    is each layer's feed-forward (a module that extends this model passes
    its own)."""
    mm = _product(quant)
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h = p["embed"][tokens.long()]
    b, s, d = h.shape
    nh, kv, dh = cfg["n_heads"], cfg["n_kv"], head_dim(cfg)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    aux = torch.zeros((), device=h.device)
    for l in range(cfg["n_layers"]):
        hn = _rms(h, p["blocks.ln1.g"][l], eps)
        qh = _rope(mm("bsd,dhk->bshk", hn, p["blocks.wq"][l]), theta)
        kh = _rope(mm("bsd,dhk->bshk", hn, p["blocks.wk"][l]), theta)
        vh = mm("bsd,dhk->bshk", hn, p["blocks.wv"][l])
        qg = qh.reshape(b, s, kv, nh // kv, dh) * dh ** -0.5
        scores = mm("bqhgd,bshd->bhgqs", qg, kh)
        att = torch.softmax(torch.where(causal, scores, _NEG), dim=-1)
        out = mm("bhgqs,bshd->bqhgd", att, vh).reshape(b, s, nh, dh)
        h = h + mm("bshk,hkd->bsd", out, p["blocks.wo"][l])
        ff, a = ffn(_rms(h, p["blocks.ln2.g"][l], eps), p, l, cfg, mm)
        h = h + ff
        if a is not None:
            aux = aux + a
    logits = mm("bsd,dv->bsv", _rms(h, p["final_norm.g"], eps), p["head"])
    valid = targets >= 0
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, targets.clamp_min(0).long()[..., None])[..., 0]
    loss = torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1)
    if cfg.get("n_experts"):
        loss = loss + cfg["aux_loss_weight"] * aux
    return loss


# ---------------------------------------------------------------------------
# the model's work, from shapes alone (the yardstick's MFU reads it)
# ---------------------------------------------------------------------------

def matmul_params_per_token(cfg: Mapping) -> int:
    """Matrix-multiply parameters one token touches in a forward pass."""
    d, dh = cfg["d_model"], head_dim(cfg)
    attn = d * dh * (2 * cfg["n_heads"] + 2 * cfg["n_kv"])
    if cfg.get("n_experts"):
        ffn_params = d * cfg["n_experts"] + cfg["top_k"] * 3 * d * cfg["d_ff"]
    else:
        ffn_params = 3 * d * cfg["d_ff"]
    return cfg["n_layers"] * (attn + ffn_params) + d * cfg["vocab"]


def attention_pairs(seq: int, *, causal: bool = True) -> int:
    """Allowed (query, key) pairs of one head over one sequence."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def model_flops_per_step(cfg: Mapping, *, nodes: int, per_node_batch: int, seq: int,
                         causal: bool = True) -> int:
    """Model FLOPs of one training step of every node (forward and
    backward): 6 × the matrix-multiply parameters a token touches (the
    attention projections, the MLP or the router and the top-k experts,
    and the output head) × the step's tokens, plus causal attention's QKᵀ
    and PV (3 × the forward's 4·Dh FLOPs for each allowed query-key pair
    of each head).  Recompute and capacity padding are not counted."""
    tokens = nodes * per_node_batch * seq
    dense = 6 * matmul_params_per_token(cfg) * tokens
    pairs = nodes * per_node_batch * attention_pairs(seq, causal=causal)
    attn = 3 * 4 * head_dim(cfg) * cfg["n_heads"] * pairs * cfg["n_layers"]
    return dense + attn


# ---------------------------------------------------------------------------
# the port's configuration of this model, and the CPU tests' size
# ---------------------------------------------------------------------------

def arch_fields(cfg: Mapping) -> dict:
    """The port's ``ArchConfig`` field values of a configuration file, the
    dtype as its name; raises for a mechanism ``loss_fn`` does not
    compute."""
    family = cfg.get("family", "dense")
    if family != ("moe" if cfg.get("n_experts") else "dense"):
        raise ValueError(f"{cfg['name']}: family {family!r} with n_experts "
                         f"{cfg.get('n_experts')!r}: the decoder computes a dense or an MoE "
                         "feed-forward")
    off = {k: cfg[k] for k, keep in _NOT_COMPUTED.items() if cfg.get(k, keep) != keep}
    if off:
        raise ValueError(f"{cfg['name']}: {off}: the decoder covers RMSNorm, SiLU, no biases, "
                         "no shared experts, no SSM and full causal attention")
    return {"name": cfg["name"], "source": cfg["source"], "dtype": cfg["dtype"],
            **{k: cfg[k] for k in _ARCH_KEYS if k in cfg}}


def tiny(cfg: Mapping) -> dict:
    """The keys that cut the configuration to the CPU tests' size."""
    return dict(TINY_MOE if cfg.get("n_experts") else TINY)

"""The plain reference of Zamba2's published hybrid block (Zamba2-7B), in
float32 PyTorch, written from ``transformers``' ``modeling_zamba2.py``
(4.57.6: ``Zamba2MambaMixer.torch_forward``, ``Zamba2AttentionDecoderLayer``,
``Zamba2MLP``, ``Zamba2HybridLayer``, ``Zamba2Model``): it imports nothing
of ``repro_torch``, ``repro`` or JAX.

The configuration holds the published ``config.json``'s keys (the catalog's
``config``), as run.  The model, for e = embed(tokens), h = e:

* every layer l: h ← h + mixer_l(RMSNorm(h + t)), with t = 0 except at the
  k-th of ``hybrid_layer_ids``, where t = linear_k(block_{k mod
  num_mem_blocks}(h, e; adapter_k));
* the mixer: [z | xBC | dt] = u·W_in (the leaves ``w_z``, ``w_x``, ``w_b``,
  ``w_c``, ``w_dt``); xBC ← SiLU(depthwise causal conv of ``mamba_d_conv``
  taps over x, B and C, with its bias); dt ← softplus(dt + dt_bias), A =
  −exp(A_log); the SSD h_t = exp(dt_t A) h_{t−1} + dt_t x_t B_tᵀ, y_t = h_t
  C_t + D x_t, with head j reading group j·G // H of B and C; y ←
  RMSNormGated(y · SiLU(z)) over G groups of d_inner/G; out = y·W_out;
* the shared block: a = RMSNorm(concat(h, e)) (2·D wide); attention of
  ``num_attention_heads`` heads of ``attention_head_dim`` with RoPE
  (rotate-half, θ = ``rope_theta``, over the whole head) and the scale
  (head_dim/2)^-½ under a causal mask, projected back to D with no
  residual; m = RMSNorm(o); [g | up] = m·[W_gate | W_up] + (m·A_k)·B_k;
  f = GELU(g) ⊙ up (the exact, erf GELU); out = f·W_down;
* final RMSNorm, the output head, next-token cross-entropy over the valid
  targets.  Every norm's epsilon is ``rms_norm_eps`` (the gated norm's is
  fixed at 1e-5 in the source; both 1e-5 here).

The SSD runs in its full-sequence form: the masked (B, L, L, H) matrix of
decays exp(Σ_{s<r≤t} dt_r A) over the whole sequence, with no chunks, so
that a fault at a chunk boundary of the program shows.  Each layer runs
under activation checkpointing, so the reference holds one layer's
(B, L, L, H) tensors at a time in its backward.

Departures from ``modeling_zamba2.py``: dt is not clamped.  The published
training path is the fused kernel, whose ``dt_limit`` defaults to (0, ∞)
when ``time_step_limit`` is null; the CPU path ``torch_forward`` clamps dt
below at ``time_step_min`` (``modeling_zamba2.py:830``).  The output head
is its own leaf, where the published model ties it to the embedding (the
port has no tie).

What every reference module exports (``perfbench.reference.model``):
``leaf_table``, ``loss_fn``, ``model_flops_per_step``, ``arch_fields`` and
``tiny``.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import _product

__all__ = ["TINY", "leaf_table", "forward", "loss_fn", "matmul_params_per_token", "ssd_flops",
           "model_flops_per_step", "arch_fields", "tiny"]

# the CPU tests' sizes (``tiny``): 4 layers, 3 of them hybrid, so both
# shared blocks run in turn and each use has its own adapter and linear;
# 2 groups of B and C over 2 SSD heads of 64 (the port's head width)
TINY = {"num_hidden_layers": 4, "hidden_size": 64, "mamba_expand": 2, "n_mamba_heads": 2,
        "mamba_headdim": 64, "mamba_ngroups": 2, "mamba_d_state": 8, "chunk_size": 8,
        "num_attention_heads": 2, "num_key_value_heads": 2, "num_query_groups": 2,
        "attention_head_dim": 64, "attention_hidden_size": 128, "kv_channels": 32,
        "intermediate_size": 96, "ffn_hidden_size": 96, "adapter_rank": 4,
        "num_mem_blocks": 2, "hybrid_layer_ids": [1, 2, 3],
        "layers_block_type": ["mamba", "hybrid", "hybrid", "hybrid"],
        "vocab_size": 128, "vocab": 128, "dtype": "float32", "nodes": 4}

_NEG = -1e30
# the published settings the model computes, and the value each must keep
_FIXED = {"mamba_expand": 2, "mamba_headdim": 64, "mamba_d_conv": 4, "use_conv_bias": True,
          "add_bias_linear": False, "hidden_act": "gelu", "use_mem_rope": True,
          "use_shared_mlp_adapter": True, "use_shared_attention_adapter": False,
          "use_long_context": False, "time_step_limit": None, "rms_norm_eps": 1e-5}


def _dims(cfg: Mapping) -> dict:
    d = cfg["hidden_size"]
    d_inner = cfg["mamba_expand"] * d
    n, g = cfg["mamba_d_state"], cfg["mamba_ngroups"]
    return {"d": d, "d_inner": d_inner, "h": cfg["n_mamba_heads"], "p": cfg["mamba_headdim"],
            "n": n, "g": g, "conv": d_inner + 2 * g * n, "k": cfg["mamba_d_conv"],
            "nh": cfg["num_attention_heads"], "kv": cfg["num_key_value_heads"],
            "dh": cfg["attention_head_dim"], "f": cfg["intermediate_size"],
            "r": cfg["adapter_rank"], "v": cfg["vocab_size"], "L": cfg["num_hidden_layers"],
            "M": cfg["num_mem_blocks"], "K": len(cfg["hybrid_layer_ids"])}


def _a_log(gen, shape, device):
    """A_log = log U(1, 16)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return torch.log(1.0 + 15.0 * u)


def _dt_bias(gen, shape, device):
    """softplus⁻¹ of dt = exp U(log 1e-3, log 1e-1), floored at 1e-4
    (``time_step_min``, ``time_step_max``, ``time_step_floor``)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp(min=1e-4)
    return dt + torch.log(-torch.expm1(-dt))


def leaf_table(cfg: Mapping) -> dict:
    """name -> (shape, init, dtype) in the program's flat order (sorted
    paths, depth first).  Matrices are drawn normal with std √(2 / fan-in),
    the embedding, the head and the adapters' B with std 0.02, the conv's
    taps with 1/√taps and its bias with 0.1; the norms' gains and D are
    ones; A_log and dt_bias by their callables.  A_log and D are float32,
    every other leaf of the configuration's dtype."""
    m = _dims(cfg)
    d, di, h, L, M, K = m["d"], m["d_inner"], m["h"], m["L"], m["M"], m["K"]
    gn, f, r, nh, kv, dh = m["g"] * m["n"], m["f"], m["r"], m["nh"], m["kv"], m["dh"]
    he = lambda fan_in: math.sqrt(2.0 / fan_in)
    table = {
        "embed": ((m["v"], d), 0.02),
        "final_norm.g": ((d,), None),
        "head": ((d, m["v"]), 0.02),
        "hybrid.adapter_a": ((K, d, r), he(d)),
        "hybrid.adapter_b": ((K, r, 2 * f), 0.02),
        "hybrid.linear": ((K, d, d), he(d)),
        "mixers.a_log": ((L, h), _a_log, "float32"),
        "mixers.conv_b": ((L, m["conv"]), 0.1),
        "mixers.conv_w": ((L, m["k"], m["conv"]), m["k"] ** -0.5),
        "mixers.d_skip": ((L, h), None, "float32"),
        "mixers.dt_bias": ((L, h), _dt_bias),
        "mixers.gn_g": ((L, di), None),
        "mixers.norm_g": ((L, d), None),
        "mixers.w_b": ((L, d, gn), he(d)),
        "mixers.w_c": ((L, d, gn), he(d)),
        "mixers.w_dt": ((L, d, h), he(d)),
        "mixers.w_out": ((L, di, d), he(di)),
        "mixers.w_x": ((L, d, di), he(d)),
        "mixers.w_z": ((L, d, di), he(d)),
        "shared_blocks.ffn.w_down": ((M, f, d), he(f)),
        "shared_blocks.ffn.w_gate": ((M, d, f), he(d)),
        "shared_blocks.ffn.w_up": ((M, d, f), he(d)),
        "shared_blocks.ln1.g": ((M, 2 * d), None),
        "shared_blocks.ln2.g": ((M, d), None),
        "shared_blocks.wk": ((M, 2 * d, kv, dh), he(2 * d)),
        "shared_blocks.wo": ((M, nh, dh, d), he(nh * dh)),
        "shared_blocks.wq": ((M, 2 * d, nh, dh), he(2 * d)),
        "shared_blocks.wv": ((M, 2 * d, kv, dh), he(2 * d)),
    }
    return {k: (v[0], v[1], v[2] if len(v) > 2 else None) for k, v in table.items()}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """``Zamba2RMSNorm``."""
    return g * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _rms_gated(x: torch.Tensor, gate: torch.Tensor, g: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    """``Zamba2RMSNormGated``: x · SiLU(gate), normalised in ``groups``
    groups of the last dim."""
    x = x * F.silu(gate)
    xg = x.view(*x.shape[:-1], groups, x.shape[-1] // groups)
    xg = xg * torch.rsqrt(xg.pow(2).mean(-1, keepdim=True) + eps)
    return g * xg.view(x.shape)


def _ssd(x, dt, a, b_in, c_in, d_skip, mm):
    """The SSD over the whole sequence in its masked decay-matrix form
    (``modeling_zamba2.py``'s ``segment_sum``, over the whole sequence).
    x: (B, L, H, P); dt: (B, L, H); a: (H,) < 0; b_in/c_in: (B, L, G, N);
    y_t = Σ_{s ≤ t} (C_t·B_s) exp(Σ_{s<r≤t} dt_r A) dt_s x_s + D x_t."""
    bsz, seq, h, _ = x.shape
    rep = h // b_in.shape[2]
    bh = b_in.repeat_interleave(rep, dim=2)          # (B, L, H, N): head j, group j // rep
    ch = c_in.repeat_interleave(rep, dim=2)
    # Σ_{s<r≤t} dt_r A summed term by term for each pair (``segment_sum``),
    # not as a difference of two long cumulative sums
    causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    steps = (dt * a)[:, :, None, :].expand(bsz, seq, seq, h)          # (B, r, s, H)
    seg = torch.cumsum(steps.masked_fill(~causal.tril(-1)[None, :, :, None], 0.0), dim=1)
    decay = torch.exp(seg.masked_fill(~causal[None, :, :, None], -math.inf))
    scores = mm("bthn,bshn->btsh", ch, bh) * decay * dt[:, None, :, :]
    return mm("btsh,bshp->bthp", scores, x) + d_skip[:, None] * x


def _mixer(p: Mapping, l: int, cfg: Mapping, h: torch.Tensor, t, mm) -> torch.Tensor:
    """``Zamba2MambaDecoderLayer`` l: h + mixer(RMSNorm(h + t))."""
    m = _dims(cfg)
    bsz, seq, _ = h.shape
    eps = cfg["rms_norm_eps"]
    u = _rms(h if t is None else h + t, p["mixers.norm_g"][l], eps)
    z = mm("bsd,de->bse", u, p["mixers.w_z"][l])
    xbc = torch.cat([mm("bsd,de->bse", u, p[f"mixers.w_{w}"][l]) for w in "xbc"], dim=-1)
    dt = mm("bsd,dh->bsh", u, p["mixers.w_dt"][l])
    conv_w = p["mixers.conv_w"][l].t()[:, None, :]   # (channels, 1, taps)
    xbc = F.conv1d(xbc.transpose(1, 2), conv_w, p["mixers.conv_b"][l], groups=m["conv"],
                   padding=m["k"] - 1)[..., :seq].transpose(1, 2)
    xbc = F.silu(xbc)
    gn = m["g"] * m["n"]
    x, b_in, c_in = torch.split(xbc, [m["d_inner"], gn, gn], dim=-1)
    dt = F.softplus(dt + p["mixers.dt_bias"][l])
    a = -torch.exp(p["mixers.a_log"][l])
    y = _ssd(x.reshape(bsz, seq, m["h"], m["p"]), dt, a,
             b_in.reshape(bsz, seq, m["g"], m["n"]), c_in.reshape(bsz, seq, m["g"], m["n"]),
             p["mixers.d_skip"][l], mm)
    y = _rms_gated(y.reshape(bsz, seq, m["d_inner"]), z, p["mixers.gn_g"][l], m["g"], eps)
    return h + mm("bse,ed->bsd", y, p["mixers.w_out"][l])


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``apply_rotary_pos_emb`` of (B, S, H, Dh) at positions 0..S−1 over the
    whole head: x·cos + rotate_half(x)·sin."""
    seq, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=x.dtype, device=x.device) / dh)
    freqs = torch.arange(seq, dtype=x.dtype, device=x.device)[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
    half = dh // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * emb.cos() + rot * emb.sin()


def _shared(p: Mapping, k: int, cfg: Mapping, h: torch.Tensor, e: torch.Tensor,
            mm) -> torch.Tensor:
    """The k-th hybrid layer's use of shared block k mod ``num_mem_blocks``
    on concat(h, e), through its own adapter and linear: the t its mixer
    adds to its input."""
    m = _dims(cfg)
    b = k % m["M"]
    eps = cfg["rms_norm_eps"]
    a = _rms(torch.cat([h, e], dim=-1), p["shared_blocks.ln1.g"][b], eps)
    q = _rope(mm("bsd,dhk->bshk", a, p["shared_blocks.wq"][b]), cfg["rope_theta"])
    kk = _rope(mm("bsd,dhk->bshk", a, p["shared_blocks.wk"][b]), cfg["rope_theta"])
    v = mm("bsd,dhk->bshk", a, p["shared_blocks.wv"][b])
    rep = m["nh"] // m["kv"]
    kk, v = kk.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    seq = h.shape[1]
    causal = torch.ones(seq, seq, dtype=torch.bool, device=h.device).tril()
    scores = mm("bqhk,bshk->bhqs", q, kk) * (m["dh"] / 2) ** -0.5
    att = torch.softmax(torch.where(causal, scores, _NEG), dim=-1)
    o = mm("bhqs,bshk->bqhk", att, v)
    o = mm("bqhk,hkd->bqd", o, p["shared_blocks.wo"][b])
    x = _rms(o, p["shared_blocks.ln2.g"][b], eps)
    low = mm("bsr,rf->bsf", mm("bsd,dr->bsr", x, p["hybrid.adapter_a"][k]),
             p["hybrid.adapter_b"][k])
    f = m["f"]
    gate = mm("bsd,df->bsf", x, p["shared_blocks.ffn.w_gate"][b]) + low[..., :f]
    up = mm("bsd,df->bsf", x, p["shared_blocks.ffn.w_up"][b]) + low[..., f:]
    out = mm("bsf,fd->bsd", F.gelu(gate) * up, p["shared_blocks.ffn.w_down"][b])
    return mm("bsd,de->bse", out, p["hybrid.linear"][k])


def forward(p: Mapping, cfg: Mapping, tokens: torch.Tensor, mm=torch.einsum) -> torch.Tensor:
    """(B, S, V) logits of a (B, S) batch; ``p`` float32 leaves, every
    matrix product through ``mm``.  Each layer and each shared-block use
    runs under activation checkpointing (the same numbers, one layer's
    activations at a time)."""
    e = p["embed"][tokens.long()]
    h = e
    uses = {layer: k for k, layer in enumerate(cfg["hybrid_layer_ids"])}
    for l in range(cfg["num_hidden_layers"]):
        t = None
        if l in uses:
            t = checkpoint(_shared, p, uses[l], cfg, h, e, mm, use_reentrant=False)
        h = checkpoint(_mixer, p, l, cfg, h, t, mm, use_reentrant=False)
    return mm("bsd,dv->bsv", _rms(h, p["final_norm.g"], cfg["rms_norm_eps"]), p["head"])


def loss_fn(p: Mapping, cfg: Mapping, tokens: torch.Tensor, targets: torch.Tensor,
            quant: Optional[str] = None) -> torch.Tensor:
    """One node's loss on its (B, S) batch; ``p`` float32 leaves."""
    logits = forward(p, cfg, tokens, _product(quant))
    valid = targets >= 0
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, targets.clamp_min(0).long()[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp(valid.sum(), min=1)


# ---------------------------------------------------------------------------
# the model's work, from shapes alone (the yardstick's MFU reads it)
# ---------------------------------------------------------------------------

def matmul_params_per_token(cfg: Mapping) -> int:
    """Matrix-multiply parameters one token touches in a forward pass: every
    layer's mixer projections (W_in of z, x, B, C and dt; W_out), each
    hybrid layer's shared block (q, k, v from 2·D, o, gate, up, down), its
    adapter and its linear, and the output head."""
    m = _dims(cfg)
    d, di = m["d"], m["d_inner"]
    mixer = d * (2 * di + 2 * m["g"] * m["n"] + m["h"]) + di * d
    block = 2 * d * (m["nh"] + 2 * m["kv"]) * m["dh"] + m["nh"] * m["dh"] * d \
        + 3 * d * m["f"]
    use = block + m["r"] * (d + 2 * m["f"]) + d * d
    return m["L"] * mixer + m["K"] * use + d * m["v"]


def _pairs(length: int, causal: bool) -> int:
    return length * (length + 1) // 2 if causal else length * length


def ssd_flops(cfg: Mapping, seq: int, *, causal: bool = True) -> int:
    """One mixer's SSD products over one sequence, forward, chunked at
    ``chunk_size`` as the published algorithm runs it: within each chunk
    C·Bᵀ (each group) and its product with x (each head) over the allowed
    pairs; the chunk states x·Bᵀ and the output C·h at every position (each
    head).  2 FLOPs a multiply-add."""
    m = _dims(cfg)
    q = cfg["chunk_size"]
    pairs = sum(_pairs(min(q, seq - a), causal) for a in range(0, seq, q))
    return 2 * pairs * (m["g"] * m["n"] + m["h"] * m["p"]) \
        + 2 * 2 * seq * m["h"] * m["p"] * m["n"]


def model_flops_per_step(cfg: Mapping, *, nodes: int, per_node_batch: int, seq: int,
                         causal: bool = True) -> int:
    """Model FLOPs of one training step of every node (forward and
    backward): 6 × the matrix-multiply parameters a token touches × the
    step's tokens; plus, × 3 for forward and backward, the attention's QKᵀ
    and PV (4·Dh a head for each allowed query-key pair) in each hybrid
    layer and every mixer's SSD products (``ssd_flops``).  Recompute is not
    counted."""
    m = _dims(cfg)
    seqs = nodes * per_node_batch
    dense = 6 * matmul_params_per_token(cfg) * seqs * seq
    attn = 3 * 4 * m["dh"] * m["nh"] * _pairs(seq, causal) * seqs * m["K"]
    ssd = 3 * ssd_flops(cfg, seq, causal=causal) * seqs * m["L"]
    return dense + attn + ssd


# ---------------------------------------------------------------------------
# the port's configuration of this model, and the CPU tests' size
# ---------------------------------------------------------------------------

def arch_fields(cfg: Mapping) -> dict:
    """The port's ``ArchConfig`` field values of a configuration file, the
    dtype as its name; raises for a setting ``loss_fn`` does not compute."""
    off = {k: cfg.get(k) for k, keep in _FIXED.items() if cfg.get(k) != keep}
    m = _dims(cfg)
    if m["h"] * m["p"] != m["d_inner"] or cfg["attention_hidden_size"] != 2 * m["d"] \
            or m["h"] % m["g"] or m["nh"] % m["kv"]:
        off["widths"] = "heads × head width ≠ d_inner, attention width ≠ 2·D, or groups"
    hybrid = [i for i, kind in enumerate(cfg["layers_block_type"]) if kind == "hybrid"]
    if hybrid != list(cfg["hybrid_layer_ids"]) or len(cfg["layers_block_type"]) != m["L"]:
        off["layers_block_type"] = "disagrees with hybrid_layer_ids or num_hidden_layers"
    if cfg["vocab"] != cfg["vocab_size"]:
        off["vocab"] = "differs from vocab_size"
    if off:
        raise ValueError(f"{cfg['name']}: {off}: the zamba2 reference computes the published "
                         "7B block alone")
    return {"name": cfg["name"], "source": cfg["source"], "dtype": cfg["dtype"],
            "family": "hybrid", "n_layers": m["L"],
            "d_model": m["d"], "d_ff": m["f"], "vocab": m["v"], "n_heads": m["nh"],
            "n_kv": m["kv"], "d_head": m["dh"], "rope_theta": float(cfg["rope_theta"]),
            "ssm_state": m["n"], "rec_chunk": cfg["chunk_size"],
            "hybrid_layer_ids": tuple(cfg["hybrid_layer_ids"]), "mem_blocks": m["M"],
            "adapter_rank": m["r"], "ssm_groups": m["g"], "remat": cfg["remat"],
            "attn_impl": cfg["attn_impl"]}


def tiny(cfg: Mapping) -> dict:
    """The keys that cut the configuration to the CPU tests' size."""
    return dict(TINY)

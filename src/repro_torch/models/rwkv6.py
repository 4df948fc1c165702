"""RWKV6 ("Finch", arXiv:2404.05892) block: the counterpart of
``repro/models/rwkv6.py``.

LayerNormed sublayers, token-shift lerps, the LoRA-modulated
data-dependent decay ``w_t = exp(-exp(w0 + lora_w(x̄_t)))``, the bonus
``u``, a per-head group norm (population variance), a SiLU-gated output
and the squared-ReLU channel mix.  As in the reference the token-shift
lerp coefficients are static; the decay is fully dynamic.

State per layer: the WKV state (B, H, N, N) in float32 and the previous
normed token of each of the two token-shifted sublayers.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ParamDef,
    at_least_f32,
    he_normal,
    layer_norm,
    normal_init,
    ones_init,
    zeros_init,
)
from repro_torch.models.recurrence import rwkv_chunked, rwkv_step

__all__ = ["rwkv_block_defs", "apply_rwkv_block", "rwkv_block_decode", "RWKVState"]

_LORA_RANK = 64


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, N, N) float32
    shift_tm: torch.Tensor  # (B, D) previous normed token (time mix)
    shift_cm: torch.Tensor  # (B, D) previous normed token (channel mix)

    @classmethod
    def empty(cls, batch, n_heads, d_head, d_model, dtype=torch.float32, device=None):
        return cls(
            wkv=torch.zeros((batch, n_heads, d_head, d_head), dtype=torch.float32,
                            device=device),
            shift_tm=torch.zeros((batch, d_model), dtype=dtype, device=device),
            shift_cm=torch.zeros((batch, d_model), dtype=dtype, device=device),
        )


def rwkv_block_defs(d_model: int, n_heads: int, d_ff: int, dtype=torch.float32) -> dict:
    d, h = d_model, n_heads
    n = d // h
    lin = lambda i, o: ParamDef((i, o), he_normal((-2,)), dtype, (None, "model"))
    row = lambda i, o, spec: ParamDef((i, o), he_normal((-2,)), dtype, spec)
    vec1 = lambda init: ParamDef((d,), init, dtype)
    return {
        "ln1_g": vec1(ones_init()),
        "ln1_b": vec1(zeros_init()),
        "ln2_g": vec1(ones_init()),
        "ln2_b": vec1(zeros_init()),
        "time_mix": {
            "mu": ParamDef((5, d), normal_init(0.1), dtype),
            "w_r": lin(d, d),
            "w_k": lin(d, d),
            "w_v": lin(d, d),
            "w_g": lin(d, d),
            "w_o": row(d, d, ("model", None)),
            "decay_w0": vec1(zeros_init()),
            "decay_a": ParamDef((d, _LORA_RANK), normal_init(0.02), dtype),
            "decay_b": ParamDef((_LORA_RANK, d), zeros_init(), dtype),
            "bonus_u": ParamDef((h, n), normal_init(0.1), dtype),
            "gn_g": vec1(ones_init()),
            "gn_b": vec1(zeros_init()),
        },
        "channel_mix": {
            "mu": ParamDef((2, d), normal_init(0.1), dtype),
            "w_k": lin(d, d_ff),
            "w_v": row(d_ff, d, ("model", None)),
            "w_r": row(d, d, (None, None)),
        },
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x̄_t = x_{t-1} (prev fills t=0). x: (B, S, D), prev: (B, D)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _lerp(x, xx, mu):
    return x + (xx - x) * mu


def _decay_logw(tm: Mapping, xw: torch.Tensor) -> torch.Tensor:
    """log w_t = -exp(w0 + lora(x)) < 0, clipped for stability."""
    lora = torch.tanh(xw @ tm["decay_a"]) @ tm["decay_b"]
    return -torch.exp(torch.clamp(tm["decay_w0"] + lora, -8.0, 6.0))


def _group_norm(x: torch.Tensor, n_heads: int, g, b, eps=1e-5) -> torch.Tensor:
    """Per-head LayerNorm of (B, S, D), population variance."""
    bsz, s, d = x.shape
    xh = at_least_f32(x.reshape(bsz, s, n_heads, d // n_heads))
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(bsz, s, d) * g + b).to(x.dtype)


def _time_mix_inputs(tm: Mapping, x, shifted, n_heads):
    b, s, d = x.shape
    n = d // n_heads
    mu = tm["mu"]
    xr, xk, xv, xg, xw = (_lerp(x, shifted, mu[i]) for i in range(5))
    r = (xr @ tm["w_r"]).reshape(b, s, n_heads, n)
    k = (xk @ tm["w_k"]).reshape(b, s, n_heads, n)
    v = (xv @ tm["w_v"]).reshape(b, s, n_heads, n)
    g = F.silu(xg @ tm["w_g"])
    logw = _decay_logw(tm, xw).reshape(b, s, n_heads, n)
    return r, k, v, g, logw


def _channel_mix(cm: Mapping, xn, shifted):
    mu = cm["mu"]
    xk = _lerp(xn, shifted, mu[0])
    xr = _lerp(xn, shifted, mu[1])
    kk = torch.square(F.relu(xk @ cm["w_k"]))
    return torch.sigmoid(xr @ cm["w_r"]) * (kk @ cm["w_v"])


def apply_rwkv_block(params: Mapping, x: torch.Tensor, state: RWKVState, *,
                     n_heads: int, chunk: int = 32):
    """Full block (time mix + channel mix, own norms and residuals).
    params: the block's nested dict; x: (B, S, D).  Returns (out, RWKVState)."""
    b, s, d = x.shape
    tm, cm = params["time_mix"], params["channel_mix"]

    xn = layer_norm(x, params["ln1_g"], params["ln1_b"])
    shifted = _shift(xn, state.shift_tm)
    r, k, v, g, logw = _time_mix_inputs(tm, xn, shifted, n_heads)
    o, wkv = rwkv_chunked(r, k, v, logw, tm["bonus_u"], state.wkv, chunk=chunk)
    o = _group_norm(o.reshape(b, s, d), n_heads, tm["gn_g"], tm["gn_b"])
    h = x + (o * g) @ tm["w_o"]

    hn = layer_norm(h, params["ln2_g"], params["ln2_b"])
    shifted_c = _shift(hn, state.shift_cm)
    out = h + _channel_mix(cm, hn, shifted_c)
    return out, RWKVState(wkv=wkv, shift_tm=xn[:, -1], shift_cm=hn[:, -1])


def rwkv_block_decode(params: Mapping, x: torch.Tensor, state: RWKVState, *,
                      n_heads: int):
    """Single-token step. x: (B, D).  Returns (out (B, D), RWKVState)."""
    b, d = x.shape
    tm, cm = params["time_mix"], params["channel_mix"]

    xn = layer_norm(x[:, None], params["ln1_g"], params["ln1_b"])[:, 0]
    r, k, v, g, logw = _time_mix_inputs(tm, xn[:, None], state.shift_tm[:, None], n_heads)
    o, wkv = rwkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], tm["bonus_u"], state.wkv)
    o = _group_norm(o.reshape(b, 1, d), n_heads, tm["gn_g"], tm["gn_b"])[:, 0]
    h = x + (o * g[:, 0]) @ tm["w_o"]

    hn = layer_norm(h[:, None], params["ln2_g"], params["ln2_b"])[:, 0]
    out = h + _channel_mix(cm, hn[:, None], state.shift_cm[:, None])[:, 0]
    return out, RWKVState(wkv=wkv, shift_tm=xn, shift_cm=hn)

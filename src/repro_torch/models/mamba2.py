"""Mamba2 (SSD) mixer block, the recurrent half of Zamba2 (arXiv:2411.15242):
the counterpart of ``repro/models/mamba2.py``.

RMSNorm → [z | x | B | C | dt] projections → a short causal depthwise
conv on x → the SSD recurrence (scalar-per-head decay) → gated RMSNorm →
out projection, with the residual.  One group (B and C shared across
heads); as in the reference only x is convolved.  ``a_log`` and
``d_skip`` are float32 whatever the model's dtype, so a bfloat16 model
holds leaves of two dtypes.  ``dt`` goes through ``F.softplus``, which
returns its input above 20 where the reference takes log1p(exp(x)): they
differ there by less than exp(-20) relative.

Decode state: (h (B, H, P, N) float32, the conv tail (B, K-1, d_inner)).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ParamDef,
    he_normal,
    normal_init,
    ones_init,
    rms_norm,
    zeros_init,
)
from repro_torch.models.recurrence import ssd_chunked, ssd_step

__all__ = ["mamba_block_defs", "apply_mamba_block", "mamba_block_decode", "MambaState",
           "mamba_n_heads"]

_CONV_K = 4
_HEAD_P = 64  # channels per SSD head


class MambaState(NamedTuple):
    h: torch.Tensor     # (B, H, P, N) float32
    conv: torch.Tensor  # (B, K-1, d_inner)

    @classmethod
    def empty(cls, batch, n_heads, d_state, d_inner, dtype=torch.float32, device=None):
        return cls(
            h=torch.zeros((batch, n_heads, _HEAD_P, d_state), dtype=torch.float32,
                          device=device),
            conv=torch.zeros((batch, _CONV_K - 1, d_inner), dtype=dtype, device=device),
        )


def mamba_n_heads(d_model: int, expand: int = 2) -> int:
    return d_model * expand // _HEAD_P


def _a_init(gen, shape, dtype, device):
    """log of uniform(1, 16) draws, in float32 before the cast."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return torch.log(1.0 + 15.0 * u).to(dtype)


def mamba_block_defs(d_model: int, d_state: int, *, expand: int = 2,
                     dtype=torch.float32) -> dict:
    d_inner = d_model * expand
    h = d_inner // _HEAD_P
    return {
        "norm_g": ParamDef((d_model,), ones_init(), dtype),
        "w_z": ParamDef((d_model, d_inner), he_normal((-2,)), dtype),
        "w_x": ParamDef((d_model, d_inner), he_normal((-2,)), dtype),
        "w_b": ParamDef((d_model, d_state), he_normal((-2,)), dtype),
        "w_c": ParamDef((d_model, d_state), he_normal((-2,)), dtype),
        "w_dt": ParamDef((d_model, h), he_normal((-2,)), dtype),
        "dt_bias": ParamDef((h,), zeros_init(), dtype),
        "conv_w": ParamDef((_CONV_K, d_inner), normal_init(0.2), dtype),
        "conv_b": ParamDef((d_inner,), zeros_init(), dtype),
        "a_log": ParamDef((h,), _a_init, torch.float32),
        "d_skip": ParamDef((h,), ones_init(), torch.float32),
        "gn_g": ParamDef((d_inner,), ones_init(), dtype),
        "w_out": ParamDef((d_inner, d_model), he_normal((-2,)), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail: torch.Tensor):
    """Depthwise causal conv, kernel K, via shifts.

    x: (B, S, C); w: (K, C); tail: (B, K-1, C), the inputs preceding x.
    Returns (y (B, S, C), new_tail (B, K-1, C)).
    """
    k = w.shape[0]
    ext = torch.cat([tail, x], dim=1)   # (B, S+K-1, C)
    s = x.shape[1]
    y = sum(ext[:, i:i + s] * w[i] for i in range(k)) + b
    return y, (ext[:, -(k - 1):] if k > 1 else tail)


def _projections(params: Mapping, xn: torch.Tensor):
    z = xn @ params["w_z"]
    xi = xn @ params["w_x"]
    b_in = xn @ params["w_b"]
    c_in = xn @ params["w_c"]
    dt = F.softplus(xn @ params["w_dt"] + params["dt_bias"])
    return z, xi, b_in, c_in, dt


def apply_mamba_block(params: Mapping, x: torch.Tensor, state: MambaState, *,
                      d_state: int, chunk: int = 64):
    """x: (B, S, D) residual stream.  Returns (out, MambaState)."""
    bsz, s, d = x.shape
    xn = rms_norm(x, params["norm_g"])
    z, xi, b_in, c_in, dt = _projections(params, xn)

    xi, conv_tail = _causal_conv(xi, params["conv_w"], params["conv_b"], state.conv)
    xi = F.silu(xi)

    h_heads = xi.shape[-1] // _HEAD_P
    xh = xi.reshape(bsz, s, h_heads, _HEAD_P)
    y, h_new = ssd_chunked(xh, dt, params["a_log"], b_in, c_in, params["d_skip"], state.h,
                           chunk=chunk)
    y = y.reshape(bsz, s, -1)
    y = rms_norm(y * F.silu(z), params["gn_g"])
    out = x + y @ params["w_out"]
    return out, MambaState(h=h_new, conv=conv_tail)


def mamba_block_decode(params: Mapping, x: torch.Tensor, state: MambaState, *,
                       d_state: int):
    """Single-token step. x: (B, D).  Returns (out (B, D), MambaState)."""
    bsz, d = x.shape
    xn = rms_norm(x[:, None], params["norm_g"])[:, 0]
    z, xi, b_in, c_in, dt = _projections(params, xn)

    xi1, new_tail = _causal_conv(xi[:, None], params["conv_w"], params["conv_b"],
                                 state.conv)
    xi1 = F.silu(xi1[:, 0])

    h_heads = xi1.shape[-1] // _HEAD_P
    xh = xi1.reshape(bsz, h_heads, _HEAD_P)
    y, h_new = ssd_step(xh, dt, params["a_log"], b_in, c_in, params["d_skip"], state.h)
    y = y.reshape(bsz, -1)
    y = rms_norm((y * F.silu(z))[:, None], params["gn_g"])[:, 0]
    out = x + y @ params["w_out"]
    return out, MambaState(h=h_new, conv=new_tail)

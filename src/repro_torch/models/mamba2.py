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

On a tensor-parallel rank (``tp``: the node's model group,
``launch/tensor_parallel.py``) the block takes the rank's shards:
``w_z``, ``w_x``, ``conv_w``, ``conv_b`` and ``gn_g`` split on d_inner, so
the rank owns (d_inner/tp)/64 SSD heads, and ``w_out`` row parallel
(then ``reduce``).  The replicated leaves its heads read (``w_b``,
``w_c``, shared by every head; ``w_dt``, ``dt_bias`` and the float32
``a_log``/``d_skip``, sliced to the local heads) enter the sharded
computation through ``enter``, as does the normed input.  The gated
RMSNorm normalises over the WHOLE d_inner: each rank sums its squares in
float32 and ``tp.sum`` adds them over the group unrounded, so the mean is
the reference's (a local norm would pass a shape check and be wrong).
The decode state on a rank is h (B, H/tp, P, N) and the conv tail (B,
K-1, d_inner/tp).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    ParamDef,
    at_least_f32,
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
        "w_z": ParamDef((d_model, d_inner), he_normal((-2,)), dtype, (None, "model")),
        "w_x": ParamDef((d_model, d_inner), he_normal((-2,)), dtype, (None, "model")),
        "w_b": ParamDef((d_model, d_state), he_normal((-2,)), dtype),
        "w_c": ParamDef((d_model, d_state), he_normal((-2,)), dtype),
        "w_dt": ParamDef((d_model, h), he_normal((-2,)), dtype),
        "dt_bias": ParamDef((h,), zeros_init(), dtype),
        "conv_w": ParamDef((_CONV_K, d_inner), normal_init(0.2), dtype, (None, "model")),
        "conv_b": ParamDef((d_inner,), zeros_init(), dtype, ("model",)),
        "a_log": ParamDef((h,), _a_init, torch.float32),
        "d_skip": ParamDef((h,), ones_init(), torch.float32),
        "gn_g": ParamDef((d_inner,), ones_init(), dtype, ("model",)),
        "w_out": ParamDef((d_inner, d_model), he_normal((-2,)), dtype, ("model", None)),
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


def _local(params: Mapping, tp):
    """(the block's leaves as this rank computes with them, the model group
    where d_inner is split over it else None).  The replicated leaves that
    the rank's heads read enter, the per-head ones sliced to its heads."""
    d_inner = params["conv_b"].shape[0]
    n_heads = params["a_log"].shape[0]
    if tp is None or d_inner == n_heads * _HEAD_P:
        return params, None
    if n_heads % tp.size:
        raise ValueError(f"{n_heads} SSD heads do not split over a model group of {tp.size}")
    hd = tp.local(n_heads)
    local = dict(params)
    local["w_b"], local["w_c"] = tp.enter(params["w_b"]), tp.enter(params["w_c"])
    local["w_dt"] = tp.enter(params["w_dt"])[:, hd]
    for name in ("dt_bias", "a_log", "d_skip"):
        local[name] = tp.enter(params[name])[hd]
    return local, tp


def _projections(params: Mapping, xn: torch.Tensor):
    z = xn @ params["w_z"]
    xi = xn @ params["w_x"]
    b_in = xn @ params["w_b"]
    c_in = xn @ params["w_c"]
    dt = F.softplus(xn @ params["w_dt"] + params["dt_bias"])
    return z, xi, b_in, c_in, dt


def _gated_norm(y, z, gamma, tp, eps: float = 1e-6):
    """``rms_norm(y · silu(z), gamma)`` over the whole d_inner; on a rank
    holding a slice of it, the squares summed over the group in float32."""
    x = y * F.silu(z)
    if tp is None:
        return rms_norm(x, gamma)
    xf = at_least_f32(x)
    var = tp.sum(xf.square().sum(dim=-1, keepdim=True)) / (x.shape[-1] * tp.size)
    return (xf * torch.rsqrt(var + eps) * at_least_f32(gamma)).to(x.dtype)


def _out(params: Mapping, y, tp):
    out = y @ params["w_out"]
    return out if tp is None else tp.reduce(out)


def apply_mamba_block(params: Mapping, x: torch.Tensor, state: MambaState, *,
                      d_state: int, chunk: int = 64, tp=None):
    """x: (B, S, D) residual stream (on a tensor-parallel rank ``tp``,
    ``params`` are its shards).  Returns (out, MambaState)."""
    bsz, s, d = x.shape
    params, tp = _local(params, tp)
    xn = rms_norm(x, params["norm_g"])
    z, xi, b_in, c_in, dt = _projections(params, xn if tp is None else tp.enter(xn))

    xi, conv_tail = _causal_conv(xi, params["conv_w"], params["conv_b"], state.conv)
    xi = F.silu(xi)

    h_heads = xi.shape[-1] // _HEAD_P
    xh = xi.reshape(bsz, s, h_heads, _HEAD_P)
    y, h_new = ssd_chunked(xh, dt, params["a_log"], b_in, c_in, params["d_skip"], state.h,
                           chunk=chunk)
    y = y.reshape(bsz, s, -1)
    y = _gated_norm(y, z, params["gn_g"], tp)
    out = x + _out(params, y, tp)
    return out, MambaState(h=h_new, conv=conv_tail)


def mamba_block_decode(params: Mapping, x: torch.Tensor, state: MambaState, *,
                       d_state: int, tp=None):
    """Single-token step. x: (B, D).  Returns (out (B, D), MambaState)."""
    bsz, d = x.shape
    params, tp = _local(params, tp)
    xn = rms_norm(x[:, None], params["norm_g"])[:, 0]
    z, xi, b_in, c_in, dt = _projections(params, xn)

    xi1, new_tail = _causal_conv(xi[:, None], params["conv_w"], params["conv_b"],
                                 state.conv)
    xi1 = F.silu(xi1[:, 0])

    h_heads = xi1.shape[-1] // _HEAD_P
    xh = xi1.reshape(bsz, h_heads, _HEAD_P)
    y, h_new = ssd_step(xh, dt, params["a_log"], b_in, c_in, params["d_skip"], state.h)
    y = y.reshape(bsz, -1)
    y = _gated_norm(y[:, None], z[:, None], params["gn_g"], tp)[:, 0]
    out = x + _out(params, y, tp)
    return out, MambaState(h=h_new, conv=new_tail)

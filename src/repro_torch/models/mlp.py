"""Dense feed-forward blocks (gated SiLU / GELU): the counterpart of
``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef, he_normal

__all__ = ["mlp_defs", "apply_mlp"]


def mlp_defs(d_model: int, d_ff: int, *, gated: bool = True, dtype=torch.float32):
    """Up-projections and down-projection, keyed in reference leaf order."""
    defs = {"w_down": ParamDef((d_ff, d_model), he_normal((-2,)), dtype)}
    if gated:
        defs["w_gate"] = ParamDef((d_model, d_ff), he_normal((-2,)), dtype)
    defs["w_up"] = ParamDef((d_model, d_ff), he_normal((-2,)), dtype)
    return defs


def apply_mlp(params, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    up = torch.einsum("bsd,df->bsf", x, params["w_up"])
    fn = F.silu if act == "silu" else (lambda t: F.gelu(t, approximate="tanh"))
    if "w_gate" in params:
        gate = torch.einsum("bsd,df->bsf", x, params["w_gate"])
        h = fn(gate) * up
    else:
        h = fn(up)
    return torch.einsum("bsf,fd->bsd", h, params["w_down"])

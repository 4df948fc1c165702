"""Dense feed-forward blocks (gated SiLU / GELU): the counterpart of
``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef, he_normal

__all__ = ["mlp_defs", "apply_mlp"]


def mlp_defs(d_model: int, d_ff: int, *, gated: bool = True, dtype=torch.float32):
    """Column-parallel up-projections, row-parallel down-projection, keyed
    in reference leaf order."""
    defs = {"w_down": ParamDef((d_ff, d_model), he_normal((-2,)), dtype, ("model", None))}
    if gated:
        defs["w_gate"] = ParamDef((d_model, d_ff), he_normal((-2,)), dtype, (None, "model"))
    defs["w_up"] = ParamDef((d_model, d_ff), he_normal((-2,)), dtype, (None, "model"))
    return defs


def apply_mlp(params, x: torch.Tensor, *, act: str = "silu", tp=None,
              adapter=None) -> torch.Tensor:
    """``act``: "silu", "gelu_erf" (exact GELU) or any other name for the
    tanh GELU.  ``tp``: the node's model group (``launch/tensor_parallel.py``)
    when the params are its rank's shards (d_ff split): the replicated ``x``
    enters the column-parallel up-projections and the row-parallel
    down-projection's partial sums are all-reduced.  ``adapter``: a gated
    MLP's low-rank (A (D, r), B (r, 2·F)) whose (x·A)·B adds to [gate | up]
    (Zamba2's per-use LoRA; one rank only)."""
    if tp is not None:
        x = tp.enter(x)
    up = torch.einsum("bsd,df->bsf", x, params["w_up"])
    fn = {"silu": F.silu, "gelu_erf": F.gelu}.get(act, lambda t: F.gelu(t, approximate="tanh"))
    if "w_gate" in params:
        gate = torch.einsum("bsd,df->bsf", x, params["w_gate"])
        if adapter is not None:
            low = (x @ adapter[0]) @ adapter[1]
            gate, up = gate + low[..., :up.shape[-1]], up + low[..., up.shape[-1]:]
        h = fn(gate) * up
    else:
        h = fn(up)
    out = torch.einsum("bsf,fd->bsd", h, params["w_down"])
    return out if tp is None else tp.reduce(out)

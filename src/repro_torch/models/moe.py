"""Mixture-of-Experts with top-k routing and capacity-based dispatch: the
counterpart of ``repro/models/moe.py``.

Dispatch is the reference's sort-free scatter/gather scheme (no (T, E, C)
one-hot products, which are infeasible at 384 experts):

  1. router: top-k expert ids and renormalized softmax weights per token
     (``torch.topk`` for ``lax.top_k``);
  2. position in expert through a stable argsort of the flat (T·k,)
     assignment and ``searchsorted(side="left")`` of each expert's group
     start; assignments past the capacity C are dropped: clamped into slot
     C−1 with a zeroed row;
  3. scatter into an (E, C, D) buffer (``index_put`` with accumulate, the
     reference's ``.at[].add``), batched expert products, gather back, and
     the weighted combine as a float32 scatter-add over tokens.

On the card the combine's scatter-add runs in atomic order: a token's k
terms are summed in no fixed order, which is exact for top-2 and
reorders float32 rounding for larger k.  The router's load-balance
auxiliary loss (Shazeer's f·p) is node-local under decentralized
training, as in the reference.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef, at_least_f32, he_normal, normal_init

__all__ = ["moe_defs", "apply_moe", "apply_moe_manual_ep", "dispatch_slots"]


def moe_defs(d_model: int, d_ff: int, n_experts: int, *, n_shared: int = 0,
             dtype=torch.float32) -> dict:
    """The router, the experts' (E, ...) projections and the optional shared
    experts.  (The reference's ``shard_ff`` is a model-axis layout: one
    card has none.)"""
    defs = {
        "router": ParamDef((d_model, n_experts), normal_init(0.02), dtype),
        "w_down": ParamDef((n_experts, d_ff, d_model), he_normal((-2,)), dtype),
        "w_gate": ParamDef((n_experts, d_model, d_ff), he_normal((-2,)), dtype),
        "w_up": ParamDef((n_experts, d_model, d_ff), he_normal((-2,)), dtype),
    }
    if n_shared:
        defs["shared"] = {
            "w_down": ParamDef((n_shared * d_ff, d_model), he_normal((-2,)), dtype),
            "w_gate": ParamDef((d_model, n_shared * d_ff), he_normal((-2,)), dtype),
            "w_up": ParamDef((d_model, n_shared * d_ff), he_normal((-2,)), dtype),
        }
    return defs


def _top_k_router(logits: torch.Tensor, k: int):
    """-> (weights (T, k) renormalized softmax, ids (T, k))."""
    probs = torch.softmax(at_least_f32(logits), dim=-1)
    top_p, top_ids = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p, top_ids


def capacity_of(t: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """The reference's expert capacity for T tokens."""
    return int(max(top_k * t * capacity_factor / n_experts, 4))


def dispatch_slots(ids: torch.Tensor, n_experts: int, capacity: int):
    """Slot of every (token, choice) in its expert's buffer.

    ids: (T, k).  Returns ``(order, sorted_e, pos, keep)`` over the flat
    T·k assignments sorted stably by expert: ``order`` the permutation,
    ``sorted_e`` the experts, ``pos`` the slot (clamped to C−1) and
    ``keep`` whether the assignment fits under the capacity."""
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=ids.device, dtype=sorted_e.dtype),
        side="left")
    pos = torch.arange(flat_e.numel(), device=ids.device) - group_start[sorted_e]
    keep = pos < capacity
    return order, sorted_e, pos.clamp(max=capacity - 1), keep


def apply_moe(params: Mapping, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, capacity: Optional[int] = None):
    """x: (B, S, D).  Returns (output (B, S, D), aux load-balance loss).
    ``params`` holds ``router``, ``w_gate``, ``w_up``, ``w_down`` and
    optionally ``shared`` (a dict of the shared experts' projections).
    (The reference's ``buf_constraint`` pins the buffer to its model axis:
    one card has none.)"""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    xt = x.reshape(t, d)

    logits = xt @ params["router"]
    weights, ids = _top_k_router(logits, top_k)      # (T, k)

    # load-balance aux loss (node-local): E · Σ_e f_e p_e
    probs = torch.softmax(at_least_f32(logits), dim=-1)
    f = torch.zeros(e, dtype=probs.dtype, device=x.device).index_add_(
        0, ids.reshape(-1), torch.ones(t * top_k, dtype=probs.dtype, device=x.device)
    ) / (t * top_k)
    aux = e * torch.sum(f * probs.mean(dim=0))

    if capacity is None:
        capacity = capacity_of(t, top_k, e, capacity_factor)
    order, sorted_e, pos, keep = dispatch_slots(ids, e, capacity)
    token_idx = order // top_k
    gathered = torch.where(keep[:, None], xt[token_idx], torch.zeros((), dtype=x.dtype,
                                                                      device=x.device))
    buf = torch.zeros((e, capacity, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((sorted_e, pos), gathered, accumulate=True)

    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    out_buf = torch.bmm(F.silu(g) * u, params["w_down"])

    picked = at_least_f32(out_buf[sorted_e, pos])
    w_sorted = weights.reshape(-1)[order]
    picked = picked * torch.where(keep, w_sorted, torch.zeros((), device=x.device))[:, None]
    out = torch.zeros((t, d), dtype=picked.dtype, device=x.device).index_add(
        0, token_idx, picked).to(x.dtype).reshape(b, s, d)

    if "shared" in params:
        sh = params["shared"]
        hs = F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])
        out = out + hs @ sh["w_down"]
    return out, aux


def apply_moe_manual_ep(*args, **kwargs):
    """The reference's explicit expert-parallel collectives (``moe_impl=
    "manual_ep"``): not ported."""
    raise ValueError(
        "moe_impl='manual_ep' (explicit expert-parallel collectives over a model "
        "axis) is not ported: ROADMAP queue 1 item 8"
    )

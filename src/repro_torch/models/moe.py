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

Expert parallelism (``apply_moe_manual_ep``): the experts are sharded on
E over the node's model group, the activations and the router are
replicated, every rank dispatches the full token set to its own experts
and one float32 all-reduce of the partial outputs follows — the
reference's ``moe_impl="manual_ep"`` schedule.  On a tensor-parallel rank
the port runs this schedule for ``moe_impl="gather"`` too, where the
reference leaves the gather path's schedule to GSPMD; the numbers are the
same function of the same weights.
"""
from __future__ import annotations

import contextlib
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef, at_least_f32, he_normal, normal_init

__all__ = ["moe_defs", "apply_moe", "apply_moe_manual_ep", "dispatch_slots",
           "counting_drops"]

# the dropped-assignment counts of the forwards run inside ``counting_drops``
_DROPS: Optional[list] = None


@contextlib.contextmanager
def counting_drops():
    """Record, per MoE layer call of a forward inside the block, the number
    of (token, choice) assignments past their expert's capacity: a list of
    0-d tensors on the layer's device (a remat recompute in the backward is
    not counted again)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def _note_drops(keep: torch.Tensor) -> None:
    if _DROPS is not None and torch._C._current_graph_task_id() == -1:
        _DROPS.append((~keep).sum().detach())

def moe_defs(d_model: int, d_ff: int, n_experts: int, *, n_shared: int = 0,
             shard_ff: bool = False, dtype=torch.float32) -> dict:
    """The router (replicated), the experts' (E, ...) projections (sharded
    on E over "model": expert parallelism) and the optional shared experts
    (column/row parallel, as an MLP).  ``shard_ff`` also puts the experts'
    d_ff over the "data" axis (the reference's 2-level expert placement for
    a G = 1 replica): up/gate ("model", None, "data"), down ("model",
    "data", None); a rank holds its d_ff slice and the ranks engine gathers
    it at use over the node's data group (``launch/tensor_parallel.py``)."""
    up = ("model", None, "data") if shard_ff else ("model", None, None)
    down = ("model", "data", None) if shard_ff else ("model", None, None)
    defs = {
        "router": ParamDef((d_model, n_experts), normal_init(0.02), dtype, (None, None)),
        "w_down": ParamDef((n_experts, d_ff, d_model), he_normal((-2,)), dtype, down),
        "w_gate": ParamDef((n_experts, d_model, d_ff), he_normal((-2,)), dtype, up),
        "w_up": ParamDef((n_experts, d_model, d_ff), he_normal((-2,)), dtype, up),
    }
    if n_shared:
        f = n_shared * d_ff
        defs["shared"] = {
            "w_down": ParamDef((f, d_model), he_normal((-2,)), dtype, ("model", None)),
            "w_gate": ParamDef((d_model, f), he_normal((-2,)), dtype, (None, "model")),
            "w_up": ParamDef((d_model, f), he_normal((-2,)), dtype, (None, "model")),
        }
    return defs


def _top_k_router(logits: torch.Tensor, k: int):
    """-> (weights (T, k) renormalized softmax, ids (T, k))."""
    probs = torch.softmax(at_least_f32(logits), dim=-1)
    top_p, top_ids = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p, top_ids


def _route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """Routing of the (T, D) tokens: (weights, ids) of ``_top_k_router`` and
    the load-balance aux loss (node-local): E · Σ_e f_e p_e."""
    e = router.shape[1]
    t = xt.shape[0]
    logits = xt @ router
    weights, ids = _top_k_router(logits, top_k)      # (T, k)
    probs = torch.softmax(at_least_f32(logits), dim=-1)
    f = torch.zeros(e, dtype=probs.dtype, device=xt.device).index_add_(
        0, ids.reshape(-1), torch.ones(t * top_k, dtype=probs.dtype, device=xt.device)
    ) / (t * top_k)
    return weights, ids, e * torch.sum(f * probs.mean(dim=0))


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
    weights, ids, aux = _route(xt, params["router"], top_k)

    if capacity is None:
        capacity = capacity_of(t, top_k, e, capacity_factor)
    order, sorted_e, pos, keep = dispatch_slots(ids, e, capacity)
    _note_drops(keep)
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
        out = out + _shared_experts(params["shared"], x)
    return out, aux


def _shared_experts(sh: Mapping, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The shared experts' gated SiLU MLP; with ``tp`` column/row parallel
    over the model group (their d_ff split)."""
    if tp is None:
        return F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"]) @ sh["w_down"]
    xin = tp.enter(x)
    return tp.reduce(F.silu(xin @ sh["w_gate"]) * (xin @ sh["w_up"]) @ sh["w_down"])


def apply_moe_manual_ep(params: Mapping, x: torch.Tensor, *, top_k: int,
                        capacity_factor: float = 1.25, capacity: Optional[int] = None,
                        tp=None, shared_tp=None, dp=None):
    """Expert-parallel MoE with explicit collectives: the reference's
    ``apply_moe_manual_ep``.

    ``tp`` is the node's model group (``launch/tensor_parallel.py``) of
    which this rank holds experts ``[rank·E/m, (rank+1)·E/m)`` (``params``'
    ``w_gate``/``w_up``/``w_down`` are its (E/m, ...) shards; the router is
    whole).  Every rank routes every token (same router, same capacity rule
    over all E experts as ``apply_moe``), dispatches to its own experts
    only, and the float32 partial outputs are combined by ONE all-reduce;
    the dispatch goes through a static (E, C) table of the assignment each
    slot holds, so a rank gathers token rows for its own (E/m, C) slots
    alone, never a (T·k, D) row for every assignment;
    the replicated tokens and routing weights enter the local dispatch
    through ``tp.enter``, so their gradients are summed over the group.
    Without ``tp`` the schedule runs as one shard holding every expert:
    ``apply_moe``'s function.  The shared experts run after, column/row
    parallel over ``shared_tp`` (the group, when their d_ff divides by its
    size; None keeps them whole).

    ``dp`` (a ``launch/tensor_parallel.DataParallel`` whose batch is split)
    makes ``x`` the tokens of every data rank, gathered (``dp.gather(x, 0)``):
    they are routed as one batch (the whole batch's capacity and aux loss,
    the same on every data rank), data rank r computes the capacity slots
    ``[r·C/d, (r+1)·C/d)`` of its experts only, and one float32
    reduce-scatter over the data group (after the model group's
    all-reduce) sums the partial outputs into each rank's own rows: the
    returned output is this rank's (B/d, S, D) rows, the shared experts run
    on them alone."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    n_shards, shard = (1, 0) if tp is None else (tp.size, tp.rank)
    e_local = params["w_gate"].shape[0]
    if e_local * n_shards != e:
        raise ValueError(f"{e} experts over {n_shards} ranks: this rank holds {e_local}")
    t = b * s
    xt = x.reshape(t, d)
    weights, ids, aux = _route(xt, params["router"], top_k)

    if capacity is None:
        capacity = capacity_of(t, top_k, e, capacity_factor)
    order, sorted_e, pos, keep = dispatch_slots(ids, e, capacity)
    _note_drops(keep)
    # the slot table: the sorted assignment each (expert, slot) holds, n
    # where it is empty (the dropped ones go to a spare column, cut off)
    n = t * top_k
    table = torch.full((e, capacity + 1), n, dtype=torch.long, device=x.device)
    table[sorted_e, torch.where(keep, pos, capacity)] = torch.arange(n, device=x.device)
    # this rank's experts and, with ``dp``, this data rank's slots [lo, hi):
    # only the assignments they hold are gathered
    lo, hi = (0, capacity) if dp is None else (dp.rank * capacity // dp.size,
                                               (dp.rank + 1) * capacity // dp.size)
    slot = table[shard * e_local:(shard + 1) * e_local, lo:hi]       # (E/m, slots)
    filled = slot < n
    slot = torch.where(filled, slot, 0)
    token = torch.where(filled, (order // top_k)[slot], 0)
    if tp is not None:
        xt, weights = tp.enter(xt), tp.enter(weights)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    buf = torch.where(filled[..., None], xt[token], zero)

    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    out_buf = torch.bmm(F.silu(g) * u, params["w_down"])

    w_slot = torch.where(filled, weights.reshape(-1)[order][slot],
                         torch.zeros((), device=x.device))
    picked = at_least_f32(out_buf) * w_slot[..., None]
    partial = torch.zeros((t, d), dtype=picked.dtype, device=x.device).index_add(
        0, token.reshape(-1), picked.reshape(-1, d))
    if tp is not None:
        partial = tp.reduce(partial)      # ONE float32 collective per layer
    if dp is not None:   # the data ranks' slots summed into this rank's rows
        b //= dp.size
        partial = dp.scatter_rows(partial)
        x = dp.own_rows(x, b)
    out = partial.to(x.dtype).reshape(b, s, d)

    if "shared" in params:
        out = out + _shared_experts(params["shared"], x, shared_tp)
    return out, aux

"""The comparison that decides ``correct``: the program's readings of its
first steps against the plain reference's, from the same weights and
batches.

Each number is the worst case over its readings:

``loss_gap``       |L_prog − L_ref| / |L_ref| over every step and node;
``grad_norm_gap``  the first gradient as the optimizer holds it (the
                   momentum after step 1): per leaf and node the gap of
                   the two norms over the reference's norm of that leaf or
                   of the node's median leaf, whichever is larger, over
                   the leaves that hold at least a thousandth of a node's
                   parameters;
``small_grad_gap`` the same over the smaller leaves (a router, the norms'
                   gains), apart because a router's norm swings from seed
                   to seed with the top-k choices of near-tied tokens;
``change_gap``     the same of the parameters' change over the checked
                   steps, leaving out the leaves whose reference gradient
                   is under a thousandth of the median leaf's (their
                   change is round-off alone);
``small_change_gap`` the change of the smaller leaves whose gradient is
                   not quiet by that rule (a router's wrong update or mix
                   shows here);
``probe_gap``      the same of the probe's per-leaf norms at every step,
                   over every leaf.

Where a leaf's norm and the median are both 0 on the reference's side
(a norm's gain that bfloat16 steps leave unmoved), the gap is 0 if the
program's reads 0 too and infinite if it does not.  A number that is not
finite counts as failed.  Each cell's limits file
names the numbers it compares; a number with no limit there is printed
and not judged.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

__all__ = ["CHECKED_STEPS", "NUMBERS", "gaps", "judge"]

CHECKED_STEPS = 3
NUMBERS = ("loss_gap", "grad_norm_gap", "small_grad_gap", "change_gap", "small_change_gap",
           "probe_gap")
QUIET_GRADIENT = 1e-3
SMALL_LEAF = 1e-3


def _leaf_gap(p: np.ndarray, r: np.ndarray, keep=None) -> float:
    """Worst per-leaf gap of norms over (..., L) arrays, over the leaves
    ``keep`` holds; the median leaf is the median of those."""
    if keep is None:
        keep = np.ones(r.shape, dtype=bool)
    med = np.array([np.median(row[k]) if k.any() else 0.0
                    for row, k in zip(r.reshape(-1, r.shape[-1]),
                                      keep.reshape(-1, r.shape[-1]))])
    denom = np.maximum(r, med.reshape(r.shape[:-1] + (1,)))
    num = np.abs(p - r)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where(num == 0, 0.0, num / denom)
    g = np.where(keep, g, 0.0)
    return float(np.max(g)) if np.all(np.isfinite(g)) else float("inf")


def gaps(prog: Mapping, ref: Mapping, sizes) -> dict:
    """The numbers compared, from two sides' ``Readings``; ``sizes`` the
    leaves' parameter counts, in leaf order."""
    with np.errstate(divide="ignore", invalid="ignore"):
        loss = np.abs(np.asarray(prog["losses"]) - ref["losses"]) / np.abs(ref["losses"])
    sizes = np.asarray(sizes, dtype=np.float64)
    large = np.broadcast_to(sizes >= SMALL_LEAF * sizes.sum(), ref["grad"].shape)
    med = np.median(ref["grad"], axis=-1, keepdims=True)
    moving = ref["grad"] >= QUIET_GRADIENT * med
    return {
        "loss_gap": float(np.max(loss)) if np.all(np.isfinite(loss)) else float("inf"),
        "grad_norm_gap": _leaf_gap(np.asarray(prog["grad"]), ref["grad"], large),
        "small_grad_gap": _leaf_gap(np.asarray(prog["grad"]), ref["grad"], ~large),
        "change_gap": _leaf_gap(np.asarray(prog["change"]), ref["change"], large & moving),
        "small_change_gap": _leaf_gap(np.asarray(prog["change"]), ref["change"],
                                      ~large & moving),
        "probe_gap": _leaf_gap(np.asarray(prog["probe"]), ref["probe"]),
    }


def judge(numbers: Mapping, limits: Mapping) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) with every limited number under
    its limit."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table

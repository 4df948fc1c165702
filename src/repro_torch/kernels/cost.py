"""What each launch of K1–K4 costs, and the hooks that bill it (and each
collective ``Comm`` issues) to the active op accounting.

The hand-written kernels are pybind calls, not aten ops, so an op-stream
accounting (``launch/hlo_analysis.py``) cannot see them.  Each wrapper
therefore calls ``bill`` where it launches its kernel on the card, and
where its ``meta`` branch stands in for the launch, with the bytes the
kernel must move (each input read once, each output written once) and the
operations it does, from the formulas below.  ``chip_smoke.py`` computes
its bounds from the same formulas.

Each formula returns ``(bytes, operations)`` as Python integers:

* K1 ``gossip_program_update`` over (G, P): θ, g, m and the wire read, θ'
  and m' written; 8 + 2·deg float32 operations an element;
* K1's one-pass route (no wire operand: the kernel computes the senders'
  rows): θ, g and m read, θ' and m' written, 14 B a bfloat16 element; the
  sender's row adds 3 operations an element;
* K2 ``gossip_update`` over (P,): θ, g, m and deg neighbour rows read, θ'
  and m' written; the same operations;
* K3 ``segment_l2_norms``: the segments' elements read, the (R, n_seg)
  float32 norms written; 2 operations an element;
* K4 ``flash_attention``: q, k, v read and the output written; 4·D FLOPs
  for each allowed (query, key) pair of each head, the least work of any
  tiling.

``launch/comm.py`` calls ``bill_collective`` for every collective it
issues.  With no accounting active, either hook costs one test of an
empty list.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["k1_cost", "k1_one_pass_cost", "k2_cost", "k3_cost", "k4_cost", "attention_pairs", "bill",
           "bill_collective"]

# accounting contexts that receive every bill, innermost last
_ACTIVE: list = []


def bill(kernel: str, nbytes: int, ops: int) -> None:
    """Report one launch of ``kernel`` to every active accounting."""
    for acc in _ACTIVE:
        acc.bill_kernel(kernel, nbytes, ops)


def bill_collective(op, world: int) -> None:
    """Report one collective a rank of a ``world``-rank group issued
    (``launch/comm.py``'s ``CollectiveOp``) to every active accounting."""
    for acc in _ACTIVE:
        acc.bill_collective(op, world)


def k1_cost(rows: int, cols: int, elem_bytes: int, deg: int) -> tuple[int, int]:
    """K1 over (rows, cols) columns of θ of ``elem_bytes`` each."""
    n = rows * cols
    eb = elem_bytes
    return n * (eb + eb + 4 + eb) + n * (eb + 4), n * (8 + 2 * deg)


def k1_one_pass_cost(rows: int, cols: int, elem_bytes: int, deg: int) -> tuple[int, int]:
    """K1's one-pass route over (rows, cols) columns of θ of ``elem_bytes`` each."""
    n = rows * cols
    eb = elem_bytes
    return n * (eb + eb + 4) + n * (eb + 4), n * (11 + 2 * deg)


def k2_cost(cols: int, elem_bytes: int, deg: int) -> tuple[int, int]:
    """K2 over one (cols,) row with ``deg`` neighbour rows."""
    eb = elem_bytes
    return cols * (eb + eb + 4 + deg * eb) + cols * (eb + 4), cols * (8 + 2 * deg)


def k3_cost(rows: int, offsets: Sequence[int], elem_bytes: int) -> tuple[int, int]:
    """K3 over the column segments ``offsets`` of (rows, ·)."""
    n = rows * (offsets[-1] - offsets[0])
    return n * elem_bytes + rows * (len(offsets) - 1) * 4, 2 * n


def attention_pairs(sq: int, sk: int, *, causal: bool, window: Optional[int]) -> int:
    """Allowed (q, k) pairs of one head under the mask (positions are the
    row indices)."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    lo = np.maximum(q - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def k4_cost(b: int, h: int, kv: int, sq: int, sk: int, d: int, elem_bytes: int, *,
            causal: bool, window: Optional[int]) -> tuple[int, int]:
    """K4 on q (b, h, sq, d) and k, v (b, kv, sk, d)."""
    flops = 4 * d * b * h * attention_pairs(sq, sk, causal=causal, window=window)
    nbytes = (2 * b * h * sq * d + 2 * b * kv * sk * d) * elem_bytes
    return nbytes, flops

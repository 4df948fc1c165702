"""DBench — white-box variance instrumentation (paper §3).

The counterpart of ``repro/core/dbench.py``.  DBench profiles a
(de)centralized run by collecting, per training iteration, the L2 norm of
every parameter tensor on every replica *before* the mixing step, then
summarizing the cross-replica dispersion of those norms with four metrics
(paper §3.3):

  * gini coefficient
  * index of dispersion        (variance / mean)
  * coefficient of variation   (std / mean)
  * quartile coefficient of dispersion  ((Q3 - Q1) / (Q3 + Q1))

and integrating across parameters via rank analysis (paper Figure 5).

The in-step probe ``param_l2_norms`` runs kernel K3 over the port's flat
(G, P) parameter buffer, one segment per leaf (over the simulator's split
state, once per row block on the block's card); the metric math below is
a numpy copy of the reference and runs host-side on (n_nodes,)-vectors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.flat import FlatLayout
from repro_torch.core.node_split import blocks_of, cat_nodes
from repro_torch.kernels.stats import segment_l2_norms

__all__ = [
    "param_l2_norms",
    "gini",
    "index_of_dispersion",
    "coefficient_of_variation",
    "quartile_coefficient",
    "variance_report",
    "rank_analysis",
    "DBenchRecorder",
]


# ---------------------------------------------------------------------------
# In-step collection
# ---------------------------------------------------------------------------

def param_l2_norms(flat, layout: FlatLayout) -> torch.Tensor:
    """L2 norm per leaf of every node: a flat (G, P) parameter buffer laid
    out by ``layout`` -> (G, n_leaves) float32, in reference leaf order.
    A split buffer (``NodeBlocks``) takes one K3 launch per block on its
    card, each checked and billed for its own rows; the norms come back
    in node order on the first block's device."""
    return cat_nodes([segment_l2_norms(b, layout.offsets) for b in blocks_of(flat)],
                     flat.device)


# ---------------------------------------------------------------------------
# Dispersion metrics (host-side, numpy; operate on the replica axis)
# ---------------------------------------------------------------------------

def _as2d(x) -> np.ndarray:
    """-> (n_replicas, n_series) float64."""
    a = np.asarray(x, dtype=np.float64)
    if a.ndim == 1:
        a = a[:, None]
    return a


def gini(x, axis: int = 0) -> np.ndarray:
    """Gini coefficient  Σ_ij |x_i - x_j| / (2 n² μ)  along ``axis``."""
    a = np.moveaxis(np.asarray(x, dtype=np.float64), axis, 0)
    n = a.shape[0]
    diffs = np.abs(a[:, None, ...] - a[None, :, ...]).sum(axis=(0, 1))
    mu = a.mean(axis=0)
    denom = 2.0 * n * n * np.where(mu == 0.0, 1.0, np.abs(mu))
    out = diffs / denom
    return np.where(mu == 0.0, 0.0, out)


def index_of_dispersion(x, axis: int = 0) -> np.ndarray:
    a = np.asarray(x, dtype=np.float64)
    mu = a.mean(axis=axis)
    var = a.var(axis=axis)
    return np.where(mu == 0.0, 0.0, var / np.where(mu == 0.0, 1.0, mu))


def coefficient_of_variation(x, axis: int = 0) -> np.ndarray:
    a = np.asarray(x, dtype=np.float64)
    mu = a.mean(axis=axis)
    sd = a.std(axis=axis)
    return np.where(mu == 0.0, 0.0, sd / np.where(mu == 0.0, 1.0, np.abs(mu)))


def quartile_coefficient(x, axis: int = 0) -> np.ndarray:
    a = np.asarray(x, dtype=np.float64)
    q1 = np.percentile(a, 25, axis=axis)
    q3 = np.percentile(a, 75, axis=axis)
    s = q3 + q1
    return np.where(s == 0.0, 0.0, (q3 - q1) / np.where(s == 0.0, 1.0, s))


_METRICS = {
    "gini": gini,
    "index_of_dispersion": index_of_dispersion,
    "coefficient_of_variation": coefficient_of_variation,
    "quartile_coefficient": quartile_coefficient,
}


def variance_report(norms: np.ndarray) -> dict[str, np.ndarray]:
    """All four metrics for per-node norms of shape (n_nodes, n_leaves)."""
    a = _as2d(norms)
    return {name: fn(a, axis=0) for name, fn in _METRICS.items()}


# ---------------------------------------------------------------------------
# Rank analysis (paper Figure 5)
# ---------------------------------------------------------------------------

def _average_ranks(a: np.ndarray) -> np.ndarray:
    """1-based ranks along axis 0 with ties averaged (scipy ``rankdata``
    "average" method): equal values share the mean of the positions they
    span, so e.g. an all-equal column ranks every entry (I+1)/2."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    flat = a.reshape(n, -1)
    out = np.empty_like(flat)
    for j in range(flat.shape[1]):
        col = flat[:, j]
        order = np.argsort(col, kind="stable")
        i = 0
        while i < n:
            k = i
            while k + 1 < n and col[order[k + 1]] == col[order[i]]:
                k += 1
            out[order[i : k + 1], j] = 0.5 * (i + k) + 1.0  # mean of i+1..k+1
            i = k + 1
    return out.reshape(a.shape)


def rank_analysis(
    per_impl_metric: Mapping[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """Rank SGD implementations by dispersion at matched iterations.

    Args:
      per_impl_metric: impl name -> (n_iters, n_leaves) metric values
        (e.g. gini) collected at the same iterations for the same model.

    Returns:
      impl name -> (n_iters,) mean rank across leaves (1 = lowest variance,
      len(impls) = highest), the paper's integration device for comparing
      topologies across heterogeneous parameters.  Ties get *average* ranks
      (scipy-style): equal-dispersion implementations tie in the Fig-5 rank
      curves instead of being split by dictionary order.
    """
    names = sorted(per_impl_metric)
    stack = np.stack([np.atleast_2d(per_impl_metric[k]) for k in names])  # (I, T, L)
    ranks = _average_ranks(stack)
    return {k: ranks[i].mean(axis=-1) for i, k in enumerate(names)}


# ---------------------------------------------------------------------------
# Recorder — the DBench profiling log of a run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DBenchRecorder:
    """Accumulates per-iteration profiling data for one training run."""

    impl: str
    n_nodes: int
    leaf_names: Sequence[str] = ()
    iterations: list[int] = dataclasses.field(default_factory=list)
    losses: list[np.ndarray] = dataclasses.field(default_factory=list)
    norms: list[np.ndarray] = dataclasses.field(default_factory=list)

    def record(self, iteration: int, per_node_loss, per_node_norms) -> None:
        """per_node_loss: (n,), per_node_norms: (n, n_leaves) — pre-mixing."""
        self.iterations.append(int(iteration))
        self.losses.append(np.asarray(per_node_loss, dtype=np.float64))
        self.norms.append(np.asarray(per_node_norms, dtype=np.float64))

    def metric_series(self, metric: str = "gini") -> np.ndarray:
        """(n_iters, n_leaves) dispersion series."""
        fn = _METRICS[metric]
        return np.stack([fn(m, axis=0) for m in self.norms])

    def summary(self) -> dict[str, Any]:
        g = self.metric_series("gini")
        return {
            "impl": self.impl,
            "n_nodes": self.n_nodes,
            "iterations": list(self.iterations),
            "mean_loss": [float(l.mean()) for l in self.losses],
            "loss_spread": [float(l.max() - l.min()) for l in self.losses],
            "mean_gini": g.mean(axis=-1).tolist(),
            "max_gini": g.max(axis=-1).tolist(),
        }

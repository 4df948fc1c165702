"""Mixing (gossip averaging): the function-level façade over the program IR.

The counterpart of ``repro/core/mixing.py``.  One mixing step θ ← W θ
compiles the graph into a ``GossipProgram`` (``core/schedule.py``) and
runs one of its interpreters:

  * ``mix_dense``    — dense mixing-matrix einsum over a stacked replica
                       axis (the paper's equation; the oracle);
  * ``mix_shift``    — the program's stacked interpreter (rolls and
                       gathers over the stacked axis);
  * ``mix_ppermute`` — the program's shard interpreter on one rank of the
                       one-rank-per-node engine: one ``Comm.permute`` per
                       PPermute op, the all-reduce for the complete graph.

Stacked values are a tensor whose leading axis is the node axis, or a dict
of such tensors, or the simulator's split node axis (a
``core/node_split.NodeBlocks`` of row blocks, each on its card), which the
dense and stacked interpreters run block by block.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graphs import CommGraph
from repro_torch.core.schedule import (
    GossipProgram, _dense, PPermute, compile_graph, permutation_for_offset,
    program_comm_bytes,
)

__all__ = [
    "mix_dense",
    "mix_shift",
    "mix_ppermute",
    "permutation_for_offset",
    "mixing_comm_bytes",
]


def _tree_bytes(tree) -> int:
    leaves = tree.values() if isinstance(tree, dict) else [tree]
    return sum(x.numel() * x.element_size() for x in leaves)


def mixing_comm_bytes(graph: CommGraph, params) -> int:
    """Bytes sent per node per mixing step (analytic model, from the
    compiled program): permutes move P each, the complete graph is a ring
    all-reduce (2·P·(n−1)/n per node).  ``params`` is one node's tensor or
    dict of tensors."""
    return program_comm_bytes(compile_graph(graph), _tree_bytes(params))


def mix_dense(stacked, w):
    """θ ← W θ with a dense (n, n) mixing matrix over leading axis 0
    (float32 accumulation; the result keeps each input's dtype; split rows
    block by block, ``split_matmul``)."""
    x = next(iter(stacked.values())) if isinstance(stacked, dict) else stacked
    wt = torch.as_tensor(np.asarray(w), device=x.device).float()
    if isinstance(stacked, dict):
        return {k: _dense(wt, v) for k, v in stacked.items()}
    return _dense(wt, stacked)


def mix_shift(stacked, graph: CommGraph):
    """θ_i ← w_self·θ_i + Σ_d w_d·θ_{(i+d) mod n} over the stacked axis."""
    return compile_graph(graph).apply_stacked(stacked)


def mix_ppermute(local, graph: CommGraph, comm, *,
                 complete_as_allreduce: bool = True):
    """One gossip step for this rank's values over ``comm``
    (``launch/comm.py``); ``graph.n`` must equal the world size.
    ``complete_as_allreduce=False`` runs the complete graph as n−1
    explicit permutes (a benchmark baseline, never the default)."""
    program = compile_graph(graph)
    if not complete_as_allreduce and graph.name == "complete":
        program = GossipProgram(
            name="complete_unrolled",
            n=graph.n,
            ops=tuple(
                PPermute(permutation_for_offset(graph.n, d), wd, offset=d)
                for d, wd in graph.weighted_offsets()
            ),
            self_weight=graph.self_weight,
        )
    return program.apply_shard(local, comm)

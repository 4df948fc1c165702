"""Deterministic synthetic LM data with per-node disjoint shards.

A numpy copy of the reference ``SyntheticLM`` (``repro/data/synthetic.py``):
seeded per (seed, node, step), so both packages draw bit-identical batches;
``node_batch_iterator`` yields them as tensors on a device.

The token stream is a learnable-structure Markov-ish source (next token =
affine function of current + noise) so that training loss decreases.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["SyntheticLM", "node_batch_iterator"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Synthetic language-model token source."""

    vocab: int
    seq_len: int
    seed: int = 0
    structure: float = 0.85  # P(next token follows the deterministic rule)

    def _rng(self, node: int, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, node, step])
        )

    def sample(self, node: int, step: int, batch: int) -> dict[str, np.ndarray]:
        """One (tokens, targets) batch for a node at a step.

        targets[t] = tokens[t+1]; last position masked with -1.
        """
        rng = self._rng(node, step)
        s = self.seq_len
        toks = np.empty((batch, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        mult = 6364136223846793005 % self.vocab
        for t in range(s):
            follow = rng.random(batch) < self.structure
            nxt = (toks[:, t] * mult + 12345) % self.vocab
            rand = rng.integers(0, self.vocab, batch)
            toks[:, t + 1] = np.where(follow, nxt, rand)
        tokens = toks[:, :-1]
        targets = toks[:, 1:].copy()
        targets[:, -1] = -1
        return {"tokens": tokens, "targets": targets}

    def stacked(self, n_nodes: int, step: int, per_node_batch: int) -> dict[str, np.ndarray]:
        """Disjoint shards for all nodes, stacked (n_nodes, B, S)."""
        outs = [self.sample(i, step, per_node_batch) for i in range(n_nodes)]
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}



def node_batch_iterator(
    source: SyntheticLM,
    n_nodes: int,
    per_node_batch: int,
    *,
    start_step: int = 0,
    extra: Optional[dict] = None,
    device=None,
) -> Iterator[dict]:
    """Infinite iterator of stacked per-node batches from ``start_step`` on,
    as tensors on ``device`` (the card by default); ``extra`` entries are
    added to every batch."""
    dev = resolve_device(device)
    step = start_step
    while True:
        b = source.stacked(n_nodes, step, per_node_batch)
        out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if extra:
            out.update(extra)
        yield out
        step += 1
